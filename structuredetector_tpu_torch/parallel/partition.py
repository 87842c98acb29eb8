"""SDNet's forward split over the mesh's "model" axis: channel shards or row
shards, with every collective placed by hand.

Under GSPMD the JAX package gets both from shardings alone: the model
axis's output-channel tensor parallelism (`param_shardings`, `cli.train
--model_parallel M`) and row (spatial) partitioning (`spatial_sharding`,
`make_sharded_forward(spatial=True)`, `make_train_step(spatial=True)`).
Here `models.network.SDNet.forward(x, partition=plan)` walks the model's
modules, the one walk of one process too, and a plan places each op:

- `ChannelPlan` (the model axis). A rank holds the Cout slice of every
  tensor that `parallel.mesh.shards_on_cout` shards (`shard_model`: real
  slices of the parameters, BN buffers and so Adam's moments), and the
  activations move between layers as channel shards. A conv all-gathers
  its input channels first. The gather's backward sums the ranks' partial
  input gradients (a reduce-scatter) when the conv is sharded, and takes
  the rank's slice when it is replicated (the head where M+N+4 does not
  divide): every rank then holds the same whole gradient, and summing it
  would scale it by M. A sharded conv that reads a replicated tensor sums
  its gradient over the group. BN, ReLU, the residual add, the max pool
  and the upsample work on the shards; the BN statistics are taken over
  the data group, whose ranks hold the same channels. The head output is
  gathered whole on every rank. Replicated tensors carry the same whole
  gradient on every rank.
- `RowPlan` (rows over the model axis, batch over data). Each rank holds
  a contiguous run of each activation's rows. Before every window op
  (the 7x7/2 stem or the space-to-depth stem, the 3x3 convs, the max
  pool, `head_hidden`) a halo exchange with the neighbour ranks
  (`_Halo`, point to point within the model group) brings the rows the
  window reads past the rank's own; its backward returns the halo
  gradients to their owners, which add them in. Only the global top and
  bottom edges take the op's own padding: zeros for a conv, -inf for
  the max pool. The BN statistics are taken over the whole mesh. The head
  output is gathered along the rows.

  The rule for small maps: where an op's rows do not split evenly over
  the group at its stride (a stride-2 op, the space-to-depth stem, on an
  odd run of local rows), or its halo is taller than a rank's rows, the
  activation's rows are gathered and the network continues replicated
  from there (BN statistics then over the data group). An FPN sum of a
  replicated map and a row-sharded skip slices the replicated map to the
  rank's rows. This is correct, if redundant: 32 rows over 4 ranks leave
  layer3 and layer4 replicated. In the backward a replicated tensor
  carries a partial gradient on each rank, the ranks' partials summing
  to its gradient (gathers reduce-scatter, slices pad with zeros, the
  final output scales by 1/M), so every parameter gradient is a partial
  that the mesh-wide average of the train step completes.

Every rank walks the same modules in the same order, so the collectives
meet. Nothing here is a kernel: the collectives are gloo's or NCCL's, as
the convolutions are cuDNN's. Int8 models are not partitioned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.network import upsample2x_nearest
from ..models.resnet import S2dStemConv, space_to_depth
from .mesh import Mesh, param_shardings, shards_on_cout


@dataclasses.dataclass(frozen=True)
class Part:
    """An activation (B, C, H, W) on this rank: the whole tensor, or this
    rank's share of it over the model axis (`split`)."""

    t: torch.Tensor
    split: bool

    def map(self, fn) -> "Part":
        return Part(fn(self.t), self.split)


def all_gather(t: torch.Tensor, dim: int, group, size: int, backend) -> torch.Tensor:
    """The `size` ranks' `t` of `group` joined along `dim`. gloo gathers
    only host memory, so a card's tensors go through the host there."""
    host = t.is_cuda and backend == "gloo"
    src = t.detach().cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def share_over_model(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Every rank of this rank's model group takes, in place, the `tensors`
    of the group's first rank (a collective of the group; gloo through
    the host for a card's tensors)."""
    first = mesh.data_index * mesh.model  # the layout of `parallel.mesh`
    for t in tensors:
        host = t.is_cuda and mesh.backend == "gloo"
        buf = t.cpu() if host else t
        dist.broadcast(buf, first, group=mesh.model_group)
        if host:
            t.copy_(buf)


def _summed(g: torch.Tensor, group) -> torch.Tensor:
    out = g.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    """The model group's shards of dim `dim` joined on every rank. Backward:
    the rank's shard of the incoming gradient, after summing it over the
    group where each rank holds a partial gradient of the whole (`reduce`),
    as it is where every rank holds the same whole gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, plan, reduce: bool):
        ctx.dim, ctx.plan, ctx.reduce, ctx.local = dim, plan, reduce, x.shape[dim]
        return all_gather(x, dim, plan.group, plan.size, plan.mesh.backend)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = _summed(g, ctx.plan.group)
        return g.narrow(ctx.dim, ctx.plan.index * ctx.local, ctx.local), None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the model group (a
    replicated tensor read by a Cout-sharded conv: each rank's gradient
    comes from its own output channels)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.plan.group), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; backward scales the gradient by 1/M (a replicated
    output whose every rank holds the whole gradient becomes the ranks'
    partials)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.size = plan.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _Slice(torch.autograd.Function):
    """This rank's rows of a replicated (B, C, H, W) tensor. Backward: the
    rows' gradient in zeros of the whole, the rank's partial."""

    @staticmethod
    def forward(ctx, x, plan):
        h = x.shape[2] // plan.size
        ctx.h, ctx.index, ctx.shape = h, plan.index, x.shape
        return x.narrow(2, plan.index * h, h).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(2, ctx.index * ctx.h, ctx.h).copy_(g)
        return out, None


class _Halo(torch.autograd.Function):
    """The rank's rows of x (B, C, h, W) with `top` rows of the rank above
    and `bottom` rows of the rank below around them, or `fill` rows at the
    global edges. Backward: the halo rows' gradients go back to the ranks
    that own those rows, which add them to their own."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int, fill: float, plan):
        h = x.shape[2]
        above, below = plan.index > 0, plan.index < plan.size - 1
        sends = [(x[:, :, h - top:], 1)] if top and below else []
        sends += [(x[:, :, :bottom], -1)] if bottom and above else []
        recvs = [(top, -1)] if top and above else []
        recvs += [(bottom, 1)] if bottom and below else []
        got = plan.exchange(sends, recvs, x)

        def edge(rows):
            shape = list(x.shape)
            shape[2] = rows
            return x.new_full(shape, fill)

        head = (got.pop(0) if above else edge(top)) if top else x[:, :, :0]
        tail = (got.pop(0) if below else edge(bottom)) if bottom else x[:, :, :0]
        ctx.h, ctx.top, ctx.bottom, ctx.plan = h, top, bottom, plan
        return torch.cat((head, x, tail), 2)

    @staticmethod
    def backward(ctx, g):
        h, top, bottom, plan = ctx.h, ctx.top, ctx.bottom, ctx.plan
        above, below = plan.index > 0, plan.index < plan.size - 1
        g_top, g_own, g_bottom = g.split((top, h, bottom), 2)
        sends = [(g_top, -1)] if top and above else []
        sends += [(g_bottom, 1)] if bottom and below else []
        recvs = [(top, 1)] if top and below else []
        recvs += [(bottom, -1)] if bottom and above else []
        got = plan.exchange(sends, recvs, g)
        dx = g_own.clone(memory_format=torch.contiguous_format)
        if top and below:
            dx[:, :, h - top:] += got.pop(0)
        if bottom and above:
            dx[:, :, :bottom] += got.pop(0)
        return dx, None, None, None, None


class _Plan:
    """What both plans share: the model group of `mesh` and this rank's
    place in it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.group, self.size, self.index = mesh.model_group, mesh.model, mesh.model_index

    def maxpool(self, m: nn.MaxPool2d, a: Part) -> Part:
        return a.map(m)

    def relu(self, a: Part) -> Part:
        return a.map(F.relu)

    def upsample(self, a: Part) -> Part:
        return a.map(upsample2x_nearest)


class ChannelPlan(_Plan):
    """Output-channel tensor parallelism: the plan of a model that
    `shard_model` sharded. `names` are the state_dict entries held as
    Cout slices (`parallel.mesh.param_shardings`)."""

    def __init__(self, mesh: Mesh, names: List[str]):
        super().__init__(mesh)
        self.names = frozenset(names)

    def enter(self, x: torch.Tensor) -> Part:
        return Part(x, False)

    def conv(self, m: nn.Conv2d, a: Part) -> Part:
        full = (m.out_channels, *m.weight.shape[1:])
        sharded = shards_on_cout("weight", full, self.size)
        x = a.t
        if a.split:
            x = _Gather.apply(x, 1, self, sharded)
        elif sharded and x.requires_grad:
            x = _SumGrad.apply(x, self)
        return Part(m(x), sharded)

    def bn(self, m: nn.Module, a: Part) -> Part:
        return Part(m(a.t, group=self.mesh.data_group), a.split)

    def add(self, a: Part, b: Part) -> Part:
        if a.split != b.split:
            a, b = (self._whole(a), b) if a.split else (a, self._whole(b))
        return Part(a.t + b.t, a.split)

    def _whole(self, a: Part) -> Part:
        return Part(_Gather.apply(a.t, 1, self, False), False)

    def leave(self, a: Part) -> torch.Tensor:
        return self._whole(a).t if a.split else a.t

    # -- the state: real slices on the rank, whole tensors in the files ----

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's Cout slice of a whole tensor."""
        c = t.shape[0] // self.size
        return t.narrow(0, self.index * c, c)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The group's slices joined (a collective of the model group)."""
        return all_gather(t.detach(), 0, self.group, self.size, self.mesh.backend)

    def full_state_dict(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.whole(v) if k in self.names else v for k, v in sd.items()}

    def local_state_dict(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self.local(v).clone() if k in self.names else v for k, v in sd.items()}

    def _optimizer_state(self, sd: dict, param_names: List[str], fn) -> dict:
        """Adam's per-parameter moments of the sharded parameters through
        `fn`; the step counts and the groups as they are."""
        state = {i: {k: fn(v) if param_names[i] in self.names and v.dim() else v
                     for k, v in s.items()} for i, s in sd["state"].items()}
        return {**sd, "state": state}

    def full_optimizer_state(self, sd: dict, param_names: List[str]) -> dict:
        return self._optimizer_state(sd, param_names, self.whole)

    def local_optimizer_state(self, sd: dict, param_names: List[str]) -> dict:
        return self._optimizer_state(sd, param_names, lambda t: self.local(t).clone())

    def average_replicated_grads(self, model: nn.Module) -> None:
        """Average the gradients of the replicated parameters over the model
        group. Every rank computed the same whole gradient; the average
        keeps the replicas equal where the card's reductions are not
        deterministic."""
        for name, p in model.named_parameters():
            if name not in self.names and p.grad is not None:
                dist.all_reduce(p.grad, group=self.group)
                p.grad.div_(self.size)


def shard_model(model: nn.Module, mesh: Mesh) -> ChannelPlan:
    """Keep on this rank only its Cout slice of every tensor that JAX's
    `param_shardings` places on the model axis (real, smaller parameters
    and BN buffers under the same names). Returns the `ChannelPlan` that
    every forward of the model then takes (`SDNet.forward(partition=)`)
    and its train state keeps (`TrainState.partition`). Build the
    optimizer after this: its moments are then slices too."""
    names = param_shardings(model.state_dict(), mesh.model)
    plan = ChannelPlan(mesh, names)
    with torch.no_grad():
        for name in names:
            owner, leaf = name.rsplit(".", 1)
            module = model.get_submodule(owner)
            t = getattr(module, leaf)
            local = plan.local(t).clone()
            if isinstance(t, nn.Parameter):
                setattr(module, leaf, nn.Parameter(local, requires_grad=t.requires_grad))
            else:
                module.register_buffer(leaf, local)
    return plan


class RowPlan(_Plan):
    """Row (spatial) partitioning: image rows over the model axis of `mesh`
    (JAX `spatial_sharding`), the parameters replicated."""

    def enter(self, x: torch.Tensor) -> Part:
        h = x.shape[2] // self.size
        if self.size == 1 or x.shape[2] % self.size:
            return Part(x, False)
        return Part(x.narrow(2, self.index * h, h), True)

    def exchange(self, sends, recvs, like: torch.Tensor) -> List[torch.Tensor]:
        """Point-to-point within the model group: each (tensor, offset) of
        `sends` to rank + offset; returns, for each (rows, offset) of
        `recvs`, the rows of `like`'s shape from rank + offset. gloo sends
        only host memory, so a card's tensors go through the host there."""
        host = like.is_cuda and self.mesh.backend == "gloo"
        device = torch.device("cpu") if host else like.device
        rank = self.mesh.rank
        ops = [dist.P2POp(dist.isend, t.to(device).contiguous(), rank + off, self.group)
               for t, off in sends]
        bufs = []
        for rows, off in recvs:
            shape = list(like.shape)
            shape[2] = rows
            bufs.append(torch.empty(shape, dtype=like.dtype, device=device))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], rank + off, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(like.device) for b in bufs]

    def _window(self, x: torch.Tensor, kernel: int, stride: int, top: int, fill: float):
        """x with the halo rows that a window op of `kernel` rows, `stride`
        and `top` padding rows reads, or None where the rank's rows do not
        fit the op (then it runs on the gathered rows)."""
        h = x.shape[2]
        bottom = max(kernel - stride - top, 0)
        if h % stride or top > h or bottom > h:
            return None
        return _Halo.apply(x, top, bottom, fill, self)

    def gather(self, a: Part) -> Part:
        return Part(_Gather.apply(a.t, 2, self, True), False)

    def conv(self, m: nn.Conv2d, a: Part) -> Part:
        if not a.split:
            return Part(m(a.t), False)
        if isinstance(m, S2dStemConv):
            # space-to-depth pairs rows: an even run, then a 4x4/1 conv
            # padded ((2, 1), (2, 1))
            if a.t.shape[2] % 2:
                return self.conv(m, self.gather(a))
            x, kernel, (sh, sw), top, (left, right) = space_to_depth(a.t), 4, (1, 1), 2, (2, 1)
        else:
            x, kernel, (sh, sw) = a.t, m.kernel_size[0], m.stride
            top, left = m.padding
            right = left
        x = self._window(x, kernel, sh, top, 0.0)
        if x is None:
            return self.conv(m, self.gather(a))
        if left or right:
            x = F.pad(x, (left, right))
        return Part(F.conv2d(x, m.weight, m.bias, (sh, sw)), True)

    def maxpool(self, m: nn.MaxPool2d, a: Part) -> Part:
        if not a.split:
            return Part(m(a.t), False)
        x = self._window(a.t, m.kernel_size, m.stride, m.padding, float("-inf"))
        if x is None:
            return self.maxpool(m, self.gather(a))
        return Part(F.max_pool2d(x, m.kernel_size, m.stride, padding=(0, m.padding)), True)

    def bn(self, m: nn.Module, a: Part) -> Part:
        # row shards: the whole mesh's batch; whole rows: the data axis's
        return Part(m(a.t, group=None if a.split else self.mesh.data_group), a.split)

    def add(self, a: Part, b: Part) -> Part:
        if a.split != b.split:
            a, b = (a, self._slice(b)) if a.split else (self._slice(a), b)
        return Part(a.t + b.t, a.split)

    def _slice(self, a: Part) -> Part:
        return Part(_Slice.apply(a.t, self), True)

    def leave(self, a: Part) -> torch.Tensor:
        if a.split:
            return _Gather.apply(a.t, 2, self, False)
        return _ScaleGrad.apply(a.t, self)
