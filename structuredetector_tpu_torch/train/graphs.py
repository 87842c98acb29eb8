"""Whole-step CUDA graphs of the train step, one per multi-scale bucket.

At the reference's batch of 8 the card finishes each of the train step's
small kernels before the host has launched the next, so the host's
launches set the pace. `StepGraphs` captures the step's body once per
bucket and replays it every step: the host launches one graph where it
launched the step kernel by kernel. A bucket is what the input shows:
the image shape and dtype, the augmentation flag, the compute dtype and
the keypoint tensors' shapes (and the config whose values the body read).

The body (`train.steps`) runs the eager step's kernels in the same order,
with three differences that leave the numbers as they are:

- the augmentation's draws are drawn on the host from
  `step_generator(seed, step)`, as in the eager step, and reach the
  graph's draw tensor in one copy from a pinned buffer (two buffers in
  turn, each written only after its last copy has run);
- the gradients accumulate into buffers made before the first capture,
  which the graph zeroes, instead of buffers the backward allocates;
- the learning rate is a constant of the graph's Adam kernel: a bucket
  whose rate is not the schedule's at the state's step is captured again
  before it replays, so the rate changes at the same step as in eager.

Fused Adam keeps its step count on the card and computes its bias
correction there, so its update reads no host value that changes between
replays. Its `capturable` flag only opens the optimizer's capture check:
it is set for the capture and restored after, and the optimizer's
state_dict stays the eager step's.

Memory: every bucket graph of a state allocates from one pool. What
outlives a replay (parameters, BN buffers, gradients, Adam's moments and
step, the static inputs) is allocated before the first capture, outside
the pool, and what a graph hands back (its stats, and the input and head
that the forward hooks see) stays referenced, so no later capture reuses
it. The rest of a graph's memory is scratch that its own replay writes
before it reads: graphs replayed one at a time on one stream share it.

A bucket's first step on a state runs eagerly. It warms what a capture
cannot (cuDNN's and the allocator's first use of the shapes, the cached
normalization constants) and shows which parameters take a gradient.
`Trainer.prewarm` warms each bucket on a copy of the model and captures
the state's graphs ahead; without it a bucket's second step captures.

A capture runs none of the model's forward hooks. After each replay the
model's forward hooks are called with clones of the replay's input and
head, so whatever watches the model sees every step's output. A hook
that returns a replacement output raises: the replayed step has already
used the head.

Where a graph cannot serve the step, `eager_reason` says why, and the
step runs eagerly; `tracing.train_graph_counters()` counts captures,
replays and eager steps by reason.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

import torch
from torch.nn.modules import module as _module

from ..ops.device_augment import (
    AugmentParams,
    draw_augment_params,
    pack_augment_params,
    step_generator,
)
from ..parallel.mesh import world_size
from ..tracing import TRAIN_GRAPH, span

ADAM_STATE = ("step", "exp_avg", "exp_avg_sq")
# the keyword arguments of the step's call of the model, as its hooks see them
MODEL_KWARGS = {"raw_output": True, "partition": None}


def _module_hooks(model: torch.nn.Module, inner) -> bool:
    """Whether a hook other than the model's own forward hooks would run in
    the step: global module hooks, the model's backward hooks, or any hook
    of one of its modules (`inner`)."""
    if (_module._global_forward_hooks or _module._global_forward_pre_hooks
            or _module._global_backward_hooks or _module._global_backward_pre_hooks
            or model._backward_hooks or model._backward_pre_hooks):
        return True
    for m in inner:
        if m._forward_hooks or m._forward_pre_hooks or m._backward_hooks or m._backward_pre_hooks:
            return True
    return False


def eager_reason(state, images: torch.Tensor, config, mesh=None,
                 spatial: bool = False) -> Optional[str]:
    """Why the train step cannot replay a CUDA graph for this input and
    state, or None where it can:

    - "process_group": more than one rank (DDP's hooks and collectives);
    - "sharded": a model sharded over the model axis (`state.partition`);
    - "spatial": rows split over the model axis (`RowPlan`);
    - "debug_nans": autograd's anomaly mode reads values on the host;
    - "pre_hooks": a forward pre-hook on the model may replace its input;
    - "module_hooks": a hook of a module inside the model, a backward hook
      or a global module hook would run only while capturing;
    - "cpu": the input is not on a CUDA device;
    - "unfused_optimizer": the optimizer is not fused Adam, whose update
      reads no host value."""
    if world_size() > 1 or (mesh is not None and mesh.size > 1):
        return "process_group"
    if state.partition is not None:
        return "sharded"
    if spatial:
        return "spatial"
    if config.debug_nans or torch.is_anomaly_enabled():
        return "debug_nans"
    model = state.model
    if model._forward_pre_hooks:
        return "pre_hooks"
    if _module_hooks(model, state.graphs.inner_modules(model)):
        return "module_hooks"
    if images.device.type != "cuda":
        return "cpu"
    opt = state.optimizer
    if not isinstance(opt, torch.optim.Adam) or not all(g.get("fused") for g in opt.param_groups):
        return "unfused_optimizer"
    return None


def _call_forward_hooks(model: torch.nn.Module, x: torch.Tensor, head: torch.Tensor) -> None:
    """The model's forward hooks, as its call in the step runs them, on
    clones of the replay's input and head."""
    args, out = (x.clone(),), head.clone()
    for hook_id, hook in list(model._forward_hooks.items()):
        if hook_id in model._forward_hooks_with_kwargs:
            result = hook(model, args, dict(MODEL_KWARGS), out)
        else:
            result = hook(model, args, out)
        if result is not None:
            raise RuntimeError("a forward hook returned a replacement output: a replayed "
                               "train step has already used the model's output")


class _Feed:
    """The static inputs that a batch size's buckets share: the keypoint
    tensors and the augmentation's draws, with the two pinned buffers the
    draws are copied from (made at the first draw)."""

    def __init__(self, kp: Dict[str, torch.Tensor], b: int, device: torch.device):
        self.kp = {name: torch.zeros_like(t) for name, t in kp.items()}
        self.draws = torch.zeros((len(AugmentParams._fields), b), dtype=torch.float32,
                                 device=device)
        self.pinned: Optional[List[torch.Tensor]] = None
        self.copied: Optional[List[torch.cuda.Event]] = None
        self.turn = 0


class _Bucket:
    """One bucket: its static image input and, once captured, its graph,
    the rate and config it was captured with, and what it hands back."""

    def __init__(self, images: torch.Tensor, feed: _Feed):
        self.images = torch.zeros_like(images)
        self.feed = feed
        self.graph = None
        self.lr: Optional[float] = None
        self.config = None
        self.outputs = None  # (input, head, stats) written by each replay


class StepGraphs:
    """The CUDA graphs of one `TrainState`'s train step, by bucket. The
    body is `body(state, images, kp, config, draws) -> (x, head, stats)`
    on the static inputs (`draws` None without augmentation)."""

    def __init__(self):
        self._buckets: Dict[tuple, _Bucket] = {}
        self._feeds: Dict[tuple, _Feed] = {}
        self._used: Optional[List[bool]] = None  # which parameters take a gradient
        self._params: Optional[List[torch.Tensor]] = None
        self._grads: Optional[List[torch.Tensor]] = None
        self._adam: Optional[List[dict]] = None
        self._stale = False  # the gradients or Adam's state may have been replaced
        self._pool = None
        self._stream = None
        self._inner = (None, ())  # (model, its modules but itself)

    @staticmethod
    def key(images: torch.Tensor, kp: Dict[str, torch.Tensor], augment: bool, config) -> tuple:
        return (tuple(images.shape), images.dtype, augment, config.compute_dtype,
                tuple((name, tuple(t.shape), t.dtype) for name, t in kp.items()))

    def inner_modules(self, model: torch.nn.Module) -> tuple:
        """The model's modules but itself, listed once (a walk of the
        module tree costs several times a scan of the list)."""
        if self._inner[0] is not model:
            self._inner = (model, tuple(m for m in model.modules() if m is not model))
        return self._inner[1]

    def warmed(self, key: tuple) -> bool:
        return key in self._buckets

    def rebind(self) -> None:
        """Something replaced the gradients or Adam's state (an eager step, a
        loaded optimizer state): point them back at the graphs' tensors,
        with the new values, before the next replay."""
        self._stale = True

    def warm(self, key: tuple, images: torch.Tensor, kp: Dict[str, torch.Tensor],
             used: List[bool]) -> None:
        """The bucket `key` took its eager warm-up step, after which `used`
        (one flag a parameter) held the parameters given a gradient."""
        if self._used is None:
            self._used = list(used)
        b = images.shape[0]
        feed = self._feeds.get((b, key[-1]))
        if feed is None:
            feed = self._feeds[(b, key[-1])] = _Feed(kp, b, images.device)
        self._buckets[key] = _Bucket(images, feed)

    def capture(self, key: tuple, state, config, augment: bool, body: Callable) -> None:
        """Capture the bucket's graph at the schedule's rate for the state's
        step. Nothing runs: the state is left as it was."""
        bucket = self._buckets[key]
        bucket.graph = bucket.outputs = None  # the old graph's scratch goes back to the pool
        self._bind(state)
        model, opt = state.model, state.optimizer
        lr = state.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        feed = bucket.feed
        hooks, model._forward_hooks = model._forward_hooks, collections.OrderedDict()
        capturable = [group["capturable"] for group in opt.param_groups]
        for group in opt.param_groups:
            group["capturable"] = True
        try:
            graph, outputs, reserved = self._record(
                bucket.images.device,
                lambda: body(state, bucket.images, feed.kp, config, feed.draws if augment else None))
        finally:
            model._forward_hooks = hooks
            for group, flag in zip(opt.param_groups, capturable):
                group["capturable"] = flag
        TRAIN_GRAPH.captured(reserved)
        bucket.graph, bucket.lr, bucket.config, bucket.outputs = graph, lr, config, outputs

    def step(self, key: tuple, state, images: torch.Tensor, kp: Dict[str, torch.Tensor],
             config, augment: bool, body: Callable) -> Dict[str, torch.Tensor]:
        """One optimizer step by a replay of the bucket's graph, captured
        first where it has none, or another rate or config. Returns the
        stats as tensors of their own, which later replays leave alone."""
        bucket = self._buckets[key]
        feed, model = bucket.feed, state.model
        if augment:
            with span("sd.train.augment"):
                draws = draw_augment_params(images.shape[0], step_generator(config.seed, state.step),
                                            device="cpu", flip_prob=config.flip_prob)
                self._put_draws(feed, draws)
        bucket.images.copy_(images)
        for name, t in feed.kp.items():
            t.copy_(kp[name])
        if (bucket.graph is None or bucket.lr != state.lr_schedule(state.step)
                or bucket.config is not config):
            self.capture(key, state, config, augment, body)
        elif self._stale:
            self._bind(state)
        for group in state.optimizer.param_groups:
            group["lr"] = bucket.lr
        bucket.graph.replay()
        state.step += 1
        TRAIN_GRAPH.replays += 1
        if not model.training:
            model.train()
        x, head, stats = bucket.outputs
        values = torch.stack(list(stats.values()))
        if model._forward_hooks:
            _call_forward_hooks(model, x, head)
        return dict(zip(stats, values.unbind()))

    def _put_draws(self, feed: _Feed, draws: AugmentParams) -> None:
        """The host's draws into the bucket's draw tensor: one copy from a
        pinned buffer, the other buffer's copy may still be in flight."""
        if feed.pinned is None:
            feed.pinned = [torch.empty(feed.draws.shape, dtype=torch.float32, pin_memory=True)
                           for _ in range(2)]
            feed.copied = [torch.cuda.Event(), torch.cuda.Event()]
        i = feed.turn
        feed.turn ^= 1
        feed.copied[i].synchronize()  # the last copy out of this buffer has run
        pack_augment_params(draws, feed.pinned[i])
        feed.draws.copy_(feed.pinned[i], non_blocking=True)
        feed.copied[i].record()

    def _bind(self, state) -> None:
        """Point the parameters' gradients and Adam's state at the tensors
        the graphs read. The first call makes them: the gradients the
        warm-up left, else zeros, and Adam's state as the optimizer holds
        it, else as its first step would make it. A later call copies
        whatever replaced them back in."""
        opt = state.optimizer
        if self._params is None:
            self._params = [p for p, u in zip(state.model.parameters(), self._used) if u]
            self._grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                           for p in self._params]
            self._adam = []
            for p in self._params:
                held = opt.state[p]
                if not held:
                    held.update(step=torch.zeros((), dtype=torch.float32, device=p.device),
                                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                                exp_avg_sq=torch.zeros_like(p,
                                                            memory_format=torch.preserve_format))
                self._adam.append({name: held[name] for name in ADAM_STATE})
        for p, grad, held in zip(self._params, self._grads, self._adam):
            p.grad = grad
            current = opt.state[p]
            for name, t in held.items():
                if name not in current:  # a loaded state without this parameter
                    t.zero_()
                elif current[name] is not t:
                    t.copy_(current[name])
                current[name] = t
        self._stale = False

    def _record(self, device: torch.device, fn: Callable):
        """Capture the kernels `fn` launches into a new graph of the shared
        pool, without running them: (graph, fn's result, the device memory
        reserved meanwhile)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        torch.cuda.synchronize(device)
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                outputs = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:  # the failed capture's own error says less
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(self._stream)
        return graph, outputs, torch.cuda.memory_reserved(device) - reserved
