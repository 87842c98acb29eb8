"""The ("data", "model") mesh across processes: one rank a device, started
by torchrun.

The port of `structuredetector_tpu/parallel/mesh.py`. Under `jit` over a
("data", "model") mesh the JAX train step is one SPMD program with
global-batch semantics, and GSPMD places every collective. The port runs
one process a device instead (`torchrun --nproc_per_node D*M -m
structuredetector_tpu_torch.cli.train --data_parallel D --model_parallel
M`), laid out as JAX's `devices.reshape(D, M)`, and places the
collectives by hand:

- on the data axis each rank brings its contiguous slice of every global
  batch: the BatchNorm statistics are those of the global batch
  (`models.resnet.BatchNorm2d`), each loss normalizer counts over the
  global batch (`ops.losses`), the augmentation is drawn for the global
  batch (`ops.device_augment`) and `DistributedDataParallel` averages the
  gradients (`train.steps`);
- on the model axis a rank holds the Cout slice of every conv that JAX's
  `param_shardings` shards (`shards_on_cout`), and the activations move
  between layers as channel shards (`parallel.partition.ChannelPlan`,
  `--model_parallel M`); or, in the spatial step and
  `make_sharded_forward(spatial=True)`, the image rows split over it with
  halo exchanges before every window op (`parallel.partition.RowPlan`).

A rank's device is `cuda:(LOCAL_RANK % device_count)`, or the CPU. The
backend follows a fixed rule: NCCL when each rank has a card of its own,
gloo when ranks share a card or run on the CPU. A failed start raises;
nothing falls back to another backend or to one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# how long a rank waits for the others at the start and in a collective
DEFAULT_TIMEOUT_S = 600.0


def torchrun_command(n: int, data: int, model: int = 1) -> str:
    axes = f"--data_parallel {data}" + (f" --model_parallel {model}" if model > 1 else "")
    return f"torchrun --nproc_per_node {n} -m structuredetector_tpu_torch.cli.train {axes} ..."


def world_size() -> int:
    """The number of ranks of the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def choose_backend(device_type: str, local_ranks: int, device_count: int) -> str:
    """NCCL when each of the host's `local_ranks` ranks has a card of its
    own, gloo when ranks share a card or run on the CPU."""
    if device_type == "cuda" and local_ranks <= device_count:
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(device="cuda", *, init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`), or from the
    arguments (`init_method` such as "file:///tmp/store" with `world_size`
    and `rank`). Returns False when neither is there, True once the
    group is up; a second call is a no-op. A failure to connect raises:
    every rank would otherwise train the whole set on its own.

    The rank's device (`utils.resolve_device`: `cuda:(LOCAL_RANK %
    device_count)` for "cuda") is made current before the group starts,
    and the backend is `choose_backend`'s, printed."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return False
        init_method = "env://"
    world = int(world_size if world_size is not None else env["WORLD_SIZE"])
    index = int(rank if rank is not None else env["RANK"])
    dev = resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(dev.type, local_ranks, count)
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=index, timeout=datetime.timedelta(seconds=timeout_s))
    if index == 0:
        print(f"Process group: {world} ranks, backend {backend}, "
              f"{local_ranks} a host on {count or 'no'} card(s)", flush=True)
    return True


def mesh_shape(data_parallel: int, model_parallel: int, world: int) -> Tuple[int, int]:
    """The (data, model) sizes of the mesh over `world` ranks, as JAX
    `create_mesh` reads its arguments: `model_parallel` <= 0 is 1 and
    `data_parallel` <= 0 takes every remaining rank (world // model). The
    port runs one process a device, so the mesh must hold every rank: a
    product other than `world` raises a ValueError that names the
    torchrun command for the mesh asked for."""
    model = max(model_parallel, 1)
    data = data_parallel if data_parallel > 0 else world // model
    if data * model != world:
        need = max(data, 1) * model
        raise ValueError(
            f"--data_parallel {data_parallel} --model_parallel {model_parallel} with {world} "
            f"process(es): the port runs one process a device; launch "
            f"{torchrun_command(need, max(data, 1), model)} (or python -m "
            f"torch.distributed.run with the same arguments), or pass --data_parallel 0 "
            f"for every rank left by the model axis")
    return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ("data", "model") mesh over the ranks: `data` x `model` of them,
    laid out as JAX's `devices.reshape(data, model)`, so rank r sits at
    data index r // model and model index r % model and each model group
    is a run of consecutive ranks. This process is `rank` of `world` on
    `device`, with the `backend` (None in one process).

    `data_group` holds the ranks of this rank's model index (the batch is
    split over them); `model_group` the ranks of its data index (channels
    or rows are split over them). With a model axis of 1 the data group is
    the default group and there is no model group (None); in one process
    neither exists."""

    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def create_mesh(data_parallel: int = 0, model_parallel: int = 1, device="cuda") -> Mesh:
    """The mesh over the ranks of the process group (`mesh_shape`). A model
    axis above 1 makes one `torch.distributed` group per model index and
    one per data index, on every rank in the same order (`new_group` is a
    collective of the default group), so every rank must call this."""
    world = world_size()
    data, model = mesh_shape(data_parallel, model_parallel, world)
    data_group, model_group = (dist.group.WORLD if world > 1 else None), None
    if model > 1:
        grid = [[d * model + m for m in range(model)] for d in range(data)]
        here = rank()
        for ranks in grid:  # the model groups: rows of the grid
            group = dist.new_group(ranks) if data > 1 else dist.group.WORLD
            if here in ranks:
                model_group = group
        for ranks in zip(*grid):  # the data groups: its columns
            group = dist.new_group(list(ranks))
            if here in ranks:
                data_group = group
    backend = dist.get_backend() if world > 1 else None
    return Mesh(data=data, model=model, rank=rank(), world=world, device=resolve_device(device),
                backend=backend, data_group=data_group, model_group=model_group)


def shards_on_cout(name: str, shape, model_size: int) -> bool:
    """Whether the state_dict tensor `name` of `shape` splits its dim 0
    (Cout) over the model axis: JAX `_kernel_spec`'s rule on the port's
    names. A 4-D conv weight whose Cout divides by `model_size` shards, and
    so does a 1-D conv bias or BN vector (weight, bias, running_mean,
    running_var) whose length divides; everything else replicates."""
    if model_size <= 1:
        return False
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 4:
        return shape[0] % model_size == 0
    if leaf in ("weight", "bias", "running_mean", "running_var") and len(shape) == 1:
        return shape[0] % model_size == 0
    return False


def param_shardings(state_dict, model_size: int) -> List[str]:
    """The names of `state_dict` (full shapes) that shard on Cout over a
    model axis of `model_size` (JAX `param_shardings`)."""
    return [k for k, v in state_dict.items() if shards_on_cout(k, tuple(v.shape), model_size)]


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over the ranks of `group` (default: the default process
    group), as a new tensor that carries no gradient."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out
