"""Data parallelism across processes: one rank a device, started by torchrun.

The port of `structuredetector_tpu/parallel/mesh.py`. Under `jit` over a
("data", "model") mesh the JAX train step is one SPMD program with
global-batch semantics. The port runs one process a device instead
(`torchrun --nproc_per_node N -m structuredetector_tpu_torch.cli.train
--data_parallel N`), each with its contiguous slice of every global
batch, and keeps the global semantics by hand:

- the BatchNorm statistics are those of the global batch
  (`models.resnet.BatchNorm2d`);
- each loss normalizer counts over the global batch (`ops.losses`);
- the augmentation is drawn for the global batch (`ops.device_augment`);
- the gradients are averaged by `DistributedDataParallel`
  (`train.steps`).

A rank's device is `cuda:(LOCAL_RANK % device_count)`, or the CPU. The
backend follows a fixed rule: NCCL when each rank has a card of its own,
gloo when ranks share a card or run on the CPU. A failed start raises;
nothing falls back to another backend or to one process.

Not ported: the "model" axis (output-channel tensor parallelism, JAX
`_kernel_spec` / `param_shardings`) and row (spatial) partitioning (JAX
`spatial_sharding`). Asking for either raises with the reason below.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

MODEL_PARALLEL_NOT_PORTED = "output-channel tensor parallelism is not ported"
SPATIAL_NOT_PORTED = "row (spatial) partitioning is not ported"

# how long a rank waits for the others at the start and in a collective
DEFAULT_TIMEOUT_S = 600.0


def torchrun_command(n: int) -> str:
    return (f"torchrun --nproc_per_node {n} -m structuredetector_tpu_torch.cli.train "
            f"--data_parallel {n} ...")


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


def data_parallel_size(data_parallel: int, model_parallel: int = 1) -> int:
    """The size of the data axis: `data_parallel`, or every rank for 0.
    Raises a ValueError that names the torchrun command when it is not
    the number of ranks, and for a model axis above 1."""
    if model_parallel > 1:
        raise ValueError(f"--model_parallel {model_parallel}: {MODEL_PARALLEL_NOT_PORTED}")
    world = world_size()
    if data_parallel not in (0, world):
        raise ValueError(
            f"--data_parallel {data_parallel} with {world} process(es): the port runs one "
            f"process a device; launch {torchrun_command(data_parallel)} "
            f"(or python -m torch.distributed.run with the same arguments), or pass 0 "
            f"for every rank")
    return world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the data axis: `data` of them (the model axis is always
    1), this process's `rank` of `world`, its `device` and the `backend`
    (None in one process)."""

    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def create_mesh(data_parallel: int = 0, model_parallel: int = 1, device="cuda") -> Mesh:
    """The data axis over the ranks of the process group (`data_parallel`
    0 = all of them; anything else must equal their number, as JAX
    `create_mesh` needs the devices to exist)."""
    data = data_parallel_size(data_parallel, model_parallel)
    backend = dist.get_backend() if data > 1 else None
    return Mesh(data=data, model=1, rank=rank(), world=world_size(),
                device=resolve_device(device), backend=backend)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks of the default process group, as a new
    tensor that carries no gradient."""
    out = t.detach().clone()
    dist.all_reduce(out)
    return out
