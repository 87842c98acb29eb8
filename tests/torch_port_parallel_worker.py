"""One rank of the port's data-parallel tests.

    python tests/torch_port_parallel_worker.py CASE RANK WORLD STORE OUT DEVICE [ARGS...]

Joins a process group of WORLD ranks through a `FileStore` at STORE
(`init_method="file://STORE"`, no TCP port), runs CASE on DEVICE ("cpu",
or "cuda" on the card) on its contiguous slice of a global batch made
from a numpy seed, and `torch.save`s its results to OUT. The pytest
side (`tests/test_torch_port_parallel.py`, `tests/test_torch_port_cuda.py`)
runs the same functions in one process on the joined batch and compares.
Imports nothing of JAX.

Cases: "all" (one BatchNorm2d forward and backward, `sdnet_loss` on
every `LOSS_CASES` pattern, both `STEP_RUNS`, `make_sharded_forward`
and the config errors under a group; ARGS: the "plain" run's weights
file), "step" (the "augment" run), "cli" (ARGS: the working directory,
then `cli.train`'s arguments), and the model axis's (`tests/
test_torch_port_model_axis.py`): "model_axis" on 2 ranks (the 1 x 2
tensor-parallel step, its checkpoint restored on two mesh shapes, the
mesh and the config under the group; ARGS: `mesh_config`'s weights
file, a checkpoint directory) and "rows" on 4 ranks (the row forward
over 1 x 4, the spatial step over 2 x 2, with each `FAULTS` fault planted
too, the tensor-parallel step over 2 x 2; ARGS: the weights file),
"host_augment" (the "cli" case with the host augmentation's rng seeded
by rank, as a thread order may leave it, recording the digest of every
batch the train step takes), and "card" on 2 ranks (`tests/
test_torch_port_cuda.py`: the 1 x 2 tensor-parallel step and the 1 x 2
row forward).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from structuredetector_tpu_torch.config import Config  # noqa: E402

GLOBAL_BATCH = 8
GRID = 8  # 32x32 input at output stride 4
RANK_TIMEOUT_S = 150  # each rank's own: a hang fails one test, not the suite


def small_config(**overrides) -> Config:
    """32x32, fpn_depth 8, fp32, two labels and one part kind."""
    values = dict(width=32, height=32, fpn_depth=8, max_objects=3, max_parts=5,
                  batch_size=GLOBAL_BATCH, use_amp=False, learning_rate=1e-3, epochs=9,
                  lr_step=3, num_workers=0, hm_loss_fn="mse")
    values.update(overrides)
    return Config(**values).set_labels(["bean", "maize"], ["leaf"])


def keypoint_batch(cfg, b: int, seed: int, pattern: str = "uneven"):
    """Padded keypoints of a global batch of `b`. The masks make the
    ranks' keypoint counts differ. "uneven": the last quarter of the
    batch (half of rank 1's samples of 2 ranks) has no valid keypoint;
    "rank1_empty": the second half has none (rank 1 no positive pixel);
    "all_empty": no sample has one."""
    rng = np.random.default_rng(seed)
    o, p = cfg.max_objects, cfg.max_parts
    kp = {
        "anchors_xy": rng.uniform(0.5, GRID - 0.5, (b, o, 2)).astype(np.float32),
        "anchor_cls": rng.integers(0, 2, (b, o)).astype(np.int32),
        "anchor_mask": rng.random((b, o)) < 0.7,
        "parts_xy": rng.uniform(0.5, GRID - 0.5, (b, p, 2)).astype(np.float32),
        "part_kind": np.zeros((b, p), np.int32),
        "part_owner_xy": rng.uniform(0.5, GRID - 0.5, (b, p, 2)).astype(np.float32),
        "part_mask": rng.random((b, p)) < 0.8,
    }
    kp["anchor_mask"][:, 0] = True  # every sample of a non-empty part has one
    empty = {"uneven": slice(3 * b // 4, b), "rank1_empty": slice(b // 2, b),
             "all_empty": slice(0, b)}[pattern]
    kp["anchor_mask"][empty] = False
    kp["part_mask"][empty] = False
    return kp


def train_batch(cfg, b: int, seed: int, uint8: bool, pattern: str = "uneven"):
    """(images, keypoints) of a global batch: uint8 images for the
    device-augmented step, else ImageNet-normalized-like float32."""
    rng = np.random.default_rng(seed + 1000)
    shape = (b, cfg.height, cfg.width, 3)
    if uint8:
        images = rng.integers(0, 256, shape, np.uint8)
    else:
        images = rng.normal(0, 1, shape).astype(np.float32)
    return images, keypoint_batch(cfg, b, seed, pattern)


def bn_inputs():
    """x (8, 4, 6, 6) with a channel mean well off 0, the upstream
    gradient, and the BN's affine parameters."""
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 2, (GLOBAL_BATCH, 4, 6, 6)) + rng.normal(0, 3, (1, 4, 1, 1)))
    g = rng.normal(0, 1, x.shape)
    w, b = rng.uniform(0.5, 1.5, 4), rng.normal(0, 0.5, 4)
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, g, w, b)]


def run_bn(x, g, w, b):
    """Forward and backward of a train-mode `BatchNorm2d` (with perturbed
    running statistics): y, dx, dweight, dbias, running mean and var."""
    from structuredetector_tpu_torch.models.resnet import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).to(x.device)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.fill_(0.2)
        bn.running_var.fill_(1.3)
    x = x.clone().requires_grad_(True)
    y = bn.train()(x)
    y.backward(g)
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def loss_inputs(cfg, pattern: str):
    """Raw head logits (B, M+N+4, 8, 8) and the keypoints of a global batch."""
    rng = np.random.default_rng(17)
    logits = rng.normal(-2, 1.5, (GLOBAL_BATCH, cfg.n_labels + cfg.n_parts + 4, GRID, GRID))
    return torch.from_numpy(logits.astype(np.float32)), keypoint_batch(cfg, GLOBAL_BATCH, 3,
                                                                        pattern)


def run_loss(cfg, logits, kp, global_sum=None):
    """sdnet_loss's total (the rank's share with `global_sum`), its stats
    and the gradient of the total with respect to the logits."""
    from structuredetector_tpu_torch.ops.decode import split_head_output
    from structuredetector_tpu_torch.ops.losses import sdnet_loss
    from structuredetector_tpu_torch.train.steps import encode_batch

    logits = logits.clone().requires_grad_(True)
    targets = encode_batch({k: torch.from_numpy(v) for k, v in kp.items()}, cfg, GRID, GRID)
    total, stats = sdnet_loss(split_head_output(logits, cfg.n_labels, cfg.n_parts), targets,
                              hm_loss_fn=cfg.hm_loss_fn, global_sum=global_sum)
    total.backward()
    return {"stats": {k: v.detach() for k, v in stats.items()}, "grad": logits.grad}


def run_steps(cfg, images, kp, steps: int, augment: bool, device, weights=None):
    """`steps` train steps of the seeded model (or `weights`, a state_dict)
    on one batch: the loss of each step, the gradient and the BN running
    statistics after the first step, the state after the last and its
    `fingerprint`."""
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.parallel.mesh import create_mesh
    from structuredetector_tpu_torch.parallel.multihost import global_batch_arrays
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    def snapshot(named):
        return {k: v.detach().cpu().clone() for k, v in named}

    model = init_model(cfg)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model = model.to(device)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    # this rank's slice on its device (the whole batch in one process)
    images, kp = global_batch_arrays(create_mesh(0, 1, device), images, kp)
    out = {"losses": []}
    for i in range(steps):
        out["losses"].append(float(train_step(state, images, kp, cfg,
                                              augment=augment)["total_loss"]))
        if i == 0:
            out["grad1"] = snapshot((n, p.grad) for n, p in model.named_parameters())
            out["stats1"] = snapshot((n, b) for n, b in model.named_buffers()
                                     if n.endswith(("running_mean", "running_var")))
    out["state"] = snapshot(model.state_dict().items())
    out["fingerprint"] = fingerprint(out["state"])
    return out


def mesh_config(**overrides) -> Config:
    """JAX tests/test_parallel.py's `make_config`: 32x32, `fpn_depth` 16,
    fp32, one label and one part kind (a head of 6 channels, which
    shards over 2 ranks), batch 4, the MSE heatmap loss."""
    values = dict(width=32, height=32, fpn_depth=16, max_objects=2, max_parts=4, batch_size=4,
                  use_amp=False, learning_rate=1e-3, hm_loss_fn="mse", num_workers=0)
    values.update(overrides)
    return Config(**values).set_labels(["bean"], ["leaf"])


def jax_test_batch(cfg, b: int):
    """JAX tests/test_parallel.py's `_batch(cfg, b)`, drawn the same way:
    (images, keypoints) as numpy arrays."""
    rng = np.random.default_rng(0)
    o, p = cfg.max_objects, cfg.max_parts
    kp = {
        "anchors_xy": rng.uniform(1, 7, (b, o, 2)).astype(np.float32),
        "anchor_cls": np.zeros((b, o), np.int32),
        "anchor_mask": np.ones((b, o), bool),
        "parts_xy": rng.uniform(1, 7, (b, p, 2)).astype(np.float32),
        "part_kind": np.zeros((b, p), np.int32),
        "part_owner_xy": rng.uniform(1, 7, (b, p, 2)).astype(np.float32),
        "part_mask": np.ones((b, p), bool),
    }
    return rng.normal(0, 1, (b, cfg.height, cfg.width, 3)).astype(np.float32), kp


def forward_images(shape, seed: int) -> np.ndarray:
    """JAX tests/test_parallel.py's forward inputs: N(0, 1) of `shape`."""
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# the row forward's inputs: JAX's 32x32 batch 4 and its 64x64 single image
ROW_INPUTS = {"rows_32": ((4, 32, 32, 3), 1), "rows_64": ((1, 64, 64, 3), 2)}
# the variants through the row forward: (config overrides, input)
ROW_VARIANTS = {"s2d": (dict(s2d_stem=True), "rows_32"),
                "head_conv": (dict(head_conv=16), "rows_64"),
                "resnet50": (dict(backbone="resnet50"), "rows_64")}


def _dropped_halo_grad(ctx, g):
    """`_Halo.backward` that drops the halo rows' gradients instead of
    returning them to the ranks that own those rows."""
    return g.narrow(2, ctx.top, ctx.h).contiguous(), None, None, None, None


def _summed_gather_grad(ctx, g):
    """`_Gather.backward` that always sums over the group: where every rank
    holds the same whole gradient (the gathered head output) it scales
    the gradient by the ranks' count."""
    from structuredetector_tpu_torch.parallel import partition

    g = partition._summed(g, ctx.plan.group)
    return g.narrow(ctx.dim, ctx.plan.index * ctx.local, ctx.local), None, None, None


# faults planted in the spatial backward, which the spatial step's bar
# must refuse: (autograd Function's name in parallel.partition, backward)
FAULTS = {"dropped_halo_grad": ("_Halo", _dropped_halo_grad),
          "summed_gather_grad": ("_Gather", _summed_gather_grad)}


def planted(fault: str):
    """A context in which `FAULTS[fault]` replaces that backward."""
    import contextlib

    from structuredetector_tpu_torch.parallel import partition

    name, backward = FAULTS[fault]
    fn = getattr(partition, name)

    @contextlib.contextmanager
    def context():
        right = fn.__dict__["backward"]
        fn.backward = staticmethod(backward)
        try:
            yield
        finally:
            fn.backward = right

    return context()


def mesh_step(cfg, mesh, images, kp, weights=None, spatial: bool = False, device="cpu"):
    """One train step (no augmentation) of the seeded model (or `weights`)
    on `mesh` (None: one process), each rank on its data index's slice of
    the global batch: the loss; the gradient, the BN statistics and the
    state after the step, whole (gathered from the model axis); the
    parameter and BN-statistic elements this rank holds; the whole train
    state dict ("whole")."""
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.parallel.partition import shard_model
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    model = init_model(cfg)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model = model.to(device)
    plan = shard_model(model, mesh) if mesh is not None and mesh.model > 1 and not spatial \
        else None
    state = create_train_state(cfg, model, steps_per_epoch=10, partition=plan)
    index, ranks = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)
    images, kp = _part(images, index, ranks), {k: _part(v, index, ranks) for k, v in kp.items()}
    stats = train_step(state, torch.from_numpy(images).to(device),
                       {k: torch.from_numpy(v).to(device) for k, v in kp.items()}, cfg,
                       mesh=mesh, spatial=spatial)
    grad = {n: p.grad.detach() for n, p in model.named_parameters()}
    if plan is not None:
        grad = plan.full_state_dict(grad)
    whole = state.state_dict()
    out = {"loss": float(stats["total_loss"]),
           "grad": {k: v.cpu().clone() for k, v in grad.items()},
           "state": {k: v.cpu().clone() for k, v in whole["model"].items()},
           "elements": {"params": sum(p.numel() for p in model.parameters()),
                        "batch_stats": sum(b.numel() for n, b in model.named_buffers()
                                           if n.endswith(("running_mean", "running_var")))},
           "whole": whole}
    return out


def _restored(cfg, mesh, ckpt_dir, whole) -> dict:
    """The checkpoint in `ckpt_dir` restored into a fresh train state
    sharded on `mesh` and into an unsharded one (the 2 x 1 mesh's): does
    each hold exactly `whole` (its slices on the sharded one)?"""
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.parallel.partition import shard_model
    from structuredetector_tpu_torch.train.checkpoints import CheckpointManager
    from structuredetector_tpu_torch.train.state import create_train_state

    out = {}
    for name, shard in (("sharded", True), ("unsharded", False)):
        model = init_model(cfg)
        plan = shard_model(model, mesh) if shard else None
        state = create_train_state(cfg, model, steps_per_epoch=10, partition=plan)
        CheckpointManager(ckpt_dir).restore_state(state)
        want = whole
        if shard:
            want = {"model": plan.local_state_dict(whole["model"]),
                    "optimizer": plan.local_optimizer_state(
                        whole["optimizer"], [n for n, _ in model.named_parameters()])}
        got = state.state_dict() if not shard else {"model": model.state_dict(),
                                                    "optimizer": state.optimizer.state_dict()}
        same = all(torch.equal(got["model"][k], v) for k, v in want["model"].items())
        for i, moments in want["optimizer"]["state"].items():
            same &= all(torch.equal(got["optimizer"]["state"][i][k], v)
                        for k, v in moments.items())
        out[name] = bool(same and state.step == 1)
    return out


def fingerprint(tensors) -> dict:
    """An exact digest of each tensor's bytes: two ranks' states compared
    without moving them."""
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def checksum(state) -> float:
    """sum |p| over the parameters (JAX's multihost checksum)."""
    return sum(float(v.double().abs().sum()) for k, v in state.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))


# steps and device augmentation of each run; "plain" starts from the
# weights given (JAX's, in the tests), "augment" from the seeded init
STEP_RUNS = {"augment": (3, True), "plain": (1, False)}


def step_run(cfg, mode: str, device, rank: int = 0, world: int = 1, weights=None):
    """A `STEP_RUNS` run on rank `rank`'s slice of the global batch."""
    steps, augment = STEP_RUNS[mode]
    images, kp = train_batch(cfg, GLOBAL_BATCH, seed=7, uint8=augment)
    return run_steps(cfg, _part(images, rank, world),
                     {k: _part(v, rank, world) for k, v in kp.items()}, steps, augment,
                     device, weights)


LOSS_CASES = [("focal", "uneven"), ("focal", "rank1_empty"), ("focal", "all_empty"),
              ("mse", "uneven"), ("mse", "rank1_empty")]


def start_ranks(tmp_path: Path, case: str, *args, world: int = 2, device: str = "cpu",
                rank_args=lambda r: []):
    """Start `case` on `world` ranks of the worker (`rank_args(r)` go
    before `args` on rank r's command line). Returns `wait()`, which
    gives each rank a timeout of its own and returns their saved results
    by rank."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    store = tmp_path / f"store-{case}"
    outs = [tmp_path / f"{case}-rank{r}.pt" for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), case, str(r), str(world),
                               str(store), str(outs[r]), device,
                               *map(str, [*rank_args(r), *args])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]

    def wait():
        failures = []
        try:
            for r, proc in enumerate(procs):
                _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
                if proc.returncode:
                    failures.append(f"rank {r} exit {proc.returncode}:\n{err[-3000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        assert not failures, "\n".join(failures)
        results = [torch.load(out, weights_only=False) for out in outs]
        for out in outs:  # the parameters weigh 85 MB a copy
            out.unlink()
        return results

    return wait


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _part(a, rank: int, world: int):
    local = a.shape[0] // world
    return a[rank * local:(rank + 1) * local]


def main(argv) -> None:
    case, rank, world, store, out, device, *args = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    import torch.distributed as dist

    from structuredetector_tpu_torch.parallel.mesh import (
        all_reduce_sum,
        create_mesh,
        maybe_initialize_distributed,
    )
    from structuredetector_tpu_torch.utils import resolve_device

    # torchrun's environment, with the FileStore in place of its TCP one
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if case in ("cli", "host_augment"):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    if not maybe_initialize_distributed(device, init_method=f"file://{store}",
                                        world_size=world, rank=rank, timeout_s=120):
        raise SystemExit("no process group")
    device = resolve_device(device)

    def part(a):
        return _part(a, rank, world)

    result = {}
    if case == "model_axis":
        from structuredetector_tpu_torch.train.checkpoints import CheckpointManager

        mesh = create_mesh(1, 2, device)
        cfg = mesh_config()
        tp = mesh_step(cfg, mesh, *jax_test_batch(cfg, 4), torch.load(args[0]))
        if rank == 0:
            CheckpointManager(args[1]).save_state(1, tp["whole"])
        dist.barrier()
        result["restore"] = _restored(cfg, mesh, args[1], tp["whole"])
        result["tp"] = tp
        result["tp_head7"] = mesh_step(small_config(), mesh,
                                       *train_batch(small_config(), GLOBAL_BATCH, 7, False))
        result["tp_resnet50"] = mesh_step(small_config(backbone="resnet50"), mesh,
                                          *train_batch(small_config(), GLOBAL_BATCH, 7, False))
        result["mesh"] = (mesh.data, mesh.model, mesh.data_index, mesh.model_index,
                          dist.get_world_size(mesh.data_group),
                          dist.get_world_size(mesh.model_group), mesh.backend)
        errors = {}
        for d, m in ((1, 2), (0, 2), (2, 2), (1, 3)):
            try:
                small_config(data_parallel=d, model_parallel=m).validate()
                errors[d, m] = None
            except ValueError as e:
                errors[d, m] = str(e)
        result["config_errors"] = errors
    if case == "rows":
        from structuredetector_tpu_torch.models.network import init_model
        from structuredetector_tpu_torch.train.steps import make_sharded_forward

        weights = torch.load(args[0])
        rows = create_mesh(1, 4, device)
        model = init_model(mesh_config())
        model.load_state_dict(weights)
        forward = make_sharded_forward(model.to(device), rows, spatial=True)
        images = {k: torch.from_numpy(forward_images(*v)).to(device)
                  for k, v in ROW_INPUTS.items()}
        for name in ROW_INPUTS:
            result[name] = {k: v.cpu() for k, v in forward(images[name]).items()}
        for name, (overrides, inputs) in ROW_VARIANTS.items():
            forward = make_sharded_forward(init_model(mesh_config(**overrides)).to(device), rows,
                                           spatial=True)
            result[name] = {k: v.cpu() for k, v in forward(images[inputs]).items()}
        grid = create_mesh(2, 2, device)
        cfg = mesh_config()
        result["spatial"] = mesh_step(cfg, grid, *jax_test_batch(cfg, 4), weights, spatial=True)
        for fault in FAULTS:
            with planted(fault):
                result[fault] = mesh_step(cfg, grid, *jax_test_batch(cfg, 4), weights,
                                          spatial=True)["grad"]
        result["tp_2x2"] = mesh_step(small_config(), grid,
                                     *train_batch(small_config(), GLOBAL_BATCH, 7, False))
    if case == "card":
        from structuredetector_tpu_torch.models.network import init_model
        from structuredetector_tpu_torch.train.steps import make_sharded_forward

        mesh = create_mesh(1, 2, device)
        result["tp"] = mesh_step(small_config(), mesh,
                                 *train_batch(small_config(), GLOBAL_BATCH, 7, False),
                                 device=device)
        forward = make_sharded_forward(init_model(mesh_config()).to(device), mesh, spatial=True)
        images = torch.from_numpy(forward_images(*ROW_INPUTS["rows_32"])).to(device)
        result["rows_32"] = {k: v.cpu() for k, v in forward(images).items()}
    if case == "step":
        result["augment"] = step_run(small_config(), "augment", device, rank, world)
    if case == "all":
        result["augment"] = step_run(small_config(), "augment", device, rank, world)
        result["plain"] = step_run(small_config(), "plain", device, rank, world,
                                   torch.load(args[0]))
    if case == "all":
        x, g, w, b = bn_inputs()
        result["bn"] = run_bn(part(x), part(g), w, b)
        for hm_loss_fn, pattern in LOSS_CASES:
            cfg = small_config(hm_loss_fn=hm_loss_fn)
            logits, kp = loss_inputs(cfg, pattern)
            result[hm_loss_fn, pattern] = run_loss(
                cfg, part(logits), {k: part(v) for k, v in kp.items()}, all_reduce_sum)

        from structuredetector_tpu_torch.models.network import init_model
        from structuredetector_tpu_torch.train.steps import make_sharded_forward

        cfg = small_config()
        images, _ = train_batch(cfg, GLOBAL_BATCH, seed=9, uint8=False)
        mesh = create_mesh(0, 1, device)
        forward = make_sharded_forward(init_model(cfg).to(device), mesh)
        result["forward"] = {k: v.cpu() for k, v in
                             forward(torch.from_numpy(images).to(device)).items()}
        errors = {}
        for n in (1, 3):
            try:
                small_config(data_parallel=n).validate()
            except ValueError as e:
                errors[n] = str(e)
        result["config_errors"] = errors
        result["mesh"] = (mesh.data, mesh.model, mesh.rank, mesh.world, mesh.backend)
    elif case in ("cli", "host_augment"):
        from structuredetector_tpu_torch.cli import train

        batches = []
        if case == "host_augment":
            from structuredetector_tpu_torch.data import augment
            from structuredetector_tpu_torch.train import trainer as trainer_module

            init, step = augment.TrainAugmentation.__init__, trainer_module.train_step

            def seeded_by_rank(self, config, rng=None, **kw):
                init(self, config, np.random.default_rng(config.seed + 1000 * rank), **kw)

            def recorded(state, images, kp, *a, **kw):
                batches.append(fingerprint({"image": images, **kp}))
                return step(state, images, kp, *a, **kw)

            augment.TrainAugmentation.__init__ = seeded_by_rank
            trainer_module.train_step = recorded
        os.chdir(args[0])
        trainer = train.main(args[1:])
        # whole under the model axis (a collective: the group is this
        # worker's, so cli.train leaves it up)
        result = {"fingerprint": fingerprint(trainer.state.state_dict()["model"]),
                  "steps": trainer.state.step, "save_dir": str(trainer.save_dir),
                  "batches": len(trainer.train_loader), "batch_digests": batches}
    elif case not in ("step", "model_axis", "rows", "card"):
        raise SystemExit(f"unknown case {case}")
    # the model-axis runs: the whole tensors are compared on rank 0, the
    # other ranks keep digests
    for run in ("tp", "tp_head7", "tp_resnet50", "spatial", "tp_2x2"):
        if run in result:
            r = result[run]
            del r["whole"]
            r["fingerprint"] = fingerprint(r["state"])
            if rank:
                result[run] = {k: r[k] for k in ("loss", "fingerprint", "elements")}
    if rank:
        for fault in FAULTS:
            result.pop(fault, None)
    # the step runs' full tensors are compared with one process only on
    # rank 0 (21M parameters each): the others keep their digests
    for run in ("augment", "plain"):
        if run in result:
            r = result[run]
            if run == "plain":
                r["checksum"] = checksum(r["state"])
            if rank or run == "plain":
                result[run] = {k: r[k] for k in ("losses", "fingerprint", "checksum",
                                                 "stats1") if k in r}
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.save(result, out)


if __name__ == "__main__":
    main(sys.argv[1:])
