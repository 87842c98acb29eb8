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
file), "step" (the "augment" run) and "cli" (ARGS: the working
directory, then `cli.train`'s arguments).
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
    if case == "cli":
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    if not maybe_initialize_distributed(device, init_method=f"file://{store}",
                                        world_size=world, rank=rank, timeout_s=120):
        raise SystemExit("no process group")
    device = resolve_device(device)

    def part(a):
        return _part(a, rank, world)

    result = {}
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
    elif case == "cli":
        from structuredetector_tpu_torch.cli import train

        os.chdir(args[0])
        trainer = train.main(args[1:])
        result = {"fingerprint": fingerprint(trainer.model.state_dict()),
                  "steps": trainer.state.step, "save_dir": str(trainer.save_dir),
                  "batches": len(trainer.train_loader)}
    elif case != "step":
        raise SystemExit(f"unknown case {case}")
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
