"""The port's data parallelism on the CPU: 2 ranks over gloo against one
process on the joined batch, and against the JAX package.

One 2-rank group of `tests/torch_port_parallel_worker.py` runs every
case (the `runs` fixture), a second one `cli.train`. The ranks meet
through a `FileStore` in `tmp_path` (no TCP port, so the suite's workers
may run several groups at once), each rank with a timeout of its own.
The model is small: 32x32, `fpn_depth` 8, fp32, global batch 8 (4 a
rank). The keypoint masks make the ranks' counts differ: a quarter of
the global batch (half of rank 1's samples) has no valid keypoint, and
for the loss also all of rank 1's, then every sample's.

Bars (relative to the largest magnitude of the reference tensor): the
BN forward, backward and running statistics within 1e-6 (the reduction
order is all that differs); the loss stats and their gradient within
1e-6; 3 train steps with device augmentation: the ranks identical, the
first step's loss, gradient and BN statistics within 1e-5, the loss
trajectory within 1e-4 and the parameters within Adam's bound (the
test's docstring says why); one step without augmentation from JAX's
weights against JAX `make_train_step(mesh=create_mesh(2, 1))` within
JAX's own 1e-4 of `tests/test_multihost.py` (loss, parameter checksum,
BN statistics); the sharded forward within 1e-6.
"""

import json
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.config import Config as JaxConfig
from structuredetector_tpu.data.pipeline import Loader as JaxLoader
from structuredetector_tpu.models import init_model as jax_init_model
from structuredetector_tpu.models.network import load_params
from structuredetector_tpu.parallel.mesh import create_mesh as jax_create_mesh
from structuredetector_tpu.parallel.multihost import process_slice as jax_process_slice
from structuredetector_tpu.train.state import create_train_state as jax_create_train_state
from structuredetector_tpu.train.state import make_optimizer as jax_make_optimizer
from structuredetector_tpu.train.steps import make_train_step as jax_make_train_step
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.config import config_from_args
from structuredetector_tpu_torch.data.pipeline import Loader
from structuredetector_tpu_torch.models.network import init_model
from structuredetector_tpu_torch.models.weights import state_dict_from_jax
from structuredetector_tpu_torch.ops.device_augment import draw_augment_params, step_generator
from structuredetector_tpu_torch.parallel import mesh as port_mesh
from structuredetector_tpu_torch.parallel.multihost import process_slice
from structuredetector_tpu_torch.train.steps import make_sharded_forward
from tests.test_torch_port_evaluate import _write_images
from tests.test_torch_port_model import nontrivial_variables
from tests.torch_port_parallel_worker import (
    GLOBAL_BATCH,
    LOSS_CASES,
    bn_inputs,
    checksum,
    fingerprint,
    loss_inputs,
    rel_gap,
    run_bn,
    run_loss,
    small_config,
    start_ranks,
    step_run,
    train_batch,
)

LR = 1e-3  # small_config's


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU runs (the suite runs in
    several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def joined(parts, key):
    return torch.cat([p[key] for p in parts])


# -- process_slice, Loader --------------------------------------------------


@pytest.mark.parametrize("indices,index,count", [
    ([3, 1, 2], 0, 1),  # one process: all of it
    (list(range(8)), 1, 2),  # contiguous halves
    (list(range(8)), 3, 4),
    ([0, 1, 2], 0, 2),  # a ragged batch is dropped
])
def test_process_slice_matches_jax(indices, index, count):
    assert process_slice(indices, index, count) == jax_process_slice(indices, index, count)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i}


@pytest.mark.parametrize("route", ["samples", "batch_fetch"])
@pytest.mark.parametrize("n,drop_last", [(16, True), (19, True), (20, False)])
def test_loader_partitions_like_jax(route, n, drop_last):
    """Each rank's batches equal JAX `Loader`'s for the same seed and epoch
    (the per-sample and the whole-batch route); `len()` counts global
    batches, the same on every rank and for one process."""
    for epoch in (0, 3):
        for rank in (0, 1):
            want = JaxLoader(_Indexed(n), batch_size=8, shuffle=True, drop_last=drop_last,
                             seed=42, process_index=rank, process_count=2,
                             collate_fn=lambda s: [x["i"] for x in s])
            fetch = (lambda idxs: [int(i) for i in idxs]) if route == "batch_fetch" else None
            got = Loader(_Indexed(n), batch_size=8, shuffle=True, drop_last=drop_last,
                         seed=42, process_index=rank, process_count=2, batch_fetch=fetch)
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            batches = [b if fetch else [int(i) for i in b["i"]] for b in got]
            assert batches == [[int(i) for i in b] for b in want]
            assert len(got) == len(Loader(_Indexed(n), batch_size=8, drop_last=drop_last))
            assert len(got) == len(batches) + (0 if drop_last or n % 8 == 0 else 0)
    with pytest.raises(ValueError, match="does not divide"):
        Loader(_Indexed(n), batch_size=9, process_index=0, process_count=2)


def test_augment_draws_are_the_global_batch_slices():
    """Rank r of 2 draws rows r*4..r*4+3 of the global batch's draws."""
    whole = draw_augment_params(8, step_generator(5, 3), device="cpu")
    for rank in (0, 1):
        part = draw_augment_params(4, step_generator(5, 3), device="cpu", rank=rank, world=2)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[4 * rank:4 * rank + 4])


# -- the process group and the config ---------------------------------------


def test_maybe_initialize_distributed_without_environment(monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert port_mesh.maybe_initialize_distributed("cpu") is False
    assert port_mesh.world_size() == 1 and port_mesh.rank() == 0
    mesh = port_mesh.create_mesh(0, 1, "cpu")
    assert (mesh.data, mesh.model, mesh.world, mesh.backend) == (1, 1, 1, None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_maybe_initialize_distributed_from_torchrun_env_then_noop(monkeypatch):
    """torchrun's environment (a group of one here) starts gloo on the CPU;
    a second call changes nothing."""
    import torch.distributed as dist

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert port_mesh.maybe_initialize_distributed("cpu", timeout_s=30) is True
        group = dist.group.WORLD
        assert dist.get_backend() == "gloo"
        assert port_mesh.maybe_initialize_distributed("cpu") is True
        assert dist.group.WORLD is group
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_maybe_initialize_distributed_connect_failure_raises():
    """Nothing listens where rank 1 looks for the store: the call raises
    instead of going on as one process."""
    import torch.distributed as dist

    with pytest.raises(Exception, match="(?i)timeout|connect|refused"):
        port_mesh.maybe_initialize_distributed(
            "cpu", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=2, rank=1,
            timeout_s=3)
    assert not dist.is_initialized()


@pytest.mark.parametrize("flag,match", [
    (["--data_parallel", "2"], "torchrun --nproc_per_node 2"),
    (["--model_parallel", "2"], "torchrun --nproc_per_node 2 .*--model_parallel 2"),
])
def test_config_errors_without_a_group(flag, match):
    with pytest.raises(ValueError, match=match):
        config_from_args(["--labels", "labels.json", *flag])
    assert config_from_args(["--labels", "labels.json", "--data_parallel", "1"])


def test_choose_backend():
    assert port_mesh.choose_backend("cuda", 2, 2) == "nccl"
    assert port_mesh.choose_backend("cuda", 2, 1) == "gloo"  # two ranks share the card
    assert port_mesh.choose_backend("cpu", 2, 0) == "gloo"


# -- over 2 ranks: one group runs every case ----------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's "all" case on 2 ranks; meanwhile JAX's mesh step and
    the one-process runs on the joined batch."""
    tmp = tmp_path_factory.mktemp("ranks")
    jcfg = JaxConfig(width=32, height=32, fpn_depth=8, max_objects=3, max_parts=5,
                     batch_size=GLOBAL_BATCH, use_amp=False, learning_rate=LR, epochs=9,
                     lr_step=3, hm_loss_fn="mse")
    jcfg.set_labels(["bean", "maize"], ["leaf"])
    model, variables = jax_init_model(jcfg)
    weights = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    torch.save(weights, tmp / "weights.pt")
    wait = start_ranks(tmp, "all", tmp / "weights.pt")

    opt = jax_make_optimizer(jcfg, steps_per_epoch=1000)
    state = jax_create_train_state(jcfg, variables, opt)
    mesh = jax_create_mesh(2, 1, devices=jax.devices()[:2])
    step = jax_make_train_step(model, jcfg, opt, out_h=8, out_w=8, mesh=mesh,
                               state_example=state, donate=False)
    images, kp = train_batch(small_config(), GLOBAL_BATCH, seed=7, uint8=False)
    state, stats = step(state, jnp.asarray(images), {k: jnp.asarray(v) for k, v in kp.items()})
    jax_run = {"loss": float(stats["total_loss"]), "state": state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))}

    cfg = small_config()
    one = {"augment": step_run(cfg, "augment", "cpu"),
           "bn": run_bn(*bn_inputs()),
           "forward": make_sharded_forward(init_model(cfg))(
               torch.from_numpy(train_batch(cfg, GLOBAL_BATCH, seed=9, uint8=False)[0]))}
    for hm_loss_fn, pattern in LOSS_CASES:
        lcfg = small_config(hm_loss_fn=hm_loss_fn)
        one[hm_loss_fn, pattern] = run_loss(lcfg, *loss_inputs(lcfg, pattern))
    ranks = wait()
    (tmp / "weights.pt").unlink()
    return {"ranks": ranks, "one": one, "jax": jax_run}


def test_two_rank_batchnorm_matches_joined_batch(runs):
    parts, want = [r["bn"] for r in runs["ranks"]], runs["one"]["bn"]
    for key in ("y", "dx"):
        assert rel_gap(joined(parts, key), want[key]) <= 1e-6, key
    for key in ("dweight", "dbias"):  # each rank's own share; DDP sums them
        assert rel_gap(parts[0][key] + parts[1][key], want[key]) <= 1e-6, key
    for key in ("running_mean", "running_var"):
        assert torch.equal(parts[0][key], parts[1][key]), key
        assert rel_gap(parts[0][key], want[key]) <= 1e-6, key


@pytest.mark.parametrize("hm_loss_fn,pattern", LOSS_CASES)
def test_two_rank_loss_matches_joined_batch(runs, hm_loss_fn, pattern):
    """The stats are the joined batch's on both ranks, and the gradient
    of each rank's share is the global loss's on its slice. The average
    of per-rank losses (plain DDP's) departs from it on these masks."""
    want = runs["one"][hm_loss_fn, pattern]
    parts = [r[hm_loss_fn, pattern] for r in runs["ranks"]]
    for key, value in want["stats"].items():
        for p in parts:
            assert rel_gap(p["stats"][key], value) <= 1e-6, key
    assert rel_gap(joined(parts, "grad"), want["grad"]) <= 1e-6
    if pattern != "all_empty":
        cfg = small_config(hm_loss_fn=hm_loss_fn)
        logits, kp = loss_inputs(cfg, pattern)
        halves = [run_loss(cfg, logits[4 * r:4 * r + 4],
                           {k: v[4 * r:4 * r + 4] for k, v in kp.items()}) for r in (0, 1)]
        naive = 0.5 * (halves[0]["stats"]["total_loss"] + halves[1]["stats"]["total_loss"])
        assert rel_gap(naive, want["stats"]["total_loss"]) > 1e-3


def _params(state):
    return [k for k in state if not k.endswith(("running_mean", "running_var",
                                                "num_batches_tracked"))]


def test_train_step_two_ranks_matches_joined_batch(runs):
    """The slice as a whole: 3 steps with device augmentation (uint8 feed)
    from the seeded init. The ranks' states are identical after every
    run. Against one process on the joined batch: the first step's loss,
    global gradient (DDP's average, left in `.grad`) and BN running
    statistics within 1e-5 (of each tensor's largest magnitude; the
    gradient of the model's), and the loss trajectory within 1e-4.

    The parameters after 3 steps are held to Adam's own bound, 2 * lr a
    step: a BN bias or weight whose effect the next BN cancels has a
    gradient of rounding noise, any reordering of float32 sums changes
    it, and Adam's first steps move it by about lr * sign(grad). Measured
    at this size: one process at 1 and at 3 threads already parts by
    1.1 % of a tensor's largest magnitude after 3 steps (down3.0.conv2),
    and the 2-rank run by 3 % after one step (down2.2.bn2.bias), with its
    third loss 2.7e-5 away."""
    parts, want = [r["augment"] for r in runs["ranks"]], runs["one"]["augment"]
    for run in ("augment", "plain"):
        assert runs["ranks"][0][run]["fingerprint"] == runs["ranks"][1][run]["fingerprint"]
    assert parts[0]["losses"] == parts[1]["losses"]
    got = parts[0]
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-5 * abs(want["losses"][0])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    scale = max(float(g.abs().max()) for g in want["grad1"].values())
    for key, value in want["grad1"].items():
        assert float((got["grad1"][key] - value).abs().max()) <= 1e-5 * scale, key
    for key, value in want["stats1"].items():
        assert rel_gap(got["stats1"][key], value) <= 1e-5, key
    for key in _params(want["state"]):
        gap = float((got["state"][key] - want["state"][key]).abs().max())
        assert gap <= 2 * LR * len(want["losses"]), key
    for key, value in want["state"].items():
        if not value.is_floating_point():
            assert torch.equal(got["state"][key], value), key


def test_train_step_two_ranks_matches_jax_mesh_step(runs):
    """The same step without augmentation, from the JAX init's weights
    (`state_dict_from_jax`), against JAX `make_train_step` over a
    2-device mesh: the loss, the parameters' checksum and the BN running
    statistics within 1e-4, JAX's own bar between its 2-process and
    1-process runs (tests/test_multihost.py)."""
    got, want = runs["ranks"][0]["plain"], runs["jax"]
    assert got["losses"][0] == pytest.approx(want["loss"], rel=1e-4)
    assert got["checksum"] == pytest.approx(checksum(want["state"]), rel=1e-4)
    for key, value in got["stats1"].items():  # after its one step
        assert rel_gap(value, want["state"][key]) <= 1e-4, key


def test_sharded_forward_over_two_ranks(runs):
    """Each rank runs its half and all-gathers: every rank returns the
    one-process forward of the whole batch. Under the group the mesh is
    2 x 1 on gloo, and a --data_parallel that is not the world size
    raises naming the torchrun command. Without a mesh, the spatial forward
    is the one forward."""
    want = runs["one"]["forward"]
    for r in runs["ranks"]:
        for key, value in want.items():
            assert rel_gap(r["forward"][key], value) <= 1e-6, key
        assert set(r["config_errors"]) == {1, 3}
        assert "torchrun --nproc_per_node 3" in r["config_errors"][3]
    assert [r["mesh"] for r in runs["ranks"]] == [(2, 1, 0, 2, "gloo"), (2, 1, 1, 2, "gloo")]
    spatial = make_sharded_forward(init_model(small_config()), spatial=True)(
        torch.from_numpy(train_batch(small_config(), GLOBAL_BATCH, seed=9, uint8=False)[0]))
    for key, value in want.items():
        assert torch.equal(spatial[key], value), key


# -- cli.train under 2 ranks -------------------------------------------------


def test_cli_train_two_ranks(tmp_path):
    """`cli.train --data_parallel 2 --device cpu`, 1 epoch, each rank in a
    working directory of its own: rank 0 alone writes `trainings/`, the
    ranks end with identical parameters, and the snapshot has no
    `module.` key and loads in JAX `load_params` and a 1-process port
    `cli.evaluate`."""
    data = tmp_path / "data"
    _write_images(data / "train", [(80, 64), (100, 90), (64, 64), (70, 120)] * 2, seed=31,
                  annotated=True)
    _write_images(data / "valid", [(90, 70), (64, 80), (110, 100)], seed=32, annotated=True)
    (data / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                  "parts": ["leaf"]}))
    common = ["--labels", str(data / "labels.json"), "--anchor_name", "stem",
              "--width", "32", "--height", "32", "--fpn_depth", "8", "--max_objects", "4",
              "--max_parts", "8", "--no_amp", "--num_workers", "0", "--eval_batch_size", "3"]
    argv = ["--device", "cpu", "--data_parallel", "2", "--train_dir", str(data / "train"),
            "--valid_dir", str(data / "valid"), "--epochs", "1", "--batch_size", "4", *common]
    cwd = [tmp_path / f"cwd{r}" for r in (0, 1)]
    for d in cwd:
        d.mkdir()
    parts = start_ranks(tmp_path / "ranks", "cli", *argv, rank_args=lambda r: [cwd[r]])()
    assert [p["steps"] for p in parts] == [2, 2] and [p["batches"] for p in parts] == [2, 2]
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
    assert not list(cwd[1].iterdir()), "rank 1 wrote files"
    assert parts[1]["save_dir"] == parts[0]["save_dir"]
    run = cwd[0] / parts[0]["save_dir"]
    state = torch.load(next((run / "state").glob("step_*.pt")), weights_only=True)
    assert not [k for k in state["model"] if k.startswith("module.")]
    assert fingerprint(state["model"]) == parts[0]["fingerprint"]
    ckpt = run / "model_best_loss.msgpack"
    tree = load_params(str(ckpt))
    assert tree["params"]["up1"]["kernel"].shape == (1, 1, 512, 8)
    assert evaluate_cli.main(["--device", "cpu", "--valid_dir", str(data / "valid"),
                              "--load_model", str(ckpt), *common])
    shutil.rmtree(run)  # Adam's state and the snapshots: 0.4 GB
