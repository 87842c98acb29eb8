"""The port's trainer and `cli.train` on the CPU, at 64x64.

A synthetic annotated set (PNG images, JSON annotations with anchor
"stem", labels bean/maize, part leaf) built the way
`tests/test_torch_port_evaluate.py` builds one. Checks:

- a 2-epoch `cli.train --device cpu` run writes `model_best_*.msgpack`
  that JAX `load_params` reads; JAX `cli.evaluate` on that checkpoint
  writes the same `--save_summary` as the port's `cli.evaluate`;
- resume: a run stopped after epoch 1 and resumed ends with the unbroken
  run's step, batches and parameters (bit for bit on the CPU);
- SIGTERM at a batch boundary saves the state, returns, restores the
  signal handlers, and the run resumes from that step;
- the stall watchdog exits with code 87 (in a subprocess);
- `--profile` writes a trace; the EMA warm-up maths, the plateau warning, `BestModelSaver` across
  resume and its staleness report, `CheckpointManager` keeping 2;
- `--pretrained` loads a cached torchvision resnet34 into the encoder and
  raises naming the place it looked when there is none; the options the
  port lacks raise a named error;
- `cli.train` raises without CUDA unless `--device cpu` is given.
"""

import json
import re
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from structuredetector_tpu.cli import evaluate as jax_evaluate_cli
from structuredetector_tpu.models.network import load_params
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.cli import train as train_cli
from structuredetector_tpu_torch.config import config_from_args
from structuredetector_tpu_torch.models.network import init_model
from structuredetector_tpu_torch.models.weights import (
    find_imagenet_resnet34,
    load_imagenet_encoder,
)
from structuredetector_tpu_torch.train import trainer as trainer_mod
from structuredetector_tpu_torch.train.checkpoints import BestModelSaver, CheckpointManager
from structuredetector_tpu_torch.train.state import create_train_state
from structuredetector_tpu_torch.train.trainer import (
    Trainer,
    ema_decay,
    ema_update,
    embedding_plateau_warning,
)
from tests.test_torch_port_evaluate import _write_images

TRAIN_SIZES = [(80, 64), (100, 90), (64, 64), (70, 120), (130, 70), (96, 96)]

@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU training runs: the suite
    runs in several worker processes at once, and a worker per core each
    asking for every core slows every worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

VALID_SIZES = [(90, 70), (64, 80), (110, 100)]
COMMON = ["--anchor_name", "stem", "--width", "64", "--height", "64", "--fpn_depth", "32",
          "--max_objects", "4", "--max_parts", "8", "--no_amp", "--num_workers", "2",
          "--batch_size", "2", "--eval_batch_size", "2"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainset")
    _write_images(root / "train", TRAIN_SIZES, seed=21, annotated=True)
    _write_images(root / "valid", VALID_SIZES, seed=22, annotated=True)
    (root / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                  "parts": ["leaf"]}))
    return root


def _argv(dataset, *extra):
    return ["--train_dir", str(dataset / "train"), "--valid_dir", str(dataset / "valid"),
            "--labels", str(dataset / "labels.json"), *COMMON, *extra]


def _config(dataset, *extra):
    return config_from_args(_argv(dataset, *extra))


_TRAIN_STEP = trainer_mod.train_step


class _Recorder:
    """Wraps the trainer's train step: records (step, first anchor of each
    image) of every step, so two runs' batches can be compared."""

    def __init__(self, after=None):
        self.calls = []
        self.after = after

    def __call__(self, state, images, kp, config, augment=False):
        self.calls.append((state.step, kp["anchors_xy"][:, 0].tolist()))
        out = _TRAIN_STEP(state, images, kp, config, augment=augment)
        if self.after is not None:
            self.after(state)
        return out


# ---------------------------------------------------------------- journey

def test_cli_train_writes_checkpoints_both_evaluates_read(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = train_cli.main(["--device", "cpu", *_argv(dataset, "--epochs", "2")])
    run = trainer.save_dir
    assert run.parent == Path("trainings")
    assert trainer.state.step == 2 * (len(TRAIN_SIZES) // 2)
    snapshots = sorted(run.glob("model_best_*.msgpack"))
    assert run / "model_best_loss.msgpack" in snapshots
    assert CheckpointManager(run).latest_step() == trainer.global_step
    for path in snapshots:
        tree = load_params(str(path))
        assert set(tree) == {"params", "batch_stats"}
        assert tree["params"]["up1"]["kernel"].shape == (1, 1, 512, 32)

    # both evaluate CLIs on the checkpoint; conf 0.2 keeps detections in
    # play on this briefly trained model (asserted below)
    ckpt = str(run / "model_best_loss.msgpack")
    argv = ["--valid_dir", str(dataset / "valid"), "--labels", str(dataset / "labels.json"),
            "--load_model", ckpt, "--conf_threshold", "0.2", *COMMON]
    jax_evaluate_cli.main([*argv, "--no_native_io", "--save_summary", str(tmp_path / "jax.json")])
    evaluators = evaluate_cli.main(["--device", "cpu", *argv, "--save_summary",
                                    str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, key
    ev = evaluators[0.2]
    assert sum(e.ndet for _, e in ev.anchor_eval.items()) > 0, "no detections: tests nothing"


# ----------------------------------------------------------------- resume

def test_resume_replays_steps_batches_and_params(dataset, tmp_path, monkeypatch):
    whole = _Recorder()
    monkeypatch.setattr(trainer_mod, "train_step", whole)
    for run in ("a", "b"):
        (tmp_path / run).mkdir()
    monkeypatch.chdir(tmp_path / "a")
    unbroken = Trainer(_config(dataset, "--epochs", "2"), device="cpu", log=False)
    unbroken.train()

    first = _Recorder()
    monkeypatch.setattr(trainer_mod, "train_step", first)
    monkeypatch.chdir(tmp_path / "b")
    stopped = Trainer(_config(dataset, "--epochs", "1"), device="cpu", log=False)
    stopped.train()
    second = _Recorder()
    monkeypatch.setattr(trainer_mod, "train_step", second)
    resumed = Trainer(_config(dataset, "--epochs", "2", "--resume", str(stopped.save_dir)),
                      device="cpu", log=False)
    resumed.train()

    steps_per_epoch = len(TRAIN_SIZES) // 2
    prewarm = len(unbroken.train_augmentation.bucket_sizes())
    calls = whole.calls[prewarm:]  # the throwaway warm-up steps come first
    assert len(calls) == 2 * steps_per_epoch
    assert first.calls[prewarm:] == calls[:steps_per_epoch]
    assert second.calls[-steps_per_epoch:] == calls[steps_per_epoch:]
    assert resumed.state.step == unbroken.state.step == 2 * steps_per_epoch
    assert resumed.global_step == unbroken.global_step
    assert resumed.train_augmentation.current_size == unbroken.train_augmentation.current_size
    a, b = unbroken.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    opt_a, opt_b = unbroken.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        assert torch.equal(st["exp_avg_sq"], opt_b["state"][i]["exp_avg_sq"])


def test_sigterm_saves_state_and_resumes(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    handler_before = signal.getsignal(signal.SIGTERM)
    cfg = _config(dataset, "--epochs", "3", "--no_prewarm")

    def preempt(state):
        if state.step == 4:  # the middle of epoch 2: a batch boundary
            signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(trainer_mod, "train_step", _Recorder(after=preempt))
    trainer = Trainer(cfg, device="cpu", log=False)
    trainer.train()  # returns: the signal stopped it at the batch boundary
    assert trainer.state.step == 4
    assert signal.getsignal(signal.SIGTERM) is handler_before
    assert CheckpointManager(trainer.save_dir).latest_step() == 4 * cfg.batch_size

    monkeypatch.setattr(trainer_mod, "train_step", _TRAIN_STEP)
    cfg.resume_dir = trainer.save_dir
    resumed = Trainer(cfg, device="cpu", log=False)
    assert resumed.resume() and resumed.state.step == 4
    resumed = Trainer(cfg, device="cpu", log=False)
    resumed.train()
    # as in the JAX trainer (trainer.py:486-489), the run goes on from the
    # start of the epoch it stopped in (4 // 3 = 1) and ends with epoch 2
    assert resumed.state.step == 4 + 2 * (len(TRAIN_SIZES) // 2)


def test_stall_watchdog_exits_87():
    script = textwrap.dedent("""
        import time
        from structuredetector_tpu_torch.train.trainer import StallWatchdog

        StallWatchdog(0.3).start()
        time.sleep(30)  # no step ever completes
        print("not reached")
    """)
    proc = subprocess.run([sys.executable, "-c", script], timeout=120, capture_output=True,
                          text=True, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 87, proc.stderr
    assert "stall-watchdog" in proc.stderr
    assert "not reached" not in proc.stdout


# ------------------------------------------------------------ the helpers

def test_ema_warmup_maths():
    assert ema_decay(0.999, 0) == pytest.approx(0.1)
    assert ema_decay(0.999, 10) == pytest.approx(11 / 20)
    assert ema_decay(0.9, 1000) == 0.9
    model = torch.nn.Linear(3, 2)
    ema = {n: torch.full_like(p, 2.0) for n, p in model.named_parameters()}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema_update(ema, model, 0.999, 5)
    d = 6 / 15
    for n in ema:
        torch.testing.assert_close(ema[n], 2.0 * d + params[n] * (1 - d))


def test_trainer_validates_and_snapshots_the_ema(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = Trainer(_config(dataset, "--epochs", "1", "--ema", "0.99", "--no_prewarm"),
                      device="cpu", log=False)
    trainer.train()
    weights = trainer._weights()
    for name, p in trainer.model.named_parameters():
        assert torch.equal(weights[name], trainer.ema_params[name])
    assert not torch.equal(trainer.ema_params["head.conv.weight"],
                           trainer.model.head.conv.weight)
    for name, buf in trainer.model.named_buffers():
        assert torch.equal(weights[name], buf)  # live BN statistics
    tree = load_params(str(trainer.save_dir / "ema_params.msgpack"))
    np.testing.assert_array_equal(
        np.asarray(tree["params"]["head"]["bias"]),
        trainer.ema_params["head.conv.bias"].numpy())


def test_profile_traces_steps_five_to_ten(dataset, tmp_path, monkeypatch):
    """`--profile` writes a torch.profiler trace of steps 5-10 under the
    run directory; an epoch shorter than 11 steps closes it at its end."""
    monkeypatch.chdir(tmp_path)
    cfg = _config(dataset, "--epochs", "1", "--no_prewarm", "--profile", "--batch_size", "1",
                  "--no_augmentation")
    trainer = Trainer(cfg, device="cpu", log=False)
    trainer.train()
    assert trainer.state.step == len(TRAIN_SIZES)
    trace = json.loads((trainer.save_dir / "profile" / "trace.json").read_text())
    assert any("conv" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.parametrize("first,current,warns", [
    ({"hm_loss": 1.0, "embedding_loss": 0.1}, {"hm_loss": 0.1, "embedding_loss": 0.099}, True),
    ({"hm_loss": 1.0, "embedding_loss": 0.1}, {"hm_loss": 0.1, "embedding_loss": 0.05}, False),
    ({"hm_loss": 1.0, "embedding_loss": 0.1}, {"hm_loss": 0.5, "embedding_loss": 0.1}, False),
    ({"hm_loss": 1.0, "embedding_loss": 0.0}, {"hm_loss": 0.1, "embedding_loss": 0.0}, False),
])
def test_embedding_plateau_warning(first, current, warns):
    assert (embedding_plateau_warning(first, current) is not None) == warns


def test_best_model_saver_survives_resume(tmp_path, tiny_config):
    from tests.test_torch_port_model import port_config

    sd = init_model(port_config(tiny_config)).state_dict()
    saver = BestModelSaver(tmp_path)
    assert set(saver.update(sd, loss=1.0, csi_f1=0.8, classif_f1=0.6, kp_f1=0.9,
                            epoch=20)) == {"loss", "csi", "classif", "kp_reg"}
    best = (tmp_path / "model_best_csi.msgpack").read_bytes()
    resumed = BestModelSaver(tmp_path)
    assert resumed.best_csi == 0.8 and resumed.best_loss == 1.0
    assert resumed.captured_epoch["csi"] == 20
    assert resumed.update(sd, loss=1.5, csi_f1=0.55, classif_f1=0.3, kp_f1=0.7, epoch=21) == []
    assert (tmp_path / "model_best_csi.msgpack").read_bytes() == best
    assert set(resumed.update(sd, loss=0.5, csi_f1=0.1, classif_f1=0.1, kp_f1=0.95,
                              epoch=40)) == {"loss", "kp_reg"}
    report = resumed.staleness_report(final_epoch=40)
    stale = [line for line in report if "STALE" in line]
    assert any("model_best_csi" in line for line in stale)
    assert not any("model_best_kp_reg" in line for line in stale)
    (tmp_path / "best_metrics.json").write_text("{not json")
    assert BestModelSaver(tmp_path).best_csi == 0.0


def test_checkpoint_manager_keeps_two_and_restores(tmp_path, tiny_config):
    from tests.test_torch_port_model import port_config

    cfg = port_config(tiny_config)
    state = create_train_state(cfg, init_model(cfg), steps_per_epoch=10)
    mgr = CheckpointManager(tmp_path)
    for step in (2, 4, 6):
        state.step = step
        mgr.save_state(step * 8, state)
    assert sorted(p.name for p in (tmp_path / "state").iterdir()) == [
        "step_000000000032.pt", "step_000000000048.pt"]
    other = create_train_state(cfg, init_model(cfg), steps_per_epoch=10)
    with torch.no_grad():
        other.model.head.conv.bias.add_(1.0)
    assert mgr.restore_state(other) and other.step == 6
    assert torch.equal(other.model.head.conv.bias, state.model.head.conv.bias)
    assert not CheckpointManager(tmp_path / "empty").restore_state(other)


def test_pretrained_backbone_from_local_cache(tmp_path, monkeypatch, tiny_config):
    from tests.test_torch_port_model import port_config

    monkeypatch.delenv("SDNET_PRETRAINED", raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / "hub" / "checkpoints"))):
        find_imagenet_resnet34()
    # a torchvision-named resnet34 state_dict, from a seeded encoder
    cfg = port_config(tiny_config)
    src = init_model(cfg).state_dict()
    tv = {}
    for k, v in src.items():
        if k.startswith("adpater.0."):
            tv["conv1." + k[len("adpater.0."):]] = v
        elif k.startswith("adpater.1."):
            tv["bn1." + k[len("adpater.1."):]] = v
        elif k.startswith("down"):
            tv[f"layer{k[4]}" + k[5:]] = v
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    (tmp_path / "hub" / "checkpoints").mkdir(parents=True)
    torch.save(tv, tmp_path / "hub" / "checkpoints" / "resnet34-b627a593.pth")
    path = find_imagenet_resnet34()
    cfg.seed += 1
    model = load_imagenet_encoder(init_model(cfg), path)
    got = model.state_dict()
    for k, v in src.items():
        if k.startswith(("adpater", "down")):
            assert torch.equal(got[k], v), k
    assert not torch.equal(got["head.conv.weight"], src["head.conv.weight"])
    del tv["layer4.2.conv2.weight"]
    torch.save(tv, path)
    with pytest.raises(ValueError, match="not a torchvision resnet34"):
        load_imagenet_encoder(init_model(cfg), path)


@pytest.mark.parametrize("flag", [["--model_parallel", "2"], ["--data_parallel", "4"]])
def test_options_the_port_lacks_raise(flag):
    with pytest.raises(ValueError, match=flag[0]):
        config_from_args(["--labels", "labels.json", *flag])


def test_cli_train_raises_without_cuda_unless_asked(dataset, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(_argv(dataset, "--epochs", "1"))
    assert not (tmp_path / "trainings").exists()
    with pytest.raises(SystemExit, match="--valid_dir"):
        train_cli.main(["--device", "cpu", "--train_dir", str(dataset / "train"),
                        "--labels", str(dataset / "labels.json")])
