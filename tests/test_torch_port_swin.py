"""SDNet on the Swin Transformer V2 encoder (`models/swin.py`) on the CPU,
held to the benchmark's plain float32 reference (`sdbench/reference/
swinv2.py`, torchvision's window attention step by step) on the seeded
weights the benchmark draws:

- the whole network at embed 32, blocks (2, 2, 2, 2), heads (1, 2, 4, 8):
  at 512x512, where every stage shifts, and at 160x160, where stages 2-4
  pad to the window; a bf16 forward fails the same tolerance;
- two blocks a stage at the published widths (embed 128, head dim 32);
- one train step's gradients, every leaf, against the reference's
  autograd;
- the parameter count of torchvision's swin_v2_b (87,930,848);
- the `sd.swin.*` spans under a profiler and `tracing.swin_counters()`;
- the paths that refuse a Swin encoder with a ValueError naming it
  (`--int8`, `--s2d_stem`, the model axis's plans, `.msgpack`, export);
- `.pth` snapshots, a torchvision-layout warm start, and `cli.train`,
  `cli.detect` and the predictor's submit/collect on a Swin config.

The published name `swin_v2_b` is pointed at the small spec for the
library paths (`tiny_swin`), so they run at CPU sizes through the same
code.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdbench.reference import swinv2 as ref
from sdbench.reference.sdnet import normalize_uint8
from structuredetector_tpu_torch import tracing
from structuredetector_tpu_torch.cli import detect as detect_cli
from structuredetector_tpu_torch.cli import train as train_cli
from structuredetector_tpu_torch.config import Config
from structuredetector_tpu_torch.export import export_model
from structuredetector_tpu_torch.models import swin
from structuredetector_tpu_torch.models.network import SDNet, build_model, init_model
from structuredetector_tpu_torch.models.weights import (
    load_imagenet_encoder,
    load_weights,
    save_msgpack,
    save_snapshot,
)
from structuredetector_tpu_torch.parallel.mesh import create_mesh
from structuredetector_tpu_torch.parallel.partition import RowPlan, shard_model
from structuredetector_tpu_torch.predictor import Predictor, PreparedImage
from tests.test_torch_port_evaluate import _write_images

TINY = swin.SwinSpec(32, (2, 2, 2, 2), (1, 2, 4, 8))
WIDE = swin.SwinSpec(128, (2, 2, 2, 2), (4, 8, 16, 32))  # head dim 32, as published


def arch(spec: swin.SwinSpec) -> dict:
    return {"embed": spec.embed, "depths": spec.depths, "heads": spec.heads,
            "window": spec.window, "mlp_ratio": spec.mlp_ratio, "patch": spec.patch}


# Float32 on both sides, the same arithmetic in another order (qkv before
# the padding, proj after the crop, `scaled_dot_product_attention`'s
# blocked softmax, the shift mask from region ids): gaps of 1e-6 of the
# logits' largest magnitude. A bf16 forward moves them by 1e-2 of it or
# more, so 1e-4 of it separates the two by two orders each way.
FORWARD_RTOL = 1e-4
# Gradients, per leaf, against the norm of the reference's: float32 sums
# of products in another order, through 8 blocks and the softmax's
# backward; the gaps read up to 1e-5 (the k third of the qkv bias has no
# gradient on either side).
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_swin(monkeypatch):
    """`swin_v2_b` is the small spec for this test."""
    monkeypatch.setitem(swin.ARCHS, "swin_v2_b", TINY)


def port(spec, dtype=torch.float32, fpn=16, n_out=7, seed=3):
    """The port's SDNet of `spec` with the benchmark's seeded weights, and
    those weights."""
    swin.ARCHS["_test"] = spec
    try:
        model = SDNet(2, 1, fpn, dtype=dtype, backbone="_test")
    finally:
        del swin.ARCHS["_test"]
    sd = ref.make_state_dict(arch(spec), fpn, n_out, seed, "cpu")
    model.load_state_dict(sd)
    return model.eval(), sd


def frames(n, size, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, generator=g)


def gap(out, want):
    return float((out - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("size,n", [(512, 1), (160, 2)], ids=["512-every-stage-shifts",
                                                            "160-pads"])
def test_port_equals_reference(size, n):
    model, sd = port(TINY)
    x = frames(n, size)
    want = ref.infer_heads(sd, arch(TINY), x)
    with torch.no_grad():
        out = model(normalize_uint8(x), raw_output=True)
    assert out.shape == want.shape == (n, 7, size // 4, size // 4)
    assert gap(out, want) <= FORWARD_RTOL
    if size == 160:  # the tolerance is tight enough to fail bf16
        model.dtype = torch.bfloat16
        with torch.no_grad():
            low = model(normalize_uint8(x), raw_output=True)
        assert gap(low, want) > 10 * FORWARD_RTOL


def test_published_widths_two_blocks_a_stage():
    """Embed 128, heads 4..32 of dim 32: stages 1-3 shift at 256x256."""
    model, sd = port(WIDE, fpn=32, seed=11)
    x = frames(1, 256, seed=1)
    want = ref.infer_heads(sd, arch(WIDE), x)
    with torch.no_grad():
        out = model(normalize_uint8(x), raw_output=True)
    assert gap(out, want) <= FORWARD_RTOL


def test_train_step_gradients_equal_the_reference():
    """Train mode (the FPN's BatchNorms on batch statistics) at 96x96,
    where stages 2-4 pad: every leaf's gradient of a fixed linear
    functional of the head."""
    model, sd = port(TINY, seed=5)
    model.train()
    x = normalize_uint8(frames(2, 96, seed=2))
    weights = torch.randn(2, 7, 24, 24, generator=torch.Generator().manual_seed(4))
    (model(x, raw_output=True) * weights).sum().backward()
    leaves = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in sd.items()}
    net = ref.SwinNet(leaves, arch(TINY), train=True)
    (net(x) * weights).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == {k for k, v in leaves.items() if v.grad is not None}
    for key, p in grads.items():
        want = leaves[key].grad
        assert float((p.grad - want).norm()) <= GRAD_RTOL * float(want.norm()) + 1e-9, key


def test_parameter_count_is_torchvisions():
    """The encoder less C2..C4's output norms, plus torchvision's 1000-way
    classifier, is swin_v2_b's published 87,930,848; C5's norm is the
    classifier's final norm."""
    with torch.device("meta"):
        enc = swin.SwinV2Encoder()
    n = sum(p.numel() for p in enc.parameters())
    n -= sum(p.numel() for norm in enc.norms[:3] for p in norm.parameters())
    assert n + 1024 * 1000 + 1000 == 87_930_848
    assert enc.widths == (128, 256, 512, 1024)


def test_spans_and_counters():
    model, _ = port(TINY)
    before = tracing.swin_counters()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(normalize_uint8(frames(2, 160)), raw_output=True)
    names = [e.name for e in prof.events()]
    assert {n: names.count(n) for n in ("sd.swin.embed", "sd.swin.attn", "sd.swin.mlp",
                                        "sd.swin.merge")} == {
        "sd.swin.embed": 1, "sd.swin.attn": 8, "sd.swin.mlp": 8, "sd.swin.merge": 3}
    after = tracing.swin_counters()
    # 160: tokens 40, 20, 10, 5 a side, padded to 40, 24, 16, 8; two blocks
    # a stage, two images
    windows = 2 * 2 * (25 + 9 + 4 + 1)
    padded = 2 * 2 * ((24 ** 2 - 20 ** 2) + (16 ** 2 - 10 ** 2) + (8 ** 2 - 5 ** 2))
    assert after["forwards"] - before["forwards"] == 1
    assert after["windows"] - before["windows"] == windows
    assert after["padded_tokens"] - before["padded_tokens"] == padded
    with torch.no_grad():  # the cell's 512: no padding
        model(normalize_uint8(frames(1, 512)), raw_output=True)
    assert tracing.swin_counters()["padded_tokens"] == after["padded_tokens"]


def _config(**kw):
    cfg = Config(width=64, height=64, fpn_depth=16, backbone="swin_v2_b", use_amp=False, **kw)
    cfg.set_labels(["bean", "maize"], ["leaf"])
    return cfg.finalize()


@pytest.mark.parametrize("case", ["int8", "s2d_stem", "channel_plan", "row_plan",
                                  "msgpack_save", "msgpack_load", "export"])
def test_paths_without_swin_raise_naming_it(case, tiny_swin, tmp_path):
    with pytest.raises(ValueError, match="swin_v2_b"):
        if case in ("int8", "s2d_stem"):
            build_model(_config(**{case: True}))
        model = init_model(_config())
        if case == "channel_plan":
            shard_model(model, mesh=None)
        elif case == "row_plan":
            model(torch.zeros(1, 3, 64, 64),
                  partition=RowPlan(create_mesh(0, 1, torch.device("cpu"))))
        elif case == "msgpack_save":
            save_msgpack(model, tmp_path / "m.msgpack")
        elif case == "msgpack_load":
            path = tmp_path / "m.msgpack"
            save_msgpack(init_model(Config(width=64, height=64, fpn_depth=16).finalize()),
                         path)
            load_weights(model, path)
        elif case == "export":
            export_model(_config(), model.state_dict(), tmp_path / "m.sdz", device="cpu")


def test_snapshot_is_pth_and_loads_strictly(tiny_swin, tmp_path):
    model = init_model(_config())
    path = save_snapshot(model, tmp_path / "model_best_loss")
    assert path.name == "model_best_loss.pth"
    other = init_model(_config(seed=9))
    load_weights(other, path)
    for key, value in model.state_dict().items():
        assert torch.equal(other.state_dict()[key], value), key
    resnet = init_model(Config(width=64, height=64, fpn_depth=16).finalize())
    with pytest.raises(ValueError, match="encoder"):
        load_weights(resnet, path)


def test_warm_start_from_a_torchvision_layout(tiny_swin, tmp_path):
    """torchvision's keys: `features.*` with the table and index buffers,
    the final `norm`, the classifier `head`."""
    donor = init_model(_config(seed=4))
    tv = {k[len("encoder."):]: v for k, v in donor.state_dict().items()
          if k.startswith("encoder.features.")}
    for name, buf in donor.named_buffers():
        if name.startswith("encoder.features."):
            tv[name[len("encoder."):]] = buf
    tv["norm.weight"] = donor.encoder.norms[3].weight.detach()
    tv["norm.bias"] = donor.encoder.norms[3].bias.detach()
    tv["head.weight"], tv["head.bias"] = torch.zeros(1000, 256), torch.zeros(1000)
    torch.save(tv, tmp_path / "swin_v2_b-test.pth")
    model = init_model(_config(seed=5))
    fpn = model.up1.weight.detach().clone()
    load_imagenet_encoder(model, tmp_path / "swin_v2_b-test.pth")
    for key, value in donor.state_dict().items():
        if key.startswith(("encoder.features.", "encoder.norms.3.")):
            assert torch.equal(model.state_dict()[key], value), key
    assert torch.equal(model.up1.weight, fpn)


def test_predictor_submit_collect(tiny_swin):
    cfg = _config()
    pred = Predictor(cfg, device="cpu")
    imgs = [np.asarray(frames(1, 64, seed=s)[0]) for s in range(3)]
    anns = pred.predict_batch_collect(pred.predict_batch_submit(
        [PreparedImage(i, (64, 64)) for i in imgs]))
    assert len(anns) == 3


def test_cli_train_then_detect(tiny_swin, tmp_path, monkeypatch):
    """Two epochs of `cli.train` on the CPU write `.pth` snapshots, which
    `cli.detect` loads."""
    root = tmp_path / "data"
    _write_images(root / "train", [(80, 64), (64, 64), (96, 96), (70, 90)], seed=1,
                  annotated=True)
    _write_images(root / "valid", [(64, 80), (90, 70)], seed=2, annotated=True)
    (root / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                  "parts": ["leaf"]}))
    common = ["--labels", str(root / "labels.json"), "--anchor_name", "stem", "--width", "64",
              "--height", "64", "--fpn_depth", "16", "--max_objects", "4", "--max_parts", "8",
              "--no_amp", "--num_workers", "2", "--batch_size", "2", "--eval_batch_size", "2",
              "--backbone", "swin_v2_b"]
    monkeypatch.chdir(tmp_path)
    trainer = train_cli.main(["--device", "cpu", "--train_dir", str(root / "train"),
                              "--valid_dir", str(root / "valid"), "--epochs", "2", *common])
    assert trainer.state.step == 4
    snapshot = trainer.save_dir / "model_best_loss.pth"
    assert snapshot.is_file() and not list(trainer.save_dir.glob("*.msgpack"))
    detect_cli.main(["--device", "cpu", "--valid_dir", str(root / "valid"), "--load_model",
                     str(snapshot), "--conf_threshold", "0.0", *common])
    assert len(list((tmp_path / "predictions").glob("*.json"))) == 2
