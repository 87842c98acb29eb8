"""The port's int8 inference (`models/quantize.py`) against the JAX
package's, on the CPU.

Small config (64x64, `fpn_depth` 32, fp32) and seeded numpy inputs,
NHWC (JAX) against NCHW (port) by transposing:

- `weight_qparams` equal to JAX's, int8 values and scales;
- the integer-grid conv equal to a float conv bit for bit (as JAX
  `test_int8.py:32-49`);
- `Int8Conv2d` against JAX `Int8Conv` on the same inputs and weights:
  int8 activations and int32 sums exactly equal, outputs within 2 ulps of
  their scale (XLA may fuse the dequant multiply and the bias add into
  one rounding);
- prequantized equal to dynamic, batchmates isolated, calibrated static
  scales bit-identical to dynamic on their single image;
- calibrated `act_scale`s against JAX's, and JAX's prequantized and
  calibrated state loaded into the port exactly;
- the whole int8 model against JAX's int8 model: its gap at most a tenth
  of the int8-against-float gap that JAX `test_int8.py:69-90` bounds,
  with equal anchor peaks;
- a train-mode int8 forward raises;
- the int8 `evaluate` summary against JAX `evaluate --int8` on one
  checkpoint.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from jax import lax

from structuredetector_tpu.cli import evaluate as jax_evaluate_cli
from structuredetector_tpu.models.network import build_model as jax_build_model
from structuredetector_tpu.models.network import save_params
from structuredetector_tpu.models.quantize import Int8Conv as JaxInt8Conv
from structuredetector_tpu.models.quantize import (
    calibrate_activation_scales as jax_calibrate,
)
from structuredetector_tpu.models.quantize import prequantize_variables as jax_prequantize
from structuredetector_tpu.models.quantize import quantize_symmetric as jax_quantize
from structuredetector_tpu.models.quantize import weight_qparams as jax_weight_qparams
from structuredetector_tpu_torch.cli import detect as detect_cli
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.config import config_from_args
from structuredetector_tpu_torch.models.network import build_model
from structuredetector_tpu_torch.models.quantize import (
    Int8Conv2d,
    calibrate_activation_scales,
    int8_conv_nhwc,
    int8_conv_reference,
    int8_convs,
    prequantize_variables,
    weight_qparams,
)
from structuredetector_tpu_torch.models.weights import load_weights, state_dict_from_jax
from tests.test_torch_port_evaluate import SIZES, _counters, _Recording, _write_images
from tests.test_torch_port_model import MAPS, nontrivial_variables, port_config


def _oihw(hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(hwio, (3, 2, 0, 1))))


def _nchw(nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(nhwc, (0, 3, 1, 2))))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# ------------------------------------------------------------ one conv

def test_weight_qparams_matches_jax():
    k = np.zeros((1, 1, 2, 3), np.float32)
    k[0, 0, 0] = [127.0, 12.7, 0.0]  # per-channel amax: 127, 12.7, 0
    k[0, 0, 1] = [-64.0, 6.35, 0.0]
    rng = np.random.default_rng(0)
    big = rng.normal(0, 0.05, (3, 3, 16, 8)).astype(np.float32)
    big[..., 5] = 0.0  # an all-zero output channel: scale 1 / 127
    for kernel in (k, big):
        q, scale = weight_qparams(_oihw(kernel))
        jq, jscale = jax_weight_qparams(jnp.asarray(kernel))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), _oihw(np.asarray(jq)).numpy())
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    q, scale = weight_qparams(_oihw(k))
    np.testing.assert_allclose(scale.numpy(), [1.0, 0.1, 1.0 / 127.0])
    np.testing.assert_array_equal(q[:, 0, 0, 0].numpy(), [127, 127, 0])
    np.testing.assert_array_equal(q[:, 1, 0, 0].numpy(), [-64, 64, 0])


def test_int8conv_exact_on_integer_grid():
    """Integer-valued weights and activations with amax 127 quantize at
    scale 1 exactly: the int8 conv equals the float conv bit for bit."""
    rng = np.random.default_rng(0)
    kernel = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.float32)
    kernel[0, 0, 0, :] = 127.0  # pin each channel's amax: scale exactly 1
    x = rng.integers(-127, 128, (2, 10, 10, 8)).astype(np.float32)
    x[:, 0, 0, 0] = 127.0
    bias = rng.normal(size=16).astype(np.float32)
    m8 = Int8Conv2d(8, 16, 3, padding=1)
    mf = nn.Conv2d(8, 16, 3, padding=1)
    for m in (m8, mf):
        m.weight.data, m.bias.data = _oihw(kernel), torch.from_numpy(bias)
    with torch.inference_mode():
        assert torch.equal(m8(_nchw(x)), mf(_nchw(x)))


CONVS = {  # (cin, cout, kernel, stride, padding, bias, (h, w))
    "3x3 s1": (16, 24, 3, 1, 1, False, (10, 12)),
    "3x3 s2": (16, 24, 3, 2, 1, False, (10, 12)),
    "1x1 s2": (16, 24, 1, 2, 0, False, (10, 12)),
    "1x1 bias": (16, 24, 1, 1, 0, True, (10, 12)),
    "3x3 on 2x2, 4 rows": (32, 16, 3, 1, 1, True, (2, 2)),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_int8conv_matches_jax_int8conv(name):
    cin, cout, k, s, p, use_bias, (h, w) = CONVS[name]
    rng = np.random.default_rng(len(name))
    kernel = rng.normal(0, 0.1, (k, k, cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    # per-sample ranges 1 and 10: each sample gets its own scale
    x = (rng.uniform(-1, 1, (2, h, w, cin)) * np.array([1.0, 10.0])[:, None, None, None]
         ).astype(np.float32)

    jm = JaxInt8Conv(features=cout, kernel_size=(k, k), strides=s, padding=p,
                     use_bias=use_bias, dtype=jnp.float32)
    params = {"kernel": jnp.asarray(kernel)}
    if use_bias:
        params["bias"] = jnp.asarray(bias)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    jx = jnp.asarray(x)
    amax = jnp.max(jnp.abs(jx), axis=(1, 2, 3))
    jscale = (jnp.where(amax > 0, amax, 1.0) / 127.0).reshape(-1, 1, 1, 1)
    jx_q = jax_quantize(jx, jscale)
    jw_q, _ = jax_weight_qparams(jnp.asarray(kernel))
    want_acc = np.asarray(lax.conv_general_dilated(
        jx_q, jw_q, window_strides=(s, s), padding=((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))

    m = Int8Conv2d(cin, cout, k, stride=s, padding=p, bias=use_bias)
    m.weight.data = _oihw(kernel)
    if use_bias:
        m.bias.data = torch.from_numpy(bias)
    with torch.inference_mode():
        x_q, scale = m.quantize_input(_nchw(x))
        acc = m.accumulate(_nchw(x))[0]
        got = _nhwc(m(_nchw(x)))
    np.testing.assert_array_equal(_nhwc(x_q), np.asarray(jx_q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -23 * np.abs(want).max())


@pytest.mark.parametrize("cin,cout,k,s,p", [(3, 5, 3, 1, 1), (16, 24, 3, 2, 1), (10, 8, 1, 2, 0),
                                            (8, 12, 1, 1, 0)])
def test_im2col_product_is_exact(cin, cout, k, s, p):
    """The im2col + `_int_mm` sums against the float64 conv of the same
    int8 values, at full int8 range, with K and N off multiples of 8."""
    g = torch.Generator().manual_seed(cin * cout)
    x = torch.randint(-127, 128, (2, 9, 11, cin), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (cout, cin, k, k), dtype=torch.int8, generator=g)
    got = int8_conv_nhwc(x, w, (s, s), (p, p))
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_conv_reference(x, w, (s, s), (p, p)))


# ------------------------------------------------------------ the model

@pytest.fixture(scope="module")
def variables(tiny_config):
    return nontrivial_variables(tiny_config, seed=11)


def _port_int8(tiny_config, variables):
    model = build_model(port_config(tiny_config, int8=True))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


def _x(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)


def _port_forward(model, x):
    with torch.inference_mode():
        out = model(_nchw(x))
    return {k: _nhwc(v) for k, v in out.items()}


def _jax_forward(cfg, variables, x):
    out = jax_build_model(cfg).apply(variables, jnp.asarray(x), train=False)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _gap(got, want):
    """rmse over the reference's spread, JAX test_int8.py's measure."""
    return float(np.sqrt(np.mean((got - want) ** 2)) / (want.std() + 1e-8))


def test_int8_convs_are_the_eligible_ones(tiny_config, variables):
    model = _port_int8(tiny_config, variables)
    names = {n for n, m in model.named_modules() if isinstance(m, Int8Conv2d)}
    convs = {n for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    assert convs - names == {"adpater.0", "head.conv"}
    assert len(names) == 42  # 32 block convs, 3 downsamples, up1, 3 laterals, 3 FPN 3x3
    assert list(model.state_dict()) == list(state_dict_from_jax(variables))


def test_prequantized_bit_identical_to_dynamic(tiny_config, variables):
    model = _port_int8(tiny_config, variables)
    x = _x(2)
    want = _port_forward(model, x)
    prequantize_variables(model)
    assert not isinstance(model.adpater[0], Int8Conv2d)
    assert model.adpater[0].weight.dtype == torch.float32
    assert model.head.conv.weight.dtype == torch.float32
    assert model.down1[0].conv1.weight.dtype == torch.int8 and model.up1.weight.dtype == torch.int8
    assert model.up2.lateral.weight_scale.shape == (tiny_config.fpn_depth,)
    got = _port_forward(model, x)
    for key in MAPS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_dynamic_scales_isolate_batchmates(tiny_config, variables):
    """A batchmate with a 10x larger range leaves another sample's output
    unchanged (micro-batched serving mixes unrelated requests)."""
    model = _port_int8(tiny_config, variables)
    x = _x(7, 1)
    alone = _port_forward(model, x)
    paired = _port_forward(model, np.concatenate([x, 10.0 * x]))
    for key in MAPS:
        np.testing.assert_array_equal(alone[key][0], paired[key][0], err_msg=key)


def test_calibrated_static_scales(tiny_config, variables):
    """Calibrated on one image, the static scales equal that image's
    dynamic ones: bit-identical output, prequantized too; stem and head
    get none. No int8 conv or no batch raises."""
    model = _port_int8(tiny_config, variables)
    x = _x(3, 1)
    want = _port_forward(model, x)
    calibrate_activation_scales(model, [_nchw(x)])
    assert model.down1[0].conv1.act_scale.shape == ()
    assert model.up2.conv[0].act_scale.shape == ()
    sd = model.state_dict()
    assert "adpater.0.act_scale" not in sd and "head.conv.act_scale" not in sd
    assert sum(k.endswith(".act_scale") for k in sd) == 42
    for out in (_port_forward(model, x), _port_forward(prequantize_variables(model), x)):
        for key in MAPS:
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_activation_scales(model, [])
    float_model = build_model(port_config(tiny_config)).eval()
    with pytest.raises(ValueError, match="nothing to calibrate"):
        calibrate_activation_scales(float_model, [_nchw(x)])


@pytest.fixture(scope="module")
def jax_int8_state(tiny_config, variables):
    """JAX's calibrated (two images) and prequantized tree, its int8
    model's output on other images, and those images."""
    cfg8 = tiny_config.__class__(**{**tiny_config.__dict__, "int8": True})
    m8 = jax_build_model(cfg8)
    cal_x = _x(6)
    cal = jax_calibrate(m8, variables, [jnp.asarray(cal_x)])
    pq = jax.tree.map(np.asarray, jax_prequantize(cal))
    x = _x(2)
    static_out = _jax_forward(cfg8, pq, x)
    return {"cfg8": cfg8, "cal_x": cal_x, "pq": pq, "x": x, "static_out": static_out}


@pytest.mark.parametrize("seed,rtol,moved", [(6, 1e-6, 0), (5, 2 / 127, 32)],
                         ids=["no-flip", "flip-in-down2"])
def test_calibrated_scales_match_jax(tiny_config, variables, jax_int8_state, seed, rtol, moved):
    """The port calibrated on the same two images as JAX: each conv's
    act_scale against JAX's. The fp32 stem and BN of XLA and torch differ
    by ulps; where no int8 rounding flips on the way to a conv, its scale
    is JAX's within 1e-6 relative (images seed 6: all 42, measured at most
    2.6e-7, 4 ulps). A flip moves one int8 activation by a step, 1/127 of
    its range, and the change compounds down the net: on images seed 5 a
    flip in `down2` moves 32 of the 42 scales by more than 1e-6, the most
    by 1.36 %, so there the bar is two steps (2/127 relative) and the
    count of moved scales is pinned."""
    if seed == 6:
        want = state_dict_from_jax(jax_int8_state["pq"])
        cal_x = jax_int8_state["cal_x"]
    else:
        cal_x = _x(seed)
        m8 = jax_build_model(jax_int8_state["cfg8"])
        want = state_dict_from_jax(jax.tree.map(
            np.asarray, jax_calibrate(m8, variables, [jnp.asarray(cal_x)])))
    model = _port_int8(tiny_config, variables)
    calibrate_activation_scales(model, [_nchw(cal_x)])
    ours = model.state_dict()
    keys = [k for k in want if k.endswith(".act_scale")]
    assert len(keys) == 42 and set(keys) == {k for k in ours if k.endswith(".act_scale")}
    rel = {k: abs(float(ours[k]) - float(want[k])) / float(want[k]) for k in keys}
    assert max(rel.values()) <= rtol, max(rel.items(), key=lambda kv: kv[1])
    assert sum(r > 1e-6 for r in rel.values()) == moved


def test_jax_int8_state_loads_into_the_port(tiny_config, variables, jax_int8_state, tmp_path):
    """JAX's prequantized + calibrated tree, written by `save_params`,
    loads into the port's int8 model: int8 weights (HWIO -> OIHW),
    weight_scale and act_scale exactly JAX's; the port's own prequantize
    of the float weights gives the same int8 weights and scales. Fed the
    same state, the two int8 models agree within the whole-model bound
    (on images without a rounding flip: see the test below)."""
    path = tmp_path / "int8.msgpack"
    save_params(jax_int8_state["pq"], path)
    model = build_model(port_config(tiny_config, int8=True)).eval()
    load_weights(model, path)
    want = state_dict_from_jax(jax_int8_state["pq"])
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    ours = prequantize_variables(_port_int8(tiny_config, variables)).state_dict()
    for key in ours:
        if key.endswith((".weight", ".weight_scale")):
            assert torch.equal(ours[key], got[key]), key

    x = jax_int8_state["x"]
    port_out = _port_forward(model, x)
    float_out = _jax_forward(tiny_config, variables, x)
    for key in MAPS:
        noise = _gap(jax_int8_state["static_out"][key], float_out[key])
        assert _gap(port_out[key], jax_int8_state["static_out"][key]) <= 0.1 * noise, key


def test_int8_model_tracks_jax_int8_model(tiny_config, variables):
    """Dynamic scales, the same float checkpoint: the port's int8 model
    departs from JAX's int8 model by at most a tenth of JAX's int8-vs-float
    gap on every map, and the anchor peaks agree.

    The two int8 models are bit-identical unless an int8 rounding flips:
    the fp32 BN of flax and torch round differently (flax scales
    `x - mean` by `scale * rsqrt(var + eps)`, torch folds the statistics
    into one multiply-add), and a value that lands within an ulp of a .5
    step, or an amax an ulp off, moves one int8 activation by a step,
    which compounds through the 42 int8 convs. Measured over input seeds
    1-10 (`_x(seed)`): 6 are bit-identical, 4 flip, with gaps of 0.01,
    0.16, 0.80 and 1.06 of the int8-vs-float gap (and one anchor peak
    moved); with the static scales of `jax_int8_state`, 7 of 10 are
    bit-identical. So the bar holds on seeds without a flip (1 here, 2
    for the static state below), and a flip is a difference of one
    quantization step, not of the algorithm."""
    cfg8 = tiny_config.__class__(**{**tiny_config.__dict__, "int8": True})
    x = _x(1)
    want_f = _jax_forward(tiny_config, variables, x)
    want_8 = _jax_forward(cfg8, variables, x)
    got_8 = _port_forward(_port_int8(tiny_config, variables), x)
    for key in MAPS:
        noise = _gap(want_8[key], want_f[key])
        assert 0 < noise < 0.25, key  # JAX test_int8.py:84's bar on its own gap
        assert _gap(got_8[key], want_8[key]) <= 0.1 * noise, (key, noise)
    for b in range(2):
        for c in range(2):
            g, w = got_8["anchor_hm"][b, ..., c], want_8["anchor_hm"][b, ..., c]
            assert np.unravel_index(g.argmax(), g.shape) == np.unravel_index(w.argmax(), w.shape)


def test_int8_train_mode_raises(tiny_config, variables):
    model = _port_int8(tiny_config, variables).train()
    with pytest.raises(ValueError, match="inference-only"):
        model(torch.zeros((1, 3, 64, 64)))
    assert config_from_args(["--labels", "labels.json", "--int8"]).int8


# ------------------------------------------------------------ evaluate --int8

CONF = 0.35


def test_int8_evaluate_matches_jax(tiny_config, tmp_path_factory, monkeypatch):
    """`evaluate --int8` of both packages on one JAX checkpoint, against
    the port's fp32 detections as ground truth: counters equal and every
    summary value within 1e-6, the threshold clear of every int8 score."""
    from structuredetector_tpu.evaluation import Evaluator as JaxEvaluator

    root = tmp_path_factory.mktemp("int8_eval")
    ckpt = root / "model.msgpack"
    save_params(nontrivial_variables(tiny_config, seed=3), ckpt)
    labels = root / "labels.json"
    labels.write_text(json.dumps({"labels": ["bean", "maize"], "parts": ["leaf"]}))
    _write_images(root / "images", SIZES, seed=9, annotated=False)
    flags = ["--labels", str(labels), "--load_model", str(ckpt), "--anchor_name", "stem",
             "--width", "64", "--height", "64", "--fpn_depth", "32", "--max_objects", "4",
             "--max_parts", "8", "--no_amp", "--num_workers", "2"]
    monkeypatch.chdir(root)
    detect_cli.main(["--device", "cpu", "--valid_dir", str(root / "images"),
                     "--conf_threshold", "0.2", *flags])
    gt = root / "predictions"

    argv = ["--valid_dir", str(gt), "--eval_batch_size", "2", "--conf_threshold", str(CONF),
            "--int8", *flags]
    ours = evaluate_cli.main(["--device", "cpu", *argv, "--save_summary",
                              str(tmp_path_factory.mktemp("s") / "port.json")])[CONF]
    recorder = _Recording(JaxEvaluator)
    monkeypatch.setattr(jax_evaluate_cli, "Evaluator", recorder)
    jax_summary = root / "jax.json"
    jax_evaluate_cli.main([*argv, "--no_native_io", "--save_summary", str(jax_summary)])

    # the threshold stands clear of every score the int8 model gives
    from structuredetector_tpu_torch.data.augment import ValidationAugmentation
    from structuredetector_tpu_torch.data.dataset import CropDataset
    from structuredetector_tpu_torch.data.pipeline import Loader
    from structuredetector_tpu_torch.ops.decode import split_head_output
    from structuredetector_tpu_torch.predictor import Predictor

    cfg = config_from_args(argv)
    predictor = Predictor(cfg, device="cpu", device_normalize=False)
    assert cfg.int8 and len(int8_convs(predictor.model)) == 42
    batch = next(iter(Loader(CropDataset(cfg, gt, ValidationAugmentation(cfg)),
                             batch_size=len(SIZES))))
    with torch.inference_mode():
        head = predictor.forward(predictor.to_device(batch["image"]))
        dec = predictor.decoder.decode_arrays(split_head_output(head, 2, 1), 0.0,
                                              cfg.decoder_dist_thresh)
    scores = torch.cat([dec["anchors"][..., 2].flatten(), dec["parts"][..., 2].flatten()])
    assert float((scores - CONF).abs().min()) > 1e-4

    assert _counters(ours) == _counters(recorder.made[0])
    assert sum(e.tp for _, e in ours.anchor_eval.items()) > 0
    got = ours.scalar_summary()
    want = json.loads(Path(jax_summary).read_text())
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, key
