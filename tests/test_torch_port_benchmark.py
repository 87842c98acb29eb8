"""What `cli.benchmark` times, for the new variants, against the JAX package.

- `python -m structuredetector_tpu_torch.cli.benchmark --device cpu` at
  64x64, batch 2, `--iters 1`, for each backbone and under
  `--int8_static`: its keys are exactly JAX `cli/benchmark.py`'s
  (read from its source) mapped to the port's names, without the kernel
  sections off the card, as JAX leaves its Pallas sections off the TPU;
  every value finite and positive;
- one train step each for resnet50, the s2d stem and `head_conv`
  against JAX `make_train_step` on the same weights and batch (64x64,
  batch 8, `fpn_depth` 16, fp32, as `tests/test_torch_port_train_step.py`,
  with its bars: loss within 1e-3 relative, FPN and head gradients
  within 1e-4 of each tensor's scale, encoder gradients within 3e-2 in
  relative L2 of JAX's and as close to a float64 evaluation, the whole
  gradient within 1e-2, BN running statistics within 1e-5 beside flax's
  own rounding, bottleneck `bn3` and downsample BNs included);
- int8 resnet50: the convs that run int8 are JAX's (every residual-block
  conv, bottleneck `conv3` and downsamples included; stem, hidden head
  and head float), and every one of its 59 int8 convs, fed the input the
  port's model hands it, gives JAX `Int8Conv`'s int8 activations and
  int32 sums exactly and its output within 2 ulps of scale.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import structuredetector_tpu.cli.benchmark as jax_benchmark
from structuredetector_tpu.models import init_model as jax_init_model
from structuredetector_tpu.models.network import build_model as jax_build_model
from structuredetector_tpu.models.network import save_params
from structuredetector_tpu.models.quantize import Int8Conv as JaxInt8Conv
from structuredetector_tpu.models.quantize import prequantize_variables as jax_prequantize
from structuredetector_tpu.models.quantize import quantize_symmetric as jax_quantize
from structuredetector_tpu.models.quantize import weight_qparams as jax_weight_qparams
from structuredetector_tpu.train.state import create_train_state as jax_create_train_state
from structuredetector_tpu.train.state import make_optimizer as jax_make_optimizer
from structuredetector_tpu.train.steps import make_train_step
from structuredetector_tpu_torch.cli import benchmark
from structuredetector_tpu_torch.models.network import build_model
from structuredetector_tpu_torch.models.quantize import (
    Int8Conv2d,
    int8_convs,
    prequantize_variables,
)
from structuredetector_tpu_torch.models.weights import load_weights, state_dict_from_jax
from structuredetector_tpu_torch.ops.decode import split_head_output
from structuredetector_tpu_torch.ops.losses import sdnet_loss
from structuredetector_tpu_torch.train.state import create_train_state
from structuredetector_tpu_torch.train.steps import encode_batch, train_step
from tests.test_torch_port_model import nontrivial_variables, port_config
from tests.test_torch_port_train_step import LR, SIZE, _batch, _rel_l2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU runs (the suite runs in
    several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ cli.benchmark

# JAX key -> the port's (`cli/benchmark.py`'s docstring)
PORT_KEYS = {
    "forward_fps": "forward_fps",
    "e2e_xla_fps": "e2e_plain_fps",
    "e2e_pallas_fps": "e2e_kernel_fps",
    "e2e_latency_batch1_ms": "e2e_latency_batch1_ms",
    "decode_xla_us_per_img": "decode_plain_us_per_img",
    "decode_pallas_us_per_img": "decode_kernel_us_per_img",
    "train_step_imgs_per_s": "train_step_imgs_per_s",
}
KERNEL_KEYS = {"e2e_kernel_fps", "decode_kernel_us_per_img"}  # JAX's TPU-only sections


def _jax_keys() -> set:
    """The result keys JAX `cli/benchmark.py` writes, from its source."""
    source = Path(jax_benchmark.__file__).read_text()
    keys = set()
    for key in re.findall(r'results\[f?"([^"]+)"\]', source):
        keys |= ({key.format(name=n) for n in ("xla", "pallas")} if "{name}" in key
                 else {key})
    return keys


def test_benchmark_keys_are_jax_keys_mapped():
    assert _jax_keys() == set(PORT_KEYS)
    args = benchmark.parse_args(["--int8_static"])
    assert (args.device, args.batch_size, args.width, args.iters, args.int8) == \
        ("cuda", 32, 512, 20, True)


@pytest.mark.parametrize("flags", [["--backbone", "resnet18"], ["--backbone", "resnet34"],
                                   ["--backbone", "resnet50"], ["--int8_static"]],
                         ids=["resnet18", "resnet34", "resnet50", "int8_static"])
def test_benchmark_cli_on_cpu(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = benchmark.main(["--device", "cpu", "-W", "64", "-H", "64", "--fpn_depth",
                                  "32", "-b", "2", "--iters", "1", "--json", *flags])
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    want = set(PORT_KEYS.values()) - KERNEL_KEYS
    if "--int8_static" in flags:
        want -= {"train_step_imgs_per_s"}
    assert set(printed) == set(results) == want
    for key, value in results.items():
        assert math.isfinite(value) and value > 0, (key, value)
        assert printed[key] == round(value, 2) > 0, key


def test_benchmark_raises_without_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(["-W", "64", "-H", "64", "-b", "2", "--iters", "1"])


# ------------------------------------------------------------ train step

TRAIN_VARIANTS = {"resnet50": dict(backbone="resnet50"), "s2d": dict(s2d_stem=True),
                  "head_conv": dict(head_conv=16)}


@pytest.fixture(scope="module")
def step_runs(tiny_config):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _one_step(dataclasses.replace(
                tiny_config, width=SIZE, height=SIZE, fpn_depth=16, max_objects=3,
                max_parts=5, learning_rate=LR, epochs=9, lr_step=3, use_amp=False,
                hm_loss_fn="mse", **TRAIN_VARIANTS[name]))
        return cache[name]

    return get


def _one_step(jax_cfg):
    """One train step of each package from the same weights on the same
    batch: JAX's state after it, the port's state_dict and gradients, and
    the port's gradients and BN statistics evaluated in float64."""
    variables = nontrivial_variables(jax_cfg, seed=11)
    images, kp = _batch(jax_cfg)
    model, _ = jax_init_model(jax_cfg)
    opt = jax_make_optimizer(jax_cfg, steps_per_epoch=1000)
    state = jax_create_train_state(jax_cfg, jax.tree.map(jnp.asarray, variables), opt)
    grid = jax_cfg.width // 4
    step = make_train_step(model, jax_cfg, opt, out_h=grid, out_w=grid, donate=False)
    state, stats = step(state, jnp.asarray(images), {k: jnp.asarray(v) for k, v in kp.items()})

    cfg = port_config(jax_cfg)
    tkp = {k: torch.from_numpy(v) for k, v in kp.items()}
    nets = {}
    for dtype in (torch.float32, torch.float64):
        nets[dtype] = build_model(cfg, dtype=torch.float32)
        nets[dtype].load_state_dict(state_dict_from_jax(variables), strict=True)
    tstate = create_train_state(cfg, nets[torch.float32], steps_per_epoch=1000)
    port_stats = train_step(tstate, torch.from_numpy(images), tkp, cfg)
    ref = nets[torch.float64].double().train()
    head = ref(torch.from_numpy(images).double().permute(0, 3, 1, 2).contiguous(),
               raw_output=True).double()
    sdnet_loss(split_head_output(head, cfg.n_labels, cfg.n_parts),
               encode_batch(tkp, cfg, grid, grid))[0].backward()
    mu = jax.tree.map(lambda m: np.asarray(m) / 0.1, state.opt_state[0].mu)
    return {"jax_loss": float(stats["total_loss"]),
            "port_loss": float(port_stats["total_loss"]),
            "jax_sd": state_dict_from_jax({"params": jax.tree.map(np.asarray, state.params),
                                           "batch_stats": jax.tree.map(np.asarray,
                                                                       state.batch_stats)}),
            "jax_grads": state_dict_from_jax({"params": mu, "batch_stats": state.batch_stats}),
            "port_sd": nets[torch.float32].state_dict(), "exact_sd": ref.state_dict(),
            "port_grads": {n: p.grad.clone() for n, p in nets[torch.float32].named_parameters()},
            "exact_grads": {n: p.grad for n, p in ref.named_parameters()}}


def _max_abs(a, b) -> float:
    return float(np.abs(a.double().numpy() - b.double().numpy()).max())


@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_one_train_step_matches_jax(step_runs, name):
    """The bars of `tests/test_torch_port_train_step.py`. BN statistics:
    flax computes the batch variance in one pass (E[x^2] - E[x]^2, float32),
    which departs from a float64 evaluation by up to 9.1e-5 in resnet50's
    last stage here (2x2 maps, 32 values a channel; measured), where the
    port's two-pass variance stays within 1.1e-5. So each statistic is
    within 1e-5 of JAX's plus JAX's own departure from float64, and no
    farther from float64 than JAX's (or 1e-5). Torch's uncorrected
    (unbiased) update would miss by var / 31 / 10, some 3e-3.

    Gradients: float32 is ill-conditioned here for JAX's step. Measured
    at this size, JAX's resnet50 gradient departs from a float64
    evaluation by up to 5.7 % of a tensor (relative L2; worse at
    128x128) and 4.4 % as a whole, the port's by up to 1.4 % and 1.04 %;
    with the s2d stem JAX's FPN gradients depart from float64 by up to
    1.5 % of a tensor's scale, the port's by 1e-5. So each tensor is held
    to the bars of `tests/test_torch_port_train_step.py` (FPN and head
    1e-4 of scale, encoder 3e-2 relative L2, the whole 1e-2) beside JAX's
    own departure from float64, and no farther from float64 than JAX's
    (or 1e-4); the whole port gradient within 2e-2 of float64."""
    run = step_runs(name)
    np.testing.assert_allclose(run["port_loss"], run["jax_loss"], rtol=1e-3)

    stats = [k for k in run["jax_sd"] if k.endswith(("running_mean", "running_var"))]
    bns = {"resnet50": 53 + 3, "s2d": 36 + 3, "head_conv": 36 + 3}[name]
    assert len(stats) == 2 * bns  # resnet50: 16 blocks x 3, 4 downsamples, the stem
    for k in stats:
        port, jax_, exact = run["port_sd"][k], run["jax_sd"][k], run["exact_sd"][k]
        jax_off = _max_abs(jax_, exact)
        assert _max_abs(port, jax_) <= 1e-5 + jax_off, (k, _max_abs(port, jax_), jax_off)
        assert _max_abs(port, exact) <= max(1e-5, jax_off), (k, _max_abs(port, exact), jax_off)

    got, want, exact = run["port_grads"], run["jax_grads"], run["exact_grads"]
    assert set(got) == set(k for k in want if not k.endswith(("running_mean", "running_var",
                                                               "num_batches_tracked")))
    for k, g in got.items():
        g, w, x = g.numpy(), want[k].numpy(), exact[k].numpy().astype(np.float32)
        scale = float(np.abs(w).max())
        assert scale > 0, k
        to_jax, to_exact, jax_to_exact = _rel_l2(g, w), _rel_l2(g, x), _rel_l2(w, x)
        assert to_exact <= max(jax_to_exact, 1e-4), (k, to_exact, jax_to_exact)
        if k.startswith(("up", "head")):  # head_hidden too
            jax_off = float(np.abs(w - x).max())
            assert float(np.abs(g - w).max()) <= 1e-4 * scale + jax_off, k
        else:
            assert to_jax <= 3e-2 + jax_to_exact, (k, to_jax, jax_to_exact)
    flat = {side: np.concatenate([np.asarray(d[k], np.float32).ravel() for k in got])
            for side, d in (("port", got), ("jax", want), ("exact", exact))}
    # measured: the port's whole gradient 1.04e-2 (resnet50) from float64,
    # JAX's 4.4e-2
    assert _rel_l2(flat["port"], flat["exact"]) <= 2e-2
    assert _rel_l2(flat["port"], flat["jax"]) <= 1e-2 + _rel_l2(flat["jax"], flat["exact"])


# ------------------------------------------------------------ int8 resnet50

@pytest.fixture(scope="module")
def resnet50(tiny_config):
    cfg = dataclasses.replace(tiny_config, backbone="resnet50")
    return cfg, nontrivial_variables(cfg, seed=11)


def _port_int8(cfg, variables):
    model = build_model(port_config(cfg, int8=True))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


def _x(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)


def _paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _jax_int8_convs(cfg) -> set:
    """The convs JAX's int8 model runs int8 (only `Int8Conv`s sow an amax
    in a calibrating forward; traced, not run), by the port's names."""
    model = jax_build_model(dataclasses.replace(cfg, int8=True))
    x = jnp.zeros((1, cfg.height, cfg.width, 3))
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    sown = jax.eval_shape(
        lambda v: model.apply(v, x, train=False, mutable=["calibration"])[1], abstract)
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    for path in _paths(sown["calibration"]):  # (..., conv, "act_amax")
        node = tree["params"]
        for key in path[:-1]:
            node = node[key]
        node["act_scale"] = np.float32(1.0)
    return {k.removesuffix(".act_scale") for k in state_dict_from_jax(tree)
            if k.endswith(".act_scale")}


@pytest.mark.parametrize("flags,floats", [
    ({}, {"adpater.0", "head.conv"}),
    (dict(s2d_stem=True), {"adpater.0", "head.conv"}),
    (dict(head_conv=16), {"adpater.0", "head_hidden", "head.conv"}),
], ids=["resnet50", "resnet50-s2d", "resnet50-head_conv"])
def test_int8_convs_are_jax_int8_convs(tiny_config, flags, floats):
    """JAX's split: every residual-block conv (48 block convs, bottleneck
    `conv3` included, 4 downsamples) and the 7 FPN convs run int8; the
    stem in either form, the hidden head and the head stay float."""
    cfg = dataclasses.replace(tiny_config, backbone="resnet50", **flags)
    model = build_model(port_config(cfg, int8=True))
    ours = {n for n, m in model.named_modules() if isinstance(m, Int8Conv2d)}
    assert ours == _jax_int8_convs(cfg)
    assert len(ours) == 59 and {"down1.0.conv3", "down1.0.downsample.0"} <= ours
    convs = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert convs - ours == floats


@functools.partial(jax.jit, static_argnums=0)
def _jax_int8_conv(jm, params, jx):
    """JAX `Int8Conv`'s output on prequantized `params`, its int8
    activations and its int32 sums. (The weights are quantized outside
    the jit, eagerly, as the port's are compared with in
    `tests/test_torch_port_int8.py`: under jit XLA may round `amax / 127`
    differently.)"""
    amax = jnp.max(jnp.abs(jx), axis=(1, 2, 3))
    jx_q = jax_quantize(jx, (jnp.where(amax > 0, amax, 1.0) / 127.0).reshape(-1, 1, 1, 1))
    s, p = jm.strides, jm.padding
    acc = lax.conv_general_dilated(
        jx_q, params["kernel"], window_strides=(s, s), padding=((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    return jm.apply({"params": params}, jx), jx_q, acc


def test_every_int8_conv_matches_jax_int8conv(resnet50):
    """Each of resnet50's int8 convs, fed the input the port's int8 model
    hands it at 64x64 (48 block convs, 4 downsamples, 7 FPN convs),
    against JAX `Int8Conv` on the same input and weights."""
    cfg, variables = resnet50
    model = _port_int8(cfg, variables)
    inputs = {}

    def keep(name):
        def hook(module, args):
            inputs[name] = args[0]  # returns None: the input goes on unchanged
        return hook

    hooks = [m.register_forward_pre_hook(keep(n))
             for n, m in model.named_modules() if isinstance(m, Int8Conv2d)]
    with torch.inference_mode():
        model(torch.from_numpy(_x(1)).permute(0, 3, 1, 2).contiguous())
    for h in hooks:
        h.remove()
    assert len(inputs) == len(int8_convs(model)) == 59
    for name, x in inputs.items():
        m = model.get_submodule(name)
        kernel = np.transpose(m.weight.detach().numpy(), (2, 3, 1, 0))
        w_q, w_scale = jax_weight_qparams(jnp.asarray(kernel))
        params = {"kernel": w_q, "kernel_scale": w_scale}
        if m.bias is not None:
            params["bias"] = jnp.asarray(m.bias.detach().numpy())
        k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
        jm = JaxInt8Conv(features=m.out_channels, kernel_size=(k, k), strides=s, padding=p,
                         use_bias=m.bias is not None, dtype=jnp.float32)
        want, jx_q, want_acc = (np.asarray(a) for a in _jax_int8_conv(
            jm, params, jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
        with torch.inference_mode():
            x_q, _ = m.quantize_input(x)
            acc = m.accumulate(x)[0]
            got = m(x).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(), np.asarray(jx_q),
                                      err_msg=name)
        np.testing.assert_array_equal(acc.numpy(), want_acc, err_msg=name)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * 2.0 ** -23 * np.abs(want).max(), err_msg=name)


def test_head_conv_int8_prequantize_keeps_the_hidden_head_float(tiny_config, tmp_path):
    """JAX `prequantize_variables` (`quantize.py:146-185`) also quantizes
    `head_hidden`, which is a float `nn.Conv`: JAX's prequantized
    `--head_conv` int8 model then departs from its dynamic one (measured
    at this size: by 3.2e3 on a head of scale 3.4). The port's
    prequantize touches only its `Int8Conv2d`s, so the hidden head stays
    float and the model bit-identical to the dynamic one; JAX's
    prequantized tree is refused, not loaded."""
    cfg = dataclasses.replace(tiny_config, head_conv=16)
    variables = nontrivial_variables(cfg, seed=5)
    model = _port_int8(cfg, variables)
    x = torch.from_numpy(_x(2)).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = model(x, raw_output=True)
        got = prequantize_variables(model)(x, raw_output=True)
    assert model.head_hidden.weight.dtype == torch.float32
    assert model.down1[0].conv1.weight.dtype == torch.int8
    assert torch.equal(got, want)
    path = tmp_path / "prequantized.msgpack"
    save_params(jax_prequantize(variables), path)
    with pytest.raises(RuntimeError, match="head_hidden.weight_scale"):
        load_weights(build_model(port_config(cfg, int8=True)), path)
