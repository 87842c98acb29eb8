"""The Swin V2 attention core (`ops/kernels/swin_window_attention.py`): its
plain version on the CPU against the path it replaced, the wrapper's
checks, and on the card the kernel (`csrc/swin_window_attention.cu`)
against the plain version.

This file imports nothing of JAX, so its card tests also run on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_port_swin_kernel.py --noconftest -m cuda

Where CUDA is unavailable (the CPU test run) the card tests skip.
"""

import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from structuredetector_tpu_torch.ops import kernels
from structuredetector_tpu_torch.ops.kernels import swin_window_attention as wa

WINDOW = 8


def sdpa_core(qkv, qkv_bias, position_bias, logit_scale, odd):
    """The core as the port ran it before the kernel: the bias plus the shift
    mask as one additive tensor, spread over the batch's windows, into
    `F.scaled_dot_product_attention` (the yardstick of the plain version)."""
    b, h, w, c3 = qkv.shape
    heads, c, window = position_bias.shape[0], c3 // 3, WINDOW
    hp, wp, shift = wa.layout(h, w, odd)
    if (hp, wp) != (h, w):
        qkv = F.pad(qkv, (0, 0, 0, wp - w, 0, hp - h))
        qkv[:, h:] = qkv_bias
        qkv[:, :, w:] = qkv_bias
    if any(shift):
        qkv = torch.roll(qkv, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    nh, nw, n = hp // window, wp // window, window * window
    qkv = qkv.view(b, nh, window, nw, window, 3, heads, c // heads)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nh * nw, heads, n, c // heads)
    scale = torch.clamp(logit_scale, max=wa.LOGIT_SCALE_MAX).exp().view(heads, 1, 1)
    q = F.normalize(qkv[0], dim=-1) * scale
    k = F.normalize(qkv[1], dim=-1)
    attn_bias = position_bias.unsqueeze(0)
    if any(shift):
        attn_bias = attn_bias + wa.shift_mask(hp, wp, shift, qkv.device).unsqueeze(1)
    attn_bias = attn_bias.to(qkv.dtype)
    if any(shift):
        attn_bias = attn_bias.expand(b, -1, -1, -1, -1).reshape(b * nh * nw, heads, n, n)
    y = F.scaled_dot_product_attention(q, k, qkv[2], attn_mask=attn_bias, scale=1.0)
    y = y.view(b, nh, nw, heads, window, window, c // heads).permute(0, 1, 4, 2, 5, 3, 6)
    y = y.reshape(b, hp, wp, c)
    if any(shift):
        y = torch.roll(y, shifts=shift, dims=(1, 2))
    return y[:, :h, :w]


def inputs(b, h, w, heads, seed=0, device="cpu", dtype=torch.float32):
    """qkv (B, H, W, 3C) and the block's qkv bias (k third zero), position
    bias in [0, 16] and logit scales about ln 10, as a block holds them."""
    g = torch.Generator().manual_seed(seed)
    c, n = heads * 32, WINDOW * WINDOW
    qkv = torch.randn(b, h, w, 3 * c, generator=g)
    bias = torch.randn(3 * c, generator=g)
    bias[c:2 * c] = 0
    pos = 16 * torch.sigmoid(torch.randn(heads, n, n, generator=g))
    scale = torch.log(torch.full((heads, 1, 1), 10.0)) + 0.5 * torch.randn(heads, 1, 1,
                                                                            generator=g)
    scale[0] = 5.0  # above ln 100: clamped
    return (qkv.to(device, dtype), bias.to(device), pos.to(device, dtype), scale.to(device))


# (b, h, w, heads): every stage shifts; pads with a shift; pads along w to
# the window, so no shift there; one window, no shift at all
CPU_CASES = {"shifts": (2, 16, 24, 2), "pads": (1, 20, 12, 1), "w-is-window": (2, 10, 5, 2),
             "one-window": (1, 5, 3, 4)}


def gap(out, want):
    return float((out.float() - want.float()).abs().max() / want.float().abs().max())


def head_gaps(out, truth):
    """Each head's largest gap from `truth`, as a share of that head's
    largest output (a head is 32 consecutive channels)."""
    def per_head(t):
        return t.reshape(-1, t.shape[-1] // wa.HEAD_DIM, wa.HEAD_DIM).amax(dim=(0, 2))

    return per_head((out.float() - truth).abs()) / per_head(truth.abs())


def assert_within_bf16_rounding(got, plain, truth):
    """The bar of the bf16 kernel, `got`, against float32 arithmetic on the
    same bf16 inputs, `truth`: each head's largest gap within one bf16
    rounding (2^-8 of that head's largest output) of the plain version's own
    bf16 run's, `plain`, and the mean gap (of the mean output) too."""
    mine, theirs = head_gaps(got, truth), head_gaps(plain, truth)
    worse = (mine > theirs + 2 ** -8).nonzero().flatten().tolist()
    assert not worse, {f"head {i}": (float(mine[i]), float(theirs[i])) for i in worse}

    def mean_gap(out):
        return float((out.float() - truth).abs().mean() / truth.abs().mean())

    assert mean_gap(got) <= mean_gap(plain) + 2 ** -8, (mean_gap(got), mean_gap(plain))


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("case", CPU_CASES)
def test_plain_version_equals_the_sdpa_path(case, odd):
    """float32: the explicit softmax against `scaled_dot_product_attention`,
    the same arithmetic in another order (gaps of ~1e-7 of the largest
    output)."""
    qkv, bias, pos, scale = inputs(*CPU_CASES[case])
    got = wa.window_attention_reference(qkv, bias, pos, scale, odd)
    want = sdpa_core(qkv, bias, pos, scale, odd)
    assert got.shape == want.shape == qkv.shape[:3] + (qkv.shape[3] // 3,)
    assert gap(got, want) <= 1e-5


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    qkv, bias, pos, scale = inputs(*CPU_CASES["pads"], seed=1)
    before = kernels.launch_counts()
    got = kernels.window_attention(qkv, bias, pos, scale, True)
    assert torch.equal(got, wa.window_attention_reference(qkv, bias, pos, scale, True))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("what", ["window", "head_dim", "bias_shape", "strided", "dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    qkv, bias, pos, scale = inputs(1, 8, 8, 2)
    error = ValueError
    if what == "window":  # a window of 7: a (heads, 49, 49) position bias
        pos = pos[:, :49, :49]
        match = r"window 8 \(64 tokens\) .* position bias \(2, 49, 49\) over qkv \(1, 8, 8, 192\)"
    elif what == "head_dim":  # 2 heads of 16
        qkv, bias = qkv[..., :96].contiguous(), bias[:96]
        match = r"head dim 32, got position bias \(2, 64, 64\) over qkv \(1, 8, 8, 96\)"
    elif what == "bias_shape":
        pos, match = pos[..., :32], r"position bias \(2, 64, 32\)"
    elif what == "strided":
        qkv, match = qkv.transpose(1, 2), "contiguous"
    else:
        qkv, error, match = qkv.half(), TypeError, "float16"
    with pytest.raises(error, match=match):
        kernels.window_attention(qkv, bias, pos, scale, False)


def test_kernels_import_without_nvcc_or_triton():
    """Nothing is built or imported from a compiler when the package loads."""
    code = ("import sys; sys.modules['triton'] = None\n"
            "import structuredetector_tpu_torch.models.swin\n"
            "from structuredetector_tpu_torch.ops.kernels import _build, swin_window_attention\n"
            "assert not _build._libs\n")
    env = {**os.environ, "PATH": "/nonexistent"}
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr


def test_load_compiles_its_own_source_only(monkeypatch, tmp_path):
    """`load(name)` runs nvcc on `csrc/<name>.cu` alone, so a ResNet model's
    decode never compiles the Swin core; `build()` compiles the sources
    still missing. A stand-in nvcc writes an empty library and logs its
    source; loading the library is stubbed."""
    from unittest import mock

    from structuredetector_tpu_torch import utils
    from structuredetector_tpu_torch.ops.kernels import _build

    log = tmp_path / "compiled.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n"
                    "open(args[args.index('-o') + 1], 'w').close()\n"
                    f"open({str(log)!r}, 'a').write(args[-1].rsplit('/', 1)[-1] + '\\n')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(utils, "_build_dir", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    _build.load("sigmoid_nms_topk")
    _build.load("sigmoid_nms_topk")
    assert log.read_text().split() == ["sigmoid_nms_topk.cu"]
    _build.load("swin_window_attention")
    assert log.read_text().split() == ["sigmoid_nms_topk.cu", "swin_window_attention.cu"]
    _build.build()
    assert sorted(log.read_text().split()[2:]) == ["sigmoid_nms.cu",
                                                   "sigmoid_nms_topk_rowmax.cu"]


def test_backward_recomputes_the_plain_version(monkeypatch):
    """The autograd.Function's gradients, with the launch swapped for the
    plain version so that it runs on the CPU, equal the plain version's own
    autograd: qkv (padded tokens included), the qkv bias, the position bias
    and the logit scale."""
    monkeypatch.setattr(wa, "_launch", lambda qkv, b, p, s, odd: wa.window_attention_reference(
        qkv, b, p, s, odd).contiguous())
    qkv, bias, pos, scale = (t.requires_grad_() for t in inputs(1, 20, 12, 2, seed=2))
    weights = torch.randn(qkv.shape[:3] + (qkv.shape[3] // 3,))
    grads = {}
    for name, fn in (("function", lambda *a: wa._WindowAttention.apply(
            a[0], a[1], a[2], a[3].reshape(-1), True)),
                     ("plain", lambda *a: wa.window_attention_reference(*a, True))):
        (fn(qkv, bias, pos, scale) * weights).sum().backward()
        grads[name] = [t.grad.clone() for t in (qkv, bias, pos, scale)]
        for t in (qkv, bias, pos, scale):
            t.grad = None
    for got, want in zip(grads["function"], grads["plain"]):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- on the card ---------------------------------------------------------

# (b, h, w, heads): the cell's four stages at 512x512, batch 2
STAGES = {"stage1": (2, 128, 128, 4), "stage2": (2, 64, 64, 8), "stage3": (2, 32, 32, 16),
          "stage4": (2, 16, 16, 32)}
# the stages at 160x160 and at 160x96 (the graph test's bucket): padded,
# and at 160x96 stage 4 (5x3 tokens) pads to one window along both, so no shift
PADDED = {"160-s1": (2, 40, 40, 4), "160-s2": (2, 20, 20, 8), "160-s3": (2, 10, 10, 16),
          "160-s4": (2, 5, 5, 32), "160x96-s1": (2, 40, 24, 4), "160x96-s2": (2, 20, 12, 8),
          "160x96-s3": (2, 10, 6, 16), "160x96-s4": (2, 5, 3, 32)}
CARD_CASES = {**STAGES, **PADDED}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_float32_on_card(case, odd):
    """float32 FMAs against the plain version in float32 (TF32 off): within
    1e-5 of the largest output; bit for bit between two launches; one
    launch a call."""
    _need_card()
    qkv, bias, pos, scale = inputs(*CARD_CASES[case], seed=3, device="cuda")
    before = kernels.launch_counts()["swin_window_attention"]
    got = kernels.window_attention(qkv, bias, pos, scale, odd)
    again = kernels.window_attention(qkv, bias, pos, scale, odd)
    assert kernels.launch_counts()["swin_window_attention"] == before + 2
    want = wa.window_attention_reference(qkv, bias, pos, scale, odd)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert gap(got, want) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_bf16_on_card(case, odd):
    """bf16 against float32 arithmetic on the same bf16 inputs, head by
    head (`assert_within_bf16_rounding`); bit for bit between two launches.
    Head 0's logit scale is clamped to 100, where q's rounding to bf16 alone
    moves the scores by ~0.2 on either path: its gaps are ~6 % of its
    largest output on both paths, the other heads' far smaller."""
    _need_card()
    qkv, bias, pos, scale = inputs(*CARD_CASES[case], seed=4, device="cuda",
                                   dtype=torch.bfloat16)
    truth = wa.window_attention_reference(qkv.float(), bias, pos.float(), scale, odd)
    plain = wa.window_attention_reference(qkv, bias, pos, scale, odd)
    got = kernels.window_attention(qkv, bias, pos, scale, odd)
    again = kernels.window_attention(qkv, bias, pos, scale, odd)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert_within_bf16_rounding(got, plain, truth)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stage3", "160x96-s2"])
def test_kernel_gradients_on_card(case):
    """float32: the autograd.Function's gradients (the plain version
    recomputed and differentiated) against the plain version's own
    autograd on the same inputs."""
    _need_card()
    qkv, bias, pos, scale = (t.requires_grad_() for t in inputs(*CARD_CASES[case], seed=5,
                                                                  device="cuda"))
    weights = torch.randn(qkv.shape[:3] + (qkv.shape[3] // 3,), device="cuda")
    grads = {}
    for name, fn in (("kernel", kernels.window_attention),
                     ("plain", wa.window_attention_reference)):
        (fn(qkv, bias, pos, scale, True) * weights).sum().backward()
        grads[name] = [t.grad for t in (qkv, bias, pos, scale)]
        for t in (qkv, bias, pos, scale):
            t.grad = None
    if case == "stage3":  # nothing pads: the qkv bias has no gradient on either path
        assert grads["kernel"][1] is None and grads["plain"][1] is None
        del grads["kernel"][1], grads["plain"][1]
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert float(want.abs().max()) > 0
        assert gap(got, want) <= 1e-6


@pytest.mark.cuda
def test_one_swin_forward_is_24_launches_on_card():
    """swin_v2_b's 24 blocks, one kernel launch each, in bf16 under
    autocast; no scaled_dot_product_attention on the way."""
    _need_card()
    from structuredetector_tpu_torch.models.network import SDNet

    model = SDNet(2, 1, 32, dtype=torch.bfloat16, backbone="swin_v2_b").cuda().eval()
    x = torch.randn(2, 3, 128, 128, device="cuda")
    calls = []
    sdpa = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = lambda *a, **k: calls.append(1) or sdpa(*a, **k)
    try:
        before = kernels.launch_counts()["swin_window_attention"]
        with torch.no_grad():
            out = model(x, raw_output=True)
        torch.cuda.synchronize()
    finally:
        F.scaled_dot_product_attention = sdpa
    assert kernels.launch_counts()["swin_window_attention"] - before == 24
    assert not calls and torch.isfinite(out).all()
