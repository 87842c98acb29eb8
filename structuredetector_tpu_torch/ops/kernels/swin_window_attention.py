"""The Swin V2 attention core: one launch of `csrc/swin_window_attention.cu`
a block.

From the (B, H, W, 3C) output of a block's qkv Linear to its (B, H, W, C)
input of proj: pad the token map to a multiple of the window (a padded
token's q, k and v are the qkv bias, the Linear of zeros), shift odd
blocks by half a window (`layout`), partition into windows of 8x8
tokens, scaled cosine attention with the continuous position bias and,
in a shifted block, the -100 mask between tokens of different regions
(`shift_mask`), then reverse, shift back and crop.

`window_attention_reference` is the plain PyTorch version. The kernel
replaces no TPU kernel; see its source for why it exists and how it is
designed. Both take window 8 and head dim 32, the only shapes of the
port's Swin encoders; the wrapper raises a ValueError naming any other
(the position bias's (heads, 64, 64) shape fixes the window).

A CPU tensor goes through the plain version. A CUDA tensor launches the
kernel (float32 or bfloat16) or raises. On the card the gradient comes
from `_WindowAttention.backward`, which recomputes the plain version
from the saved inputs and differentiates it (no backward kernel).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ...tracing import SWIN
from ._build import load

WINDOW = 8
HEAD_DIM = 32
LOGIT_SCALE_MAX = math.log(100.0)
MASK_VALUE = -100.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layout(h: int, w: int, odd: bool) -> Tuple[int, int, Tuple[int, int]]:
    """A block's (h, w) token map padded to a multiple of the window,
    (hp, wp), and its shift: half a window for odd blocks, none along a
    dimension whose padded size is the window."""
    hp, wp = h + (-h) % WINDOW, w + (-w) % WINDOW
    s = WINDOW // 2 if odd else 0
    return hp, wp, (s if hp > WINDOW else 0, s if wp > WINDOW else 0)


def shift_mask(hp: int, wp: int, shift: Tuple[int, int], device) -> torch.Tensor:
    """(nW, N, N) additive mask of a shifted block on a padded (hp, wp)
    map: -100 between two tokens of a window that came from different
    regions of the rolled map, else 0 (torchvision's region ids)."""

    def regions(n, s):
        i = torch.arange(n, device=device)
        if s == 0:
            return torch.zeros_like(i)
        return (i >= n - WINDOW).long() + (i >= n - s).long()

    ids = regions(hp, shift[0])[:, None] * 3 + regions(wp, shift[1])[None, :]
    ids = ids.view(hp // WINDOW, WINDOW, wp // WINDOW, WINDOW).transpose(1, 2)
    ids = ids.reshape(-1, WINDOW * WINDOW)
    differ = ids[:, None, :] != ids[:, :, None]
    return torch.zeros(differ.shape, device=device).masked_fill_(differ, MASK_VALUE)


def window_attention_reference(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                               position_bias: torch.Tensor, logit_scale: torch.Tensor,
                               odd: bool) -> torch.Tensor:
    """Plain PyTorch version. q and k are normalized in float32 and q
    scaled by exp(min(logit_scale, ln 100)); the products run in qkv's
    dtype, the scores, bias, mask and softmax in float32."""
    b, h, w, c3 = qkv.shape
    heads, c, dtype = position_bias.shape[0], c3 // 3, qkv.dtype
    hp, wp, shift = layout(h, w, odd)
    if (hp, wp) != (h, w):
        qkv = F.pad(qkv, (0, 0, 0, wp - w, 0, hp - h))
        qkv[:, h:] = qkv_bias
        qkv[:, :, w:] = qkv_bias
    if any(shift):
        qkv = torch.roll(qkv, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    ws, nh, nw, n = WINDOW, hp // WINDOW, wp // WINDOW, WINDOW * WINDOW
    qkv = qkv.view(b, nh, ws, nw, ws, 3, heads, c // heads)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nh * nw, heads, n, c // heads)
    scale = torch.clamp(logit_scale.float(), max=LOGIT_SCALE_MAX).exp().view(heads, 1, 1)
    q = (F.normalize(qkv[0].float(), dim=-1) * scale).to(dtype)
    k = F.normalize(qkv[1].float(), dim=-1).to(dtype)
    attn = (q @ k.transpose(-2, -1)).float() + position_bias.float()
    if any(shift):
        mask = shift_mask(hp, wp, shift, qkv.device)
        attn = (attn.view(b, nh * nw, heads, n, n) + mask.unsqueeze(1)).view(-1, heads, n, n)
    y = attn.softmax(dim=-1).to(dtype) @ qkv[2]
    y = y.view(b, nh, nw, heads, ws, ws, c // heads).permute(0, 1, 4, 2, 5, 3, 6)
    y = y.reshape(b, hp, wp, c)
    if any(shift):
        y = torch.roll(y, shifts=shift, dims=(1, 2))
    return y[:, :h, :w]


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor, position_bias: torch.Tensor,
                     logit_scale: torch.Tensor, odd: bool) -> torch.Tensor:
    """(B, H, W, 3C) qkv -> (B, H, W, C): a Swin V2 block's attention core.
    `qkv_bias` (3C,): the padded tokens' q, k, v; `position_bias` (heads,
    N, N), whose N = 64 fixes the window at 8; `logit_scale` (heads
    elements); `odd`: a shifted block. Counts the block's windows and
    padded tokens in `tracing.SWIN`."""
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"expected (B, H, W, 3C) qkv, got shape {tuple(qkv.shape)}")
    heads, n = position_bias.shape[0], WINDOW * WINDOW
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if position_bias.dim() != 3 or position_bias.shape[1:] != (n, n) \
            or c != heads * HEAD_DIM:
        raise ValueError(
            f"window attention takes window {WINDOW} ({n} tokens) and head dim {HEAD_DIM}, "
            f"got position bias {tuple(position_bias.shape)} over qkv {tuple(qkv.shape)}")
    if logit_scale.numel() != heads or qkv_bias.shape != (3 * c,):
        raise ValueError(
            f"logit scale {tuple(logit_scale.shape)} and qkv bias {tuple(qkv_bias.shape)} "
            f"do not fit {heads} heads over qkv {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"window attention takes float32 or bfloat16 qkv, not {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("window attention needs a contiguous (B, H, W, 3C) qkv")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window attention runs on cpu or cuda, not {qkv.device}")
    hp, wp, shift = layout(h, w, odd)
    SWIN.attended(b * hp * wp // n, b * (hp * wp - h * w))
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, qkv_bias, position_bias, logit_scale, odd)
    return _WindowAttention.apply(qkv, qkv_bias.float().contiguous(),
                                  position_bias.to(qkv.dtype).contiguous(),
                                  logit_scale.float().reshape(heads), odd)


window_attention.launches = 0


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, qkv_bias, position_bias, logit_scale, odd):
        ctx.save_for_backward(qkv, qkv_bias, position_bias, logit_scale)
        ctx.odd = odd
        return _launch(qkv, qkv_bias, position_bias, logit_scale, odd)

    @staticmethod
    def backward(ctx, grad):
        saved = [t.detach().requires_grad_(need)
                 for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = window_attention_reference(*saved, ctx.odd)
        wanted = [t for t in saved if t.requires_grad]
        # the qkv bias is unused where nothing pads: its gradient is None
        grads = iter(torch.autograd.grad(y, wanted, grad, allow_unused=True) if wanted else ())
        return (*(next(grads) if t.requires_grad else None for t in saved), None)


def _launch(qkv, qkv_bias, position_bias, logit_scale, odd) -> torch.Tensor:
    b, h, w, c3 = qkv.shape
    heads = position_bias.shape[0]
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    if qkv.data_ptr() % 16 or qkv_bias.data_ptr() % 16:
        raise ValueError("window attention needs 16-byte aligned qkv and qkv bias")
    shift = layout(h, w, odd)[2]
    lib = load("swin_window_attention")
    with torch.cuda.device(qkv.device):
        err = lib.sdnet_swin_window_attention(
            qkv.data_ptr(), qkv_bias.data_ptr(), position_bias.data_ptr(),
            logit_scale.data_ptr(), out.data_ptr(), _DTYPES[qkv.dtype], b, h, w, c3 // 3,
            heads, shift[0], shift[1], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"swin_window_attention kernel launch failed: CUDA error {err}")
    window_attention.launches += 1
    return out
