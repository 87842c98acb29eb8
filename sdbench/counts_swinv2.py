"""Operations and bytes of SDNet on a Swin V2 encoder, from shapes: the
yardstick of `mfu_swinv2.infer` and `attn_roofline.infer`. Nothing here
reads the program; the architecture is the reference's
(`reference/swinv2.py`).

Multiply-adds, counted as torchvision's published GFLOPS of `swin_v2_b`
count them: the patch embedding, each block's qkv, proj and MLP Linears
on every token, its attention's two products (q k^T and attn v) on the
padded windows, its position-bias MLP over the (2w - 1)^2 table, and the
patch mergings' reductions. LayerNorms, GELU, softmax, the shift and the
additions are left out. `forward_flops` adds the FPN and head
convolutions (`counts.forward_flops`'s rule) and doubles.

The attention core (the program's `sd.swin.attn` span): its two products'
FLOPs, and its bytes with q, k, v read once and the output written once
in bf16, plus the position bias and, in a shifted block, the mask.
"""

from __future__ import annotations

from typing import List, Tuple

from .counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, _conv_macs
from .reference.swinv2 import CPB_HIDDEN, widths

BF16_BYTES = 2


def _pad(n: int, w: int) -> int:
    return n + (-n) % w


def _stages(arch: dict, w: int, h: int) -> List[Tuple[int, int]]:
    """The token grid (h, w) of each stage."""
    p = arch["patch"]
    h, w = h // p, w // p
    out = [(h, w)]
    for _ in arch["depths"][1:]:
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def _blocks(arch: dict, w: int, h: int):
    """(stage index, dim, heads, tokens, padded tokens, shifted) of every
    block, in order."""
    ws = arch["window"]
    out = []
    for i, ((th, tw), depth, heads) in enumerate(zip(_stages(arch, w, h), arch["depths"],
                                                     arch["heads"])):
        dim = arch["embed"] * 2 ** i
        hp, wp = _pad(th, ws), _pad(tw, ws)
        for j in range(depth):
            shifted = j % 2 == 1 and (hp > ws or wp > ws)
            out.append((i, dim, heads, th * tw, hp * wp, shifted))
    return out


def encoder_macs(arch: dict, w: int = 256, h: int = 256, classes: int = 0) -> int:
    """The encoder's multiply-adds at (w, h), with a `classes`-way
    classifier on C5 where asked (torchvision's count: 1000)."""
    p, c, ws = arch["patch"], arch["embed"], arch["window"]
    stages = _stages(arch, w, h)
    macs = _conv_macs(3, c, p, *stages[0])
    table = (2 * ws - 1) ** 2
    for _, dim, heads, tokens, padded, _ in _blocks(arch, w, h):
        macs += tokens * 12 * dim * dim  # qkv 3, proj 1, MLP 8
        macs += 2 * padded * ws * ws * dim  # q k^T and attn v
        macs += table * (2 * CPB_HIDDEN + CPB_HIDDEN * heads)
    for i in range(1, len(stages)):
        dim = c * 2 ** (i - 1)
        th, tw = stages[i]
        macs += th * tw * 4 * dim * 2 * dim
    return macs + widths(arch)[-1] * classes


def forward_flops(arch: dict, fpn_depth: int, n_out: int, w: int, h: int) -> int:
    """FLOPs of one SDNet forward of one (w, h) image."""
    macs = encoder_macs(arch, w, h)
    c2, c3, c4, c5 = widths(arch)
    (h2, w2), (h3, w3), (h4, w4), (h5, w5) = _stages(arch, w, h)
    macs += _conv_macs(c5, fpn_depth, 1, h5, w5)
    for skip, (hs, ws_) in ((c4, (h4, w4)), (c3, (h3, w3)), (c2, (h2, w2))):
        macs += _conv_macs(skip, fpn_depth, 1, hs, ws_) + _conv_macs(fpn_depth, fpn_depth, 3,
                                                                     hs, ws_)
    macs += _conv_macs(fpn_depth, n_out, 1, h2, w2)
    return 2 * macs


def attention_core(arch: dict, w: int, h: int, batch: int) -> Tuple[int, int, int]:
    """(FLOPs, bytes, blocks) of the attention cores of one forward of
    `batch` images."""
    n = arch["window"] ** 2
    flops = nbytes = 0
    blocks = _blocks(arch, w, h)
    for _, dim, heads, _, padded, shifted in blocks:
        flops += 2 * 2 * batch * padded * n * dim
        nbytes += 4 * batch * padded * dim * BF16_BYTES + heads * n * n * BF16_BYTES
        if shifted:
            nbytes += padded * n * BF16_BYTES  # (windows, N, N)
    return flops, nbytes, len(blocks)


def attention_bound_seconds(arch: dict, w: int, h: int, batch: int) -> Tuple[float, int]:
    """(the least time the card could take for the attention cores of one
    forward, bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s, whichever is
    larger; the number of cores in a forward)."""
    flops, nbytes, blocks = attention_core(arch, w, h, batch)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES), blocks
