"""Operations and bytes from shapes: the yardstick of the roofline and peak
shares. Nothing here reads the program; the architecture is the
reference's (`reference/sdnet.py`).

- `forward_flops`: the convolutions of one SDNet forward of one image,
  2 * Cin * k * k * Cout * Ho * Wo each (a multiply and an add), the stem,
  every residual block and projection, the FPN's 1x1 laterals and 3x3
  convolutions, the head. Pooling, BatchNorm, ReLU, the additions and
  the upsampling are left out, as the published counts leave them out.
- `encoder_macs`: the classifier's count as He et al. 2016 (Table 1) and
  torchvision publish it, the encoder plus the 1000-way fully connected
  layer, in multiply-adds.
- the decode stage's bytes, and kernel A's and B's, each input byte read
  once and each output byte written once (float32 maps).
"""

from __future__ import annotations

from .reference.sdnet import ARCHS, blocks, stage_channels

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense, NVIDIA's data sheet (700 W)
PEAK_HBM_BYTES = 3.35e12


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv_macs(cin, cout, k, ho, wo) -> int:
    return cin * k * k * cout * ho * wo


def _encoder(backbone: str, w: int, h: int):
    """(multiply-adds of the encoder's convolutions, the four stages' sizes)."""
    bottleneck, _ = ARCHS[backbone]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = _conv_macs(3, 64, 7, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    sizes, last = [], 1
    for i, _, cin, width, stride, proj in blocks(backbone):
        if i != last:
            sizes.append((h, w))
            last = i
        ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
        if bottleneck:
            macs += _conv_macs(cin, width, 1, h, w) + _conv_macs(width, width, 3, ho, wo)
            macs += _conv_macs(width, 4 * width, 1, ho, wo)
            out = 4 * width
        else:
            macs += _conv_macs(cin, width, 3, ho, wo) + _conv_macs(width, width, 3, ho, wo)
            out = width
        if proj:
            macs += _conv_macs(cin, out, 1, ho, wo)
        h, w = ho, wo
    sizes.append((h, w))
    return macs, sizes


def encoder_macs(backbone: str, w: int = 224, h: int = 224) -> int:
    """The classifier's multiply-adds: encoder + 1000-way fc."""
    macs, _ = _encoder(backbone, w, h)
    return macs + stage_channels(backbone)[-1] * 1000


def forward_flops(backbone: str, fpn_depth: int, n_out: int, w: int, h: int) -> int:
    """FLOPs of one SDNet forward of one (w, h) image."""
    macs, sizes = _encoder(backbone, w, h)
    c2, c3, c4, c5 = stage_channels(backbone)
    (h2, w2), (h3, w3), (h4, w4), (h5, w5) = sizes
    macs += _conv_macs(c5, fpn_depth, 1, h5, w5)
    for skip, (hs, ws) in ((c4, (h4, w4)), (c3, (h3, w3)), (c2, (h2, w2))):
        macs += _conv_macs(skip, fpn_depth, 1, hs, ws) + _conv_macs(fpn_depth, fpn_depth, 3, hs, ws)
    macs += _conv_macs(fpn_depth, n_out, 1, h2, w2)
    return 2 * macs


def train_flops(backbone: str, fpn_depth: int, n_out: int, w: int, h: int) -> int:
    """Forward + backward of one image: three forwards' FLOPs (the backward
    computes the input's and the weights' gradients, one forward each)."""
    return 3 * forward_flops(backbone, fpn_depth, n_out, w, h)


def decode_bytes(batch: int, n_labels: int, n_parts: int, grid_h: int, grid_w: int,
                 max_objects: int, max_parts: int) -> int:
    """What the decode needs: the float32 heatmaps read once, the offsets at
    the K + P picks and the embeddings at the P parts read once, the four
    outputs written once (anchors (B, K, 4) and parts (B, P, 6) float32,
    parents int32, valid flags one byte)."""
    maps = batch * (n_labels + n_parts) * grid_h * grid_w * 4
    gathers = batch * (2 * (max_objects + max_parts) + 2 * max_parts) * 4
    outputs = batch * (max_objects * 4 * 4 + max_parts * 6 * 4 + max_parts * 4 + max_parts)
    return maps + gathers + outputs


def kernel_a_bytes(planes: int, h: int, w: int) -> int:
    """Sigmoid + NMS over whole maps: float32 logits in, probabilities out."""
    return 2 * planes * h * w * 4


def kernel_b_bytes(planes: int, h: int, w: int, k: int) -> int:
    """Sigmoid + NMS + per-plane top-k: logits in, k values and indices out."""
    return planes * h * w * 4 + planes * k * 8
