"""`mfu.infer`: the whole inference step's share of the card's bf16 peak.
Analytic forward FLOPs of an image at the network's size (`counts.py`)
times the images of the window, over the window, over 989 TFLOP/s."""

from sdbench.counts import PEAK_BF16_FLOPS, forward_flops


def read(ctx):
    w, c = ctx.window, ctx.config
    if not w.get("images"):
        return None
    flops = forward_flops(c["backbone"], c["fpn_depth"], ctx.n_out, c["width"], c["height"])
    return 100.0 * flops * w["images"] / w["seconds"] / PEAK_BF16_FLOPS
