"""`mfu_swinv2.infer`: the whole inference step's share of the card's bf16
peak on the Swin V2 configuration. Analytic forward FLOPs of an image at
the network's size (`counts_swinv2.forward_flops`: encoder, FPN and
head) times the images of the window, over the window, over 989 TFLOP/s."""

from sdbench.counts import PEAK_BF16_FLOPS
from sdbench.counts_swinv2 import forward_flops
from sdbench.reference.swinv2 import arch_of


def read(ctx):
    w, c = ctx.window, ctx.config
    if not w.get("images"):
        return None
    flops = forward_flops(arch_of(c), c["fpn_depth"], ctx.n_out, c["width"], c["height"])
    return 100.0 * flops * w["images"] / w["seconds"] / PEAK_BF16_FLOPS
