"""`mfu.train`: the whole train step's share of the card's bf16 peak. For
each epoch of the window, three times the analytic forward FLOPs of an
image at the epoch's multi-scale size (`counts.train_flops`) times its
images; summed, over the window, over 989 TFLOP/s."""

from sdbench.counts import PEAK_BF16_FLOPS, train_flops


def read(ctx):
    w, c = ctx.window, ctx.config
    if not w.get("epochs"):
        return None
    flops = sum(n * train_flops(c["backbone"], c["fpn_depth"], ctx.n_out, *size)
                for size, n in w["epochs"])
    return 100.0 * flops / w["seconds"] / PEAK_BF16_FLOPS
