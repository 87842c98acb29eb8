"""`attn_roofline.infer`: the Swin attention core's share of its roofline.
The least time the card could take for the cores of one forward of the
window's batch (`counts_swinv2.attention_bound_seconds`: bytes at 3.35
TB/s, which bound it, or FLOPs at 989 TFLOP/s), per core, times the
number of the program's `sd.swin.attn` spans in the window, over the
device time of every operation launched inside them. It reads the same
work whatever implements the core. None where the program has no such
span."""

from sdbench.counts_swinv2 import attention_bound_seconds
from sdbench.reference.swinv2 import arch_of


def read(ctx):
    calls, seconds = ctx.trace.range_device_time("sd.swin.attn")
    if not calls or seconds <= 0:
        return None
    c = ctx.config
    bound, blocks = attention_bound_seconds(arch_of(c), c["width"], c["height"],
                                            ctx.window["batch"])
    return 100.0 * calls * bound / blocks / seconds
