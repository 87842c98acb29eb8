"""`attn_share.infer`: the share of the window's busy device time spent in
the Swin attention core: the device time of every operation launched
inside the program's `sd.swin.attn` spans over the union of the device's
busy intervals in the window (`trace.Reduced`). None where the program
has no such span or the trace no device operations."""


def read(ctx):
    calls, seconds = ctx.trace.range_device_time("sd.swin.attn")
    if not calls or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * seconds / ctx.trace.busy_s
