"""`decode_roofline.infer`: the decode stage's share of its byte roofline.
The bytes the decode needs at the batch's shapes (`counts.decode_bytes`)
at 3.35 TB/s, over the device time of every operation launched inside the
benchmark's `sdbench.decode` range around the predictor's decode call,
summed over the window's calls. It reads the same work whatever kernel
implements it."""

from sdbench.counts import PEAK_HBM_BYTES, decode_bytes


def read(ctx):
    calls, seconds = ctx.trace.range_device_time("sdbench.decode")
    if not calls or seconds <= 0:
        return None
    c = ctx.config
    gh, gw = int(c["height"] / c["down_ratio"]), int(c["width"] / c["down_ratio"])
    need = decode_bytes(ctx.window["batch"], len(c["labels"]), len(c["parts"]), gh, gw,
                        c["max_objects"], c["max_parts"])
    return 100.0 * calls * need / PEAK_HBM_BYTES / seconds
