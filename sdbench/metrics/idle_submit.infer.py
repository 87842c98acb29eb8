"""The share of the traced window in which the card idled while the loop
submitted a batch: under `sd.predict.submit` or one of its spans (prep,
h2d, forward and decode enqueue) on the loop's thread (`sdbench.spans`)."""

from sdbench.spans import SUBMIT, idle_share


def read(ctx):
    return idle_share(ctx.trace, SUBMIT)
