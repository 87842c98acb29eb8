"""The share of the traced window in which the card idled while the loop
built a batch's annotations in Python: under `sd.predict.materialize` on
the loop's thread (`sdbench.spans`)."""

from sdbench.spans import MATERIALIZE, idle_share


def read(ctx):
    return idle_share(ctx.trace, MATERIALIZE)
