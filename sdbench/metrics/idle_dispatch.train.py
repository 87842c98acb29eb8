"""The share of the traced window in which the card idled while the host
enqueued a train step: under `sd.train.step` or one of its phases
(augment, encode, forward, backward, optimizer) on the loop's thread
(`sdbench.spans`). A collection that the loader's coordinator thread runs
is not in the benchmark's trace: its pause counts here where it falls in
a step."""

from sdbench.spans import DISPATCH, idle_share


def read(ctx):
    return idle_share(ctx.trace, DISPATCH)
