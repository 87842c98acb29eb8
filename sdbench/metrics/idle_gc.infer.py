"""The share of the traced window in which the card idled while the garbage
collector ran: under an `sd.gc.*` span on any thread (`sdbench.spans`)."""

from sdbench.spans import GC, idle_share


def read(ctx):
    return idle_share(ctx.trace, (GC,))
