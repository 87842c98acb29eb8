"""The share of the traced window in which the card idled while the train
loop waited for the loader's next batch or staged its copy to the card:
under `sd.loader.wait` or `sd.loader.h2d` on the loop's thread
(`sdbench.spans`). A collection that the loader's coordinator thread runs
is not in the benchmark's trace: its pause counts here where it falls in
a wait."""

from sdbench.spans import LOADER, idle_share


def read(ctx):
    return idle_share(ctx.trace, LOADER)
