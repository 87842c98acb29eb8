"""The share of the traced window in which no kernel, copy or fill ran on
the card: one minus the union of the device operations' intervals over the
window's length (`trace.Reduced`)."""


def read(ctx):
    idle = ctx.trace.idle_share
    return None if idle is None else 100.0 * idle
