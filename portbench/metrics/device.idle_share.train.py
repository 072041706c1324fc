"""Share of the traced training window in which no operation ran on the
device: one minus the union of the device's operation intervals over the
window."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
