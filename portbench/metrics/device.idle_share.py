"""Per cent of the window in which no kernel, copy or set ran on the
device: one minus the union of the profiler's device intervals over the
window's length."""


def read(ctx):
    if not ctx.events or not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
