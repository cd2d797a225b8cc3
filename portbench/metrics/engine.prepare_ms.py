"""Host milliseconds a batch spends in phase B (``prepare_batch``: the f64
top-hit model and the significance dispatch), from the engine's own
``phase_seconds["prepare"]`` over the window."""


def read(ctx):
    if not ctx.n_batches or "prepare" not in ctx.phases:
        return None
    return ctx.phases["prepare"] * 1e3 / ctx.n_batches
