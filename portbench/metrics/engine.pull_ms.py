"""Host milliseconds a batch spends pulling its significant set in phase C
(``finalize_batch``; includes the wait for the device), from the engine's
``phase_seconds["finalize_pull"]`` over the window."""


def read(ctx):
    if not ctx.n_batches or "finalize_pull" not in ctx.phases:
        return None
    return ctx.phases["finalize_pull"] * 1e3 / ctx.n_batches
