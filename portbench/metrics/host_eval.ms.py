"""Host milliseconds a batch spends in the native evaluation and formatting
(``native.evaluate_batch``), from the engine's
``phase_seconds["finalize_eval"]`` over the window."""


def read(ctx):
    if not ctx.n_batches or "finalize_eval" not in ctx.phases:
        return None
    return ctx.phases["finalize_eval"] * 1e3 / ctx.n_batches
