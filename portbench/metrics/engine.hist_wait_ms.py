"""Host milliseconds a batch waits in phase B for its histogram to reach
the host (``ready.synchronize()``: the device still folds), from the
program's ``engine.prepare.hist_wait`` span: its seconds over the window in
``ctx.span_seconds``, which a run without the program's spans lacks."""


def read(ctx):
    spent = getattr(ctx, "span_seconds", None)
    if not ctx.n_batches or not spent or "engine.prepare.hist_wait" not in spent:
        return None
    return spent["engine.prepare.hist_wait"] * 1e3 / ctx.n_batches
