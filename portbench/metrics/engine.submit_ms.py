"""Host milliseconds a batch spends in phase A (``submit_batch``: the
native 8-mer pass, the exact-match lookup and the launches of the fold, the
histogram and its pinned copy), from the engine's
``phase_seconds["submit"]``, which its ``engine.submit`` span fills, over
the window."""


def read(ctx):
    if not ctx.n_batches or "submit" not in ctx.phases:
        return None
    return ctx.phases["submit"] * 1e3 / ctx.n_batches
