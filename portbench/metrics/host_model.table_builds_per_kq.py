"""Probability tables the host model built (``KTableCache`` misses) per
thousand queries, from the engine's ``ktable.builds`` and ``queries``
counters over the window in ``ctx.counters``, which a run without them
lacks."""


def read(ctx):
    c = getattr(ctx, "counters", None)
    if not c or not c.get("queries") or "ktable.builds" not in c:
        return None
    return c["ktable.builds"] * 1e3 / c["queries"]
