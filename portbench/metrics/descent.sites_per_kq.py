"""(query, node) sites handed to the max-confidence descents per thousand
queries, from the engine's ``descent.sites`` and ``queries`` counters over
the window in ``ctx.counters``, which a run without them lacks."""


def read(ctx):
    c = getattr(ctx, "counters", None)
    if not c or not c.get("queries") or "descent.sites" not in c:
        return None
    return c["descent.sites"] * 1e3 / c["queries"]
