"""Per cent of the window's queries that some reference holds whole
(``hist[K] > 0``), for which the host model takes its closed form, from the
engine's ``model.closed_form`` and ``queries`` counters over the window in
``ctx.counters``, which a run without them lacks."""


def read(ctx):
    c = getattr(ctx, "counters", None)
    if not c or not c.get("queries") or "model.closed_form" not in c:
        return None
    return 100.0 * c["model.closed_form"] / c["queries"]
