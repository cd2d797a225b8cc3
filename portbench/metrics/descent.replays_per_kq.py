"""Queries the engine replayed on the host (descents and rounding-risk
confidences) per thousand queries, from the ``host_replays`` counter over
the window."""


def read(ctx):
    if not ctx.queries or ctx.host_replays is None:
        return None
    return ctx.host_replays * 1e3 / ctx.queries
