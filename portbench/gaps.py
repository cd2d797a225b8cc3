"""The device's idle time put down to the host work that caused it: the
window minus the union of the device's intervals, split by the innermost
program span open at each instant on the thread that runs the query loop,
summed by span name. Time no span covers goes under :data:`NO_SPAN`.
Nothing here imports the program.

Times are nanoseconds on the profiler's clock; the program's span records
(``raxtax_tpu_torch.utils.trace``: ``start_ns``, ``end_ns``, ``name``,
``tid``) are on the program's clock and are shifted by the offset its
recorder reports.
"""

from __future__ import annotations

NO_SPAN = "(no span)"


def idle_intervals(events: list, t0: int, t1: int) -> list:
    """``[(start, end)]`` of the window ``[t0, t1)`` in which no device
    activity of ``events`` (``(name, start_ns, duration_ns)``) ran."""
    out = []
    cur = t0
    for s, e in sorted((s, s + d) for _, s, d in events):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def innermost(spans: list) -> list:
    """``[(start, end, name)]``, disjoint and in order, of the innermost
    span open at each instant, from ``(start, end, name)`` spans of one
    thread (which nest, as blocks of one thread do)."""
    out = []
    stack: list = []  # (end, name), the innermost last
    cur = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((cur, end, top))
            cur = end
        if stack:
            out.append((cur, s, stack[-1][1]))
        stack.append((e, name))
        cur = s
    while stack:
        end, top = stack.pop()
        out.append((cur, end, top))
        cur = end
    return [x for x in out if x[1] > x[0]]


def attribute(idle: list, segments: list) -> dict:
    """Seconds of the ``idle`` intervals under each name of the disjoint,
    ordered ``segments`` (:func:`innermost`), the rest under
    :data:`NO_SPAN`."""
    by: dict = {}
    j = 0
    for s, e in idle:
        covered = 0
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            a, b, name = segments[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                by[name] = by.get(name, 0) + part
                covered += part
            k += 1
        by[NO_SPAN] = by.get(NO_SPAN, 0) + (e - s - covered)
    return {k: v / 1e9 for k, v in by.items() if v > 0}


def idle_gaps(events: list, spans: list, tid: int, offset_ns: int,
              t0: int, t1: int, n: int = 10) -> list:
    """``[[span name, seconds]]`` of the ``n`` names that hold most of the
    device's idle time in the window ``[t0, t1)``, from the spans of thread
    ``tid`` alone."""
    segs = innermost([(s["start_ns"] + offset_ns, s["end_ns"] + offset_ns,
                       s["name"]) for s in spans if s["tid"] == tid])
    by = attribute(idle_intervals(events, t0, t1), segs)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
