"""K5 and the exact-f64 significance and descent stages around it.

The reference's confidence pipeline is: per-query f64 prefix sums of tip
probabilities (reference: src/lineage.rs:62-67), node confidences as prefix
differences (src/lineage.rs:114-117), and max-confidence descents compared
in f64 with last-max ties (src/lineage.rs:154-170). Byte parity of the
output hinges on f64 ROUNDING, so the prefix sum must add in tip order, one
tip after the other. The GPU has IEEE f64 in hardware: everything here works
on ``float64`` tensors directly.

- :func:`exact_cumsum` — K5, CUDA kernel ``csrc/exact_cumsum.cu``
  (``rx_exact_cumsum``). Replaces the TPU kernel ``_scan_kernel``
  (``ops/exactscan.py`` of the JAX package: ``exact_cumsum_pairs`` followed
  by ``cum_pairs_bn``), which adds u32 halves with software IEEE arithmetic.
  One lane of a walker warp carries one query's chain in a register, two
  chains per CTA, while copy warps stream tiles through a shared-memory ring
  with ``cp.async``. Bound: only ``B`` chains exist, so the dependent-add
  latency times ``N`` limits it, not the ``2 * B * N * 8`` bytes it moves. ``torch.cumsum`` is a
  parallel scan on CUDA (another rounding) and is NOT its plain version: the
  plain version is an explicit ordered loop over tips.
- :func:`dadd_chain` — one GPU thread's chain of dependent f64 adds
  (``rx_dadd_chain``, same source): the latency of one add, which times
  ``N`` is K5's floor, measured on the card at hand.
- :func:`node_conf_exact`, :func:`significant_nodes_exact`,
  :func:`max_descent_exact` — plain PyTorch in f64.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .nodeconf import SignificantSet, compact_eval_nodes, compact_unit_wide
from .planes import planes_probs, probs_to_tip_order


def exact_cumsum_plain(p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: ``cum[:, t+1] = cum[:, t] + p[:, t]``,
    one tip after the other (each step is one elementwise f64 add over the
    batch, so every chain is strictly sequential)."""
    B, N = p.shape
    pt = p.t().contiguous()  # [N, B]: one contiguous row per tip
    out = torch.zeros((N + 1, B), dtype=torch.float64, device=p.device)
    for t in range(N):
        torch.add(out[t], pt[t], out=out[t + 1])
    return out.t().contiguous()


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]


def exact_cumsum(p: torch.Tensor) -> torch.Tensor:
    """Zero-prefixed inclusive sequential-f64 prefix sum along tips:
    ``[B, N] float64 -> [B, N+1]`` with ``cum[b, t]`` the sum of tips
    ``< t``, bit-identical to a sequential host loop."""
    if p.ndim != 2 or p.dtype != torch.float64:
        raise TypeError("exact_cumsum expects a [B, N] float64 tensor")
    if not p.is_cuda:
        return exact_cumsum_plain(p)
    _build.require_cuda_tensor(p, torch.float64, "p")
    B, N = p.shape
    fn = _build.entry("exact_cumsum", "rx_exact_cumsum", _ARGTYPES)
    out = torch.empty((B, N + 1), dtype=torch.float64, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        exact_cumsum.launches += 1
        code = fn(p.data_ptr(), out.data_ptr(), B, N, stream)
    _build.check("exact_cumsum", code, "exact_cumsum")
    return out


#: kernel launches made by :func:`exact_cumsum`
exact_cumsum.launches = 0


def dadd_chain_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of :func:`dadd_chain`: the same sum by a host loop
    (Python floats are IEEE f64 rounded to nearest); no cycles (NaN)."""
    xs = [float(v) for v in x.cpu()]
    acc = 0.0
    for i in range(steps):
        acc += xs[i % 8]
    return torch.tensor([acc, float("nan")], dtype=torch.float64)


def dadd_chain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """K5's chain floor, measured: ``steps`` (a multiple of 32) dependent f64
    adds of the eight addends ``x[i % 8]`` in one GPU thread, with no memory
    traffic (``rx_dadd_chain`` in ``csrc/exact_cumsum.cu``). Returns ``[sum,
    SM cycles of the loop]`` as float64. A CPU tensor takes the plain
    version. Not on any classify path: it times what K5's walker cannot beat."""
    if x.shape != (8,) or x.dtype != torch.float64:
        raise TypeError("dadd_chain expects an [8] float64 tensor")
    if not x.is_cuda:
        return dadd_chain_plain(x, steps)
    _build.require_cuda_tensor(x, torch.float64, "x")
    fn = _build.entry(
        "exact_cumsum", "rx_dadd_chain",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    )
    out = torch.empty(2, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), out.data_ptr(), steps, stream)
    _build.check("exact_cumsum", code, "dadd_chain")
    return out


def node_conf_exact(cum: torch.Tensor, s: torch.Tensor, e: torch.Tensor):
    """Exact f64 node confidences ``fl64(cum[e] - cum[s])``. ``s``/``e`` may
    be ``[J]`` (shared across the batch) or ``[B, k]`` per-row indices."""
    if s.ndim == 1:
        return cum[:, e] - cum[:, s]
    return torch.gather(cum, 1, e) - torch.gather(cum, 1, s)


def significant_nodes_exact(
    planes: torch.Tensor,  # [B, P, S, 128] int32 counter planes
    table64: torch.Tensor,  # [B, s_max] float64 per-size probabilities
    node_starts: torch.Tensor,  # [J] eval-node range starts
    node_ends: torch.Tensor,  # [J]
    split2: tuple | None = None,  # (ws, we, wpos, tip_has_unit)
    layout: str = "flat",
    num_tips: int = 0,
):
    """Exact significance: f64 table lookup (K4) -> sequential f64 scan (K5)
    -> threshold masks on the exact f64 confidences. Returns ``(sig, cum)``:
    ``sig`` is a :class:`~.nodeconf.SignificantSet` whose device work is
    queued but not yet compacted (``sig.pull()`` does that, with the only
    host synchronisation), ``cum [B, Np+1]`` feeds
    :func:`max_descent_exact`."""
    B = planes.shape[0]
    probs_bm = planes_probs(planes, table64)
    if layout == "flat":
        probs = probs_bm.reshape(B, -1)
    else:
        probs = probs_to_tip_order(probs_bm).contiguous()
    cum = exact_cumsum(probs)
    if split2 is not None:
        sig = compact_unit_wide(
            cum, split2[0], split2[1], split2[2], split2[3], num_tips
        )
    else:
        sig = compact_eval_nodes(cum, node_starts, node_ends)
    return sig, cum


def max_descent_exact(
    cum: torch.Tensor,  # [B, N+1] float64 exact prefix sums
    b_idx: torch.Tensor,  # [M] query index per descent
    start_nodes: torch.Tensor,  # [M] GLOBAL node id to descend from
    range_start: torch.Tensor,  # [n_nodes]
    range_end: torch.Tensor,  # [n_nodes]
    child_ptr: torch.Tensor,  # [n_nodes+1] CSR pointers
    child_ids: torch.Tensor,  # [C]
    node_is_inner: torch.Tensor,  # [n_nodes] bool
) -> torch.Tensor:  # [M] final node per descent
    """Max-confidence descent with exact f64 comparisons: bit for bit the
    reference's recursion (src/lineage.rs:154-170) — child confidence
    ``fl64(cum[end] - cum[start])``, and like Rust's ``max_by`` the LAST
    maximal child wins. All sites advance one tree level per step; a step is
    a segmented arg-max over the flattened (site, child) list."""
    dev = cum.device
    cur = start_nodes.long().clone()
    b_idx = b_idx.long()
    child_ptr = child_ptr.long()
    child_ids = child_ids.long()
    range_start = range_start.long()
    range_end = range_end.long()
    while True:
        act = torch.nonzero(node_is_inner[cur]).reshape(-1)
        m = act.numel()
        if m == 0:
            return cur
        nodes = cur[act]
        lo = child_ptr[nodes]
        cnt = child_ptr[nodes + 1] - lo
        if bool((cnt == 0).any()):
            raise RuntimeError("descent reached an inner node with no child")
        site = torch.repeat_interleave(torch.arange(m, device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        within = torch.arange(site.numel(), device=dev) - first[site]
        cid = child_ids[lo[site] + within]
        q = b_idx[act][site]
        v = cum[q, range_end[cid]] - cum[q, range_start[cid]]
        vmax = torch.full((m,), -1.0, dtype=cum.dtype, device=dev)
        vmax = vmax.scatter_reduce(0, site, v, "amax", include_self=True)
        pos = torch.where(v == vmax[site], within, -1)
        best = torch.full((m,), -1, dtype=torch.long, device=dev)
        best = best.scatter_reduce(0, site, pos, "amax", include_self=True)
        cur[act] = child_ids[lo + best]
