"""Meshes of ranks and the sharded classification pipeline.

The JAX package's 2-D ``jax.sharding.Mesh`` (``raxtax_tpu/parallel/mesh.py``)
on ``torch.distributed``:

- ``data`` axis: query batches are data-parallel (the reference's only
  parallelism);
- ``model`` axis: the reference k-mer presence matrix, the "model" of this
  system, is sharded by reference columns (postings) or rows (ref-major).
  Each shard computes partial counts, histograms and node confidences, and
  the partials merge with sums over the model axis.

**The mapping.** One rank is one process and one device
(``parallel/multihost.py``). A mesh ``(d, m)`` is ``d * m`` consecutive
ranks in the row-major order of the JAX package's
``np.asarray(devices).reshape(d, m)``: mesh rank ``d_idx * m + m_idx``. The
world is cut into ``world / (d * m)`` such meshes (independent meshes; the
global mesh is the one mesh of the whole world). Each rank holds two process
groups, made by every rank of the world in one order: the *model* group
(the ranks of its ``d_idx``) and the *data* group (the ranks of its
``m_idx``). The JAX collectives become methods of :class:`Mesh`:

==========================================  ===============================
JAX                                         port
==========================================  ===============================
``jax.lax.psum(x, "model")``                ``mesh.psum(x, "model")``:
                                            ``all_reduce(SUM)``
``jax.lax.pmin(x, "data")``                 ``mesh.pmin(x, "data")``:
                                            ``all_reduce(MIN)``
``all_gather(x, axis, dim, tiled=True)``    ``mesh.all_gather(x, axis,
                                            dim)``: a list, then ``cat``
==========================================  ===============================

NCCL runs them on the device. Gloo takes CUDA tensors for some collectives
and operations only, so under gloo (two ranks sharing one card) every
collective on a CUDA tensor copies it through pinned host memory, one rule
for all of them, counted in :data:`COUNTERS` (NCCL's path makes no copy). A
mesh of one rank still makes real collective calls.

**The stages** (:class:`ShardedPipeline`) run the single-device kernels on
each rank's stripe with its own widths: the ``pallas`` backend gathers the
rank's postings rows and folds them (K9), ``stream`` folds row-sorted pairs
of the rank's own queries (K10), both then zero the exact matches' local
tips, count the histogram (K3) over the stripe's ``n_local`` tips and sum it
over the model axis; ``xla`` makes dense counts of the rank's ref-major row
block. Significance is the double-f32 one with the full-width f32 table (K4,
or a gather of dense counts), the scan is K6 where ``n_local`` is a multiple
of 128 (always for the planes backends) and the pairwise tree elsewhere.

**What is replaced, not ported.** The JAX module's escape to virtual CPU
devices when a mesh is larger than the chips (``mesh.py:203-215``) becomes
ranks: a mesh larger than the world raises. ``_replicate`` (an all-gather
over the data axis of the per-batch outputs, for multi-process meshes)
becomes a host all-gather on every mesh: every rank's host receives the
whole batch's outputs and runs the host stages on them, and only the writer
writes. ``threshold_set`` (a top-k of a sticky width) becomes ``nonzero`` on
each shard, which has no width to outgrow; the per-shard lists differ in
length, so their counts are gathered first, then the lists padded to the
longest.

Floating point. A sum of two f32 values does not depend on the order of its
addends, so with ``model <= 2`` every merged value (the hi plane of the
confidences, the lo plane at the selected entries, the descent's child
confidences) has the JAX package's bits. The data-axis merges are exact at
any size (one owner's value plus zeros, and a minimum). With more model
shards NCCL's or gloo's order is not XLA's; the engine's mesh margins
(``CONF_RISK_MARGIN_MESH``, ``DESCENT_MARGIN_SAFE_MESH``) cover both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import multihost
from ..ops.nodeconf import (
    SIG_THRESHOLD,
    _dd_sub,
    _pull_parts,
    gather_table,
    max_descent,
    node_conf_dd,
    tip_prob_cumsum_dd,
)

#: ``host_copies``: CUDA tensors copied through pinned host memory for a
#: gloo collective since start-up
COUNTERS = {"host_copies": 0}


def mesh_shape(spec: str, n: int) -> tuple[int, int]:
    """``(data, model)`` of ``spec`` ("<data>,<model>") over ``n`` ranks;
    an empty spec puts every rank on the model axis (database sharding).
    Raises ``ValueError`` for a malformed spec or one larger than ``n``."""
    if not spec:
        return 1, n
    try:
        d, m = (int(x) for x in spec.split(","))
    except ValueError:
        raise ValueError(
            f"mesh {spec!r} is not '<data>,<model>' (e.g. '2,4')"
        ) from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {spec!r} has an axis below 1")
    if d * m > n:
        raise ValueError(f"mesh {d}x{m} > {n} available ranks")
    return d, m


def mesh_grid(d: int, m: int, world: int) -> np.ndarray:
    """``[world / (d*m), d, m]``: the global ranks of each mesh of the
    world, row-major within a mesh."""
    k = d * m
    if world % k:
        raise ValueError(
            f"a world of {world} ranks is no whole number of {d}x{m} meshes"
        )
    return np.arange(world).reshape(world // k, d, m)


def mesh_plan(spec: str, world: int, global_mesh: bool = False):
    """``(data, model)`` of the meshes a run forms, or None when every rank
    runs the single-device engine (no ``--mesh``, no ``--global-mesh`` over
    several ranks: the JAX rule "a mesh forms when --mesh is set or there
    are several local devices", with one device per rank). A global mesh
    spans the whole world (an empty spec: ``1 x world``); independent meshes
    cut it into whole meshes. Raises ``ValueError`` otherwise."""
    if global_mesh and world > 1:
        d, m = mesh_shape(spec, world)
        if d * m != world:
            raise ValueError(
                f"--global-mesh spans the world of {world} ranks; mesh "
                f"{d}x{m} covers {d * m}"
            )
        return d, m
    if not spec:
        return None
    d, m = mesh_shape(spec, world)
    mesh_grid(d, m, world)
    return d, m


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        # a base-class view: a database loaded from its cache holds
        # np.memmap arrays, whose slices would stay memmaps
        return arr.view(np.ndarray) if type(arr) is not np.ndarray else arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


@dataclass(eq=False)
class Mesh:
    """This rank's view of its mesh: the shape, its coordinates, its groups
    and the collectives over them."""

    shape: dict  #: {"data": d, "model": m}
    coords: tuple  #: (d_idx, m_idx) of this rank
    ranks: np.ndarray  #: [d, m] global ranks of this mesh
    device: torch.device
    backend: str  #: "nccl" or "gloo"
    groups: dict  #: the "data" and the "model" group of this rank

    @property
    def mesh_rank(self) -> int:
        return self.coords[0] * self.shape["model"] + self.coords[1]

    def _collective(self, x: torch.Tensor, run) -> torch.Tensor:
        if self.backend == "gloo" and x.is_cuda:
            COUNTERS["host_copies"] += 1
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return run(host).to(x.device)
        return run(x.contiguous())

    def _reduce(self, x, axis: str, op):
        def run(t):
            t = t.clone()
            dist.all_reduce(t, op, group=self.groups[axis])
            return t

        return self._collective(x, run)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0):
        """The axis's ranks' ``x`` concatenated along ``dim`` in rank order
        (the JAX ``all_gather(..., tiled=True)``)."""
        def run(t):
            outs = [torch.empty_like(t) for _ in range(self.shape[axis])]
            dist.all_gather(outs, t, group=self.groups[axis])
            return torch.cat(outs, dim=dim)

        return self._collective(x, run)

    def all_gather_ragged(self, xs: list, axis: str) -> list:
        """1-D tensors of one length per rank (it may differ between ranks),
        each concatenated over the axis's ranks in rank order: the lengths
        are gathered first, then the tensors padded to the longest."""
        n = torch.tensor([xs[0].shape[0]], dtype=torch.int64, device=xs[0].device)
        sizes = self.all_gather(n, axis).tolist()
        top = max(sizes)
        if top == 0:
            return [x[:0] for x in xs]
        out = []
        for x in xs:
            pad = x.new_zeros(top - x.shape[0])
            g = self.all_gather(torch.cat([x, pad]), axis)
            out.append(torch.cat(
                [g[i * top : i * top + s] for i, s in enumerate(sizes)]
            ))
        return out


def make_mesh(spec: str = "", device=None) -> Mesh:
    """This rank's mesh of ``spec`` ("<data>,<model>"; empty: ``1 x world``).

    The world is cut into consecutive meshes of ``data * model`` ranks;
    every rank of the world must call this with the same spec at the same
    point (it makes every mesh's groups, in one order). Without an
    initialized world, this process becomes a world of one
    (``multihost.initialize_single``). ``device`` defaults to the rank's
    GPU and raises without one; pass ``"cpu"`` to run on the CPU. Raises
    ``ValueError`` for a malformed spec, one larger than the world, or a
    world that is no whole number of such meshes."""
    dev = multihost.rank_device(device)
    if not dist.is_initialized():
        multihost.initialize_single(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    d, m = mesh_shape(spec, world)
    grid = mesh_grid(d, m, world)
    groups: dict = {}
    for g in range(grid.shape[0]):
        for i in range(d):
            pg = dist.new_group(grid[g, i].tolist(), timeout=multihost.TIMEOUT)
            if rank in grid[g, i]:
                groups["model"] = pg
        for j in range(m):
            pg = dist.new_group(grid[g, :, j].tolist(), timeout=multihost.TIMEOUT)
            if rank in grid[g, :, j]:
                groups["data"] = pg
    r = rank % (d * m)
    return Mesh(
        shape={"data": d, "model": m}, coords=(r // m, r % m),
        ranks=grid[rank // (d * m)], device=dev, backend=dist.get_backend(),
        groups=groups,
    )


@dataclass(eq=False)
class MeshSignificantSet:
    """The significant set of a batch, merged over the mesh by :meth:`pull`.

    ``merged`` parts are ``(conf_hi [b_l, n] already summed over model,
    starts [n], ends [n], codes [n])`` on this shard's clipped ranges: their
    low words are computed at the selected entries only and summed over
    model there. ``local`` parts are ``(mask [b_l, n_local], codes [n_local],
    probs)``: single tips, which only their owning shard sees (their
    partial confidence is exactly 0 on every other shard), gathered over
    model as lists."""

    mesh: Mesh
    batch: int
    cum: tuple  #: (cum_hi, cum_lo) [b_l, n_local + 1]
    merged: list
    local: list

    def pull(self):
        """``(off int64 [B+1], idx int32, hi f32, lo f32)`` of the whole
        batch on every rank; entries of query b are ``[off[b], off[b+1])``."""
        mesh = self.mesh
        cum_hi, cum_lo = self.cum
        thr = torch.full((), SIG_THRESHOLD, dtype=torch.float32,
                         device=cum_hi.device)
        rows, codes, his, los = [], [], [], []
        for conf, starts, ends, code in self.merged:
            r, j = torch.nonzero(conf >= thr, as_tuple=True)
            s, e = starts[j], ends[j]
            lo = _dd_sub(cum_hi[r, e], cum_lo[r, e], cum_hi[r, s], cum_lo[r, s])[1]
            rows.append(r)
            codes.append(code[j])
            his.append(conf[r, j])
            # the model group's ranks selected the same entries (their
            # conf_hi is one merged tensor): all skip or none
            los.append(mesh.psum(lo, "model") if lo.numel() else lo)
        for mask, code, probs in self.local:
            r, j = torch.nonzero(mask, as_tuple=True)
            r, c, h = mesh.all_gather_ragged([r, code[j], probs[r, j]], "model")
            rows.append(r)
            codes.append(c)
            his.append(h)
            los.append(torch.zeros_like(h))
        b_l = cum_hi.shape[0]
        r = torch.cat(rows) + mesh.coords[0] * b_l
        r, c, h, lo = mesh.all_gather_ragged(
            [r, torch.cat(codes), torch.cat(his), torch.cat(los)], "data"
        )
        return _pull_parts(self.batch, [r], [c], [[h], [lo]])


@dataclass(eq=False)
class ShardedPipeline:
    """Mesh-parallel count / histogram / significance / descent stages.

    Holds this rank's stripe of the database on its device (and, in
    ``state``, the small replicated arrays); the per-batch methods mirror the
    single-device stages of ``engine/device.py`` and are called by every
    rank of the mesh in the same order, each with the whole batch's host
    inputs."""

    mesh: Mesh
    n_padded: int
    backend: str  #: "xla" (dense counts), "pallas" (K9) or "stream" (K10)
    #: this rank's column stripe of the postings, [65537, S_l, 128] int32
    kmer_major3: torch.Tensor | None
    #: this rank's block of ref-major rows, [n_local, 2048] int32
    ref_bits: torch.Tensor | None
    #: the replicated state (node ranges, descent CSR, unit CSR) as the
    #: single-device engine keeps it (``convert.DeviceState``, no matrix)
    state: object
    #: unit/wide split (default): (wide_starts, wide_ends, wide_pos,
    #: tip_has_unit [n_padded])
    split2: tuple | None = None
    #: single-tip split: (inner_starts, inner_ends, inner_pos,
    #: evalpos_of_tip [n_padded])
    split: tuple | None = None

    @classmethod
    def create(cls, db, mesh: Mesh, backend: str = "xla", split2: bool = True,
               split_sig: bool = False) -> "ShardedPipeline":
        """Upload this rank's stripe. ``split2`` (the unit/wide split) is
        taken before ``split_sig`` (the single-tip split), as the
        single-device dispatch does; the JAX mesh takes ``split_sig``
        first. The output is the same either way."""
        import os

        from ..convert import device_state, shard_fields

        if backend in ("pallas", "stream") and db.kmer_layout != "packed":
            # model shards own contiguous reference-column blocks, which
            # only the packed layout provides
            raise RuntimeError(
                "sharded pipeline needs the packed kmer-major layout; "
                "convert with db.database.ensure_kmer_layout(db, 'packed')"
            )
        model = mesh.shape["model"]
        part = shard_fields(
            {"kmer_major": db.kmer_major, "ref_major": db.ref_major},
            (mesh.shape["data"], model), mesh.mesh_rank, backend,
        )
        # Per-shard memory budget (bytes): a database larger than one
        # device must shard over the model axis; the guard turns a would-be
        # device out-of-memory error into an actionable one
        budget = int(os.environ.get("RAXTAX_SHARD_HBM_BUDGET", "0") or 0)
        if budget and part["matrix"].nbytes > budget:
            raise RuntimeError(
                f"database shard of {part['matrix'].nbytes} bytes exceeds the "
                f"per-device budget RAXTAX_SHARD_HBM_BUDGET={budget}; "
                f"increase the model axis (currently {model})"
            )
        dev = mesh.device
        n_padded = part["n_padded"]
        state = device_state(
            db, dev, split2=split2, split_sig=split_sig and not split2,
            matrix=False,
        )
        mat = torch.from_numpy(part["matrix"].view(np.int32)).to(dev)
        kmer_major3 = ref_bits = None
        if backend == "xla":
            ref_bits = mat
        else:
            kmer_major3 = mat.reshape(mat.shape[0], -1, 128)

        def padded(a, fill):
            out = torch.full((n_padded,), fill, dtype=a.dtype, device=dev)
            out[: a.shape[0]] = a
            return out

        sp2 = sps = None
        if state.split2 is not None:
            sp2 = state.split2[:3] + (padded(state.split2[3], False),)
        elif state.split_sig is not None:
            sps = state.split_sig[:3] + (padded(state.split_sig[3], -1),)
        return cls(
            mesh=mesh, n_padded=n_padded,
            backend=backend, kmer_major3=kmer_major3, ref_bits=ref_bits,
            state=state, split2=sp2, split=sps,
        )

    @property
    def n_local(self) -> int:
        return self.n_padded // self.mesh.shape["model"]

    @property
    def lo(self) -> int:
        """This shard's first global tip."""
        return self.mesh.coords[1] * self.n_local

    def rows(self, batch: int) -> slice:
        """This rank's queries of a batch (the batch is a multiple of the
        data axis)."""
        b_l = batch // self.mesh.shape["data"]
        return slice(self.mesh.coords[0] * b_l, (self.mesh.coords[0] + 1) * b_l)

    def _up(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.mesh.device.type == "cuda":
            return t.pin_memory().to(self.mesh.device, non_blocking=True)
        return t

    # -- stage 1: counts + histogram ------------------------------------

    def counts_and_hist(self, kmer_idx: np.ndarray, exact_ids, s_max: int,
                        query_bits: np.ndarray | None = None):
        """``(counts, hist)``: this rank's counter planes ``[b_l, P, S_l,
        128]`` (dense counts ``[b_l, n_local]`` for ``xla``) and the whole
        batch's histogram ``[B, s_max]``, summed over model and gathered
        over data. Bucket 0 still holds the padded tips: the caller takes
        ``n_padded - num_tips`` out. ``exact_ids`` ``[B, E]`` (-1-padded) or
        None; ``query_bits`` ``[B, 2048]`` for ``xla``."""
        from ..ops.histogram import intersection_histogram
        from ..ops.intersect_fold import intersection_planes_gathered
        from ..ops.intersect_stream import intersection_planes_stream
        from ..ops.intersect_xla import intersection_counts_xla, zero_reference_ids
        from ..ops.planes import planes_histogram, zero_tips_in_planes

        rows = self.rows(kmer_idx.shape[0])
        ids = None
        if exact_ids is not None:
            e = np.asarray(exact_ids[rows], np.int64)
            ids = self._up(np.where(
                (e >= self.lo) & (e < self.lo + self.n_local), e - self.lo, -1
            ))
        if self.backend == "xla":
            qb = np.ascontiguousarray(query_bits[rows]).view(np.int32)
            counts = intersection_counts_xla(self._up(qb), self.ref_bits)
            if ids is not None:
                counts = zero_reference_ids(counts, ids)
            hist = intersection_histogram(counts, s_max)
        else:
            kidx = self._up(kmer_idx[rows])
            k_pad = kmer_idx.shape[1]
            fold = (
                intersection_planes_stream if self.backend == "stream"
                else intersection_planes_gathered
            )
            counts = fold(kidx, self.kmer_major3, max_count=k_pad)
            if ids is not None:
                counts = zero_tips_in_planes(counts, ids)
            # every tip of the stripe counts here; the padding comes out on
            # the host
            hist = planes_histogram(counts, s_max, self.n_local)
        hist = self.mesh.all_gather(self.mesh.psum(hist, "model"), "data")
        return counts, hist

    # -- stage 2: significance ------------------------------------------

    def significant(self, counts: torch.Tensor, table: torch.Tensor):
        """``(sig, cum0)``: a :class:`MeshSignificantSet` of the batch
        (``table`` ``[B, s_max]`` f32 on this rank's device) and this
        shard's ``(cum_hi, cum_lo)`` for the descents."""
        from ..ops.planes import planes_probs, probs_to_tip_order

        mesh = self.mesh
        tab = table[self.rows(table.shape[0])]
        if self.backend == "xla":
            probs = gather_table(counts, tab)
        else:
            # the full-width f32 lookup: exact for every count, no overflow
            # lists under a mesh
            probs = probs_to_tip_order(planes_probs(counts, tab)).contiguous()
        cum_hi, cum_lo = tip_prob_cumsum_dd(probs)
        lo, n_l = self.lo, self.n_local
        thr = torch.full((), SIG_THRESHOLD, dtype=torch.float32, device=probs.device)

        def merged(starts, ends, codes):
            s = torch.clamp(starts - lo, 0, n_l)
            e = torch.clamp(ends - lo, 0, n_l)
            conf = mesh.psum(node_conf_dd(cum_hi, cum_lo, s, e)[0], "model")
            return conf, s, e, codes

        tips = torch.arange(n_l, device=probs.device)
        parts, local = [], []
        if self.split2 is not None:
            ws, we, wp, has_unit = self.split2
            if ws.numel():
                parts.append(merged(ws, we, wp))
            local.append((
                (probs >= thr) & has_unit[lo : lo + n_l][None, :],
                -(lo + tips + 2), probs,
            ))
        elif self.split is not None:
            i_s, i_e, i_p, evalpos = self.split
            if i_s.numel():
                parts.append(merged(i_s, i_e, i_p))
            ev = evalpos[lo : lo + n_l]
            local.append(((probs >= thr) & (ev >= 0)[None, :], ev, probs))
        else:
            starts = self.state.node_starts
            parts.append(merged(
                starts, self.state.node_ends,
                torch.arange(starts.shape[0], device=probs.device),
            ))
        sig = MeshSignificantSet(
            mesh=mesh, batch=table.shape[0], cum=(cum_hi, cum_lo),
            merged=parts, local=local,
        )
        return sig, (cum_hi, cum_lo)

    # -- stage 3: descents and count rows --------------------------------

    def _owned(self, b: torch.Tensor, b_l: int):
        local = b - self.mesh.coords[0] * b_l
        owned = (local >= 0) & (local < b_l)
        return owned, torch.clamp(local, 0, b_l - 1)

    def descend(self, cum0, b_arr, start_arr) -> tuple[np.ndarray, np.ndarray]:
        """``(final node ids [M], min descent margins [M])`` of the
        (query, start node) sites. Every data rank runs every descent, on a
        clamped local query index where it does not own the query; the
        finals are owner-masked and summed over data, the margins take the
        minimum over data. The per-step child confidences are summed over
        model inside the descent."""
        mesh, st = self.mesh, self.state
        dev = cum0[0].device
        b = torch.as_tensor(np.asarray(b_arr), dtype=torch.int64, device=dev)
        start = torch.as_tensor(np.asarray(start_arr), dtype=torch.int64, device=dev)
        owned, lb = self._owned(b, cum0[0].shape[0])
        s = torch.clamp(st.range_start - self.lo, 0, self.n_local)
        e = torch.clamp(st.range_end - self.lo, 0, self.n_local)
        finals, margins = max_descent(
            cum0, lb, start, s, e, st.child_ptr, st.child_ids, st.is_inner,
            merge=lambda v: mesh.psum(v, "model"),
        )
        finals = mesh.psum(torch.where(owned, finals, 0), "data")
        inf = torch.full_like(margins, float("inf"))
        margins = mesh.pmin(torch.where(owned, margins, inf), "data")
        return finals.cpu().numpy(), margins.cpu().numpy()

    def gather_rows(self, counts: torch.Tensor, queries: list[int]) -> np.ndarray:
        """``[len(queries), n_padded]`` int32 exact counts of the selected
        queries (of the whole batch) in tip order, on every rank: an
        owner-masked take, a sum over data, a gather over model on the tip
        axis, then the planes decoded."""
        from ..ops.planes import decode_plane_rows

        mesh = self.mesh
        idx = torch.as_tensor(queries, dtype=torch.int64, device=counts.device)
        owned, local = self._owned(idx, counts.shape[0])
        sel = counts.index_select(0, local)
        keep = owned.reshape((-1,) + (1,) * (sel.ndim - 1))
        sel = mesh.psum(torch.where(keep, sel, torch.zeros_like(sel)), "data")
        if self.backend == "xla":
            return mesh.all_gather(sel, "model", dim=1).to(torch.int32).cpu().numpy()
        full = mesh.all_gather(sel, "model", dim=2)
        return decode_plane_rows(full, list(range(len(queries)))).cpu().numpy()
