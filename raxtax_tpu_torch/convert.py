"""State carried across: database fields in, resident tensors out.

- :func:`database_fields` / :func:`database_from_numpy` move a database
  between the JAX package and this one as plain numpy arrays and strings
  (neither package imports the other; the ``.rxdb`` cache file is the other
  bridge, readable by both).
- :func:`shard_fields` cuts one rank's stripe of a mesh out of those
  fields: the JAX package's ``addressable_shards`` of its sharded matrices.
- :func:`device_state` uploads what the engine keeps resident on the device:
  the k-mer-major postings matrix (block-padded, with its host block CSR,
  when the sparse fold is asked for) or, for the dense-count backend, the
  ref-major matrix; the eval-node ranges, the unit/wide or single-tip split
  and the descent CSR.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .db.database import Database, ExactIndex
from .db.taxonomy import NODE_INNER, Taxonomy
from .ops.intersect_fold import prepare_kmer_major, prepare_kmer_major_sparse
from .ops.nodeconf import bitmajor_evalpos


def database_fields(db) -> dict:
    """The fields of a ``Database`` (this package's or the JAX package's —
    only attributes are read) as numpy arrays, strings and lists."""
    tax = db.taxonomy
    return {
        "lineages": list(tax.lineages),
        "labels": list(tax.labels),
        "parent": np.asarray(tax.parent),
        "depth": np.asarray(tax.depth),
        "range_start": np.asarray(tax.range_start),
        "range_end": np.asarray(tax.range_end),
        "node_type": np.asarray(tax.node_type),
        "num_tips": int(tax.num_tips),
        "kmer_major": np.asarray(db.kmer_major),
        "ref_major": (
            None if db.ref_major is None else np.asarray(db.ref_major)
        ),
        "kmer_layout": str(db.kmer_layout),
        "seq_flat": np.asarray(db.seq_flat),
        "seq_offsets": np.asarray(db.seq_offsets),
        "exact_hashes": np.asarray(db.exact_map._hashes),
        "exact_tips": np.asarray(db.exact_map._tips),
        "exact_native": bool(db.exact_map._native),
    }


def database_from_numpy(fields: dict) -> Database:
    """Build this package's ``Database`` from :func:`database_fields`
    output. The ref-major matrix (read by the dense-count backend only) is
    carried when the source database holds one."""
    taxonomy = Taxonomy(
        lineages=list(fields["lineages"]),
        labels=list(fields["labels"]),
        parent=np.asarray(fields["parent"], np.int32),
        depth=np.asarray(fields["depth"], np.int32),
        range_start=np.asarray(fields["range_start"], np.int32),
        range_end=np.asarray(fields["range_end"], np.int32),
        node_type=np.asarray(fields["node_type"], np.uint8),
        num_tips=int(fields["num_tips"]),
    )
    seq_flat = np.asarray(fields["seq_flat"], np.uint8)
    seq_offsets = np.asarray(fields["seq_offsets"], np.int64)
    exact = ExactIndex.from_saved(
        seq_flat, seq_offsets, fields["exact_hashes"], fields["exact_tips"],
        bool(fields["exact_native"]),
    )
    return Database(
        taxonomy=taxonomy,
        ref_major=(
            None if fields.get("ref_major") is None
            else np.asarray(fields["ref_major"], np.uint32)
        ),
        kmer_major=np.asarray(fields["kmer_major"], np.uint32),
        seq_flat=seq_flat,
        seq_offsets=seq_offsets,
        exact_map=exact,
        kmer_layout=str(fields["kmer_layout"]),
    )


def shard_fields(fields: dict, mesh_shape: tuple[int, int], rank: int,
                 backend: str = "pallas") -> dict:
    """One rank's share of the database on a ``(data, model)`` mesh, as the
    JAX package's ``ShardedPipeline.create`` pads and shards it
    (``raxtax_tpu/parallel/mesh.py:290-325``); the rank's model coordinate
    is ``(rank % (data * model)) % model``. Returns ``{"matrix", "n_padded",
    "n_local", "lo"}``: for ``pallas`` the k-mer-major postings padded to
    ``model * 128`` words, for ``stream`` to ``model * 1024`` words (the
    JAX module's ``model * LANE * 8``; its row padding to ``ROW_BLOCK`` is
    not made, the port's stream fold reads the rows as they are), each cut
    to the rank's contiguous column block; for ``xla`` the ref-major rows
    padded to a multiple of ``model``, cut to the rank's row block.
    ``n_local`` tips from ``lo`` on belong to the rank."""
    from .ops.intersect_fold import BLOCK_WORDS, LANE
    from .parallel.mesh import pad_to_multiple

    d, m = mesh_shape
    m_idx = (rank % (d * m)) % m
    if backend in ("pallas", "stream"):
        km = np.asarray(fields["kmer_major"])
        width = LANE if backend == "pallas" else BLOCK_WORDS
        km = pad_to_multiple(km, m * width, axis=1)
        w_l = km.shape[1] // m
        matrix = km[:, m_idx * w_l : (m_idx + 1) * w_l]
        n_padded = km.shape[1] * 32
    elif backend == "xla":
        if fields.get("ref_major") is None:
            raise RuntimeError(
                "xla backend needs the ref-major matrix, but this database "
                "was built with with_ref_major=False (pallas/stream only); "
                "rebuild the database or pick --backend pallas"
            )
        ref = pad_to_multiple(np.asarray(fields["ref_major"]), m, axis=0)
        n_l = ref.shape[0] // m
        matrix = ref[m_idx * n_l : (m_idx + 1) * n_l]
        n_padded = ref.shape[0]
    else:
        raise ValueError(f"unknown mesh backend {backend!r}")
    n_local = n_padded // m
    return {
        "matrix": np.ascontiguousarray(matrix), "n_padded": n_padded,
        "n_local": n_local, "lo": m_idx * n_local,
    }


@dataclass
class DeviceState:
    """Tensors the engine keeps resident on ``device``."""

    device: torch.device
    num_tips: int
    layout: str  #: "packed" or "flat" (tip -> (word, bit) mapping)
    #: [65537, S, 128] int32 postings rows (None: dense-count backend)
    kmer_major3: torch.Tensor | None
    node_starts: torch.Tensor  #: [J] eval-node tip-range starts
    node_ends: torch.Tensor  #: [J]
    #: (wide_starts, wide_ends, wide_pos, tip_has_unit) or None
    split2: tuple | None
    unit_ptr: np.ndarray | None  #: host CSR tip -> unit eval positions
    unit_vals: np.ndarray | None
    range_start: torch.Tensor  #: [n_nodes] global-node tip ranges
    range_end: torch.Tensor
    child_ptr: torch.Tensor  #: [n_nodes+1] CSR over ALL children
    child_ids: torch.Tensor
    is_inner: torch.Tensor  #: [n_nodes] bool
    pad_node: int  #: a non-Inner node id (a no-op descent start)
    #: unit/wide double-f32 path: carry the overflow tips in a sideband
    #: (True) or patch them with a scatter (False)
    sideband: bool = True
    #: host block CSR of the sparse fold (None: dense fold only)
    blk_ptr: np.ndarray | None = None
    blk_ids: np.ndarray | None = None
    #: [N, 2048] int32 ref-major presence rows (dense-count backend only)
    ref_bits: torch.Tensor | None = None
    #: (inner_starts, inner_ends, inner_pos, evalpos_of_tip), the single-tip
    #: split of the double-f32 significance stage, or None; with ``bm_scan``
    #: ``evalpos_of_tip`` is in the bit-major flat order K7's output has
    split_sig: tuple | None = None


def device_state(
    db: Database, device, split2: bool = True, sparse: bool = False,
    dense_counts: bool = False, split_sig: bool = False, bm_scan: bool = False,
    matrix: bool = True,
) -> DeviceState:
    """Upload the resident state. The descent CSR is in GLOBAL node space:
    the reference's ``max_by`` ranges over all children, childless Sequence
    nodes included (src/lineage.rs:154-170). With ``sparse`` the matrix is
    padded to whole 8 x 128-word blocks and its block CSR is kept on the
    host; the other folds run on the same copy. With ``dense_counts`` the
    ref-major matrix is uploaded in place of the postings matrix.
    ``split_sig`` adds the single-tip split of the double-f32 significance
    stage, remapped for the bit-major scan with ``bm_scan``. ``matrix=False``
    uploads no matrix at all (a mesh's pipeline holds its own stripe)."""
    dev = torch.device(device)
    tax = db.taxonomy

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    eval_ids = tax.eval_ids
    split = unit_ptr = unit_vals = None
    sideband = True
    if split2:
        ws, we, wp, unit_ptr, unit_vals = tax.unit_wide_arrays()
        # the sideband's work grows with the wide boundaries, the scatter's
        # with the tips: only taxonomies where most nodes are wide keep the
        # scatter (the JAX package's rule)
        sideband = 2 * ws.size <= max(4096, db.num_tips // 2)
        split = (
            up(ws, torch.int64), up(we, torch.int64), up(wp, torch.int64),
            up((unit_ptr[1:] - unit_ptr[:-1]) > 0),
        )
    pad_node = tax.n_nodes - 1  # the last created node is a Sequence leaf
    assert tax.node_type[pad_node] != NODE_INNER
    blk_ptr = blk_ids = kmer_major3 = ref_bits = split_one = None
    if split_sig:
        split_one = tuple(up(a, torch.int64) for a in tax.split_sig_arrays())
    if not matrix:
        pass
    elif dense_counts:
        ref_bits = up(np.ascontiguousarray(db.ref_major).view(np.int32))
    elif sparse:
        kmer_major3, blk_ptr, blk_ids = prepare_kmer_major_sparse(db, dev)
    else:
        kmer_major3 = prepare_kmer_major(db, dev)
    if split_one is not None and bm_scan:
        split_one = (*split_one[:3], bitmajor_evalpos(
            split_one[3], int(kmer_major3.shape[1])))
    return DeviceState(
        device=dev,
        num_tips=db.num_tips,
        layout=db.kmer_layout,
        kmer_major3=kmer_major3,
        node_starts=up(tax.range_start[eval_ids], torch.int64),
        node_ends=up(tax.range_end[eval_ids], torch.int64),
        split2=split,
        unit_ptr=unit_ptr,
        unit_vals=unit_vals,
        range_start=up(tax.range_start, torch.int64),
        range_end=up(tax.range_end, torch.int64),
        child_ptr=up(tax.child_ptr, torch.int64),
        child_ids=up(tax.child_ids, torch.int64),
        is_inner=up(tax.node_type == NODE_INNER),
        pad_node=pad_node,
        sideband=sideband,
        blk_ptr=blk_ptr,
        blk_ids=blk_ids,
        ref_bits=ref_bits,
        split_sig=split_one,
    )
