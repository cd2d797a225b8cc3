"""State carried across: database fields in, resident tensors out.

- :func:`database_fields` / :func:`database_from_numpy` move a database
  between the JAX package and this one as plain numpy arrays and strings
  (neither package imports the other; the ``.rxdb`` cache file is the other
  bridge, readable by both).
- :func:`device_state` uploads what the engine keeps resident on the device:
  the k-mer-major postings matrix, the eval-node ranges, the unit/wide split
  and the descent CSR.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .db.database import Database, ExactIndex
from .db.taxonomy import NODE_INNER, Taxonomy
from .ops.intersect_fold import prepare_kmer_major


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
        "kmer_layout": str(db.kmer_layout),
        "seq_flat": np.asarray(db.seq_flat),
        "seq_offsets": np.asarray(db.seq_offsets),
        "exact_hashes": np.asarray(db.exact_map._hashes),
        "exact_tips": np.asarray(db.exact_map._tips),
        "exact_native": bool(db.exact_map._native),
    }


def database_from_numpy(fields: dict) -> Database:
    """Build this package's ``Database`` from :func:`database_fields`
    output. The ref-major matrix is not carried: no ported path reads it."""
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
        ref_major=None,
        kmer_major=np.asarray(fields["kmer_major"], np.uint32),
        seq_flat=seq_flat,
        seq_offsets=seq_offsets,
        exact_map=exact,
        kmer_layout=str(fields["kmer_layout"]),
    )


@dataclass
class DeviceState:
    """Tensors the engine keeps resident on ``device``."""

    device: torch.device
    num_tips: int
    layout: str  #: "packed" or "flat" (tip -> (word, bit) mapping)
    kmer_major3: torch.Tensor  #: [65537, S, 128] int32 postings rows
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


def device_state(db: Database, device, split2: bool = True) -> DeviceState:
    """Upload the resident state. The descent CSR is in GLOBAL node space:
    the reference's ``max_by`` ranges over all children, childless Sequence
    nodes included (src/lineage.rs:154-170)."""
    dev = torch.device(device)
    tax = db.taxonomy

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    eval_ids = tax.eval_ids
    split = unit_ptr = unit_vals = None
    if split2:
        ws, we, wp, unit_ptr, unit_vals = tax.unit_wide_arrays()
        split = (
            up(ws, torch.int64), up(we, torch.int64), up(wp, torch.int64),
            up((unit_ptr[1:] - unit_ptr[:-1]) > 0),
        )
    pad_node = tax.n_nodes - 1  # the last created node is a Sequence leaf
    assert tax.node_type[pad_node] != NODE_INNER
    return DeviceState(
        device=dev,
        num_tips=db.num_tips,
        layout=db.kmer_layout,
        kmer_major3=prepare_kmer_major(db, dev),
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
    )
