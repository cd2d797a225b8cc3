"""Flattened lineage taxonomy.

TPU-first re-design of the reference's pointer tree (reference: src/tree.rs).
Instead of `Node { label, confidence_range, children, node_type }` objects we
store one struct-of-arrays taxonomy: per-node `(range_start, range_end,
parent, depth, node_type)` plus a CSR child index. Confidence of any node is
then a contiguous range sum over per-tip probabilities — an O(1) prefix-sum
gather on device.

Construction faithfully mirrors `Tree::new` (src/tree.rs:47-140):

- (lineage, sequence) pairs are stably sorted by lineage string;
- the tree is grown left-to-right; at each level the new record is matched
  against the *last child* of the current node by label (src/tree.rs:77-96);
- each record appends one `Sequence` node below its final taxon node with a
  one-tip range (src/tree.rs:102-107);
- `confidence_range` of every node on the path is extended to the current tip.

Tip index == position in the lineage-sorted record order (`num_tips` tips).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NODE_INNER = 0  # reference: NodeType::Inner
NODE_TAXON = 1  # reference: NodeType::Taxon
NODE_SEQUENCE = 2  # reference: NodeType::Sequence

ROOT = 0  #: node id of the synthetic root ("root", NodeType::Inner)


@dataclass
class Taxonomy:
    """Struct-of-arrays lineage tree over `num_tips` reference records."""

    lineages: list[str]  #: sorted lineage string per tip
    labels: list[str]  #: per-node level label (root is "root")
    parent: np.ndarray  #: int32 [n_nodes], parent[ROOT] == -1
    depth: np.ndarray  #: int32 [n_nodes], depth[ROOT] == 0
    range_start: np.ndarray  #: int32 [n_nodes] inclusive tip range start
    range_end: np.ndarray  #: int32 [n_nodes] exclusive tip range end
    node_type: np.ndarray  #: uint8 [n_nodes]
    num_tips: int

    # CSR over *eval nodes* (all nodes except childless Sequence leaves):
    # children of node i are child_ids[child_ptr[i]:child_ptr[i+1]], in
    # creation (== DFS/lineage) order.
    child_ptr: np.ndarray = field(default=None)  # int64 [n_nodes+1]
    child_ids: np.ndarray = field(default=None)  # int32

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    def __post_init__(self):
        if self.child_ptr is None:
            self._build_csr()
        if not hasattr(self, "eval_ids") or self.eval_ids is None:
            self._build_eval_view()

    def _build_csr(self):
        n = self.n_nodes
        counts = np.zeros(n + 1, dtype=np.int64)
        valid = self.parent >= 0
        np.add.at(counts, self.parent[valid] + 1, 1)
        self.child_ptr = np.cumsum(counts)
        order = np.argsort(self.parent[valid], kind="stable")
        self.child_ids = np.nonzero(valid)[0].astype(np.int32)[order]

    def _build_eval_view(self):
        """Eval nodes: every node that participates in confidence evaluation.

        Childless Sequence nodes are excluded — they never affect the output
        (they are neither Taxon leaves nor Inner nodes, so eval_recurse at
        src/lineage.rs:119-179 can neither emit them nor fall back through
        them, and their significance flag is provably irrelevant for Taxon
        parents). Sequence nodes *with* children (degenerate lineages where a
        taxon label equals its parent's) are kept.
        """
        has_children = np.diff(self.child_ptr) > 0
        keep = (self.node_type != NODE_SEQUENCE) | has_children
        keep[ROOT] = True
        self.eval_ids = np.nonzero(keep)[0].astype(np.int32)
        # position of node in eval view, -1 if excluded
        self.eval_pos = np.full(self.n_nodes, -1, dtype=np.int32)
        self.eval_pos[self.eval_ids] = np.arange(
            self.eval_ids.shape[0], dtype=np.int32
        )

    def children(self, node: int) -> np.ndarray:
        return self.child_ids[self.child_ptr[node] : self.child_ptr[node + 1]]

    def subtree_fraction(self, node: int) -> float:
        """Expected confidence of a node under the uniform prior:
        subtree tip count / num_tips (reference: src/lineage.rs:137-139)."""
        return (
            float(self.range_end[node] - self.range_start[node]) / self.num_tips
        )

    def split_sig_arrays(self):
        """Structures for split significance compaction
        (ops/nodeconf._compact_split).

        Partitions the eval view into single-tip nodes (range length 1 —
        the per-record Taxon leaves, typically ~7/8 of all eval nodes)
        whose confidence is exactly ``probs[tip]``, and the remaining
        "inner" nodes that need cumsum boundary gathers. Each tip is
        assigned at most ONE single-tip node (the first in eval order);
        further single-tip nodes on the same tip — degenerate lineages
        where a child spans its parent's whole range — stay on the inner
        path so no eval node is ever dropped.

        Returns ``(inner_starts, inner_ends, inner_pos, evalpos_of_tip)``,
        all int32: per-inner-node tip ranges and eval positions, and a
        [num_tips] map tip -> eval position of its single-tip node (-1
        when covered by the inner part instead).
        """
        ids = self.eval_ids
        s = self.range_start[ids].astype(np.int32)
        e = self.range_end[ids].astype(np.int32)
        pos = np.arange(ids.shape[0], dtype=np.int32)
        single = (e - s) == 1
        tips = s[single]
        first = np.unique(tips, return_index=True)[1]
        evalpos_of_tip = np.full(self.num_tips, -1, dtype=np.int32)
        evalpos_of_tip[tips[first]] = pos[single][first]
        covered = np.zeros(ids.shape[0], dtype=bool)
        covered[pos[single][first]] = True
        inner = ~covered
        return s[inner], e[inner], pos[inner], evalpos_of_tip

    def unit_wide_arrays(self):
        """Structures for the generalized split significance compaction
        (ops/nodeconf — unit/wide partition).

        Every eval node with range length 1 is a UNIT node: its confidence
        is exactly ``probs[tip]``, and a tip can host SEVERAL unit nodes
        (degenerate lineages — a 1-record species, its genus, ...; at 1M
        synthetic references HALF of all eval nodes are 1-record species,
        which the single-slot split above still pays boundary gathers
        for). The few remaining WIDE nodes (range length > 1) need cumsum
        boundary gathers.

        Returns ``(wide_starts, wide_ends, wide_pos, unit_ptr, unit_vals)``
        int32: per-wide-node tip ranges + eval positions, and a CSR
        mapping tip -> ALL its unit nodes' eval positions
        (``unit_vals[unit_ptr[t]:unit_ptr[t+1]]``).
        """
        ids = self.eval_ids
        s = self.range_start[ids].astype(np.int32)
        e = self.range_end[ids].astype(np.int32)
        pos = np.arange(ids.shape[0], dtype=np.int32)
        unit = (e - s) == 1
        wide = ~unit
        tips = s[unit]
        order = np.argsort(tips, kind="stable")
        unit_vals = pos[unit][order]
        counts = np.bincount(tips, minlength=self.num_tips)
        unit_ptr = np.zeros(self.num_tips + 1, dtype=np.int64)
        np.cumsum(counts, out=unit_ptr[1:])
        return (
            s[wide], e[wide], pos[wide],
            unit_ptr, unit_vals.astype(np.int32),
        )

    def path_from(self, ancestor: int, node: int) -> list[int]:
        """Nodes strictly below `ancestor` down to and including `node`."""
        path = []
        cur = int(node)
        while cur != int(ancestor):
            path.append(cur)
            cur = int(self.parent[cur])
            if cur < 0:
                raise ValueError("node is not a descendant of ancestor")
        return path[::-1]


def sort_records(
    lineages: list[str], sequences: list[np.ndarray]
) -> tuple[list[str], list[np.ndarray]]:
    """Stable sort of (lineage, sequence) pairs by lineage string.

    Mirrors src/tree.rs:53-54 (`sort_by` on the lineage, which is stable).
    Comparison is on UTF-8 bytes, exactly like Rust `str::cmp`.
    """
    order = sorted(
        range(len(lineages)), key=lambda i: lineages[i].encode("utf-8")
    )
    return [lineages[i] for i in order], [sequences[i] for i in order]


def build_taxonomy(sorted_lineages: list[str]) -> Taxonomy:
    """Build the flattened tree from lineage-sorted records.

    Implements the exact "match against the last child" walk of
    src/tree.rs:67-127 with a rightmost-path stack: because children are only
    ever appended at the end, the current rightmost path is a stack and the
    per-level label comparison against `get_last_child_label` is a comparison
    against the stack entry at that depth.
    """
    labels = ["root"]
    parent = [-1]
    depth = [0]
    range_start = [0]
    range_end = [0]
    node_type = [NODE_INNER]

    # stack[d] = node id of the rightmost node at depth d+1 (root excluded)
    stack: list[int] = []
    stack_labels: list[str] = []

    from ..utils.logging import Progress

    meter = Progress(len(sorted_lineages), "Building lineage tree...")
    for tip, lineage in enumerate(sorted_lineages):
        meter.inc()
        levels = lineage.split(",")
        last = len(levels) - 1
        for lvl, label in enumerate(levels):
            if lvl < len(stack) and stack_labels[lvl] == label:
                node = stack[lvl]
                range_end[node] = tip + 1
            else:
                del stack[lvl:]
                del stack_labels[lvl:]
                node = len(labels)
                labels.append(label)
                parent.append(stack[lvl - 1] if lvl > 0 else ROOT)
                depth.append(lvl + 1)
                range_start.append(tip)
                range_end.append(tip + 1)
                node_type.append(NODE_TAXON if lvl == last else NODE_INNER)
                stack.append(node)
                stack_labels.append(label)
            # reference updates the *parent's* range at every level
            # (src/tree.rs:86, 94); with our stack walk that is equivalent to
            # extending every node along the path, handled above, plus root:
        range_end[ROOT] = tip + 1
        # Sequence node below the final taxon node (src/tree.rs:102-107).
        leaf = stack[last]
        del stack[last + 1 :]
        del stack_labels[last + 1 :]
        node = len(labels)
        labels.append(labels[leaf])
        parent.append(leaf)
        depth.append(last + 2)
        range_start.append(tip)
        range_end.append(tip + 1)
        node_type.append(NODE_SEQUENCE)
        stack.append(node)
        stack_labels.append(labels[leaf])
    meter.finish()

    return Taxonomy(
        lineages=list(sorted_lineages),
        labels=labels,
        parent=np.asarray(parent, dtype=np.int32),
        depth=np.asarray(depth, dtype=np.int32),
        range_start=np.asarray(range_start, dtype=np.int32),
        range_end=np.asarray(range_end, dtype=np.int32),
        node_type=np.asarray(node_type, dtype=np.uint8),
        num_tips=len(sorted_lineages),
    )
