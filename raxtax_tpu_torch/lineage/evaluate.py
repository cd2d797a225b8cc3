"""Lineage confidence aggregation and result emission.

Host-side replay of the reference's `Lineage::evaluate` recursion
(reference: src/lineage.rs:61-179), re-designed for the TPU pipeline: instead
of walking the whole pointer tree with a per-tip probability vector, the
device delivers only the *significant* node confidences (range sums over the
per-tip probability vector, thresholded at the 2-decimal rounding cutoff),
and this module replays the exact recursion over that sparse set. The
max-confidence fallback descent (src/lineage.rs:151-177) runs through a
resolver callback (device kernel or host oracle).

Semantics preserved exactly:

- child confidences are rounded half-away-from-zero to 2 decimals before the
  zero-pruning test (src/lineage.rs:128-132);
- results are emitted at Taxon nodes whose recursion pushed nothing deeper
  (src/lineage.rs:141-148);
- if no child of an Inner node is significant, the max-confidence path is
  followed to a Taxon node and emitted at confidence 0.01 per descended
  level (src/lineage.rs:151-177);
- results are sorted descending-lexicographically by confidence vector with
  stable ties (src/lineage.rs:92-93);
- local_signal is the L2 distance between sum-normalized observed vs expected
  confidence vectors starting at the first level where expected < 1.0
  (src/lineage.rs:94-102, src/utils.rs:91-105).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from ..db.taxonomy import NODE_INNER, NODE_TAXON, ROOT, Taxonomy
from ..utils.encoding import round_half_away


@dataclass
class EvaluationResult:
    """One output line (reference: src/lineage.rs:8-49)."""

    query_label: str
    lineage: str
    confidence_values: list[float]
    local_signal: float
    global_signal: float

    def out_line(self) -> str:
        confs = ",".join(f"{v:.2f}" for v in self.confidence_values)
        return (
            f"{self.query_label}\t{self.lineage}\t{confs}"
            f"\t{self.local_signal:.5f}\t{self.global_signal:.5f}"
        )

    def tsv_line(self, sequence: str) -> str:
        taxa = self.lineage.split(",")
        inter = "\t".join(
            x
            for pair in zip(taxa, (f"{v:.2f}" for v in self.confidence_values))
            for x in pair
        )
        return (
            f"{self.query_label}\t{inter}\t{self.local_signal:.5f}"
            f"\t{self.global_signal:.5f}\t{sequence}"
        )


def euclidean_distance_l1(a, b) -> float:
    """L2 distance between sum-normalized vectors (src/utils.rs:91-105).

    Pure-Python math: the vectors are lineage-depth-sized (a handful of
    levels), called once per output line — numpy overhead dominates there.
    """
    assert len(a) == len(b)
    if len(a) == 0:
        return 0.0
    # sequential left-to-right sums, matching Rust's Iterator::sum
    # rounding; manual loops beat genexpr+sum() at these tiny lengths
    a_sum = 0.0
    for x in a:
        a_sum += x
    b_sum = 0.0
    for y in b:
        b_sum += y
    assert a_sum > 0.0 and b_sum > 0.0
    acc = 0.0
    for x, y in zip(a, b):
        d = x / a_sum - y / b_sum
        acc += d * d
    return math.sqrt(acc)


def evaluate_significant(
    tax: Taxonomy,
    query_label: str,
    significant: Mapping[int, float],
    global_signal: float,
    fallback_resolver: Callable[[int], int],
) -> list[EvaluationResult]:
    """Replay eval_recurse over the significant-node sparse set.

    `significant` maps node id -> raw (unrounded) confidence for every eval
    node whose confidence could round to >= 0.01 (callers may include extras;
    they are re-rounded and pruned here). `fallback_resolver(node)` must
    return the Taxon node reached from `node` by repeatedly descending into
    the max-confidence child while the current node is Inner
    (src/lineage.rs:154-170, ties resolved to the *last* max, like Rust's
    `Iterator::max_by`).
    """
    # children of each node restricted to the significant set, in id
    # (== creation/DFS) order; rounding vectorized over the whole set
    # (reference: src/lineage.rs:128-129 round-half-away at 2 decimals)
    sig_children: dict[int, list[int]] = {}
    rounded: dict[int, float] = {}
    if significant:
        nodes = np.fromiter(significant.keys(), np.int64, len(significant))
        nodes.sort()
        vals = np.empty(nodes.shape[0], np.float64)
        for i, n in enumerate(nodes):
            vals[i] = significant[int(n)]
        rvals = round_half_away(vals)
        parents = tax.parent[nodes]
        for n, rv, par in zip(nodes.tolist(), rvals.tolist(), parents.tolist()):
            if rv == 0.0 or n == ROOT:
                continue
            rounded[n] = rv
            sig_children.setdefault(par, []).append(n)

    results: list[tuple[int, list[float], list[float]]] = []
    frac = tax.subtree_fraction

    def recurse(node: int, conf_prefix: list[float], exp_prefix: list[float]) -> bool:
        no_child_significant = True
        pushed = False
        for c in sig_children.get(node, ()):  # rounded conf != 0 by construction
            no_child_significant = False
            prefix = conf_prefix + [rounded[c]]
            eprefix = exp_prefix + [frac(c)]
            child_pushed = recurse(c, prefix, eprefix)
            if not child_pushed and tax.node_type[c] == NODE_TAXON:
                results.append((int(tax.range_start[c]), prefix, eprefix))
                pushed = True
            pushed |= child_pushed
        if no_child_significant and tax.node_type[node] == NODE_INNER:
            leaf = fallback_resolver(node)
            path = tax.path_from(node, leaf)
            prefix = conf_prefix + [0.01] * len(path)
            eprefix = exp_prefix + [frac(p) for p in path]
            results.append((int(tax.range_start[leaf]), prefix, eprefix))
            pushed = True
        return pushed

    recurse(ROOT, [], [])

    # descending lexicographic sort, stable ties (src/lineage.rs:92-93)
    results.sort(key=lambda r: tuple(r[1]), reverse=True)

    out = []
    for tip, conf_values, expected in results:
        start = len(expected) - 1
        for i, e in enumerate(expected):
            if e < 1.0:
                start = i
                break
        local = euclidean_distance_l1(conf_values[start:], expected[start:])
        out.append(
            EvaluationResult(
                query_label=query_label,
                lineage=tax.lineages[tip],
                confidence_values=conf_values,
                local_signal=local,
                global_signal=global_signal,
            )
        )
    return out


def evaluate_dense(
    tax: Taxonomy,
    query_label: str,
    tip_probs: np.ndarray,
    global_signal: float | None = None,
) -> list[EvaluationResult]:
    """Full-vector evaluation (oracle path; mirrors src/lineage.rs:61-112).

    Computes every eval-node confidence from the per-tip probability vector
    via a prefix sum, then delegates to :func:`evaluate_significant` with an
    exact f64 fallback resolver.
    """
    probs = np.asarray(tip_probs, dtype=np.float64)
    csum = np.concatenate(([0.0], np.cumsum(probs)))
    conf = csum[tax.range_end] - csum[tax.range_start]  # per node

    if global_signal is None:
        # sequential over tips, the reference's grouping (lineage.rs:86-90)
        global_signal = float(
            np.sqrt(np.cumsum((probs - 1.0 / tax.num_tips) ** 2)[-1])
        )

    eval_ids = tax.eval_ids
    sig = {
        int(n): float(conf[n])
        for n in eval_ids
        if round_half_away(conf[n]) != 0.0
    }

    def resolver(node: int) -> int:
        cur = node
        while tax.node_type[cur] == NODE_INNER:
            kids = tax.children(cur)
            vals = conf[kids]
            # Rust max_by returns the LAST maximal element
            best = len(vals) - 1 - int(np.argmax(vals[::-1]))
            cur = int(kids[best])
        return cur

    return evaluate_significant(tax, query_label, sig, global_signal, resolver)
