"""The plain reference that decides ``correct``: raxtax's classification of
one query, worked out again from the records alone.

For a query with ``K`` distinct 8-mers it counts, for every reference, the
8-mers the two share (plain PyTorch on the run's device: a membership table
gathered at every reference's distinct 8-mers), bins the counts, computes
the analytic top-hit probability of each count in f64 (``T = K // 2`` draws
with replacement, the multiset formulation of raxtax ``src/prob.rs``), and
evaluates the lineage tree as raxtax ``src/lineage.rs`` does: range sums of
the probabilities in lineage-sorted tip order, confidences rounded half away
from zero to two decimals, significant children followed, the
maximum-confidence descent where none is, results sorted by confidence, the
local signal against the subtree fractions and the global signal over every
tip in order. A single exact match prints its lineage at confidence 1.
Lines are formatted as ``raxtax.out`` and ``raxtax.tsv`` print them.

It imports numpy, scipy and torch, and nothing of the program: the lineage
tree, the 8-mer sets and the exact matches are built here from the records
the benchmark made. ``dtype`` sets the float type of the whole model; the
float32 instance is the control the comparison must fail.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from scipy.special import gammaln

K_LEN = 8
SENTINEL = 1 << 16  #: "no 8-mer": an index past every packed 8-mer
#: 4-bit one-hot -> 2-bit code; 255 for ambiguity codes and padding
TWO_BIT = np.full(16, 255, dtype=np.uint8)
TWO_BIT[[1, 2, 4, 8]] = [0, 1, 2, 3]
ACGT_TEXT = np.full(16, ord("-"), dtype=np.uint8)
ACGT_TEXT[[1, 2, 4, 8]] = np.frombuffer(b"ACGT", dtype=np.uint8)


def query_kmers(seq4: np.ndarray) -> np.ndarray:
    """Sorted distinct packed 8-mers of a 4-bit sequence (windows holding
    an ambiguity code are skipped); the first base is the high bits."""
    two = TWO_BIT[np.asarray(seq4, dtype=np.uint8)].astype(np.int64)
    if two.size < K_LEN:
        return np.empty(0, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(two, K_LEN)
    ok = (win != 255).all(axis=1)
    shifts = np.arange(2 * (K_LEN - 1), -1, -2)
    return np.unique((win[ok] << shifts).sum(axis=1))


def reference_kmers(codes4: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                    device, rows: int = 32768) -> torch.Tensor:
    """``[N, A - 7]`` int32 on ``device``: each record's distinct 8-mers,
    sorted, the rest :data:`SENTINEL`."""
    n, a = codes4.shape
    w = a - K_LEN + 1
    out = torch.empty((n, w), dtype=torch.int32, device=device)
    lut = torch.from_numpy(TWO_BIT.astype(np.int32)).to(device)
    pos = torch.arange(a, device=device)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        two = lut[torch.from_numpy(codes4[lo:hi]).to(device).long()]
        s = torch.from_numpy(starts[lo:hi]).to(device).long()[:, None]
        e = s + torch.from_numpy(lengths[lo:hi]).to(device).long()[:, None]
        valid = (two != 255) & (pos >= s) & (pos < e)
        km = torch.zeros((hi - lo, w), dtype=torch.int32, device=device)
        ok = torch.ones((hi - lo, w), dtype=torch.bool, device=device)
        for i in range(K_LEN):
            km |= (two[:, i : i + w] & 3) << (2 * (K_LEN - 1 - i))
            ok &= valid[:, i : i + w]
        km[~ok] = SENTINEL
        km = km.sort(dim=1).values
        dup = torch.zeros_like(ok)
        dup[:, 1:] = km[:, 1:] == km[:, :-1]
        km[dup] = SENTINEL
        out[lo:hi] = km
    return out


# ---- the analytic top-hit probability model (raxtax src/prob.rs) ----


def ln_binomial(n, k, dtype):
    n = np.asarray(n, dtype=dtype)
    k = np.asarray(k, dtype=dtype)
    one = dtype(1.0)
    return gammaln(n + one) - gammaln(k + one) - gammaln(n - k + one)


def k_tables(K: int, dtype) -> dict:
    """Per-size tables of a query with ``K`` distinct 8-mers, ``T = K // 2``
    draws: the ln pmf of the draw count of a reference sharing ``s``
    8-mers, its running ln cmf, and the full-match probabilities."""
    T = K // 2
    S = K + 1
    ln_z = dtype(ln_binomial(K + T - 1, T, dtype)) if K > 0 else dtype(0.0)
    s = np.arange(S, dtype=dtype)[:, None]
    i = np.arange(1, T + 1, dtype=dtype)[None, :]
    one = dtype(1.0)
    pmf = np.full((S, T + 1), -np.inf, dtype=dtype)
    if S > 2:
        sz = s[1:-1]
        with np.errstate(divide="ignore"):
            possible = np.cumsum(np.log((sz + i - one) / i), axis=1)
        imp0 = ln_binomial(K - sz[:, 0] + T - 1, T, dtype)[:, None]
        if T > 1:
            j = np.arange(1, T, dtype=dtype)[None, :]
            dec = np.log((K - sz + T - j) / (T - j + one))
            impossible_mid = imp0 - np.cumsum(dec, axis=1)
        else:
            impossible_mid = np.empty((S - 2, 0), dtype=dtype)
        impossible = np.concatenate(
            [impossible_mid, np.zeros((S - 2, 1), dtype=dtype)], axis=1
        )
        pmf[1:-1, 0] = imp0[:, 0] - ln_z
        if T >= 1:
            pmf[1:-1, 1:] = possible + impossible - ln_z
    pmf[0, :] = -np.inf
    pmf[0, 0] = 0.0
    if S >= 2:
        pmf[-1, :] = -np.inf
        pmf[-1, T] = 0.0
    with np.errstate(divide="ignore"):
        cmf = np.log(np.cumsum(np.exp(pmf), axis=1))
    neg = cmf == -np.inf
    with np.errstate(invalid="ignore"):
        ratio = np.exp(pmf - cmf)
    ratio[neg] = 0.0
    # -inf cells would make 0 * -inf; a large finite value makes a size no
    # reference has contribute exactly 0 (-1e308 in f64, as raxtax's port)
    floor = -1.0e308 if dtype == np.float64 else np.finfo(dtype).min
    cmf_safe = np.where(neg, floor, cmf).astype(dtype)
    sz_all = np.arange(S, dtype=dtype)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        full = np.exp(ln_binomial(sz_all + T - 1, T, dtype) - ln_z)
    full[0] = 0.0
    full[-1] = 1.0
    return {"ratio": ratio, "cmf_safe": cmf_safe, "full": full}


def size_probs(hist: np.ndarray, K: int, tables: dict, dtype) -> np.ndarray:
    """Top-hit probability of each intersection size, normalized so that
    the references' probabilities sum to 1."""
    if K == 0:
        probs = np.ones(1, dtype=dtype)
    elif hist[K] > 0:
        probs = tables["full"].copy()
    else:
        h = hist[: K + 1].astype(dtype)
        with np.errstate(over="ignore"):
            prod = h @ tables["cmf_safe"]
            probs = tables["ratio"] @ np.exp(prod)
    h = hist[: probs.shape[0]].astype(dtype)
    total = h @ probs
    if not total > 0:
        raise ArithmeticError("top-hit probabilities sum to zero")
    return probs / total


def round_half_away(x):
    """Two decimals, half away from zero (Rust ``f64::round``)."""
    scaled = np.multiply(x, 100.0)
    return np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) / 100.0


def signal_distance(a, b) -> float:
    """L2 distance of the sum-normalized vectors, summed left to right."""
    if not a:
        return 0.0
    a_sum = 0.0
    for x in a:
        a_sum += x
    b_sum = 0.0
    for y in b:
        b_sum += y
    acc = 0.0
    for x, y in zip(a, b):
        d = x / a_sum - y / b_sum
        acc += d * d
    return math.sqrt(acc)


class Reference:
    """raxtax over one set of records; :meth:`lines` classifies a query."""

    def __init__(self, lineages: list, codes4: np.ndarray, starts: np.ndarray,
                 lengths: np.ndarray, device="cpu", dtype=np.float64):
        self.dtype = dtype
        self.device = torch.device(device)
        self.codes4, self.starts, self.lengths = codes4, starts, lengths
        n = len(lineages)
        self.n = n
        # tips: records stably sorted by their lineage's bytes
        keys = np.array([l.encode("utf-8") for l in lineages])
        self.order = np.argsort(keys, kind="stable")
        self.tip_of = np.empty(n, dtype=np.int64)
        self.tip_of[self.order] = np.arange(n)
        self.lineages = [lineages[i] for i in self.order]
        levels = [l.split(",") for l in self.lineages]
        depth = len(levels[0])
        if any(len(lv) != depth for lv in levels):
            raise ValueError("the reference takes lineages of one depth")
        self.depth = depth
        # a node of level d starts where any level <= d changes (the tree
        # grows by matching each level against the last child's label)
        new = np.zeros(n, dtype=bool)
        new[0] = True
        self.node_start, self.node_end, self.first_child = [], [], []
        prev_start = np.array([0])
        for d in range(depth):
            lab = np.array([lv[d] for lv in levels], dtype=object)
            new[1:] |= lab[1:] != lab[:-1]
            st = np.nonzero(new)[0]
            self.node_start.append(st)
            self.node_end.append(np.append(st[1:], n))
            parent = np.searchsorted(prev_start, st, side="right") - 1
            self.first_child.append(
                np.searchsorted(parent, np.arange(prev_start.size + 1))
            )
            prev_start = st
        self.refk = reference_kmers(codes4, starts, lengths, self.device)
        self.refk_size = (self.refk != SENTINEL).sum(dim=1)
        self._tables: dict = {}

    def with_dtype(self, dtype) -> "Reference":
        """The same records and tree, the model computed in ``dtype``."""
        other = copy.copy(self)
        other.dtype, other._tables = dtype, {}
        return other

    # -- counts and exact matches --

    def counts(self, kmers: np.ndarray) -> np.ndarray:
        """Shared 8-mers of the query with every record, in record order."""
        member = torch.zeros(SENTINEL + 1, dtype=torch.bool, device=self.device)
        member[torch.from_numpy(kmers).to(self.device)] = True
        return member[self.refk].sum(dim=1).cpu().numpy().astype(np.int64)

    def exact_tips(self, seq4: np.ndarray, kmers: np.ndarray,
                   counts: np.ndarray) -> list:
        """Tips whose sequence equals the query byte for byte."""
        k = kmers.size
        cand = np.nonzero((counts == k) &
                          (self.refk_size.cpu().numpy() == k) &
                          (self.lengths == seq4.size))[0]
        tips = []
        for r in cand:
            s = int(self.starts[r])
            if np.array_equal(self.codes4[r, s : s + seq4.size], seq4):
                tips.append(int(self.tip_of[r]))
        return sorted(tips)

    # -- the model and the tree --

    def tables(self, K: int) -> dict:
        t = self._tables.get(K)
        if t is None:
            t = self._tables[K] = k_tables(K, self.dtype)
        return t

    def evaluate(self, counts_tip: np.ndarray, K: int):
        """``(results, global signal)``: results are (tip, confidences,
        expected fractions) in raxtax's output order."""
        dt = self.dtype
        hist = np.bincount(counts_tip, minlength=K + 1)
        probs = size_probs(hist, K, self.tables(K), dt)[counts_tip]
        gsig = float(np.sqrt(np.cumsum((probs - dt(1.0 / self.n)) ** 2)[-1]))
        csum = np.concatenate((np.zeros(1, dt), np.cumsum(probs)))
        conf = [csum[e] - csum[s] for s, e in zip(self.node_start, self.node_end)]
        rounded = [round_half_away(c) for c in conf]
        n, last = self.n, self.depth - 1
        results = []

        def frac(d, i):
            return float(self.node_end[d][i] - self.node_start[d][i]) / n

        def kids(d, i):  # children of node i of level d (d = -1: the root)
            fc = self.first_child[d + 1]
            return int(fc[i]), int(fc[i + 1])

        def descend(d, i):  # the maximum-confidence path below (d, i)
            path = []
            while d < last:
                lo, hi = kids(d, i)
                vals = conf[d + 1][lo:hi]
                i = lo + (hi - lo - 1 - int(np.argmax(vals[::-1])))
                d += 1
                path.append((d, i))
            return path

        def recurse(d, i, cp, ep):
            pushed = False
            lo, hi = kids(d, i)
            sig = np.nonzero(rounded[d + 1][lo:hi] != 0.0)[0]
            for c in (lo + sig).tolist():
                p = cp + [float(rounded[d + 1][c])]
                e = ep + [frac(d + 1, c)]
                child_pushed = d + 1 < last and recurse(d + 1, c, p, e)
                if not child_pushed and d + 1 == last:
                    results.append((int(self.node_start[d + 1][c]), p, e))
                    pushed = True
                pushed |= child_pushed
            if sig.size == 0 and d < last:
                path = descend(d, i)
                leaf = path[-1]
                results.append((int(self.node_start[leaf[0]][leaf[1]]),
                                cp + [0.01] * len(path),
                                ep + [frac(pd, pi) for pd, pi in path]))
                pushed = True
            return pushed

        recurse(-1, 0, [], [])
        results.sort(key=lambda r: tuple(r[1]), reverse=True)
        return results, gsig

    def lines(self, label: str, seq4: np.ndarray) -> tuple:
        """``(raxtax.out lines, raxtax.tsv lines)`` of one query."""
        seq4 = np.asarray(seq4, dtype=np.uint8)
        kmers = query_kmers(seq4)
        counts = self.counts(kmers)
        counts_tip = counts[self.order]
        results, gsig = self.evaluate(counts_tip, int(kmers.size))
        rows = []
        for tip, confs, expected in results:
            start = len(expected) - 1
            for i, e in enumerate(expected):
                if e < 1.0:
                    start = i
                    break
            local = signal_distance(confs[start:], expected[start:])
            rows.append((self.lineages[tip], confs, local))
        exact = self.exact_tips(seq4, kmers, counts)
        if len(exact) == 1:
            lineage = self.lineages[exact[0]]
            rows = [(lineage, [1.0] * (lineage.count(",") + 1), rows[0][2])]
        text = ACGT_TEXT[seq4].tobytes().decode("ascii")
        out, tsv = [], []
        for lineage, confs, local in rows:
            c = ",".join(f"{v:.2f}" for v in confs)
            out.append(f"{label}\t{lineage}\t{c}\t{local:.5f}\t{gsig:.5f}")
            pairs = "\t".join(
                x for pair in zip(lineage.split(","), (f"{v:.2f}" for v in confs))
                for x in pair
            )
            tsv.append(f"{label}\t{pairs}\t{local:.5f}\t{gsig:.5f}\t{text}")
        return out, tsv
