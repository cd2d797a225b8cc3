"""Seeded reference databases and query files for the benchmark.

A hierarchical barcode world: a consensus sequence per taxon of the
configuration's ``consensus_rank``, each lower rank derived from its parent
by a fixed share of substitutions on the variable alignment positions, and
every record derived from its species the same way. Lineages are SINTAX
style (``k:...,p:...,...``), one label per rank. Queries come from the
traffic file: exact copies of records, or a taxon's consensus plus
substitutions, over the whole alignment, a record-like trimmed span or a
named region (the V4 window of 16S).

What the seed changes: the sequences, which parent gets which number of
children, which species gets which number of records, the trims and the
queries. What it does not change: the taxonomy's rank counts, the multisets
of children per parent, of species sizes and of record lengths, and the
share of each kind of query, so every seed gives the same amount of work.
Children per parent are heavy-tailed, as genus sizes are (Yule 1925): the
same rank-size law as the species sizes, at least one child each.

Query files are written as FASTA, one line a sequence, the files a user's
run reads; :func:`read_fasta` reads them back for the check.

Imports numpy only; codes are 2-bit (A, C, G, T = 0..3) while a world is
built and 4-bit one-hot (1, 2, 4, 8; 0 pads) once it is handed out, the
encoding of FASTA files read by raxtax.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

ENC4 = np.array([1, 2, 4, 8], dtype=np.uint8)  # 2-bit -> 4-bit one-hot
TEXT = np.zeros(16, dtype=np.uint8)  # 4-bit -> FASTA letter
TEXT[ENC4] = np.frombuffer(b"ACGT", dtype=np.uint8)
CODE4 = np.zeros(256, dtype=np.uint8)  # FASTA letter -> 4-bit
CODE4[np.frombuffer(b"ACGT", dtype=np.uint8)] = ENC4

#: streams of one seed, so each draw is independent of the others' sizes
_WORLD, _FILES, _COPIES, _WARMUP, _CHECK = range(5)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any Python integer)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *stream])
    )


def substitute(rng, seqs: np.ndarray, var_pos: np.ndarray, count: int) -> None:
    """Change ``count`` distinct positions of ``var_pos`` in every row of the
    2-bit array ``seqs`` (in place) to another base."""
    m = seqs.shape[0]
    if count <= 0 or m == 0:
        return
    if count > var_pos.size:
        raise ValueError("more substitutions than variable positions")
    pos = rng.integers(0, var_pos.size, size=(m, count))
    while True:  # redraw repeated positions until every row's are distinct
        pos.sort(axis=1)
        dup = np.zeros(pos.shape, dtype=bool)
        dup[:, 1:] = pos[:, 1:] == pos[:, :-1]
        n = int(dup.sum())
        if n == 0:
            break
        pos[dup] = rng.integers(0, var_pos.size, size=n)
    rows = np.arange(m)[:, None]
    cols = var_pos[pos]
    shift = rng.integers(1, 4, size=(m, count), dtype=np.uint8)
    seqs[rows, cols] = (seqs[rows, cols] + shift) % 4


def substitutions(rate: float, n_var: int) -> int:
    """Substitutions for a divergence ``rate`` over ``n_var`` positions."""
    return int(round(rate * n_var))


def species_sizes(n_species: int, n_records: int, exponent: float,
                  min_size: int, cap: int) -> np.ndarray:
    """Records per species, largest first: ``min_size`` each plus a share of
    the rest that falls as ``rank ** -exponent``, no species above ``cap``,
    summing to ``n_records`` exactly. Depends on its arguments only."""
    extra = n_records - n_species * min_size
    if extra < 0 or cap * n_species < n_records:
        raise ValueError("species sizes cannot meet the record count")
    w = np.arange(1, n_species + 1, dtype=np.float64) ** -float(exponent)
    room = float(cap - min_size)
    capped = np.zeros(n_species, dtype=bool)
    while True:
        left = extra - room * capped.sum()
        x = np.where(capped, room, left * w / w[~capped].sum())
        over = ~capped & (x > room)
        if not over.any():
            break
        capped |= over
    base = np.floor(x).astype(np.int64)
    short = extra - int(base.sum())
    # the remainder goes to the largest fractional parts, ties to rank
    frac_order = np.lexsort((np.arange(n_species), -(x - base)))
    base[frac_order[:short]] += 1
    return base + min_size


def parents(rng, n_parent: int, n_child: int, law: dict, rank: str) -> np.ndarray:
    """``[n_child]`` parent of each child: children per parent drawn from
    :func:`species_sizes` (at least one, at most ``law["cap"][rank]``),
    the multiset shuffled by ``rng``, each parent's children contiguous."""
    counts = species_sizes(n_parent, n_child, law["exponent"], 1,
                           int(law["cap"][rank]))
    counts = counts[rng.permutation(n_parent)]
    return np.repeat(np.arange(n_parent, dtype=np.int64), counts)


def conserved_mask(length: int, share: float, blocks: int) -> np.ndarray:
    """``True`` at the conserved positions: ``blocks`` equal blocks spread
    evenly over the alignment, ``share`` of its positions in all."""
    mask = np.zeros(length, dtype=bool)
    if share <= 0 or blocks <= 0:
        return mask
    blen = int(round(share * length / blocks))
    for i in range(blocks):
        mid = (i + 0.5) * length / blocks
        lo = max(0, int(round(mid - blen / 2)))
        mask[lo : lo + blen] = True
    return mask


def spread_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths evenly spread over ``[lo, hi]`` (the same multiset for
    every seed)."""
    if lo == hi:
        return np.full(n, lo, dtype=np.int32)
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    return np.floor(lo + q * (hi - lo + 1)).astype(np.int32)


@dataclass
class World:
    """Reference records of one configuration and seed."""

    config: dict
    #: [N, A] 4-bit codes of every record's aligned row; record i is
    #: ``codes4[i, starts[i] : starts[i] + lengths[i]]``
    codes4: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray
    lineages: list
    species_of: np.ndarray  #: [N] species index of each record
    #: ancestors[r][s]: index at rank r of species s's taxon
    ancestors: list
    #: parent[r][i]: the taxon of rank r-1 above taxon i of rank r (None
    #: at the top rank)
    parent: list
    #: 2-bit consensus rows by rank name, from ``consensus_rank`` down
    consensus: dict
    var_pos: np.ndarray  #: variable alignment positions

    @property
    def n(self) -> int:
        return self.codes4.shape[0]

    @property
    def alignment_length(self) -> int:
        return self.codes4.shape[1]

    def record(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.codes4[i, s : s + int(self.lengths[i])]

    def fixed_length(self) -> bool:
        return bool((self.starts == 0).all() and
                    (self.lengths == self.alignment_length).all())

    def port_sequences(self):
        """The records as raxtax reads them: one ``[N, L]`` array when every
        record has the alignment's length, else a list of 1-D arrays."""
        if self.fixed_length():
            return self.codes4
        return [self.record(i) for i in range(self.n)]


def make_world(config: dict, seed: int) -> World:
    """The reference records of ``config`` for ``seed``."""
    ranks = list(config["ranks"])
    taxa = [int(config["taxa"][r]) for r in ranks]
    n = int(config["records"])
    A = int(config["alignment_length"])
    lo, hi = (int(x) for x in config["record_length"])
    rng = rng_for(seed, _WORLD)

    # the taxonomy's shape: the children of a parent are a contiguous run
    # of the rank below, their numbers a fixed multiset shuffled by the
    # seed; species sizes likewise
    n_sp = taxa[-1]
    law = config["species_records"]
    sizes = species_sizes(n_sp, n, law["exponent"], law["min"], law["cap"])
    sizes = sizes[rng.permutation(n_sp)]
    species_of = np.repeat(np.arange(n_sp, dtype=np.int32), sizes)
    # parent[r][i]: the taxon of rank r-1 above taxon i of rank r
    parent = [None] + [
        parents(rng, taxa[r - 1], taxa[r], config["children"], ranks[r])
        for r in range(1, len(ranks))
    ]
    ancestors = [None] * len(ranks)
    ancestors[-1] = np.arange(n_sp, dtype=np.int64)
    for r in range(len(ranks) - 2, -1, -1):
        ancestors[r] = parent[r + 1][ancestors[r + 1]]
    widths = [len(str(t - 1)) for t in taxa]
    names = config.get("rank_names", {})
    species_lineage = []
    for s in range(n_sp):
        parts = []
        for r, rank in enumerate(ranks):
            i = int(ancestors[r][s])
            name = names.get(rank)
            parts.append(
                f"{rank}:{name}" if name and taxa[r] == 1
                else f"{rank}:{rank.upper()}{i:0{widths[r]}d}"
            )
        species_lineage.append(",".join(parts))
    lineages = [species_lineage[s] for s in species_of]

    # sequences: a backbone, random variable positions per consensus taxon,
    # then substitutions rank by rank and per record
    mask = conserved_mask(A, float(config.get("conserved_share", 0.0)),
                          int(config.get("conserved_blocks", 0)))
    var_pos = np.nonzero(~mask)[0]
    backbone = rng.integers(0, 4, size=A, dtype=np.uint8)
    c_rank = ranks.index(config["consensus_rank"])
    div = config["divergence"]
    cons = np.tile(backbone, (taxa[c_rank], 1))
    cons[:, var_pos] = rng.integers(0, 4, size=(taxa[c_rank], var_pos.size),
                                    dtype=np.uint8)
    consensus = {ranks[c_rank]: cons}
    for r in range(c_rank + 1, len(ranks)):
        child = consensus[ranks[r - 1]][parent[r]]
        substitute(rng, child, var_pos,
                   substitutions(div[ranks[r]], var_pos.size))
        consensus[ranks[r]] = child
    codes = consensus[ranks[-1]][species_of]
    substitute(rng, codes, var_pos, substitutions(div["record"], var_pos.size))
    for i in range(0, n, 65536):  # to 4-bit in place, a block at a time
        codes[i : i + 65536] = ENC4[codes[i : i + 65536]]

    lengths = spread_lengths(n, lo, hi)[rng.permutation(n)]
    starts = np.floor(rng.random(n) * (A - lengths + 1)).astype(np.int32)
    return World(
        config=config, codes4=codes, starts=starts, lengths=lengths,
        lineages=lineages, species_of=species_of, ancestors=ancestors,
        parent=parent, consensus=consensus, var_pos=var_pos,
    )


@dataclass
class QueryFile:
    """One query file: labels and 4-bit rows, query i being
    ``rows[i, :lengths[i]]``."""

    labels: list
    rows: np.ndarray  #: [Q, longest] 4-bit codes, 0 past each length
    lengths: np.ndarray
    #: record copied by each query, -1 where the query was derived (or is
    #: not known, in a file read back)
    copied: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)

    def sequence(self, i: int) -> np.ndarray:
        return self.rows[i, : int(self.lengths[i])]

    def queries(self) -> list:
        """``(label, 4-bit sequence)`` pairs, as raxtax's query parser
        returns them."""
        return [(self.labels[i], self.sequence(i)) for i in range(len(self))]

    def write_fasta(self, path) -> None:
        """The file as FASTA: a header line and one sequence line a query."""
        text = TEXT[self.rows]
        n, width = text.shape
        head = {len(label) for label in self.labels}
        if len(head) == 1 and (self.lengths == width).all():
            # labels of one width and sequences of one length: every record
            # is a row of one byte array
            h = head.pop()
            out = np.empty((n, h + width + 3), dtype=np.uint8)
            out[:, 0] = ord(">")
            out[:, 1 : h + 1] = np.frombuffer(
                "".join(self.labels).encode(), dtype=np.uint8).reshape(n, h)
            out[:, h + 1] = ord("\n")
            out[:, h + 2 : h + 2 + width] = text
            out[:, -1] = ord("\n")
            Path(path).write_bytes(out.tobytes())
            return
        Path(path).write_bytes(b"".join(
            b">%s\n%s\n" % (label.encode(), text[i, : int(self.lengths[i])].tobytes())
            for i, label in enumerate(self.labels)
        ))


@dataclass
class WrittenFile:
    """A query file made in set-up and written to ``path``."""

    path: Path
    lengths: np.ndarray

    def __len__(self) -> int:
        return int(self.lengths.size)


def read_fasta(path) -> QueryFile:
    """A FASTA file of A, C, G and T back as a :class:`QueryFile`."""
    labels, seqs = [], []
    for block in Path(path).read_bytes().split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        labels.append(head.decode())
        seqs.append(np.frombuffer(body.replace(b"\n", b""), dtype=np.uint8))
    lengths = np.array([s.size for s in seqs], dtype=np.int32)
    rows = np.zeros((len(seqs), int(lengths.max(initial=0))), dtype=np.uint8)
    for i, s in enumerate(seqs):
        rows[i, : s.size] = CODE4[s]
    return QueryFile(labels=labels, rows=rows, lengths=lengths,
                     copied=np.full(len(seqs), -1, dtype=np.int64))


def cut(full: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Rows ``full[i, starts[i] : starts[i] + lengths[i]]`` left-aligned in
    one array as wide as the longest, zero past each length."""
    width = int(lengths.max(initial=0))
    if width == full.shape[1] and not starts.any() and (lengths == width).all():
        return full
    col = np.arange(width)
    idx = np.minimum(starts[:, None] + col, full.shape[1] - 1)
    rows = np.take_along_axis(full, idx, axis=1)
    rows[col >= lengths[:, None]] = 0
    return rows


class Traffic:
    """The query files of one cell and seed (see the traffic file)."""

    def __init__(self, world: World, traffic: dict, seed: int):
        self.world = world
        self.cfg = traffic
        self.seed = int(seed)
        self.file_queries = int(traffic["file_queries"])
        self._copy_order = None

    def _copies(self, f: int, n: int) -> np.ndarray:
        """Records copied by file ``f``: consecutive slices of one
        seed-wide permutation, so no record is copied twice in a run."""
        if self._copy_order is None:
            self._copy_order = rng_for(self.seed, _COPIES).permutation(
                self.world.n
            )
        idx = (np.arange(f * n, (f + 1) * n)) % self.world.n
        return self._copy_order[idx]

    def _make(self, rng, n: int, labels: list, copies: np.ndarray,
              longest: bool = False) -> QueryFile:
        w, cfg = self.world, self.cfg
        A = w.alignment_length
        span = cfg["span"]
        n_der = n - copies.size
        # derived queries: a record drawn uniformly (so species in
        # proportion to their records), its anchor taxon's consensus, then
        # the substitutions of each divergence stage
        rec = rng.integers(0, w.n, size=n_der)
        anchor = cfg["anchor"]
        ranks = list(w.config["ranks"])
        taxon = w.ancestors[ranks.index(anchor)][w.species_of[rec]]
        if span in w.config["regions"]:
            # only the region's columns are made, and the divergence falls
            # on the variable positions among them
            a, b = (int(x) for x in w.config["regions"][span])
            seqs = w.consensus[anchor][taxon, a:b]
            var = w.var_pos[(w.var_pos >= a) & (w.var_pos < b)] - a
        else:
            seqs = w.consensus[anchor][taxon]
            var = w.var_pos
        for rate in cfg["divergence"]:
            substitute(rng, seqs, var, substitutions(rate, var.size))
        width = seqs.shape[1]
        if span == "record":
            lo, hi = (int(x) for x in w.config["record_length"])
            d_len = rng.integers(lo, hi + 1, size=n_der).astype(np.int32)
            if longest and n_der:
                d_len[0] = hi
            d_start = np.floor(rng.random(n_der) * (A - d_len + 1)).astype(np.int32)
        elif span == "full" or span in w.config["regions"]:
            d_start = np.zeros(n_der, dtype=np.int32)
            d_len = np.full(n_der, width, dtype=np.int32)
        else:
            raise ValueError(f"unknown span {span!r}")
        derived = cut(ENC4[seqs], d_start, d_len)
        copied = cut(w.codes4[copies], w.starts[copies], w.lengths[copies])
        rows = np.zeros((n, max(derived.shape[1], copied.shape[1])), dtype=np.uint8)
        rows[:n_der, : derived.shape[1]] = derived
        rows[n_der:, : copied.shape[1]] = copied
        lengths = np.concatenate([d_len, w.lengths[copies]]).astype(np.int32)
        source = np.concatenate([np.full(n_der, -1), copies]).astype(np.int64)
        order = rng.permutation(n)
        if longest:  # the longest query leads, to pin the shape buckets
            order = np.concatenate([[0], order[order != 0]])
        return QueryFile(labels=labels, rows=rows[order], lengths=lengths[order],
                         copied=source[order])

    def file(self, f: int) -> QueryFile:
        """The ``f``-th query file of the run."""
        n = self.file_queries
        n_copy = int(round(float(self.cfg.get("record_copy_share", 0.0)) * n))
        labels = [f"q{f:05d}.{i:05d}" for i in range(n)]
        return self._make(rng_for(self.seed, _FILES, f), n, labels,
                          self._copies(f, n_copy))

    def write_files(self, directory: Path, count: int) -> list:
        """The run's first ``count`` query files, written as
        ``directory/q<f>.fasta``."""
        Path(directory).mkdir(parents=True, exist_ok=True)
        out = []
        for f in range(count):
            qf = self.file(f)
            path = Path(directory) / f"q{f}.fasta"
            qf.write_fasta(path)
            out.append(WrittenFile(path=path, lengths=qf.lengths))
        return out

    def warmup(self) -> QueryFile:
        """The short warm-up file: the traffic's own shapes, its longest
        query first; its labels are not used by the window."""
        n = int(self.cfg["warmup_queries"])
        n_copy = int(round(float(self.cfg.get("record_copy_share", 0.0)) * n))
        rng = rng_for(self.seed, _WARMUP)
        copies = rng.integers(0, self.world.n, size=n_copy)
        return self._make(rng, n, [f"w{i}" for i in range(n)], copies,
                          longest=True)
