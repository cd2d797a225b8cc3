"""The reference database: taxonomy + bit matrices + exact-match map.

TPU-native equivalent of the reference `Tree` aggregate (src/tree.rs:36-43):
`root`/`lineages` become the flattened :class:`Taxonomy`, `k_mer_map` becomes
the packed bit matrices, `sequences` becomes a host hash map from encoded
sequence bytes to tip ids. Persisted as an uncompressed ``.npz`` (the
binary-DB cache, mirroring the bincode fast path at src/tree.rs:147-164 and
src/parser.rs:38-40).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import bitmatrix
from .taxonomy import Taxonomy, build_taxonomy, sort_records

DB_FORMAT_VERSION = 1
DB_MAGIC = "raxtax-tpu-db"


_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)  # odd 64-bit mixing constant


class ExactIndex:
    """Hash index over the reference sequences (exact-match lookup).

    TPU-first replacement for the reference's `sequences: HashMap<Vec<u8>,
    Vec<u32>>` (src/tree.rs:50-51, 109-112): instead of a 1M-iteration
    Python dict build on every load (seconds to tens of seconds), hash all
    sequences with one vectorized numpy pass and answer
    lookups by binary search + byte-wise verification.
    """

    def __init__(self, seq_flat: np.ndarray, seq_offsets: np.ndarray,
                 _saved=None):
        self._flat = np.asarray(seq_flat)
        self._offsets = np.asarray(seq_offsets)
        if _saved is not None:  # from_saved: skip the hashing pass
            self._hashes, self._tips, self._native = _saved
            return
        n = self._offsets.shape[0] - 1
        # the native FNV hasher streams the flat blob in one C pass;
        # the vectorized numpy path below is the
        # no-compiler fallback. Index and per-query lookups MUST use the
        # same implementation — record which one built the index.
        from .. import native

        hashes = native.hash_sequences(self._flat, self._offsets)
        self._native = hashes is not None
        if hashes is None:
            hashes = self._hash_all()
        order = np.lexsort((np.arange(n), hashes))
        self._hashes = hashes[order]
        self._tips = order.astype(np.int64)

    @classmethod
    def from_saved(cls, seq_flat, seq_offsets, hashes, tips,
                   built_native: bool) -> "ExactIndex":
        """Reconstruct from the persisted sorted hash/tip arrays (v2 cache),
        skipping the full seq_flat hashing pass — the last piece of the
        reference's `sequences` HashMap (src/tree.rs:50-51) that was still
        rebuilt on every load. Query-time hashing must match the
        implementation that BUILT the index (native FNV vs numpy
        polynomial); if the native lib's availability changed since the
        save, fall back to a fresh build."""
        from .. import native

        if bool(built_native) != (native.get_lib() is not None):
            return cls(seq_flat, seq_offsets)
        hashes = np.asarray(hashes, dtype=np.uint64)
        tips = np.asarray(tips, dtype=np.int64)
        n = np.asarray(seq_offsets).shape[0] - 1
        # a stale/inconsistent cache would silently miss exact matches or
        # index out of range at query time; rebuild from scratch instead
        if (
            hashes.shape != (n,)
            or tips.shape != (n,)
            or (n > 0 and (int(tips.max()) >= n or int(tips.min()) < 0))
        ):
            return cls(seq_flat, seq_offsets)
        return cls(
            seq_flat, seq_offsets,
            _saved=(hashes, tips, bool(built_native)),
        )

    def _hash_all(self) -> np.ndarray:
        flat, offsets = self._flat, self._offsets
        n = offsets.shape[0] - 1
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        lengths = np.diff(offsets)
        max_len = int(lengths.max(initial=0))
        pows = np.empty(max(max_len, 1), dtype=np.uint64)
        pows[0] = 1
        with np.errstate(over="ignore"):
            for i in range(1, max_len):
                pows[i] = pows[i - 1] * _HASH_MULT
            if flat.size == 0:
                return lengths.astype(np.uint64)
            # position of each byte within its own segment
            pos = np.arange(flat.size, dtype=np.int64) - np.repeat(
                offsets[:-1].astype(np.int64), lengths
            )
            terms = (flat.astype(np.uint64) + np.uint64(1)) * pows[pos]
            # per-segment sums via reduceat would drop empty segments;
            # use a padded wrapping cumsum instead
            csum = np.empty(flat.size + 1, dtype=np.uint64)
            csum[0] = 0
            np.cumsum(terms, out=csum[1:])
            seg = csum[offsets[1:]] - csum[offsets[:-1]]
            return seg * _HASH_MULT + lengths.astype(np.uint64)

    def _hash_one(self, seq: np.ndarray) -> np.uint64:
        seq = np.asarray(seq, dtype=np.uint8)
        if self._native:
            from .. import native

            h = native.hash_sequences(
                seq, np.array([0, seq.size], dtype=np.int64), threads=1
            )
            if h is not None:
                return h[0]
            # native lib vanished mid-process (never expected); fall through
        if seq.size == 0:
            return np.uint64(0) * _HASH_MULT + np.uint64(0)
        with np.errstate(over="ignore"):
            pows = np.empty(seq.size, dtype=np.uint64)
            pows[0] = 1
            for i in range(1, seq.size):
                pows[i] = pows[i - 1] * _HASH_MULT
            h = ((seq.astype(np.uint64) + np.uint64(1)) * pows).sum(
                dtype=np.uint64
            )
            return h * _HASH_MULT + np.uint64(seq.size)

    def _verify(self, lo: int, hi: int, seq: np.ndarray) -> list[int]:
        out = []
        for tip in self._tips[lo:hi]:
            tip = int(tip)
            s, e = int(self._offsets[tip]), int(self._offsets[tip + 1])
            if e - s == seq.size and np.array_equal(self._flat[s:e], seq):
                out.append(tip)
        return out

    def get(self, encoded_query: np.ndarray) -> list[int]:
        seq = np.asarray(encoded_query, dtype=np.uint8)
        h = self._hash_one(seq)
        lo = int(np.searchsorted(self._hashes, h, side="left"))
        hi = int(np.searchsorted(self._hashes, h, side="right"))
        return self._verify(lo, hi, seq)

    def get_batch(self, seqs: list[np.ndarray]) -> list[list[int]]:
        """Exact-match lookups for a whole batch: one native hashing pass +
        one vectorized binary search (most queries have no hash hit, so the
        per-query Python cost collapses to the rare candidate verification).
        """
        n = len(seqs)
        if n == 0:
            return []
        seqs = [np.asarray(s, dtype=np.uint8) for s in seqs]
        hs = None
        if self._native:
            from .. import native

            offsets = np.zeros(n + 1, dtype=np.int64)
            offsets[1:] = np.cumsum([s.shape[0] for s in seqs])
            flat = (
                np.concatenate(seqs) if offsets[-1] else np.empty(0, np.uint8)
            )
            hs = native.hash_sequences(flat, offsets, threads=1)
        if hs is None:  # numpy-built index (or lib vanished): per query
            return [self.get(s) for s in seqs]
        lo = np.searchsorted(self._hashes, hs, side="left")
        hi = np.searchsorted(self._hashes, hs, side="right")
        return [
            self._verify(int(lo[i]), int(hi[i]), seqs[i]) if hi[i] > lo[i]
            else []
            for i in range(n)
        ]

    def __eq__(self, other) -> bool:  # test convenience
        return isinstance(other, ExactIndex) and np.array_equal(
            self._hashes, other._hashes
        ) and np.array_equal(self._tips, other._tips)


@dataclass
class Database:
    taxonomy: Taxonomy
    #: [num_tips, 2048] uint32, or None when built with
    #: with_ref_major=False (pallas/stream/oracle paths never read it)
    ref_major: np.ndarray | None
    kmer_major: np.ndarray  #: [65537, n_words] uint32 postings bitvectors
    seq_flat: np.ndarray  #: uint8, concatenated 4-bit-encoded sequences
    seq_offsets: np.ndarray  #: int64 [num_tips+1]
    exact_map: ExactIndex  #: encoded sequence -> sorted tip ids
    #: reference-column layout of kmer_major (bitmatrix.build_kmer_major):
    #: "packed" = ref r at word r/32 bit r%32; "flat" = word r%W bit r/W,
    #: making the fold kernel's bit-major planes enumerate references in
    #: taxonomy order (no [B, n] permute before the significance scan)
    kmer_layout: str = "packed"

    @property
    def num_tips(self) -> int:
        return self.taxonomy.num_tips

    def sequence(self, tip: int) -> np.ndarray:
        return self.seq_flat[self.seq_offsets[tip] : self.seq_offsets[tip + 1]]

    def exact_matches(self, encoded_query: np.ndarray) -> list[int]:
        """Tip ids of references whose sequence equals the query byte-wise
        (reference: src/raxtax.rs:42; empty list when absent)."""
        return self.exact_map.get(np.asarray(encoded_query, dtype=np.uint8))


def _build_exact_map(seq_flat, seq_offsets, num_tips) -> ExactIndex:
    return ExactIndex(seq_flat, seq_offsets)


#: refuse the numpy bit-matrix fallback above this many references unless
#: RAXTAX_ALLOW_SLOW_BUILD=1 — the Python/numpy path costs tens of minutes
#: at 1M refs, and a silent fallback would eat a whole benchmark budget
_SLOW_BUILD_LIMIT = 200_000


#: below this many references the flat postings layout is pure waste: its
#: word count is fixed at a multiple of 1024 (bitmatrix.flat_words), so a
#: tiny database would carry a 1024-word row per k-mer where the packed
#: layout needs one or two
_FLAT_LAYOUT_MIN_REFS = 16384


def resolve_kmer_layout(kmer_layout: str, num_refs: int) -> str:
    """"auto" -> "flat" at scale (permute-free significance), "packed"
    below :data:`_FLAT_LAYOUT_MIN_REFS` (and for the mesh pipeline)."""
    if kmer_layout != "auto":
        return kmer_layout
    return "flat" if num_refs >= _FLAT_LAYOUT_MIN_REFS else "packed"


def build_database(
    lineages: list[str],
    sequences: "list[np.ndarray] | np.ndarray",
    threads: int = 0,
    with_ref_major: bool = True,
    kmer_layout: str = "auto",
) -> Database:
    """Build the full database from raw (file-order) records.

    Mirrors `Tree::new` (src/tree.rs:47-140): stable lineage sort, flattened
    tree, exact-match map keyed by encoded sequence, packed k-mer presence.
    `threads` sizes the native bit-matrix worker pool (0 = all cores),
    mirroring -t/--threads -> rayon (src/main.rs:119-124).

    `sequences` may be a list of 1-D 4-bit-encoded arrays (ragged) or one
    `[n, L]` 2-D array for uniform-length records — the 2-D form sorts and
    flattens with vectorized gathers instead of 1M-element Python loops.
    Logs per-stage wall times (the reference times its DB build as a
    first-class phase, src/tree.rs:46).
    """
    import logging
    import time

    log = logging.getLogger("raxtax")
    n = len(lineages)
    kmer_layout = resolve_kmer_layout(kmer_layout, n)
    if n != len(sequences):
        raise ValueError("lineage/sequence count mismatch")
    if n >= 2**31:
        raise ValueError("Too many database sequences for 32-bit indices")

    t0 = time.time()
    is_2d = isinstance(sequences, np.ndarray) and sequences.ndim == 2
    if is_2d:
        order = sorted(range(n), key=lambda i: lineages[i].encode("utf-8"))
        sorted_lineages = [lineages[i] for i in order]
        seq2d = np.ascontiguousarray(
            sequences[np.asarray(order, dtype=np.int64)], dtype=np.uint8
        )
        seq_flat = seq2d.reshape(-1)
        seq_offsets = np.arange(n + 1, dtype=np.int64) * seq2d.shape[1]
        sorted_seqs: list[np.ndarray] | None = None
    else:
        sorted_lineages, sorted_seqs = sort_records(lineages, list(sequences))
        seq_offsets = np.zeros(n + 1, dtype=np.int64)
        seq_offsets[1:] = np.cumsum([s.shape[0] for s in sorted_seqs])
        seq_flat = (
            np.concatenate(sorted_seqs) if n else np.empty(0, np.uint8)
        ).astype(np.uint8)
    t_sort = time.time()

    taxonomy = build_taxonomy(sorted_lineages)
    t_tax = time.time()

    from .. import native

    mats = native.build_bit_matrices_flat(
        seq_flat, seq_offsets, threads, with_ref_major=with_ref_major,
        kmer_layout=kmer_layout,
    )
    if mats is not None:
        ref_major, kmer_major = mats
    else:
        import os

        if n > _SLOW_BUILD_LIMIT and not os.environ.get(
            "RAXTAX_ALLOW_SLOW_BUILD"
        ):
            raise RuntimeError(
                f"native bit-matrix build unavailable and the numpy "
                f"fallback would take tens of minutes at {n} references; "
                f"install g++ (native/rx_host.cpp auto-builds) or set "
                f"RAXTAX_ALLOW_SLOW_BUILD=1 to proceed anyway"
            )
        if n > 10_000:
            log.warning(
                "native bit-matrix build unavailable: numpy fallback at "
                "%d references may take minutes", n,
            )
        if sorted_seqs is None:
            sorted_seqs = list(seq2d)
        ref_ids, kmers = bitmatrix.distinct_kmers_per_ref(sorted_seqs)
        ref_major = bitmatrix.build_ref_major(ref_ids, kmers, n)
        kmer_major = bitmatrix.build_kmer_major(
            ref_ids, kmers, n, kmer_layout=kmer_layout
        )
    t_bits = time.time()

    exact_map = _build_exact_map(seq_flat, seq_offsets, n)
    t_exact = time.time()
    log.info(
        "database build: sort+flatten %.1fs, taxonomy %.1fs, bit matrices "
        "%.1fs, exact index %.1fs (%d refs)",
        t_sort - t0, t_tax - t_sort, t_bits - t_tax, t_exact - t_bits, n,
    )
    return Database(
        taxonomy=taxonomy,
        ref_major=ref_major,
        kmer_major=kmer_major,
        seq_flat=seq_flat,
        seq_offsets=seq_offsets,
        exact_map=exact_map,
        kmer_layout=kmer_layout,
    )


def ensure_kmer_layout(db: Database, kmer_layout: str) -> Database:
    """Return `db` with kmer_major in the requested layout, rebuilding the
    postings matrix from the stored sequences when it differs (one native
    pass; the sharded mesh pipeline slices contiguous reference columns and
    therefore needs the packed layout, while the single-chip planes path
    wants flat — see bitmatrix.build_kmer_major)."""
    kmer_layout = resolve_kmer_layout(kmer_layout, db.num_tips)
    if db.kmer_layout == kmer_layout:
        return db
    import logging

    logging.getLogger("raxtax").info(
        "rebuilding kmer-major postings in %s layout (database holds %s)",
        kmer_layout, db.kmer_layout,
    )
    from .. import native

    mats = native.build_bit_matrices_flat(
        np.ascontiguousarray(db.seq_flat, np.uint8),
        np.ascontiguousarray(db.seq_offsets, np.int64),
        with_ref_major=False, kmer_layout=kmer_layout,
    )
    if mats is not None:
        km = mats[1]
    else:
        n = db.num_tips
        if n > _SLOW_BUILD_LIMIT and not os.environ.get(
            "RAXTAX_ALLOW_SLOW_BUILD"
        ):
            raise RuntimeError(
                "native build unavailable for the kmer-layout rebuild at "
                f"{n} references (set RAXTAX_ALLOW_SLOW_BUILD=1 to force "
                "the numpy path)"
            )
        seqs = [db.sequence(i) for i in range(n)]
        ref_ids, kmers = bitmatrix.distinct_kmers_per_ref(seqs)
        km = bitmatrix.build_kmer_major(
            ref_ids, kmers, n, kmer_layout=kmer_layout
        )
    db.kmer_major = km
    db.kmer_layout = kmer_layout
    return db


RXDB_MAGIC = b"RXDB0002"
_RXDB_ALIGN = 4096


def save_database(db: Database, path: str | Path) -> None:
    """Persist the binary DB cache (cf. src/tree.rs:147-153).

    Format v2: one file — a JSON header (array names, dtypes, shapes,
    offsets) followed by page-aligned raw array bytes. Unlike the v1 npz
    (a zip container that must be streamed through a decompressor), every
    array is `np.memmap`-addressable: loading a multi-GB database costs
    milliseconds, pages fault in lazily, and backends that never touch an
    array (the pallas path never reads the 8 GB ref-major matrix) never
    pay its IO.
    """
    import json

    tax = db.taxonomy
    lineage_blob = np.frombuffer(
        "\n".join(tax.lineages).encode("utf-8"), dtype=np.uint8
    )
    label_blob = np.frombuffer(
        "\n".join(tax.labels).encode("utf-8"), dtype=np.uint8
    )
    arrays = {
        "lineage_blob": lineage_blob,
        "label_blob": label_blob,
        "parent": tax.parent,
        "depth": tax.depth,
        "range_start": tax.range_start,
        "range_end": tax.range_end,
        "node_type": tax.node_type,
        "seq_offsets": db.seq_offsets,
        "seq_flat": db.seq_flat,
        # persisted exact-match index (sorted hash + tip arrays): loads
        # skip the full-seq_flat hashing pass entirely
        "exact_hashes": db.exact_map._hashes,
        "exact_tips": db.exact_map._tips,
        "kmer_major": db.kmer_major,
    }
    if db.ref_major is not None:
        arrays["ref_major"] = db.ref_major
    entries = {}
    # header is padded to one page; arrays start page-aligned after it
    offset = _RXDB_ALIGN
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        arrays[name] = arr
        entries[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
        }
        offset += (arr.nbytes + _RXDB_ALIGN - 1) // _RXDB_ALIGN * _RXDB_ALIGN
    header = json.dumps(
        {
            "magic": DB_MAGIC,
            "version": 2,
            "num_tips": int(tax.num_tips),
            "exact_native": bool(db.exact_map._native),
            "kmer_layout": db.kmer_layout,
            "arrays": entries,
        }
    ).encode("utf-8")
    assert len(header) + len(RXDB_MAGIC) < _RXDB_ALIGN, "header too large"
    with open(path, "wb") as f:
        f.write(RXDB_MAGIC)
        f.write(header)
        for name, arr in arrays.items():
            f.seek(entries[name]["offset"])
            arr.tofile(f)
        f.truncate(offset)


def _load_database_v2(path: str | Path) -> Database:
    import json

    with open(path, "rb") as f:
        head = f.read(_RXDB_ALIGN)
    if not head.startswith(RXDB_MAGIC):
        raise ValueError("not a raxtax-tpu v2 database")
    meta = json.loads(head[len(RXDB_MAGIC) :].split(b"\x00", 1)[0])
    if meta.get("magic") != DB_MAGIC or meta.get("version") != 2:
        raise ValueError("unsupported database header")

    def arr(name, mmap=True):
        e = meta["arrays"][name]
        shape = tuple(e["shape"])
        if mmap:
            return np.memmap(
                path, dtype=np.dtype(e["dtype"]), mode="r",
                offset=e["offset"], shape=shape,
            )
        with open(path, "rb") as f:
            f.seek(e["offset"])
            return np.fromfile(
                f, dtype=np.dtype(e["dtype"]),
                count=int(np.prod(shape)) if shape else 1,
            ).reshape(shape)

    num_tips = int(meta["num_tips"])
    lineages = bytes(arr("lineage_blob", mmap=False)).decode("utf-8").split("\n")
    labels = bytes(arr("label_blob", mmap=False)).decode("utf-8").split("\n")
    if num_tips == 0:
        lineages = []
    taxonomy = Taxonomy(
        lineages=lineages,
        labels=labels,
        parent=arr("parent", mmap=False),
        depth=arr("depth", mmap=False),
        range_start=arr("range_start", mmap=False),
        range_end=arr("range_end", mmap=False),
        node_type=arr("node_type", mmap=False),
        num_tips=num_tips,
    )
    # lazy mmap: only the exact-match verification and oracle/descent
    # replays slice individual sequences out of it; nothing streams the
    # whole 400-MB-at-1M blob at load time anymore
    seq_flat = arr("seq_flat")
    seq_offsets = arr("seq_offsets", mmap=False)
    if "exact_hashes" in meta["arrays"]:
        exact = ExactIndex.from_saved(
            seq_flat, seq_offsets,
            arr("exact_hashes", mmap=False),
            arr("exact_tips", mmap=False),
            meta.get("exact_native", False),
        )
    else:  # older cache: rebuild (hashes the whole blob)
        exact = _build_exact_map(seq_flat, seq_offsets, num_tips)
    return Database(
        taxonomy=taxonomy,
        # lazy mmap: pallas runs never fault it in; absent when the DB was
        # built with with_ref_major=False
        ref_major=(
            arr("ref_major") if "ref_major" in meta["arrays"] else None
        ),
        kmer_major=arr("kmer_major"),
        seq_flat=seq_flat,
        seq_offsets=seq_offsets,
        exact_map=exact,
        kmer_layout=meta.get("kmer_layout", "packed"),
    )


def load_database(path: str | Path) -> Database:
    """Load a binary DB (v2 page-aligned mmap format, or the older npz);
    raises on anything that isn't one (the caller falls back to FASTA
    parsing, cf. src/parser.rs:38-40)."""
    with open(path, "rb") as f:
        if f.read(len(RXDB_MAGIC)) == RXDB_MAGIC:
            return _load_database_v2(path)
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != DB_MAGIC:
            raise ValueError("not a raxtax-tpu database")
        version = int(z["version"])
        if version != DB_FORMAT_VERSION:
            raise ValueError(f"unsupported database version {version}")
        lineages = bytes(z["lineage_blob"]).decode("utf-8").split("\n")
        labels = bytes(z["label_blob"]).decode("utf-8").split("\n")
        num_tips = int(z["num_tips"])
        if num_tips == 0:
            lineages = []
        taxonomy = Taxonomy(
            lineages=lineages,
            labels=labels,
            parent=z["parent"],
            depth=z["depth"],
            range_start=z["range_start"],
            range_end=z["range_end"],
            node_type=z["node_type"],
            num_tips=num_tips,
        )
        seq_flat = z["seq_flat"]
        seq_offsets = z["seq_offsets"]
        return Database(
            taxonomy=taxonomy,
            ref_major=z["ref_major"],
            kmer_major=z["kmer_major"],
            seq_flat=seq_flat,
            seq_offsets=seq_offsets,
            exact_map=_build_exact_map(seq_flat, seq_offsets, num_tips),
        )


def load_or_parse_database(
    path: str | Path, threads: int = 0, with_ref_major: bool = True,
    kmer_layout: str = "auto",
) -> tuple[bool, Database]:
    """Binary-DB fast path with FASTA fallback (src/parser.rs:36-44).

    Returns (parsed_from_fasta, db). `with_ref_major=False` skips building
    the [N, 2048] ref-major matrix on the FASTA path — only the xla
    bit-matmul backend reads it (engine/device.py), and at 1M references it
    is ~8 GB of build time, cache bytes and load faults the pallas/stream
    backends never touch. A binary DB loads whatever it contains (a
    mismatched `kmer_layout` postings matrix is rebuilt in one native
    pass); the engine raises an actionable error if xla later needs the
    ref-major matrix.
    """
    try:
        db = load_database(path)
    except Exception:
        db = None
    if db is not None:
        return False, ensure_kmer_layout(db, kmer_layout)
    from ..io.fasta import parse_reference_fasta_file

    records = parse_reference_fasta_file(path)
    return True, build_database(
        records.lineages, records.sequences, threads=threads,
        with_ref_major=with_ref_major, kmer_layout=kmer_layout,
    )
