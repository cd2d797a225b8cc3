"""ctypes loader for the native host kernels (native/rx_host.cpp).

Auto-builds the shared library with g++ on first use (cached by source
mtime) into this package's own ``build/native`` directory; every entry
point has a pure-numpy fallback, so the package works — just slower —
without a compiler (host code only: the device kernels under ``csrc/``
have no such fallback). Plain C ABI + ctypes, no binding generator.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger("raxtax")

_SRC = Path(__file__).resolve().parent.parent / "native" / "rx_host.cpp"
_LIB_DIR = Path(
    os.environ.get(
        "RAXTAX_TORCH_NATIVE_DIR",
        Path(__file__).resolve().parent / "build" / "native",
    )
)
_lib = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> Path | None:
    if not _SRC.is_file():
        return None
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    lib = _LIB_DIR / f"rx_host_{int(_SRC.stat().st_mtime)}.so"
    if lib.is_file():
        return lib
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", str(tmp), str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except Exception as e:  # missing compiler, etc.
        log.info("native build failed (%s); using numpy fallbacks", e)
        tmp.unlink(missing_ok=True)
        return None
    return lib


def get_lib():
    """The loaded native library, or None (numpy fallbacks apply)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("RAXTAX_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.rx_build_ref_major.argtypes = [
            _u8p, _i64p, ctypes.c_int64, _u32p, _i32p, ctypes.c_int32,
        ]
        lib.rx_build_kmer_major.argtypes = [
            _u32p, ctypes.c_int64, _u32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.rx_build_kmer_major_direct.argtypes = [
            _u8p, _i64p, ctypes.c_int64, _u32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,
        ]
        lib.rx_distinct_kmers.restype = ctypes.c_int64
        lib.rx_distinct_kmers.argtypes = [_u8p, ctypes.c_int64, _u16p]
        lib.rx_distinct_kmers_batch.argtypes = [_u8p, _i64p, ctypes.c_int64, _u16p, _i64p]
        lib.rx_pack_query_rows.argtypes = [_u8p, _i64p, ctypes.c_int64, _u32p]
        lib.rx_hash_sequences.argtypes = [
            _u8p, _i64p, ctypes.c_int64, _u64p, ctypes.c_int32,
        ]
        lib.rx_tip_cumsum_nibble.argtypes = [
            _u32p, _i32p, _u16p, ctypes.c_int64, _f64p, ctypes.c_int64, _f64p,
        ]
        lib.rx_tip_cumsum_u16.argtypes = [_u16p, _f64p, ctypes.c_int64, _f64p]
        lib.rx_tip_cumsum_planes4.argtypes = [
            _u32p, ctypes.c_int64, _i32p, _u16p, ctypes.c_int64, _f64p,
            ctypes.c_int64, _f64p, ctypes.c_int64,
        ]
        lib.rx_evaluate.restype = ctypes.c_int
        lib.rx_evaluate.argtypes = [
            _i32p, _u8p, _i32p, _i32p, ctypes.c_int64,
            _u8p, _i64p,
            ctypes.c_char_p, ctypes.c_int64,
            _i32p, _f64p, ctypes.c_int64,
            _i32p, _i32p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
            _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            _u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rx_evaluate_batch.restype = ctypes.c_int
        lib.rx_evaluate_batch.argtypes = [
            _i32p, _u8p, _i32p, _i32p, ctypes.c_int64,
            _u8p, _i64p,
            _u8p, _i64p,
            _i32p, _f64p, _i64p,
            _i32p, _i32p, _i64p,
            _f64p, _i32p, ctypes.c_int32,
            _u8p, _i64p,
            ctypes.c_int64,
            _u8p, ctypes.c_int64, _i64p,
            _u8p, ctypes.c_int64, _i64p,
            _i32p,
        ]
        lib.rx_find_sites.restype = ctypes.c_int64
        lib.rx_find_sites.argtypes = [
            _i32p, _f64p, _i64p, ctypes.c_int64,
            _i32p, _u8p, _i32p, _i32p, ctypes.c_int64,
        ]
        lib.rx_descend_planes4_batch.argtypes = [
            _u32p, ctypes.c_int64, _i32p, _u16p, ctypes.c_int64, _i64p,
            _f64p, _i64p, ctypes.c_int64,
            _i32p, _i32p, ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _u8p, _i32p, ctypes.c_int64,
        ]
        lib.rx_parse_fasta.restype = ctypes.c_int
        lib.rx_parse_fasta.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int,
            _u8p, _i64p, _i64p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rx_baseline_intersect.restype = ctypes.c_int64
        lib.rx_baseline_intersect.argtypes = [
            _i32p, _i64p, _u16p, ctypes.c_int64,
            _u16p, ctypes.c_int64, _i64p,
        ]
        _lib = lib
        log.info("native host kernels loaded: %s", path)
    except OSError as e:
        log.info("native load failed (%s); using numpy fallbacks", e)
    return _lib


# ---------------------------------------------------------------- wrappers

REF_WORDS = 2048
NUM_KMERS = 1 << 16


def _flatten(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([s.shape[0] for s in seqs])
    flat = (
        np.concatenate(seqs).astype(np.uint8)
        if seqs
        else np.empty(0, np.uint8)
    )
    return np.ascontiguousarray(flat), offsets


def resolve_threads(threads: int = 0) -> int:
    """0 -> all available cores (reference: src/main.rs:119-124)."""
    if threads and threads > 0:
        return threads
    return os.cpu_count() or 1


def build_bit_matrices_flat(
    flat: np.ndarray, offsets: np.ndarray, threads: int = 0,
    with_ref_major: bool = True, kmer_layout: str = "packed",
) -> tuple[np.ndarray | None, np.ndarray] | None:
    """(ref_major [n,2048] u32 or None, kmer_major postings matrix u32)
    via the native one-pass build, from pre-flattened sequences, or None
    when the library is unavailable.

    `with_ref_major=False` skips the ref-major matrix entirely (the
    Pallas/stream backends and the host oracle never read it) — at 1M refs
    that halves the build's fresh-memory footprint, which dominates build
    time on hosts with slow page-fault provisioning.

    `kmer_layout` selects the reference-column layout of kmer_major:
    "packed" = ref r at word r/32, bit r%32 (width ceil(n/32));
    "flat" = ref r at word r%W, bit r/W with W lane-padded
    (db.bitmatrix.flat_words) — the fold kernel's bit-major expansion then
    enumerates references in taxonomy order, so the device needs no
    [B, n] permute before the significance prefix scan.

    `threads` sizes the native worker pool (0 = all cores) — the reference
    parallelizes its postings build the same way (src/tree.rs:134-137)."""
    lib = get_lib()
    if lib is None:
        return None
    from .db.bitmatrix import flat_words

    n = offsets.shape[0] - 1
    nt = resolve_threads(threads)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    flat_w = flat_words(n) if kmer_layout == "flat" else 0
    nw = flat_w if flat_w else max(1, -(-n // 32))
    kmer_major = np.zeros((NUM_KMERS + 1, nw), dtype=np.uint32)
    if not with_ref_major:
        if n:
            lib.rx_build_kmer_major_direct(
                flat, offsets, n, kmer_major, nw, nt, flat_w
            )
        return None, kmer_major
    ref_major = np.zeros((max(n, 1), REF_WORDS), dtype=np.uint32)
    counts = np.zeros(max(n, 1), dtype=np.int32)
    if n:
        lib.rx_build_ref_major(flat, offsets, n, ref_major, counts, nt)
        lib.rx_build_kmer_major(ref_major, n, kmer_major, nw, nt, flat_w)
    return ref_major[:n] if n else ref_major[:0], kmer_major


def build_bit_matrices(
    seqs: list[np.ndarray], threads: int = 0
) -> tuple[np.ndarray, np.ndarray] | None:
    """List-of-sequences convenience wrapper over
    :func:`build_bit_matrices_flat`."""
    if get_lib() is None:
        return None
    flat, offsets = _flatten(seqs)
    return build_bit_matrices_flat(flat, offsets, threads=threads)


def distinct_kmers(seq: np.ndarray) -> np.ndarray | None:
    """Sorted distinct 8-mers of one 4-bit sequence, or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(NUM_KMERS, dtype=np.uint16)
    s = np.ascontiguousarray(seq, dtype=np.uint8)
    m = lib.rx_distinct_kmers(s, s.shape[0], out)
    return out[:m].copy()


def hash_sequences(
    flat: np.ndarray, offsets: np.ndarray, threads: int = 0
) -> np.ndarray | None:
    """u64 FNV-1a hash of every segment, or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = offsets.shape[0] - 1
    out = np.empty(max(n, 1), dtype=np.uint64)
    if n:
        lib.rx_hash_sequences(
            np.ascontiguousarray(flat, np.uint8),
            np.ascontiguousarray(offsets, np.int64),
            n, out, resolve_threads(threads),
        )
    return out[:n]


def distinct_kmers_flat(
    seqs: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray] | None:
    """(kmers u16 flat, offsets i64 [n+1]) — every sequence's sorted
    distinct 8-mers in one native pass, or None w/o the lib. Replaces n
    per-query ctypes calls in the engine's submit phase."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(seqs)
    if n == 0:
        return np.zeros(0, np.uint16), np.zeros(1, np.int64)
    flat, offsets = _flatten(seqs)
    # each input base opens at most one window
    out = np.empty(max(flat.size, 1), dtype=np.uint16)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    lib.rx_distinct_kmers_batch(flat, offsets, n, out, out_offsets)
    return out, out_offsets


def distinct_kmer_counts(seqs: list[np.ndarray]) -> np.ndarray | None:
    """Distinct-8-mer count of every sequence (int64 [n]), or None w/o the
    lib. One native pass; feeds DeviceClassifier.prewarm."""
    res = distinct_kmers_flat(seqs)
    if res is None:
        return None
    return np.diff(res[1])


def parse_fasta(
    data: bytes, with_tax: bool
) -> tuple[list[str], list[np.ndarray]] | None:
    """One-pass FASTA parse + 4-bit encode (reference: src/parser.rs:36-154).

    Returns (labels, encoded_sequences) — labels are lineages in reference
    mode, full headers in query mode. None when the native lib is missing
    OR the input has any error (callers re-run the Python parser for the
    reference's exact error messages).
    """
    lib = get_lib()
    if lib is None or not data:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    max_records = int(np.count_nonzero(buf == ord(">"))) + 1
    seq_out = np.empty(buf.shape[0], dtype=np.uint8)
    seq_offsets = np.zeros(max_records + 1, dtype=np.int64)
    label_ranges = np.zeros(2 * max_records + 2, dtype=np.int64)
    n_records = ctypes.c_int64(0)
    rc = lib.rx_parse_fasta(
        np.ascontiguousarray(buf), buf.shape[0], 1 if with_tax else 0,
        seq_out, seq_offsets, label_ranges, ctypes.byref(n_records),
    )
    if rc != 0:
        return None
    m = int(n_records.value)
    labels = [
        data[label_ranges[2 * i] : label_ranges[2 * i + 1]].decode("utf-8")
        for i in range(m)
    ]
    seqs = [
        seq_out[seq_offsets[i] : seq_offsets[i + 1]].copy() for i in range(m)
    ]
    return labels, seqs


def tip_cumsum_nibble(
    plane_row: np.ndarray,  # u32 nibble plane of one query
    over_idx: np.ndarray,  # i32 ascending overflow tips
    over_val: np.ndarray,  # u16 overflow counts
    n_over: int,
    table64: np.ndarray,  # f64 per-size probabilities
    num_tips: int,
) -> np.ndarray | None:
    """cum[num_tips+1] f64 sequential prefix sum, or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    cum = np.empty(num_tips + 1, dtype=np.float64)
    lib.rx_tip_cumsum_nibble(
        np.ascontiguousarray(plane_row, np.uint32),
        np.ascontiguousarray(over_idx, np.int32),
        np.ascontiguousarray(over_val, np.uint16),
        n_over,
        np.ascontiguousarray(table64, np.float64),
        num_tips,
        cum,
    )
    return cum


def tip_cumsum_planes4(
    lo4_row: np.ndarray,  # [4, S, 128] u32 tier planes of one query
    over_idx: np.ndarray,  # i32 ascending overflow tips
    over_val: np.ndarray,  # u16 overflow counts
    n_over: int,
    table64: np.ndarray,  # f64 per-size probabilities
    num_tips: int,
    flat_w: int = 0,  # 0 = packed tip layout; W = flat (word q%W, bit q/W)
) -> np.ndarray | None:
    """cum[num_tips+1] f64 sequential prefix sum from the planes wire
    format, or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    planes = np.ascontiguousarray(lo4_row, np.uint32).reshape(4, -1)
    cum = np.empty(num_tips + 1, dtype=np.float64)
    lib.rx_tip_cumsum_planes4(
        planes,
        planes.shape[1],
        np.ascontiguousarray(over_idx, np.int32),
        np.ascontiguousarray(over_val, np.uint16),
        n_over,
        np.ascontiguousarray(table64, np.float64),
        num_tips,
        cum,
        flat_w,
    )
    return cum


def tip_cumsum_u16(
    row: np.ndarray, table64: np.ndarray, num_tips: int
) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    cum = np.empty(num_tips + 1, dtype=np.float64)
    lib.rx_tip_cumsum_u16(
        np.ascontiguousarray(row[:num_tips], np.uint16),
        np.ascontiguousarray(table64, np.float64),
        num_tips,
        cum,
    )
    return cum


def descend_planes4_batch(
    lo4: np.ndarray,  # [n_rows, 4, S, 128] u32 tier planes (whole wire)
    over_idx: np.ndarray,  # [n_rows, budget] i32 ascending overflow tips
    over_val: np.ndarray,  # [n_rows, budget] u16 overflow counts
    n_over: np.ndarray,  # [n_rows] overflow lengths
    tables64: list,  # per-row f64 tables (indexed by wire row)
    rows: np.ndarray,  # [n_sites] i32 wire row per site (grouped by row)
    nodes: np.ndarray,  # [n_sites] i32 global start node per site
    num_tips: int,
    range_start: np.ndarray,
    range_end: np.ndarray,
    child_ptr: np.ndarray,
    child_ids: np.ndarray,
    node_type: np.ndarray,
    flat_w: int = 0,  # 0 = packed tip layout; W = flat (word q%W, bit q/W)
) -> np.ndarray | None:
    """Final node per site from one batched host pass (exact sequential-f64
    prefix sums, reference max_by tie semantics — src/lineage.rs:151-177),
    or None w/o the lib. Each wire row's cumsum is built once; the site
    list must arrive grouped by row (engine sites are query-sorted)."""
    lib = get_lib()
    if lib is None or rows.size == 0:
        return None if lib is None else np.empty(0, np.int32)
    lo4 = np.ascontiguousarray(lo4, np.uint32)
    n_rows = lo4.shape[0]
    plane_words = lo4.reshape(n_rows, 4, -1).shape[2]
    # tables are ragged per row; concatenate in row order with offsets.
    # Rows never referenced by a site still need a (cheap) slot: reuse an
    # empty region by pointing their offset at 0 length... the C side only
    # dereferences offsets of referenced rows, but build densely anyway
    # to keep the contract simple.
    offs = np.zeros(n_rows + 1, np.int64)
    parts = []
    pos = 0
    for r in range(n_rows):
        t = tables64[r] if r < len(tables64) and tables64[r] is not None \
            else np.zeros(1, np.float64)
        offs[r] = pos
        parts.append(np.ascontiguousarray(t, np.float64))
        pos += parts[-1].shape[0]
    offs[n_rows] = pos
    tables_flat = (
        np.concatenate(parts) if parts else np.zeros(1, np.float64)
    )
    out = np.empty(rows.shape[0], np.int32)
    lib.rx_descend_planes4_batch(
        lo4,
        plane_words,
        np.ascontiguousarray(over_idx, np.int32),
        np.ascontiguousarray(over_val, np.uint16),
        over_idx.shape[1],
        np.ascontiguousarray(n_over, np.int64),
        tables_flat,
        offs,
        num_tips,
        np.ascontiguousarray(rows, np.int32),
        np.ascontiguousarray(nodes, np.int32),
        rows.shape[0],
        np.ascontiguousarray(range_start, np.int32),
        np.ascontiguousarray(range_end, np.int32),
        np.ascontiguousarray(child_ptr, np.int32),
        np.ascontiguousarray(child_ids, np.int32),
        np.ascontiguousarray(node_type, np.uint8),
        out,
        flat_w,
    )
    return out


def pack_query_rows(seqs: list[np.ndarray]) -> np.ndarray | None:
    """[len(seqs), 2048] u32 query presence rows, or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(seqs)
    rows = np.zeros((max(n, 1), REF_WORDS), dtype=np.uint32)
    if n:
        flat, offsets = _flatten(seqs)
        lib.rx_pack_query_rows(flat, offsets, n, rows)
    return rows[:n]


def find_sites(
    nodes: np.ndarray,  # i32 packed significant nodes (GLOBAL ids)
    vals: np.ndarray,  # f64 unrounded confidences, same packing
    offsets: np.ndarray,  # i64 [B+1] per-query slices
    parent: np.ndarray,  # i32 [n_nodes]
    node_type: np.ndarray,  # u8 [n_nodes]
) -> tuple[np.ndarray, np.ndarray] | None:
    """(site_query i32 [M], site_node i32 [M]) fallback-descent starts for
    the whole batch (engine finalize semantics), or None w/o the lib."""
    lib = get_lib()
    if lib is None:
        return None
    n_q = offsets.shape[0] - 1
    nodes = np.ascontiguousarray(nodes, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    parent = np.ascontiguousarray(parent, np.int32)
    node_type = np.ascontiguousarray(node_type, np.uint8)
    cap = max(4 * n_q, 64)
    while True:
        out_q = np.empty(cap, np.int32)
        out_n = np.empty(cap, np.int32)
        m = lib.rx_find_sites(
            nodes, vals, offsets, n_q, parent, node_type, out_q, out_n, cap
        )
        if m >= 0:
            return out_q[:m].copy(), out_n[:m].copy()
        cap = -m


class NativeEvaluator:
    """Per-query lineage evaluation + formatting through rx_evaluate.

    Holds the DB-constant operands (flattened taxonomy arrays, the
    per-tip lineage-string blob); :meth:`evaluate` formats one query's
    `.out`/`.tsv` text blocks. Returns None from :func:`create` when the
    native library is unavailable (callers keep the Python replay).
    """

    def __init__(self, lib, db):
        tax = db.taxonomy
        self._lib = lib
        self._parent = np.ascontiguousarray(tax.parent, np.int32)
        self._node_type = np.ascontiguousarray(tax.node_type, np.uint8)
        self._rs = np.ascontiguousarray(tax.range_start, np.int32)
        self._re = np.ascontiguousarray(tax.range_end, np.int32)
        self._num_tips = int(tax.num_tips)
        encoded = [l.encode("utf-8") for l in tax.lineages]
        self._lin_offsets = np.zeros(len(encoded) + 1, np.int64)
        self._lin_offsets[1:] = np.cumsum([len(e) for e in encoded])
        self._lin_blob = np.frombuffer(
            b"".join(encoded) or b"\x00", np.uint8
        ).copy()
        self._out_buf = np.empty(1 << 16, np.uint8)
        self._tsv_buf = np.empty(1 << 16, np.uint8)

    @classmethod
    def create(cls, db) -> "NativeEvaluator | None":
        lib = get_lib()
        if lib is None:
            return None
        return cls(lib, db)

    def evaluate_batch(
        self,
        labels: list[str],
        sig_nodes: np.ndarray,  # i32 packed (CSR over queries); any order
        sig_vals: np.ndarray,  # f64, same packing
        sig_offsets: np.ndarray,  # i64 [B+1]
        fb_starts: np.ndarray,  # i32 packed fallback start nodes
        fb_leaves: np.ndarray,  # i32 packed precomputed leaves
        fb_offsets: np.ndarray,  # i64 [B+1]
        global_signals: np.ndarray,  # f64 [B]
        override_tips: np.ndarray,  # i32 [B], -1 = no override
        seqs: list[np.ndarray],  # 4-bit encoded (decompressed in C for tsv)
        want_tsv: bool = True,
    ) -> tuple[list[str | None], list[str | None]]:
        """One native call for the whole batch: per-query (out_text,
        tsv_text), with None entries for queries the native path declined
        (missing fallback / no results) — callers replay those in Python."""
        B = len(labels)
        lab_enc = [l.encode("utf-8") for l in labels]
        lab_off = np.zeros(B + 1, np.int64)
        lab_off[1:] = np.cumsum([len(e) for e in lab_enc])
        lab_blob = np.frombuffer(b"".join(lab_enc) or b"\x00", np.uint8)
        if want_tsv:
            seq_blob, seq_off = _flatten([np.asarray(s) for s in seqs])
            if seq_blob.size == 0:
                seq_blob = np.zeros(1, np.uint8)
        else:
            seq_blob = np.zeros(1, np.uint8)
            seq_off = np.zeros(B + 1, np.int64)
        status = np.zeros(B, np.int32)
        out_off = np.zeros(B + 1, np.int64)
        tsv_off = np.zeros(B + 1, np.int64)
        sig_nodes = np.ascontiguousarray(sig_nodes, np.int32)
        sig_vals = np.ascontiguousarray(sig_vals, np.float64)
        sig_offsets = np.ascontiguousarray(sig_offsets, np.int64)
        fb_starts = np.ascontiguousarray(fb_starts, np.int32)
        fb_leaves = np.ascontiguousarray(fb_leaves, np.int32)
        fb_offsets = np.ascontiguousarray(fb_offsets, np.int64)
        global_signals = np.ascontiguousarray(global_signals, np.float64)
        override_tips = np.ascontiguousarray(override_tips, np.int32)
        for _ in range(3):
            rc = self._lib.rx_evaluate_batch(
                self._parent, self._node_type, self._rs, self._re,
                self._num_tips,
                self._lin_blob, self._lin_offsets,
                np.ascontiguousarray(lab_blob), lab_off,
                sig_nodes, sig_vals, sig_offsets,
                fb_starts, fb_leaves, fb_offsets,
                global_signals, override_tips, 1 if want_tsv else 0,
                np.ascontiguousarray(seq_blob), seq_off,
                B,
                self._out_buf, self._out_buf.shape[0], out_off,
                self._tsv_buf, self._tsv_buf.shape[0], tsv_off,
                status,
            )
            if rc == 1:  # grow and retry
                self._out_buf = np.empty(
                    max(int(out_off[B]) + 64, 1 << 16), np.uint8
                )
                self._tsv_buf = np.empty(
                    max(int(tsv_off[B]) + 64, 1 << 16), np.uint8
                )
                continue
            break
        else:
            return [None] * B, [None] * B
        out_blob = self._out_buf[: out_off[B]].tobytes()
        tsv_blob = self._tsv_buf[: tsv_off[B]].tobytes()
        outs: list[str | None] = []
        tsvs: list[str | None] = []
        for q in range(B):
            if status[q] != 0:
                outs.append(None)
                tsvs.append(None)
                continue
            outs.append(out_blob[out_off[q] : out_off[q + 1]].decode("utf-8"))
            tsvs.append(
                tsv_blob[tsv_off[q] : tsv_off[q + 1]].decode("utf-8")
                if want_tsv
                else ""
            )
        return outs, tsvs

    def evaluate(
        self,
        label: str,
        sig_nodes: np.ndarray,  # i32, ascending node ids
        sig_vals: np.ndarray,  # f64
        fb_starts: np.ndarray,  # i32
        fb_leaves: np.ndarray,  # i32
        global_signal: float,
        override_tip: int,  # -1 = no single-exact-match override
        seq_str: str,
        want_tsv: bool = True,
    ) -> tuple[str, str] | None:
        """(out_text, tsv_text), or None if the native path declined
        (missing fallback entry / no results) — caller uses the Python
        replay."""
        lab = label.encode("utf-8")
        seq = seq_str.encode("utf-8")
        out_len = ctypes.c_int64(0)
        tsv_len = ctypes.c_int64(0)
        for _ in range(3):
            rc = self._lib.rx_evaluate(
                self._parent, self._node_type, self._rs, self._re,
                self._num_tips,
                self._lin_blob, self._lin_offsets,
                lab, len(lab),
                np.ascontiguousarray(sig_nodes, np.int32),
                np.ascontiguousarray(sig_vals, np.float64),
                len(sig_nodes),
                np.ascontiguousarray(fb_starts, np.int32),
                np.ascontiguousarray(fb_leaves, np.int32),
                len(fb_starts),
                float(global_signal), int(override_tip),
                1 if want_tsv else 0,
                seq, len(seq),
                self._out_buf, self._out_buf.shape[0],
                ctypes.byref(out_len),
                self._tsv_buf, self._tsv_buf.shape[0],
                ctypes.byref(tsv_len),
            )
            if rc == 1:  # grow buffers and retry
                self._out_buf = np.empty(
                    max(int(out_len.value) + 64, 1 << 16), np.uint8
                )
                self._tsv_buf = np.empty(
                    max(int(tsv_len.value) + 64, 1 << 16), np.uint8
                )
                continue
            if rc != 0:
                return None
            return (
                self._out_buf[: out_len.value].tobytes().decode("utf-8"),
                self._tsv_buf[: tsv_len.value].tobytes().decode("utf-8"),
            )
        return None
