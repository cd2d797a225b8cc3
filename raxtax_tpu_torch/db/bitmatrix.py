"""Packed k-mer presence bit matrices.

The reference stores an inverted index `k_mer_map: Vec<Vec<u32>>` mapping each
16-bit 8-mer to a sorted postings list of reference ids (src/tree.rs:114-137)
and walks it with a scatter-add (src/raxtax.rs:58-64). That layout is
CPU-idiomatic; the TPU dual is a dense packed bit matrix:

- **ref-major** `R[num_refs, 2048] uint32`: bit k of row n set iff reference n
  contains k-mer k. Feeds the XLA unpack+matmul counts path.
- **kmer-major** `P[65537, ceil(N/32)] uint32` (transposed postings
  bitvectors; one extra all-zero row used as the padding target): bit n of row
  k set iff reference n contains k-mer k. Feeds the Pallas gather +
  bit-sliced-popcount kernel.

Both are built host-side with vectorized numpy from the COO (ref, kmer) pairs.
"""

from __future__ import annotations

import numpy as np

from ..utils.encoding import NUM_KMERS, sequence_to_kmers

WORD_BITS = 32
REF_WORDS = NUM_KMERS // WORD_BITS  # 2048 words per reference row


def distinct_kmers_per_ref(
    sequences: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Sorted distinct 8-mers of every reference, as a ragged COO.

    Returns (ref_ids int32 [nnz], kmers uint16 [nnz]) sorted by ref id then
    kmer. Mirrors the per-record windowing at src/tree.rs:114-123 plus the
    per-kmer dedup at src/tree.rs:134-137.
    """
    refs = []
    kms = []
    for i, seq in enumerate(sequences):
        k = sequence_to_kmers(seq)
        kms.append(k)
        refs.append(np.full(k.shape[0], i, dtype=np.int32))
    if not kms:
        return np.empty(0, np.int32), np.empty(0, np.uint16)
    return np.concatenate(refs), np.concatenate(kms)


def _set_bits(shape: tuple[int, int], rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Dense uint32 bit matrix with bit (rows, cols) set, vectorized.

    Groups (row, word) pairs and ORs bit masks with `bitwise_or.reduceat`,
    avoiding the slow `ufunc.at` scatter.
    """
    n_rows, n_words = shape
    out = np.zeros(n_rows * n_words, dtype=np.uint32)
    if rows.size == 0:
        return out.reshape(shape)
    word = cols.astype(np.int64) >> 5
    bit = np.uint32(1) << (cols.astype(np.uint32) & np.uint32(31))
    flat = rows.astype(np.int64) * n_words + word
    order = np.argsort(flat, kind="stable")
    flat = flat[order]
    bit = bit[order]
    starts = np.nonzero(np.concatenate(([True], flat[1:] != flat[:-1])))[0]
    out[flat[starts]] = np.bitwise_or.reduceat(bit, starts)
    return out.reshape(shape)


def build_ref_major(
    ref_ids: np.ndarray, kmers: np.ndarray, num_refs: int
) -> np.ndarray:
    """[num_refs, 2048] uint32 presence matrix (bit index = kmer)."""
    return _set_bits((num_refs, REF_WORDS), ref_ids, kmers.astype(np.int64))


def flat_words(num_refs: int) -> int:
    """Word count W of the FLAT postings layout, with capacity
    32*W >= num_refs. W is a multiple of 1024 = LANE(128) x 8 sublanes so
    NO device-side prep (dense fold, block-sparse fold, stream) ever pads
    the matrix further — the flat tip mapping (word q%W, bit q/W) is baked
    into the matrix and any later width change would shear it."""
    return 1024 * max(1, -(-num_refs // (WORD_BITS * 1024)))


def build_kmer_major(
    ref_ids: np.ndarray, kmers: np.ndarray, num_refs: int,
    kmer_layout: str = "packed",
) -> np.ndarray:
    """[65537, n_words] uint32 postings bitvectors.

    Row 65536 is all zeros — the scatter target for padded query k-mers in
    the Pallas kernel. `kmer_layout` picks the reference-column layout:
    "packed" puts ref r at word r/32, bit r%32 (n_words = ceil(n/32));
    "flat" puts ref r at word r%W, bit r/W (n_words = :func:`flat_words`),
    so the fold kernel's bit-major planes enumerate references in taxonomy
    order and the significance stage skips its [B, n] permute.
    """
    refs = ref_ids.astype(np.int64)
    if kmer_layout == "flat":
        w = flat_words(num_refs)
        cols = (refs % w) * WORD_BITS + refs // w
        return _set_bits((NUM_KMERS + 1, w), kmers.astype(np.int64), cols)
    n_words = max(1, -(-num_refs // WORD_BITS))
    return _set_bits((NUM_KMERS + 1, n_words), kmers.astype(np.int64), refs)


def pack_query_kmers(kmer_sets: list[np.ndarray]) -> np.ndarray:
    """[B, 2048] uint32 query presence rows from per-query distinct kmers."""
    rows = np.concatenate(
        [np.full(k.shape[0], i, dtype=np.int64) for i, k in enumerate(kmer_sets)]
    ) if kmer_sets else np.empty(0, np.int64)
    cols = (
        np.concatenate(kmer_sets).astype(np.int64)
        if kmer_sets
        else np.empty(0, np.int64)
    )
    return _set_bits((len(kmer_sets), REF_WORDS), rows, cols)
