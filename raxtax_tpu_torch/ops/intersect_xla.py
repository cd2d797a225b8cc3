"""The dense intersection counts: bit-unpack + matrix product.

``counts[b, n] = popcount(query_bits[b] & ref_bits[n])`` as the product of
the two 65,536-wide 0/1 vectors, the dense dual of the reference's
inverted-index walk (src/raxtax.rs:54-64). Port of
``ops/intersect_xla.py`` of the JAX package, where the product is left to
XLA; here it is left to ``torch.matmul`` (a plain product outside any
kernel). The one-hot vectors are never whole in memory: the packed words are
unpacked slab by slab (64 words = 2,048 columns) and, on the reference side,
chunk by chunk of references.

Exactness. A slab's product is an integer of at most 2,048. On the GPU the
operands are float16 (tensor cores) and so is each slab's product: every
integer up to 2,048 — and so every partial sum, whatever the order of the
adds — is a float16 value, so nothing rounds; the slabs accumulate in
float32, exact below 2^24. bfloat16, which the TPU's matrix unit accumulates
in float32, holds integers only up to 256 in a PyTorch product's output. On
the CPU the operands are float32.
"""

from __future__ import annotations

import torch

from .bitops import unpack_bits

SLAB_WORDS = 64  #: words per product step (64 * 32 = 2,048 one-hot columns)
REF_CHUNK = 65536  #: references unpacked at once


def intersection_counts_xla(
    query_bits: torch.Tensor,  # [B, 2048] int32 bit patterns
    ref_bits: torch.Tensor,  # [N, 2048] int32 bit patterns
    slab_words: int = SLAB_WORDS,
) -> torch.Tensor:  # [B, N] float32 (exact integers)
    n_words = query_bits.shape[-1]
    if ref_bits.shape[-1] != n_words or n_words % slab_words:
        raise ValueError("query and reference rows must share a word count "
                         "that is a multiple of the slab")
    B, N = query_bits.shape[0], ref_bits.shape[0]
    work = torch.float16 if query_bits.is_cuda else torch.float32
    counts = torch.zeros((B, N), dtype=torch.float32, device=query_bits.device)
    for w0 in range(0, n_words, slab_words):
        qb = unpack_bits(query_bits[:, w0 : w0 + slab_words], work)
        for n0 in range(0, N, REF_CHUNK):
            rb = unpack_bits(
                ref_bits[n0 : n0 + REF_CHUNK, w0 : w0 + slab_words], work
            )
            counts[:, n0 : n0 + REF_CHUNK] += torch.matmul(qb, rb.T)
    return counts


def zero_reference_ids(counts: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Zero the counts of the given reference ids per query
    (src/raxtax.rs:65-68). ``ids`` is ``[B, E]`` int, padded with -1; used
    by ``--skip-exact-matches``. Updates ``counts`` in place and returns
    it."""
    ids = ids.long()
    rows, slots = torch.nonzero(ids >= 0, as_tuple=True)
    counts[rows, ids[rows, slots]] = 0.0
    return counts
