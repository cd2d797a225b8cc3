"""Synthetic COI-like worlds for smoke tests and profiles.

Family consensus sequences plus point mutations, a six-level lineage per
record, and queries derived from the same families — the generator the JAX
package's ``bench.py`` uses (same seeds, same draws), so both packages can
be driven on the same world. Everything is made from seeds at run time.
"""

from __future__ import annotations

import time

import numpy as np

SEQ_LEN = 400
N_FAMILIES = 512

_ENC = np.array([1, 2, 4, 8], dtype=np.uint8)  # 4-bit A/C/G/T codes


def synth_fam(seed: int = 42):
    """The family consensus sequences (queries derive from these too)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(N_FAMILIES, SEQ_LEN), dtype=np.int8), rng


def synth_records(n_refs: int, fam: np.ndarray, rng):
    """Lineage strings and ONE ``[n_refs, SEQ_LEN]`` 4-bit array (the
    ``build_database`` 2-D fast path): family consensus + 30 mutations."""
    g_mod = n_refs // 8 or 1
    lineages = [
        f"p:P{i % 4},c:C{i % 16},o:O{i % 64},f:F{i % N_FAMILIES},"
        f"g:G{i % g_mod},s:S{i}"
        for i in range(n_refs)
    ]
    seqs = fam[np.arange(n_refs) % N_FAMILIES].astype(np.uint8)
    pos = rng.integers(0, SEQ_LEN, size=(n_refs, 30))
    sub = rng.integers(0, 4, size=(n_refs, 30), dtype=np.uint8)
    np.put_along_axis(seqs, pos, sub, axis=1)
    return lineages, _ENC[seqs]


def synth_queries(fam: np.ndarray, n: int, seed: int = 7):
    """``n`` (label, 4-bit sequence) queries: consensus + 10 mutations."""
    rng = np.random.default_rng(seed)
    seqs = fam[np.arange(n) % N_FAMILIES].astype(np.uint8)
    pos = rng.integers(0, SEQ_LEN, size=(n, 10))
    sub = rng.integers(0, 4, size=(n, 10), dtype=np.uint8)
    np.put_along_axis(seqs, pos, sub, axis=1)
    enc = _ENC[seqs]
    return [(f"q{i}", enc[i]) for i in range(n)]


def build_world(n_refs: int, n_queries: int, with_ref_major: bool = False):
    """(database in the flat postings layout, queries, build seconds).
    ``with_ref_major`` also builds the ``[n_refs, 2048]`` ref-major matrix
    the dense-count backend reads."""
    from ..db.database import build_database

    fam, rng = synth_fam()
    t0 = time.time()
    lineages, seqs = synth_records(n_refs, fam, rng)
    db = build_database(
        lineages, seqs, with_ref_major=with_ref_major, kmer_layout="flat"
    )
    return db, synth_queries(fam, n_queries), time.time() - t0
