"""Small random worlds for the byte-parity fuzz (``tools/fuzz_hardware.py``).

The same draws as the JAX package's test worlds, so both packages can be fuzzed
on the same seeds: 2-7 family sequences of 40-260 bases (1 % IUPAC
ambiguity codes), 4-59 references with point mutations and lineages of depth
2-5, and six queries per world: exact copies of references, references with
three point mutations, and random sequences. Small worlds with tiny uniform
probabilities are where last-ulp rounding and half-cent boundaries bite.
"""

from __future__ import annotations

import numpy as np

from ..db.database import Database, build_database
from ..utils.encoding import encode_sequence

BASES = "ACGTNWSMKRYBDHV"


def rand_seq(rng, n: int) -> str:
    """A random sequence of ``n`` bases, 1 % of them an IUPAC code."""
    idx = rng.integers(0, 4, size=n)
    amb = rng.random(n) < 0.01
    idx[amb] = rng.integers(0, len(BASES), size=int(amb.sum()))
    return "".join(BASES[i] for i in idx)


def make_world(seed: int, with_ref_major: bool = True) -> tuple[Database, list]:
    """``(database, [(label, encoded query)] * 6)`` of world ``seed``."""
    rng = np.random.default_rng(seed)
    n_fam = int(rng.integers(2, 8))
    depth_choices = [2, 3, 4, 5]
    fams = [rand_seq(rng, int(rng.integers(40, 260))) for _ in range(n_fam)]
    lineages, seqs = [], []
    n_refs = int(rng.integers(4, 60))
    for i in range(n_refs):
        d = depth_choices[i % len(depth_choices)] if rng.random() < 0.3 else 3
        lineages.append(
            ",".join(f"l{k}:V{(i // max(1, (k + 1))) % (3 + k)}" for k in range(d))
        )
        base = list(fams[i % n_fam])
        for _ in range(int(rng.integers(0, max(2, len(base) // 8)))):
            base[rng.integers(0, len(base))] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(base))
    db = build_database(
        lineages, [encode_sequence(s) for s in seqs], with_ref_major=with_ref_major
    )
    queries = []
    for i in range(6):
        r = rng.random()
        if r < 0.3:
            queries.append(
                (f"q{i}", encode_sequence(seqs[int(rng.integers(0, n_refs))]))
            )
        elif r < 0.6:
            base = list(seqs[int(rng.integers(0, n_refs))])
            for _ in range(3):
                base[rng.integers(0, len(base))] = "ACGT"[rng.integers(0, 4)]
            queries.append((f"q{i}", encode_sequence("".join(base))))
        else:
            queries.append(
                (f"q{i}", encode_sequence(rand_seq(rng, int(rng.integers(10, 200)))))
            )
    return db, queries
