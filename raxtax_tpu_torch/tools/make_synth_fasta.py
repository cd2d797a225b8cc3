"""Write a synthetic COI-like reference FASTA for the runtime / memory sweep.

    python -m raxtax_tpu_torch.tools.make_synth_fasta N_RECORDS OUT.fasta [--seed 42]

Family consensus sequences plus 30 point mutations per record and six-rank
lineages in ``tax=`` annotations: the bytes the JAX package's
``scripts/make_synth_fasta.py`` writes for the same ``N_RECORDS`` and seed
(its constants are copied here, not imported).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

#: the benchmark world's shape (the JAX package's bench.py)
SEQ_LEN = 400
N_FAMILIES = 512
N_MUTATIONS = 30


def write_synth_fasta(n: int, out: str, seed: int = 42) -> None:
    rng = np.random.default_rng(seed)
    # the same draws in the same order as the script: the families, then per
    # record the mutation positions and the new bases
    fam = rng.integers(0, 4, size=(N_FAMILIES, SEQ_LEN))
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    fam_bytes = letters[fam]
    g_mod = n // 8 or 1
    with open(out, "w") as f:
        for i in range(n):
            lineage = (
                f"p:P{i % 4},c:C{i % 16},o:O{i % 64},f:F{i % N_FAMILIES},"
                f"g:G{i % g_mod},s:S{i}"
            )
            s = fam_bytes[i % N_FAMILIES].copy()
            pos = rng.integers(0, SEQ_LEN, size=N_MUTATIONS)
            s[pos] = letters[rng.integers(0, 4, size=N_MUTATIONS)]
            f.write(f">rec{i};tax={lineage};\n")
            f.write(s.tobytes().decode("ascii") + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=42)
    a = ap.parse_args(argv)
    write_synth_fasta(a.n, a.out, a.seed)
    print(f"wrote {a.n} records to {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
