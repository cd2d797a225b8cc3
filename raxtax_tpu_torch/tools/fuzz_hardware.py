"""Adversarial byte-parity fuzz of the device engine against the host oracle.

    python -m raxtax_tpu_torch.tools.fuzz_hardware [--trials 50] [--seed0 2000]
        [--backends pallas xla stream] [--device cpu]

The counterpart of the JAX package's ``scripts/fuzz_hardware.py``: the same
random worlds (``tools/fuzzworld.py``; seed ``seed0 + t`` for trial ``t``),
the same checks — every query's ``raxtax.out`` and ``raxtax.tsv`` lines
byte-equal to the exact host oracle — over the engine's matrix of choices,
each mapped to ``make_classifier`` as ``cli.py`` maps ``--backend`` and the
``RAXTAX_*`` names:

- backend ``pallas`` / ``xla`` / ``stream`` (period 3);
- ``(skip_exact_matches, raw_confidence)``, the 4-cycle;
- significance ``auto`` / ``exact`` / ``dd`` (``RAXTAX_EXACT``; period 21);
- the fold of ``pallas``: dense / sparse / gathered (``RAXTAX_SPARSE_FOLD``,
  ``RAXTAX_FUSED_GATHER=0``; period 15);
- the postings layout packed / flat (period 9), ``bm_scan`` (period 11),
  ``split_sig`` of ``xla`` (period 7);
- the three-phase pipeline with two batches in flight (period 5).

Every period is coprime with the 4-cycle of the flags, so every value of every
dimension meets every flag combination (the JAX script's split2 period of 4
paired split2 only with ``skip_exact=True``, and its pipelined odd trials
were exactly its ``raw_confidence`` trials). Combinations the port refuses by
design are not drawn, and the tool says so once: ``bm_scan`` on the flat
layout, ``split_sig`` on a planes backend, and split2 off (the port has no
switch for it). ``--mesh`` is not ported (multi-GPU is a later item).

Prints one line per trial and a tally; a mismatch prints both outputs.
Exit code 1 on any mismatch. Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from types import SimpleNamespace

from .profile_path import drive

BACKENDS = ("pallas", "xla", "stream")
FLAGS = tuple(itertools.product([False, True], [False, True]))
SIGNIFICANCE = ("auto", "exact", "dd")
FOLDS = ("dense", "sparse", "gathered")
LAYOUTS = ("packed", "flat")
BATCH = 4
#: a time limit on :func:`run` never cuts it below this many trials: two of
#: each backend x flag combination
MIN_TRIALS = 24

NOT_DRAWN = (
    "not drawn (refused by the port on purpose): bm_scan on the flat layout, "
    "split_sig on a planes backend, split2 off; --mesh is not ported"
)


def trial_config(t: int, backends=BACKENDS) -> dict:
    """The engine choices of trial ``t``."""
    backend = backends[t % len(backends)]
    skip_exact, raw_conf = FLAGS[t % 4]
    layout = LAYOUTS[(t % 9) % 2]
    return {
        "backend": backend,
        "skip_exact": skip_exact,
        "raw_conf": raw_conf,
        "significance": SIGNIFICANCE[(t // 7) % 3],
        "fold": FOLDS[(t // 5) % 3] if backend == "pallas" else (
            "stream" if backend == "stream" else "none"),
        "layout": layout,
        "bm_scan": bool((t % 11) % 2) and layout == "packed" and backend != "xla",
        "split_sig": bool((t % 7) % 2) and backend == "xla",
        "pipelined": bool((t % 5) % 2),
    }


def cli_args(cfg: dict, device: str) -> SimpleNamespace:
    """The parsed command line the CLI would hand ``make_classifier``."""
    return SimpleNamespace(
        backend=cfg["backend"], device=device, batch_size=BATCH,
        debug_checks=True, tsv=True, skip_exact_matches=cfg["skip_exact"],
        raw_confidence=cfg["raw_conf"], significance=cfg["significance"],
        fold=cfg["fold"] if cfg["backend"] == "pallas" else "dense",
        bm_scan=cfg["bm_scan"], split_sig=cfg["split_sig"],
    )


def classify(clf, queries, pipelined: bool) -> list:
    """The world's queries through ``clf``: batch by batch, or through the
    three-phase loop with two batches in flight (covers state that flips
    between prepare and finalize)."""
    if pipelined:
        return drive(clf, queries, BATCH)
    got = []
    for lo in range(0, len(queries), BATCH):
        got += clf.classify_batch(queries[lo : lo + BATCH])
    return got


def run_trial(t: int, seed: int, cfg: dict, device: str, out=print) -> tuple[int, int]:
    """One trial; returns ``(query checks, mismatches)``."""
    from ..db.database import ensure_kmer_layout
    from ..engine.classify import make_classifier
    from ..models.oracle import OracleClassifier
    from .fuzzworld import make_world

    db, queries = make_world(seed)
    db = ensure_kmer_layout(db, cfg["layout"])
    clf = make_classifier(db, cli_args(cfg, device), n_queries_hint=len(queries))
    orc = OracleClassifier(
        db, skip_exact_matches=cfg["skip_exact"], raw_confidence=cfg["raw_conf"]
    )
    got = classify(clf, queries, cfg["pipelined"])
    bad = 0
    for (label, seq), qr in zip(queries, got, strict=True):
        want = orc.classify(label, seq)
        if (qr.out_string() != want.out_string()
                or qr.tsv_string() != want.tsv_string()):
            bad += 1
            out(f"MISMATCH seed={seed} {cfg} query={label}\n"
                f"  device: {qr.out_string()!r} / {qr.tsv_string()!r}\n"
                f"  oracle: {want.out_string()!r} / {want.tsv_string()!r}")
    c = cfg
    out(f"trial {t}: seed={seed} backend={c['backend']} "
        f"skip={int(c['skip_exact'])} raw={int(c['raw_conf'])} "
        f"pipe={int(c['pipelined'])} significance={c['significance']} "
        f"fold={c['fold']} layout={c['layout']} bm={int(c['bm_scan'])} "
        f"split_sig={int(c['split_sig'])} queries={len(queries)} "
        f"{'OK' if not bad else 'MISMATCH'}")
    return len(queries), bad


def run(trials: int, seed0: int, device: str, backends=BACKENDS,
        seconds: float = 0.0, out=print) -> dict:
    """The fuzz; returns the tally. With ``seconds``, no trial starts after
    that many seconds once :data:`MIN_TRIALS` have run."""
    out(NOT_DRAWN)
    t0 = time.time()
    total = mismatches = done = 0
    for t in range(trials):
        if seconds and done >= MIN_TRIALS and time.time() - t0 > seconds:
            break
        n, bad = run_trial(t, seed0 + t, trial_config(t, backends), device, out)
        total += n
        mismatches += bad
        done += 1
    out(f"fuzz total: {done} trials, {total} query checks, {mismatches} mismatches")
    return {"trials": done, "query_checks": total, "mismatches": mismatches,
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--backends", nargs="+", choices=BACKENDS, default=list(BACKENDS))
    ap.add_argument("--seed0", type=int, default=2000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mesh", default="", help="not ported")
    a = ap.parse_args(argv)
    if a.mesh:
        print("error: --mesh is not ported to the PyTorch/CUDA package yet",
              file=sys.stderr)
        return 2
    from ..utils.device import resolve_device

    resolve_device(a.device)
    tally = run(a.trials, a.seed0, a.device, tuple(a.backends))
    return 1 if tally["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
