"""Throughput benchmark of the port on one GPU: end-to-end classification of
a fixed synthetic workload, as the JAX package's ``bench.py`` measures it.

    python -m raxtax_tpu_torch.tools.bench                    # 65,536 then 1M refs
    RAXTAX_BENCH_REFS=1000000 RAXTAX_BENCH_BATCH=512 python -m raxtax_tpu_torch.tools.bench
    RAXTAX_EXACT=0 python -m raxtax_tpu_torch.tools.bench     # the dd path
    RAXTAX_BENCH_REFS=300 RAXTAX_BENCH_QUERIES=8 python -m raxtax_tpu_torch.tools.bench --device cpu

It builds the synthetic COI-like world of ``tools/synth.py`` (the JAX bench's
generator: 512 families of 400 bp, families seed 42, queries seed 7),
classifies the query set through the full device pipeline (fold, histogram,
probability model, significance, descents, native evaluation and formatted
output lines) in the three-deep submit / prepare / finalize loop of
``engine/classify.py``, and prints ONE JSON line per finished configuration
on stdout; everything else goes to stderr::

    {"metric": "classify_throughput_<n>ref_db", "value": <best pass q/s>,
     "unit": "queries/s/gpu", "vs_baseline": <best / oracle q/s>,
     "median": <median pass q/s>, "pass_s": [...], "warmup_s": ..., "batch": B}

Environment (the JAX bench's names and defaults): ``RAXTAX_BENCH_REFS`` (one
size; default 65,536 then 1,000,000, smallest first), ``_QUERIES`` (2,048),
``_BATCH`` (0: the engine sizes it; an explicit size may pass the engine's
``BATCH_MAX``), ``_BACKEND`` (``auto``; ``pallas``, ``stream``, ``xla``),
``_REPS`` (3 timed passes), ``_BUDGET`` (1,320 s for the whole run),
``_ORACLE_QUERIES`` (16 up to 200,000 references, else 5), and
``RAXTAX_BENCH_CACHE_DIR`` (the database cache; the temporary directory by
default). The engine's mode comes from the names the port's CLI reads
(``cli.engine_mode_from_env``: ``RAXTAX_EXACT``, ``RAXTAX_SPARSE_FOLD``,
``RAXTAX_FUSED_GATHER``, ``RAXTAX_BM_SCAN``, ``RAXTAX_SPLIT2``,
``RAXTAX_SPLIT_SIG``).

A global deadline gates every expensive phase: a configuration after the
first runs only when its estimate fits what is left of the budget, under a
``SIGALRM`` set to the rest, so a banked line survives a later configuration
that cannot finish. ``vs_baseline`` is measured live against the port's host
oracle (``models/oracle.py``, the reference algorithm in numpy) on this
machine's CPU. The database cache is written atomically (temporary name,
then rename) by a thread that overlaps the upload and the warm-up; the
timed passes start once it has ended, so they never share the host with
the write.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

from .synth import synth_fam, synth_queries, synth_records

T_START = time.time()
#: host seconds per reference to synthesize and build a database, until a
#: configuration has measured its own (the card's host builds 1M in 20-32 s)
BUILD_S_PER_REF = 5e-5
#: seconds a configuration needs beyond its build: upload, kernel builds,
#: warm-up, the timed passes and the oracle
RUN_S = 150.0


@dataclass
class BenchConfig:
    """The run's settings, read from the environment by :func:`config`."""

    configs: list
    n_queries: int
    batch: int
    backend: str
    reps: int
    budget: float
    oracle_queries: int | None
    cache_dir: Path
    #: when the budget started (``time.time()`` at :func:`config`)
    t_start: float


def config(environ=None) -> BenchConfig:
    env = os.environ if environ is None else environ
    refs = env.get("RAXTAX_BENCH_REFS")
    oracle = env.get("RAXTAX_BENCH_ORACLE_QUERIES")
    return BenchConfig(
        configs=[int(refs)] if refs else [65536, 1_000_000],
        n_queries=int(env.get("RAXTAX_BENCH_QUERIES", 2048)),
        batch=int(env.get("RAXTAX_BENCH_BATCH", 0)),
        backend=env.get("RAXTAX_BENCH_BACKEND", "auto"),
        reps=max(1, int(env.get("RAXTAX_BENCH_REPS", 3))),
        budget=float(env.get("RAXTAX_BENCH_BUDGET", 1320)),
        oracle_queries=int(oracle) if oracle else None,
        cache_dir=Path(env.get("RAXTAX_BENCH_CACHE_DIR") or tempfile.gettempdir()),
        t_start=time.time(),
    )


def log(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def remaining(cfg: BenchConfig) -> float:
    return cfg.budget - (time.time() - cfg.t_start)


def cache_path(cfg: BenchConfig, n_refs: int) -> Path:
    """The port's own cache file: the dense-count backend keeps the packed
    layout with the ref-major matrix, the planes backends the flat layout
    without it."""
    suffix = "_packed_ref" if cfg.backend == "xla" else "_km_flat"
    return cfg.cache_dir / f"raxtax_torch_bench_db_{n_refs}_v1{suffix}.rxdb"


def get_database(cfg: BenchConfig, n_refs: int, fam, rng):
    """``(database, build seconds or None when loaded from the cache, the
    thread writing the cache or None)``; pass the thread to
    :func:`join_saver` before timing anything on the host."""
    from ..db.database import build_database, load_database, save_database

    with_ref = cfg.backend == "xla"
    layout = "packed" if with_ref else "flat"
    cache = cache_path(cfg, n_refs)
    if cache.is_file():
        try:
            t0 = time.time()
            db = load_database(cache)
            if db.kmer_layout != layout:
                raise ValueError(f"cache layout {db.kmer_layout}")
            log(f"loaded cached DB in {time.time() - t0:.1f}s: {cache}")
            return db, None, None
        except Exception as e:  # stale or corrupt cache
            log(f"cache load failed ({e}); rebuilding")
    t0 = time.time()
    lineages, seqs = synth_records(n_refs, fam, rng)
    db = build_database(lineages, seqs, with_ref_major=with_ref, kmer_layout=layout)
    build_s = time.time() - t0
    log(f"built {n_refs}-ref DB in {build_s:.1f}s")
    est_save = 5 + 1e-8 * (
        db.kmer_major.nbytes + db.seq_flat.nbytes
        + (db.ref_major.nbytes if db.ref_major is not None else 0)
    )
    saver = None
    if remaining(cfg) > est_save + 60:
        # the multi-GB write overlaps the upload and the warm-up; the rename
        # keeps it atomic, so a run killed mid-write cannot poison the next
        tmp = cache.with_suffix(f".tmp.{os.getpid()}")

        def _save(t0=time.time()):
            try:
                cache.parent.mkdir(parents=True, exist_ok=True)
                save_database(db, tmp)
                os.replace(tmp, cache)
                log(f"cached DB in {time.time() - t0:.1f}s: {cache}")
            except OSError as e:
                log(f"could not cache DB: {e}")
                tmp.unlink(missing_ok=True)

        saver = threading.Thread(target=_save, daemon=True)
        saver.start()
    else:
        log(f"skipping DB cache write (est {est_save:.0f}s > budget)")
    return db, build_s, saver


def join_saver(saver: threading.Thread | None) -> None:
    """Wait for :func:`get_database`'s cache write, if any, and log the
    wait (it is in no timed number)."""
    if saver is not None:
        t0 = time.time()
        saver.join()
        log(f"waited {time.time() - t0:.1f}s for the DB cache write")


def make_bench_classifier(db, backend: str, batch: int, device: str,
                          n_queries: int):
    """The classifier the CLI would make for ``--backend backend
    --batch-size batch --device device`` under this environment."""
    from ..cli import engine_mode_from_env
    from ..engine.classify import make_classifier

    args = SimpleNamespace(
        backend=backend, device=device, batch_size=batch, debug_checks=False,
        tsv=True, skip_exact_matches=False, raw_confidence=False,
        **engine_mode_from_env(),
    )
    return make_classifier(db, args, n_queries_hint=n_queries)


def _sync(clf) -> None:
    import torch

    if clf.state.device.type == "cuda":
        torch.cuda.synchronize(clf.state.device)


def warm_up(clf, queries, batches: int = 4) -> float:
    """Pin the shape buckets to the query set's largest query, then run
    ``batches`` serialized batches over distinct chunks (kernel builds,
    allocator, sticky flips); returns the seconds taken."""
    from .. import native

    B = clf.batch_size
    counts = native.distinct_kmer_counts([s for _, s in queries])
    if counts is not None:
        clf.prewarm(int(counts.max()))
    t0 = time.time()
    for w in range(batches):
        lo = (w * B) % max(len(queries) - B, 1)
        clf.classify_batch(queries[lo : lo + B])
    _sync(clf)
    return time.time() - t0


def timed_passes(clf, queries, reps: int, cfg: BenchConfig | None = None,
                 warmup: int = 4, saver: threading.Thread | None = None) -> dict:
    """``warmup`` serialized batches over distinct chunks, then ``reps``
    passes over ``queries`` through the three-deep loop, every result
    formatted. Returns best and median q/s, the pass seconds, the warm-up
    seconds and the batch size. With ``cfg``, passes after the first stop
    when less than 90 s of its budget is left. ``saver``, the cache write,
    is joined between the warm-up and the first pass."""
    B = clf.batch_size
    warmup_s = warm_up(clf, queries, warmup)
    log(f"warm-up batches: {warmup_s:.1f}s")
    join_saver(saver)
    pass_times: list[float] = []
    for rep in range(reps):
        if pass_times and cfg is not None and remaining(cfg) < 90:
            log("skipping the remaining passes (budget)")
            break
        done = 0
        t0 = time.time()
        prepared: deque = deque()
        for lo in range(0, len(queries), B):
            a_state = clf.submit_batch(queries[lo : lo + B])
            if len(prepared) >= 2:
                for r in clf.finalize_batch(prepared.popleft()):
                    r.out_string()
                    done += 1
            prepared.append(clf.prepare_batch(a_state))
        while prepared:
            for r in clf.finalize_batch(prepared.popleft()):
                r.out_string()
                done += 1
        dt = time.time() - t0
        log(f"pass {rep + 1}/{reps}: {done} queries in {dt:.2f}s")
        pass_times.append(dt)
    if clf.state.device.type == "cuda":
        import torch

        log(f"peak GPU memory {torch.cuda.max_memory_allocated()} bytes")
    log(
        f"modes: significance={clf.significance} exact_mode={clf._exact_mode} "
        f"sparse={clf._sparse} mux_dense={clf._mux_dense} "
        f"fb_dense={clf._fb_dense} over_budget={clf._over_budget} "
        f"host_replays={clf.host_replays}"
    )
    qps = sorted(len(queries) / t for t in pass_times)
    return {
        "best": qps[-1], "median": qps[len(qps) // 2],
        "pass_s": [round(t, 3) for t in pass_times],
        "warmup_s": round(warmup_s, 1), "batch": B,
    }


def measure_oracle(cfg: BenchConfig, db, queries, n_oracle: int) -> float:
    """Queries per second of the host oracle: one over its median seconds a
    query."""
    from ..models.oracle import OracleClassifier

    o = OracleClassifier(db)
    times = []
    for label, seq in queries[:n_oracle]:
        t0 = time.time()
        o.classify(label, seq).out_string()
        times.append(time.time() - t0)
        if remaining(cfg) < 45:
            break
    times.sort()
    med = times[len(times) // 2]
    log(f"oracle: median {med * 1000:.0f}ms/query over {len(times)}")
    return 1.0 / med


def run_config(cfg: BenchConfig, n_refs: int, device: str) -> float | None:
    """One configuration end to end; prints its JSON line. Returns the
    build seconds per reference when it built the database."""
    log(f"=== config: {n_refs} references ===")
    fam, rng = synth_fam()
    db, build_s, saver = get_database(cfg, n_refs, fam, rng)
    queries = synth_queries(fam, cfg.n_queries)
    t0 = time.time()
    clf = make_bench_classifier(db, cfg.backend, cfg.batch, device, len(queries))
    _sync(clf)
    log(f"classifier: batch {clf.batch_size}, created in {time.time() - t0:.1f}s")
    m = timed_passes(clf, queries, cfg.reps, cfg, saver=saver)
    del clf
    n_oracle = cfg.oracle_queries or (16 if n_refs <= 200_000 else 5)
    base = measure_oracle(cfg, db, queries, n_oracle)
    print(json.dumps({
        "metric": f"classify_throughput_{n_refs}ref_db",
        "value": round(m["best"], 2),
        "unit": "queries/s/gpu",
        "vs_baseline": round(m["best"] / base, 2),
        "median": round(m["median"], 2),
        "pass_s": m["pass_s"],
        "warmup_s": m["warmup_s"],
        "batch": m["batch"],
    }), flush=True)
    return None if build_s is None else build_s / n_refs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the "
                    "kernels' plain versions; for tests)")
    a = ap.parse_args(argv)
    from ..utils.device import resolve_device

    resolve_device(a.device)
    cfg = config()
    per_ref = BUILD_S_PER_REF
    done = 0
    for n_refs in cfg.configs:
        cached = cache_path(cfg, n_refs).is_file()
        est = (0.0 if cached else 2.0 * per_ref * n_refs) + RUN_S
        if done and remaining(cfg) < est:
            log(f"skipping {n_refs}-ref config: est {est:.0f}s > "
                f"{remaining(cfg):.0f}s left")
            break
        try:
            if done:
                # a banked line must survive whatever the next configuration
                # does: the alarm caps it at the rest of the budget
                def _alarm(signum, frame):
                    raise TimeoutError("config wall-clock budget exhausted")

                signal.signal(signal.SIGALRM, _alarm)
                signal.alarm(max(60, int(remaining(cfg) - 30)))
            measured = run_config(cfg, n_refs, a.device)
            per_ref = measured or per_ref
            done += 1
        except Exception as e:
            log(f"config {n_refs} failed: {type(e).__name__}: {e}")
            if a.device == "cuda":
                import torch

                log(f"peak GPU memory {torch.cuda.max_memory_allocated()} bytes")
            if done:
                break
            raise
        finally:
            if done:
                signal.alarm(0)
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
