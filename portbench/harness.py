"""One run of one cell: set-up, the measured window, the traced reading,
and the check against the plain reference.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration file it names, ``portbench/traffic/<traffic>.json`` and, for
each per-layer metric, ``portbench/metrics/<metric>.py`` with a
``read(ctx)`` that returns a number or None. A new cell, traffic mix or
metric is added as files and entries, without an edit here.

Set-up builds the records from the seed, the database with the program's
``build_database`` and the classifier with its ``make_classifier``, both
with the arguments its command line would pass (``--tsv``, ``--backend
auto``, batch size auto, every ``RAXTAX_*`` unset), and classifies one
warm-up file twice, timing the second pass. From that rate it writes, as
FASTA, :data:`MARGIN` times the query files the window would use, then
drops the records, so nothing of the generator stays in memory. The window
reads query files one after another with the program's own parser and
classifies them through its ``run_queries`` and ``ResultWriter``, as a
user's run works through its files, and starts a new file until the
window's seconds have passed; a window that uses up the files made for it
raises :class:`BenchError` rather than make one inside it. The check makes
the records again from the seed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import logging
import math
import resource
import shutil
import sys
import tempfile
import time
from itertools import zip_longest
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import generator, yardstick
from .reference import Reference, query_kmers

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "raxtax_tpu")
GIB = float(1 << 30)
#: query files made before the window, as a multiple of what the warm-up's
#: rate would finish in it (the warm-up's second pass has run at 0.72 to 1.10
#: times the window's rate on the card)
MARGIN = 2.0
#: most bytes of query files a run may write before its window
WRITE_BUDGET = 2 << 30


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_spec(root: Path, name: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic and metrics by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, cell=cell,
        config=load_json(root / conf["file"]),
        traffic=load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def load_reader(root: Path, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cli_args(device: str):
    """The arguments the program's command line makes for
    ``raxtax-torch -d REFS -i QUERIES --tsv``, with every ``RAXTAX_*``
    name unset."""
    from raxtax_tpu_torch.cli import build_arg_parser, engine_mode_from_env

    args = build_arg_parser().parse_args(
        ["-d", "references.fasta", "-i", "queries.fasta", "--tsv",
         "--device", device]
    )
    vars(args).update(engine_mode_from_env({}))
    return args


def build(world, args):
    """The database as the command line builds it from FASTA records."""
    from raxtax_tpu_torch.cli import cache_layout
    from raxtax_tpu_torch.db.database import build_database

    _, with_ref_major, layout = cache_layout(
        args.backend, args.only_db, args.bm_scan, args.significance,
        mesh=args.mesh, processes=1,
    )
    return build_database(
        world.lineages, world.port_sequences(), threads=args.threads,
        with_ref_major=with_ref_major, kmer_layout=layout,
    )


def classify_file(db, clf, args, queries: list, out_dir: Path) -> None:
    """Queries through the program's loop and writer, into
    ``out_dir/raxtax.{out,tsv,log,ckp}``."""
    from raxtax_tpu_torch.engine.classify import run_queries
    from raxtax_tpu_torch.io.outputs import OutputWriters, ResultWriter
    from raxtax_tpu_torch.utils.logging import setup_logging

    out_dir.mkdir(parents=True)
    writers = OutputWriters(
        primary=open(out_dir / "raxtax.out", "w"),
        tsv=open(out_dir / "raxtax.tsv", "w"),
        log=open(out_dir / "raxtax.log", "w"),
        progress=open(out_dir / "raxtax.ckp", "w"),
    )
    try:
        setup_logging(writers.log, logging.INFO)
        writer = ResultWriter(writers)
        try:
            run_queries(db, queries, args, writer, classifier=clf)
        finally:
            writer.join()
    finally:
        logging.getLogger("raxtax").handlers.clear()
        writers.close()


def parse_queries(path: Path) -> list:
    """A query file read by the program's own parser, as its command line
    reads ``-i``."""
    from raxtax_tpu_torch.io.fasta import parse_query_fasta_file

    return parse_query_fasta_file(path)


def files_for(rate: float, seconds: float, file_queries: int) -> int:
    """Query files made before the window: :data:`MARGIN` times what the
    warm-up's rate would finish in the window, plus the file that runs over
    its end."""
    return int(math.ceil(MARGIN * rate * seconds / file_queries)) + 1


def rss_bytes() -> int:
    """The process's resident set now (``VmRSS``), 0 where it cannot be
    read."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def profiler(device: str):
    """A profiler of the device's activity only (the host's operators
    are not recorded), reduced in memory when it stops."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
    return profile(activities=[act])


def read_outputs(out_dir: Path, labels: set) -> tuple:
    """``({label: .out lines}, {label: .tsv lines})`` of the given labels."""
    found = []
    for name in ("raxtax.out", "raxtax.tsv"):
        by: dict = {}
        with open(out_dir / name) as f:
            for line in f:
                line = line.rstrip("\n")
                label = line.split("\t", 1)[0]
                if label in labels:
                    by.setdefault(label, []).append(line)
        found.append(by)
    return tuple(found)


def committed(out_dir: Path) -> int:
    """Queries the writer committed to the progress file."""
    with open(out_dir / "raxtax.ckp") as f:
        return sum(1 for line in f if line.strip())


def sample(files: list, seed: int, k: int) -> list:
    """``(file index, query index)`` of ``k`` window queries drawn from the
    seed, and the longest query of the window."""
    sizes = [len(f) for f in files]
    total = sum(sizes)
    rng = generator.rng_for(seed, generator._CHECK)
    picks = set(rng.choice(total, size=min(k, total), replace=False).tolist())
    lengths = np.concatenate([f.lengths for f in files])
    picks.add(int(np.argmax(lengths)))
    bounds = np.cumsum([0] + sizes)
    out = []
    for g in sorted(picks):
        fi = int(np.searchsorted(bounds, g, side="right") - 1)
        out.append((fi, g - int(bounds[fi])))
    return out


def lines_differ(got: list, want: list) -> int:
    """Lines that differ byte for byte, position by position (a missing or
    extra line differs)."""
    return sum(a != b for a, b in zip_longest(got, want))


def compare(ref, files: list, picks: list, out_dirs: list) -> int:
    """Lines of the picked queries' ``raxtax.out`` and ``raxtax.tsv`` that
    differ from the reference's (a missing line differs)."""
    differ = 0
    by_file: dict = {}
    for fi, qi in picks:
        by_file.setdefault(fi, []).append(qi)
    for fi, qis in sorted(by_file.items()):
        qf = generator.read_fasta(files[fi].path)
        got_out, got_tsv = read_outputs(out_dirs[fi], {qf.labels[q] for q in qis})
        for q in qis:
            label = qf.labels[q]
            want_out, want_tsv = ref.lines(label, qf.sequence(q))
            differ += lines_differ(got_out.get(label, []), want_out)
            differ += lines_differ(got_tsv.get(label, []), want_tsv)
    return differ


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: Path = ROOT, device: str = "cuda", log=None) -> dict:
    """One run; returns the result line's object. ``log`` takes the
    progress lines (standard error by default)."""
    import torch

    if log is None:
        def log(msg):
            print(msg, file=sys.stderr, flush=True)

    spec = cell_spec(root, cell)
    traffic = spec.traffic
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        return _run(spec, traffic, seed, seconds, trace, t_start, device,
                    run_dir, root, log, torch)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(spec, traffic, seed, seconds, trace, t_start, device, run_dir, root,
         log, torch):
    stamps = {"imports": time.perf_counter()}
    rss = {"imports": rss_bytes()}
    world = generator.make_world(spec.config, seed)
    pool = generator.Traffic(world, traffic, seed)
    n_refs = world.n
    pool.warmup().write_fasta(run_dir / "warmup.fasta")
    stamps["world"] = time.perf_counter()
    rss["world"] = rss_bytes()
    log("generator arrays beside the records (held until the query files are "
        f"written) {sum(a.nbytes for a in world.consensus.values()) / GIB:.3f} GiB")

    args = cli_args(device)
    db = build(world, args)
    stamps["build"] = time.perf_counter()
    from raxtax_tpu_torch.engine.classify import make_classifier

    fq = int(traffic["file_queries"])
    clf = make_classifier(db, args, n_queries_hint=fq)
    batch = int(clf.batch_size)
    stamps["classifier"] = time.perf_counter()
    warm = parse_queries(run_dir / "warmup.fasta")
    classify_file(db, clf, args, warm, run_dir / "warmup")
    t_rate = time.perf_counter()  # a second pass, everything built, is timed
    classify_file(db, clf, args, parse_queries(run_dir / "warmup.fasta"),
                  run_dir / "warmup-rate")
    sync(device)
    rate = len(warm) / (time.perf_counter() - t_rate)
    if trace:  # the profiler's own start-up belongs to set-up
        with profiler(device):
            classify_file(db, clf, args, warm, run_dir / "warmup-traced")
    sync(device)
    stamps["warmup"] = time.perf_counter()

    # every query file of the window is made and written now: none is made
    # inside it
    n_files = files_for(rate, seconds, fq)
    width = max(len(s) for _, s in warm)
    if n_files * fq * (width + 32) > WRITE_BUDGET:
        raise BenchError(
            f"{n_files} query files at the warm-up's {rate:.0f} queries/s "
            f"would pass the {WRITE_BUDGET >> 30} GiB a run may write")
    files = pool.write_files(run_dir / "queries", n_files)
    del pool, world, warm
    gc.collect()
    stamps["query files"] = time.perf_counter()
    rss["set-up"] = rss_bytes()
    prev = t_start
    for k, t in stamps.items():
        log(f"setup {k} {t - prev:.3f} s")
        prev = t
    log(f"warm-up rate {rate:.1f} queries/s: {n_files} query files of {fq}")

    # ---- the window ----
    phases0 = dict(clf.phase_seconds)
    replays0 = clf.host_replays
    prof = profiler(device) if trace else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    out_dirs = []
    file_s = []
    done = 0
    f = 0
    try:
        while True:
            if f == len(files):
                raise BenchError(
                    f"the window used all {f} query files made before it "
                    f"after {time.perf_counter() - t0:.3f} of {seconds} s: the "
                    f"program ran past {MARGIN:g} times the warm-up's rate")
            out_dirs.append(run_dir / f"file{f}")
            t_file = time.perf_counter()
            classify_file(db, clf, args, parse_queries(files[f].path), out_dirs[-1])
            file_s.append(time.perf_counter() - t_file)
            done += len(files[f])
            f += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        t1 = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = t1 - t0
    files = files[:f]
    peak_dev = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rss["window"] = rss_bytes()
    phases = {k: clf.phase_seconds[k] - phases0.get(k, 0.0)
              for k in clf.phase_seconds}
    replays = clf.host_replays - replays0
    n_batches = sum(math.ceil(len(q) / batch) for q in files)
    log(f"window {window_s:.3f} s, {f} files, {done} queries, batch {batch}")
    log("file seconds " + " ".join(f"{t:.3f}" for t in file_s))
    log("phase ms/batch " + " ".join(
        f"{k} {v * 1e3 / n_batches:.2f}" for k, v in phases.items()))
    log("rss GiB " + " ".join(f"{k} {v / GIB:.3f}" for k, v in rss.items())
        + f" peak {peak_rss / GIB:.3f}")

    # the program's state goes before the reference is built
    del clf, db
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    result = {
        "correct": False, "attempted": done, "failed": 0, "metrics": {},
        "device": device_info(device, peak_dev, torch),
    }
    if trace:
        events = yardstick.device_events(prof)
        busy = yardstick.union_seconds(events)
        shapes = [s for wf in files for s in yardstick.batch_shapes(
            [query_kmers(seq) for seq in file_sequences(wf)], batch)]
        ctx = SimpleNamespace(
            phases=phases, n_batches=n_batches,
            queries=done, host_replays=replays, events=events, window_s=window_s,
            busy_s=busy, n_refs=n_refs, batch_shapes=shapes,
            peaks=yardstick.peaks_for(result["device"]["kind"]),
        )
        for m in spec.per_layer:
            v = load_reader(root, m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": yardstick.top_ops(events)}
    else:
        values = {
            "throughput": done / window_s,
            "peak_device_mem": peak_dev / GIB,
            "peak_host_rss": peak_rss / GIB,
            "setup_s": setup_s,
        }
        for m in spec.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {
                    "value": values[m["name"]], "unit": m["unit"]}

    # ---- the check: the records again from the seed, the reference ----
    t_check = time.perf_counter()
    unanswered = sum(len(wf) - committed(d) for wf, d in zip(files, out_dirs))
    world = generator.make_world(spec.config, seed)
    ref = Reference(world.lineages, world.codes4, world.starts, world.lengths,
                    device=device)
    del world
    picks = sample(files, seed, int(traffic["check_queries"]))
    differ = compare(ref, files, picks, out_dirs)
    log(f"check {len(picks)} queries in {time.perf_counter() - t_check:.3f} s")
    result["failed"] = unanswered
    result["correct"] = unanswered == 0 and differ == 0
    result["check"] = {
        "unanswered": {"value": unanswered, "limit": 0},
        "lines_differ": {"value": differ, "limit": 0, "queries": len(picks)},
    }
    return result


def file_sequences(wf) -> list:
    """The 4-bit sequences of a written query file."""
    qf = generator.read_fasta(wf.path)
    return [qf.sequence(i) for i in range(len(qf))]


def device_info(device: str, peak: int, torch) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}
