"""Output directory management and the ordered writer.

Mirrors the reference's output plumbing: four writers (`raxtax.out`,
optional `raxtax.tsv`, `raxtax.log`, progress `raxtax.ckp`) created under the
prefix directory (reference: src/io.rs:202-263), plus the dedicated writer
thread that drains a result queue and appends the query label to the
progress file *after* its result lines — making the progress file the commit
point for checkpointing (reference: src/main.rs:126-136).
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import IO

from ..utils.trace import span
from .checkpoint import Checkpoint, check_incomplete_output

log = logging.getLogger("raxtax")


class OutputError(RuntimeError):
    pass


@dataclass
class OutputWriters:
    primary: IO[str]
    tsv: IO[str] | None
    log: IO[str]
    progress: IO[str]

    def close(self):
        for f in (self.primary, self.tsv, self.log, self.progress):
            if f is not None:
                f.close()


def _open(path: Path, append: bool) -> IO[str]:
    return open(path, "a" if append else "w")


def get_output(args) -> tuple[OutputWriters, Checkpoint]:
    """Create/validate the output directory, writers and checkpoint
    (reference: src/io.rs:202-263)."""
    import os

    prefix = Path(args.prefix)
    if getattr(args, "_read_only_output", False):
        # global-mesh participant (host != 0): recover the coordinator's
        # processed baseline, write nothing (host 0 owns every artifact)
        ckp_path = prefix / "raxtax.json"
        checkpoint = None
        if not args.redo and ckp_path.is_file():
            try:
                ckp = Checkpoint.load(ckp_path)
                if ckp.valid_for(args):
                    with open(ckp.progress_file) as f:
                        ckp.processed_queries = {
                            l.rstrip("\n") for l in f if l.strip()
                        }
                    checkpoint = ckp
            except (OSError, ValueError, KeyError) as e:
                # FATAL, not a fallback: a participant that silently resumes
                # from an empty processed baseline builds a different query
                # list than host 0 and drives the shared global mesh through
                # a different number of collective steps — a mid-run
                # distributed deadlock. Dying here is loud and immediate.
                raise OutputError(
                    "global-mesh participant failed to read the "
                    f"coordinator checkpoint {ckp_path}: {e}"
                ) from e
        if checkpoint is None:
            checkpoint = Checkpoint.new(
                ckp_path, args, prefix / "raxtax.ckp"
            )
        checkpoint.read_only = True
        writers = OutputWriters(
            primary=open(os.devnull, "w"),
            tsv=open(os.devnull, "w") if args.tsv else None,
            log=open(os.devnull, "w"),
            progress=open(os.devnull, "w"),
        )
        return writers, checkpoint
    # multi-host runs write per-host shards ('' for single-process runs;
    # see parallel/multihost.py)
    shard = getattr(args, "_shard_suffix", "")
    ckp_path = prefix / f"raxtax.json{shard}"
    out_path = prefix / f"raxtax.out{shard}"
    tsv_path = prefix / f"raxtax.tsv{shard}"

    checkpoint = None
    resuming = False
    if not args.redo and ckp_path.is_file():
        try:
            ckp = Checkpoint.load(ckp_path)
            if ckp.valid_for(args):
                with open(ckp.progress_file) as f:
                    ckp.processed_queries = {l.rstrip("\n") for l in f if l.strip()}
                check_incomplete_output(out_path, ckp.processed_queries)
                if args.tsv:
                    check_incomplete_output(tsv_path, ckp.processed_queries)
                checkpoint = ckp
                resuming = True
        except (OSError, ValueError, KeyError) as e:
            log.error("Failed to read checkpoint!: %s", e)
    if checkpoint is None:
        if (
            prefix.is_dir()
            and not ckp_path.is_file()
            and not args.redo
            # shard runs tolerate an existing prefix when it holds a merged
            # checkpoint (multi-host resume; the merged processed baseline
            # is folded in below) or only other hosts' shard artifacts
            # (hosts create their files concurrently)
            and not (shard and (prefix / "raxtax.json").is_file())
            and not (
                shard
                and all(".shard" in p.name for p in prefix.iterdir())
            )
        ):
            raise OutputError(
                f"Output folder {prefix} already exists! Please specify another "
                "folder with -o <PATH> or run with --redo to force overriding "
                "existing files!"
            )
        prefix.mkdir(parents=True, exist_ok=True)
        checkpoint = Checkpoint.new(
            ckp_path, args, prefix / f"raxtax.ckp{shard}"
        )
    prefix.mkdir(parents=True, exist_ok=True)
    if shard and not args.redo:
        # fold the merged (consolidated) progress baseline into this host's
        # processed set so completed queries from prior runs — under any
        # process count — are skipped
        merged_json = prefix / "raxtax.json"
        if merged_json.is_file():
            try:
                merged = Checkpoint.load(merged_json)
                if merged.valid_for(args):
                    with open(merged.progress_file) as f:
                        checkpoint.processed_queries |= {
                            l.rstrip("\n") for l in f if l.strip()
                        }
            except (OSError, ValueError, KeyError) as e:
                log.error("Failed to read merged checkpoint!: %s", e)
    append = not args.redo
    writers = OutputWriters(
        primary=_open(out_path, append),
        tsv=_open(tsv_path, append) if args.tsv else None,
        log=_open(prefix / f"raxtax.log{shard}", append),
        progress=_open(prefix / f"raxtax.ckp{shard}", append),
    )
    if resuming:
        msg = f"Restarting from checkpoint {checkpoint.checkpoint_file}"
        log.info(msg)
        writers.log.write(f"[INFO ] {msg}\n")
    return writers, checkpoint


class ResultWriter:
    """Single writer thread draining an unbounded queue of
    (query_label, out_string, tsv_string|None) tuples, exactly like the
    reference's crossbeam consumer (src/main.rs:126-136)."""

    _SENTINEL = object()

    def __init__(self, writers: OutputWriters):
        self.writers = writers
        self.queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="raxtax-writer")
        self._thread.start()

    def send(self, label: str, out_string: str, tsv_string: str | None):
        self.queue.put((label, out_string, tsv_string))

    #: max queries committed per flush burst
    BURST = 256

    def _run(self):
        """Drain in bursts: write a burst's result lines, flush, then write
        its progress labels, flush. The progress file therefore never
        overstates completed work (its entries only hit the OS after their
        result lines), at two flushes per burst instead of per query —
        the same commit ordering as the reference writer thread
        (src/main.rs:126-136)."""
        import queue as _queue

        try:
            while True:
                item = self.queue.get()
                done = item is self._SENTINEL
                burst = [] if done else [item]
                while len(burst) < self.BURST and not done:
                    try:
                        nxt = self.queue.get_nowait()
                    except _queue.Empty:
                        break
                    if nxt is self._SENTINEL:
                        done = True
                        break
                    burst.append(nxt)
                for label, out_string, tsv_string in burst:
                    if self.writers.tsv is not None:
                        self.writers.tsv.write(tsv_string + "\n")
                    self.writers.primary.write(out_string + "\n")
                self.writers.primary.flush()
                if self.writers.tsv is not None:
                    self.writers.tsv.flush()
                for label, _, _ in burst:
                    self.writers.progress.write(label + "\n")
                self.writers.progress.flush()
                if done:
                    return
        except BaseException as e:  # surfaced on join
            self.error = e

    def join(self):
        self.queue.put(self._SENTINEL)
        with span("writer.join"):
            self._thread.join()
        if self.error is not None:
            raise self.error
