"""Logging, phase timers and progress reporting.

Equivalent of the reference's env_logger + logging_timer + indicatif stack
(reference: src/main.rs:34-39, SURVEY.md C17): a file logger with
``[LEVEL] message`` lines, phase timers that record wall-clock durations of
every pipeline stage, and a low-overhead stderr progress meter.
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager

log = logging.getLogger("raxtax")

_LEVEL_NAMES = {
    logging.DEBUG: "DEBUG",
    logging.INFO: "INFO ",
    logging.WARNING: "WARN ",
    logging.ERROR: "ERROR",
    logging.CRITICAL: "FATAL",
}


class _RefFormatter(logging.Formatter):
    def format(self, record):
        level = _LEVEL_NAMES.get(record.levelno, record.levelname)
        return f"[{level}] {record.getMessage()}"


def verbosity_to_level(verbose: int, quiet: int) -> int:
    """clap-verbosity-flag mapping with Info default (src/io.rs:153)."""
    n = 2 + verbose - quiet  # 2 == Info
    if n <= -1:
        return logging.CRITICAL + 10  # off
    return {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO}.get(
        n, logging.DEBUG
    )


def setup_logging(log_stream, level: int) -> None:
    """Pipe the 'raxtax' logger into the run's log file (src/main.rs:34-39)."""
    log.setLevel(level)
    log.handlers.clear()
    handler = logging.StreamHandler(log_stream)
    handler.setFormatter(_RefFormatter())
    log.addHandler(handler)
    log.propagate = False


def report_error(message: str, error: BaseException | str = "") -> None:
    """Log + colored stderr mirror (src/utils.rs:131-137)."""
    suffix = f": {error}" if str(error) else ""
    log.error("%s%s", message, suffix)
    print(f"\x1b[31m[ERROR]\x1b[0m {message}{suffix}", file=sys.stderr)


def report_warning(message: str) -> None:
    print(f"\x1b[33m[WARN ]\x1b[0m {message}", file=sys.stderr)


def info_stderr(message: str, level: int = logging.INFO) -> None:
    if level >= logging.INFO:
        print(f"[INFO ] {message}", file=sys.stderr)


@contextmanager
def phase_timer(name: str, level: int = logging.INFO):
    """logging_timer-style phase duration logging (SURVEY.md C17)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - start) * 1e3
        log.log(level, "%s took %.3f ms", name, ms)


class Progress:
    """Minimal stderr progress meter (indicatif stand-in)."""

    def __init__(self, total: int, message: str, enabled: bool = True):
        self.total = max(total, 1)
        self.message = message
        self.count = 0
        self.enabled = enabled and sys.stderr.isatty()
        self._start = time.perf_counter()
        self._last = 0.0

    def inc(self, n: int = 1):
        self.count += n
        now = time.perf_counter()
        if self.enabled and (now - self._last > 0.1 or self.count >= self.total):
            self._last = now
            pct = 100.0 * self.count / self.total
            rate = self.count / max(now - self._start, 1e-9)
            print(
                f"\r{self.message} {self.count}/{self.total} "
                f"({pct:5.1f}%) {rate:,.0f}/s",
                end="",
                file=sys.stderr,
            )

    def finish(self):
        if self.enabled:
            print(file=sys.stderr)
