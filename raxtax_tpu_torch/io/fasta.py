"""FASTA readers for reference databases and query files.

Host-side input layer (reference: src/parser.rs:36-154, src/utils.rs:42-60).
Semantics preserved:

- plain or gzip input, chosen by file extension (``.gz`` / ``.gzip``);
- lines are trimmed; blank lines and ``;`` comment lines are dropped;
- the first retained line must start with ``>``;
- reference headers must carry a ``tax=<lineage>;`` annotation (regex
  ``tax=([^;]+);``); the captured lineage becomes the record label;
- query labels are the full header text after ``>``;
- sequences are 4-bit encoded with full IUPAC support.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.encoding import encode_sequence
from ..utils.trace import span

_TAX_RE = re.compile(r"tax=([^;]+);")


class FastaError(ValueError):
    pass


def read_text(path: str | Path) -> str:
    """Read a possibly-gzipped text file (reference: src/utils.rs:42-60)."""
    path = Path(path)
    ext = path.suffix.lower().lstrip(".")
    if ext in ("gz", "gzip"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path, "rt") as f:
        return f.read()


def read_bytes(path: str | Path) -> bytes:
    path = Path(path)
    ext = path.suffix.lower().lstrip(".")
    if ext in ("gz", "gzip"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _clean_lines(fasta_str: str) -> list[str]:
    if not fasta_str:
        raise FastaError("File is empty")
    lines = [l.strip() for l in fasta_str.splitlines()]
    lines = [l for l in lines if l and not l.startswith(";")]
    if not lines or not lines[0].startswith(">"):
        raise FastaError("Not a valid FASTA file")
    return lines


@dataclass
class ReferenceRecords:
    """Raw reference records, in file order (pre lineage sort)."""

    lineages: list[str]
    sequences: list[np.ndarray]  # 4-bit encoded


def parse_reference_fasta_str(fasta_str: str) -> ReferenceRecords:
    """Parse a reference FASTA string (reference: src/parser.rs:46-105)."""
    from ..utils.logging import Progress

    lines = _clean_lines(fasta_str)
    lineages: list[str] = []
    chunks: list[list[str]] = []
    current: list[str] = []
    meter = Progress(len(lines), "Parsing reference sequences...")
    for line in lines:
        meter.inc()
        if line.startswith(">"):
            label = line[1:]
            m = _TAX_RE.search(label)
            if m is None:
                raise FastaError(
                    f"Unexpected taxonomical annotation detected in label {label}"
                )
            lineages.append(m.group(1))
            if current:
                chunks.append(current)
                current = []
        else:
            current.append(line)
    chunks.append(current)
    meter.finish()
    if len(lineages) != len(chunks):
        raise FastaError("Number of sequences does not match number of labels")
    sequences = [encode_sequence("".join(c)) for c in chunks]
    return ReferenceRecords(lineages=lineages, sequences=sequences)


def parse_reference_fasta_file(path: str | Path) -> ReferenceRecords:
    data = read_bytes(path)
    from .. import native

    parsed = native.parse_fasta(data, with_tax=True)
    if parsed is not None:
        lineages, seqs = parsed
        return ReferenceRecords(lineages=lineages, sequences=seqs)
    # slow path: no native lib, or an input error whose exact message the
    # Python parser reproduces
    return parse_reference_fasta_str(data.decode("utf-8"))


def iter_fasta_records(path: str | Path):
    """Raw (header, sequence-string) pairs, unencoded — harness/tooling use."""
    lines = _clean_lines(read_text(path))
    header = None
    current: list[str] = []
    for line in lines:
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(current)
            header = line[1:]
            current = []
        else:
            current.append(line)
    if header is not None:
        yield header, "".join(current)


def parse_query_fasta_str(
    fasta_str: str, queries_to_skip: set[str] | None = None
) -> list[tuple[str, np.ndarray]]:
    """Parse a query FASTA string (reference: src/parser.rs:117-154).

    Queries whose full labels appear in `queries_to_skip` are dropped
    (checkpoint resume support).
    """
    lines = _clean_lines(fasta_str)
    queries: list[tuple[str, list[str]]] = []
    label = ""
    current: list[str] = []
    for line in lines:
        if line.startswith(">"):
            # NOTE: the reference only flushes when the running sequence is
            # non-empty (src/parser.rs:138-141), so consecutive headers
            # collapse onto the last one. Preserved.
            if current:
                queries.append((label, current))
                current = []
            label = line[1:]
        else:
            current.append(line)
    queries.append((label, current))
    skip = queries_to_skip or set()
    return [
        (lab, encode_sequence("".join(c)))
        for lab, c in queries
        if lab not in skip
    ]


def parse_query_fasta_file(
    path: str | Path, queries_to_skip: set[str] | None = None
) -> list[tuple[str, np.ndarray]]:
    from .. import native

    with span("query.parse"):
        data = read_bytes(path)
        parsed = native.parse_fasta(data, with_tax=False)
        if parsed is None:
            return parse_query_fasta_str(data.decode("utf-8"), queries_to_skip)
        labels, seqs = parsed
        skip = queries_to_skip or set()
        return [(lab, s) for lab, s in zip(labels, seqs) if lab not in skip]
