"""Checkpoint / resume management.

Mirrors the reference's three-artifact scheme (reference: src/io.rs:17-303,
SURVEY.md §5):

- ``raxtax.json`` — paths, database fingerprint (path/size/mtime) and the
  three semantics-changing flags; written atomically via tmp+rename;
- ``raxtax.ckp`` — append-only completed-query labels, written *after* each
  query's results so it understates-never-overstates progress;
- the binary database cache, fingerprint-tracked.

On resume, ``raxtax.out`` / ``raxtax.tsv`` are trimmed to completed queries
and reopened in append mode.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path

log = logging.getLogger("raxtax")


@dataclass
class FileFingerprint:
    """Path + size + mtime identity of the database file (src/io.rs:24-45)."""

    path: str
    size: int
    modified: int

    @classmethod
    def of(cls, path: str | Path) -> "FileFingerprint":
        st = os.stat(path)
        return cls(
            path=str(Path(path).absolute()),
            size=st.st_size,
            modified=int(st.st_mtime),
        )

    def to_json(self) -> dict:
        return {"path": self.path, "size": self.size, "modified": self.modified}

    @classmethod
    def from_json(cls, d: dict) -> "FileFingerprint":
        return cls(path=d["path"], size=int(d["size"]), modified=int(d["modified"]))


@dataclass
class Checkpoint:
    checkpoint_file: str
    progress_file: str
    db_fingerprint: FileFingerprint
    raw_confidence: bool
    skip_exact_matches: bool
    tsv: bool
    processed_queries: set[str] = field(default_factory=set)
    #: which arrays the binary DB carries: "full" (ref-major + kmer-major)
    #: or "km-only" (pallas/stream builds skip the ref-major matrix).
    #: Informational — the .rxdb header is authoritative and the engine
    #: errors actionably when xla needs the missing matrix.
    db_variant: str = "full"
    #: non-writing participant of a global-mesh run (host != 0): reads the
    #: coordinator host's checkpoint, never persists or deletes anything
    read_only: bool = False

    @classmethod
    def new(cls, ckp_path: Path, args, progress_path: Path | None = None) -> "Checkpoint":
        if progress_path is None:
            progress_path = ckp_path.with_suffix(".ckp")
        return cls(
            checkpoint_file=str(ckp_path.absolute()),
            progress_file=str(Path(progress_path).absolute()),
            db_fingerprint=FileFingerprint.of(args.database_path),
            raw_confidence=args.raw_confidence,
            skip_exact_matches=args.skip_exact_matches,
            tsv=args.tsv,
        )

    def save(self) -> None:
        """Atomic write via tmp+rename (src/io.rs:72-78)."""
        if self.read_only:
            return
        tmp = self.checkpoint_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "checkpoint_file": self.checkpoint_file,
                    "progress_file": self.progress_file,
                    "db_fingerprint": self.db_fingerprint.to_json(),
                    "raw_confidence": self.raw_confidence,
                    "skip_exact_matches": self.skip_exact_matches,
                    "tsv": self.tsv,
                    "db_variant": self.db_variant,
                },
                f,
                indent=2,
            )
        os.replace(tmp, self.checkpoint_file)

    @classmethod
    def load(cls, path: str | Path) -> "Checkpoint":
        with open(path) as f:
            d = json.load(f)
        return cls(
            checkpoint_file=d["checkpoint_file"],
            progress_file=d["progress_file"],
            db_fingerprint=FileFingerprint.from_json(d["db_fingerprint"]),
            raw_confidence=bool(d["raw_confidence"]),
            skip_exact_matches=bool(d["skip_exact_matches"]),
            tsv=bool(d["tsv"]),
            db_variant=str(d.get("db_variant", "full")),
        )

    def valid_for(self, args) -> bool:
        """Flag + fingerprint validation (src/io.rs:288-302)."""
        try:
            fp = FileFingerprint.of(self.db_fingerprint.path)
        except OSError as e:
            log.error("Could not verify checkpoint, starting from scratch!: %s", e)
            return False
        return (
            args.tsv == self.tsv
            and args.raw_confidence == self.raw_confidence
            and args.skip_exact_matches == self.skip_exact_matches
            and fp == self.db_fingerprint
        )

    def cleanup(self) -> None:
        """Remove checkpoint artifacts and the binary DB (src/io.rs:80-89)."""
        if self.read_only:
            return
        for p in (self.checkpoint_file, self.progress_file, self.db_fingerprint.path):
            os.remove(p)


def check_incomplete_output(path: Path, processed: set[str]) -> None:
    """Trim an output file to lines of completed queries (src/io.rs:156-187).

    A line is retained iff its first tab-field is a processed query label.
    """
    if not path.is_file():
        return
    retained = []
    needs_rewrite = False
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if "\t" not in line:
                needs_rewrite = True
                continue
            query = line.split("\t", 1)[0]
            if query in processed:
                retained.append(line)
            else:
                needs_rewrite = True
    if needs_rewrite:
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            if retained:
                f.write("\n".join(retained) + "\n")
        os.replace(tmp, path)
