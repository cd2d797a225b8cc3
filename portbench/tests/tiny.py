"""A tiny root for CPU runs of the harness: its own BENCHMARK.json, a
configuration and traffic files of a few hundred records, and the real
per-layer metrics."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

COI = {
    "name": "tinycoi", "records": 400,
    "ranks": ["k", "p", "c", "o", "f", "g", "s"], "rank_names": {"k": "Animalia"},
    "taxa": {"k": 1, "p": 2, "c": 3, "o": 4, "f": 6, "g": 12, "s": 40},
    "children": {"law": "zipf", "exponent": 1.2,
                 "cap": {"p": 2, "c": 2, "o": 2, "f": 3, "g": 4, "s": 10}},
    "alignment_length": 120, "record_length": [120, 120],
    "conserved_share": 0.0, "conserved_blocks": 0, "consensus_rank": "f",
    "divergence": {"g": 0.12, "s": 0.05, "record": 0.0075},
    "species_records": {"law": "zipf", "exponent": 1.2, "min": 1, "cap": 60},
    "regions": {},
}
SSU = {
    "name": "tinyssu", "records": 300,
    "ranks": ["d", "p", "c", "o", "f", "g", "s"], "rank_names": {},
    "taxa": {"d": 2, "p": 3, "c": 4, "o": 5, "f": 6, "g": 10, "s": 30},
    "children": {"law": "zipf", "exponent": 1.2,
                 "cap": {"p": 2, "c": 2, "o": 2, "f": 2, "g": 3, "s": 8}},
    "alignment_length": 200, "record_length": [170, 200],
    "conserved_share": 0.35, "conserved_blocks": 3, "consensus_rank": "f",
    "divergence": {"g": 0.06, "s": 0.025, "record": 0.005},
    "species_records": {"law": "zipf", "exponent": 1.2, "min": 1, "cap": 50},
    "regions": {"v4": [60, 113]},
}
TRAFFIC = {
    "known": {"anchor": "s", "divergence": [0.0075], "record_copy_share": 0.2,
              "span": "full"},
    "fulllength": {"anchor": "s", "divergence": [0.005],
                   "record_copy_share": 0.0, "span": "record"},
    "v4": {"anchor": "s", "divergence": [0.005], "record_copy_share": 0.0,
           "span": "v4"},
}
CELLS = [("tinycoi.known", "tinycoi", "known"),
         ("tinyssu.fulllength", "tinyssu", "fulllength"),
         ("tinyssu.v4", "tinyssu", "v4")]


def make_root(root: Path, file_queries: int = 24) -> Path:
    """Write the tiny root under ``root`` and return it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    shutil.copytree(REPO / "portbench" / "metrics", pb / "metrics")
    bench["configs"] = []
    for conf in (COI, SSU):
        (pb / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        bench["configs"].append({
            "name": conf["name"], "source": "test", "reduced": [], "why": "test",
            "file": f"portbench/configs/{conf['name']}.json"})
    for name, t in TRAFFIC.items():
        t = dict(t, file_queries=file_queries, warmup_queries=8,
                 check_queries=16)
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench["workloads"] = [
        {"name": c, "config": conf, "traffic": t, "chips": 1, "why": "test"}
        for c, conf, t in CELLS
    ]
    for m in bench["per_layer"]:
        m["workloads"] = [c for c, _, _ in CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
