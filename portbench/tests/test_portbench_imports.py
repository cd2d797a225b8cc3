"""What a run loads and reads: no JAX, no JAX package (top-level names
compared whole, so the port ``raxtax_tpu_torch`` passes), no module of the
program in the reference, and none of the JAX package's benchmark files."""

import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tiny import REPO

RUN = (
    "import sys, time, json\n"
    "from pathlib import Path\n"
    "opened = []\n"
    "sys.addaudithook(lambda ev, a: opened.append(str(a[0])) "
    "if ev == 'open' and isinstance(a[0], (str, bytes)) else None)\n"
    "from portbench import harness\n"
    "from portbench.tests.tiny import make_root\n"
    "import tempfile\n"
    "root = make_root(Path(tempfile.mkdtemp()))\n"
    "r = harness.run('tinycoi.known', 9, 0.05, True, time.perf_counter(), root=root,"
    " device='cpu', log=lambda m: None)\n"
    "assert r['correct'], r\n"
    "print(json.dumps({'modules': sorted(sys.modules), 'opened': opened,"
    " 'forbidden': harness.forbidden_modules()}))\n"
)


def child(code):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    got = child(RUN)
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "raxtax_tpu_torch" in tops  # the port runs, and passes the check
    assert not tops & {"jax", "jaxlib", "flax", "raxtax_tpu"}
    assert got["forbidden"] == []
    for path in got["opened"]:
        rel = os.path.relpath(os.path.abspath(path), REPO)
        assert not rel.startswith("benchmarks" + os.sep), path
        assert rel != "bench.py" and not rel.startswith("BENCH_"), path
        assert not rel.startswith("raxtax_tpu" + os.sep), path


def test_the_check_compares_whole_names():
    sys.modules["raxtax_tpu_torch_probe_name"] = sys  # a name with the prefix
    try:
        assert "raxtax_tpu_torch_probe_name" not in harness.forbidden_modules()
        sys.modules["raxtax_tpu.probe"] = sys
        assert "raxtax_tpu.probe" in harness.forbidden_modules()
    finally:
        sys.modules.pop("raxtax_tpu_torch_probe_name", None)
        sys.modules.pop("raxtax_tpu.probe", None)


def test_the_reference_loads_nothing_of_the_program():
    got = child(
        "import sys, json\n"
        "import portbench.reference, portbench.generator, portbench.yardstick\n"
        "print(json.dumps({'modules': sorted(sys.modules)}))\n"
    )
    tops = {m.split(".")[0] for m in got["modules"]}
    assert not tops & {"raxtax_tpu_torch", "raxtax_tpu", "jax", "jaxlib"}


def test_no_source_names_the_jax_packages_benchmark():
    for f in (REPO / "portbench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        text = f.read_text()
        for word in ("benchmarks/", "BENCH_", "import raxtax_tpu\n",
                     "from raxtax_tpu ", "from raxtax_tpu.", "import jax"):
            assert word not in text, (f, word)
