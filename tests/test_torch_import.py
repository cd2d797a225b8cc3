"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points refuse to run without a GPU unless the CPU is
asked for."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "raxtax_tpu_torch"


def test_import_pulls_no_jax():
    code = (
        "import sys\n"
        "import raxtax_tpu_torch, raxtax_tpu_torch.cli\n"
        "import raxtax_tpu_torch.engine.device, raxtax_tpu_torch.convert\n"
        "import raxtax_tpu_torch.engine.classify\n"
        "import raxtax_tpu_torch.ops.intersect_stream\n"
        "import raxtax_tpu_torch.ops.intersect_xla, raxtax_tpu_torch.ops.bitops\n"
        "import raxtax_tpu_torch.ops.histogram\n"
        "import raxtax_tpu_torch.tools.compare_modes\n"
        "import raxtax_tpu_torch.tools.profile_path\n"
        "import raxtax_tpu_torch.ops.exactf64, raxtax_tpu_torch.ops.opchain\n"
        "import raxtax_tpu_torch.tools.probe_f64, raxtax_tpu_torch.tools.probe_ops\n"
        "import raxtax_tpu_torch.tools.fuzzworld\n"
        "import raxtax_tpu_torch.tools.fuzz_hardware\n"
        "import raxtax_tpu_torch.tools.sweep_common\n"
        "import raxtax_tpu_torch.tools.make_synth_fasta\n"
        "import raxtax_tpu_torch.tools.runtime_memory\n"
        "import raxtax_tpu_torch.tools.profile_stages\n"
        "import raxtax_tpu_torch.tools.diag_engine\n"
        "import raxtax_tpu_torch.tools.kernel_ab, raxtax_tpu_torch.tools.kernel_batch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'raxtax_tpu', 'tests', 'bench', 'psutil')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    # -S -I keep site customisation (which may import jax by itself) and
    # the environment out; the repo root goes on the path by hand
    r = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n" + code],
        capture_output=True, text=True, cwd=str(ROOT),
    )
    if "BAD ['jax" in r.stdout and _site_imports_jax():
        pytest.skip("this interpreter imports jax at start-up by itself")
    assert r.returncode == 0, r.stdout + r.stderr


def _site_imports_jax() -> bool:
    r = subprocess.run(
        [sys.executable, "-c", "import sys; print('jax' in sys.modules)"],
        capture_output=True, text=True,
    )
    return r.stdout.strip() == "True"


def test_sources_name_the_jax_package_only_in_prose():
    """No import of ``jax``, of the JAX package, of the repository's tests or
    benchmark, or of ``psutil`` anywhere in the port or in chip_smoke.py."""
    pat = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|raxtax_tpu|tests|bench|psutil)"
        r"(\.|\s|$)", re.M
    )
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_need_a_gpu_unless_cpu_is_asked():
    import torch

    from raxtax_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_create_without_gpu_raises():
    import torch

    from raxtax_tpu_torch.db.database import build_database
    from raxtax_tpu_torch.engine.device import DeviceClassifier
    from raxtax_tpu_torch.utils.encoding import encode_sequence

    db = build_database(
        ["a:A,b:B", "a:A,b:C"],
        [encode_sequence("ACGTACGTACGTAAC"), encode_sequence("ACGTTCGTACGTAAG")],
    )
    if torch.cuda.is_available():
        assert DeviceClassifier.create(db).state.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceClassifier.create(db)
    assert DeviceClassifier.create(db, device="cpu").state.device.type == "cpu"


def test_wrappers_never_take_the_plain_version_for_a_cuda_tensor(monkeypatch):
    """A wrapper picks its plain version by the tensor's device alone: with
    ``is_cuda`` true it goes to the kernel's checks and build, and raises
    there on a machine that cannot build."""
    import torch

    from raxtax_tpu_torch.ops import (
        exactf64,
        exactscan,
        intersect_fold,
        intersect_stream,
        opchain,
        planes,
    )

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def boom(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(exactscan, "exact_cumsum_plain", boom)
    monkeypatch.setattr(planes, "planes_histogram_plain", boom)
    monkeypatch.setattr(planes, "planes_probs_plain", boom)
    monkeypatch.setattr(intersect_fold, "fold_planes_plain", boom)
    monkeypatch.setattr(intersect_fold, "fold_planes_sparse_plain", boom)
    monkeypatch.setattr(intersect_fold, "fold_planes_gathered_plain", boom)
    monkeypatch.setattr(intersect_stream, "fold_planes_stream_plain", boom)
    monkeypatch.setattr(planes, "planes_high_counts_plain", boom)
    monkeypatch.setattr(planes, "dd_cumsum_plain", boom)
    monkeypatch.setattr(exactf64, "probe_f64_ew_plain", boom)
    monkeypatch.setattr(exactf64, "probe_f64_scan_plain", boom)
    monkeypatch.setattr(opchain, "probe_op_chain_plain", boom)
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    p = torch.zeros((2, 8), dtype=torch.float64).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        exactscan.exact_cumsum(p)
    pl = torch.zeros((2, 5, 1, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        planes.planes_histogram(pl, 32, 100)
    tab = torch.zeros((2, 32), dtype=torch.float64).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        planes.planes_probs(pl, tab)
    idx = torch.zeros((2, 32), dtype=torch.int32).as_subclass(FakeCuda)
    kc = torch.zeros(2, dtype=torch.int32).as_subclass(FakeCuda)
    km = torch.zeros((65537, 1, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        intersect_fold.fold_planes(idx, kc, km)
    km8 = torch.zeros((65537, 8, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        intersect_fold.fold_planes_sparse(idx, idx, kc, km8, max_count=32)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        planes.planes_high_counts(pl)
    x = torch.zeros((2, 256), dtype=torch.float32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        planes.dd_cumsum(x)
    xb = torch.zeros((2, 32, 1, 128), dtype=torch.float32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        planes.dd_cumsum_bitmajor(xb)
    rows = torch.zeros((2 * 16, 1, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        intersect_fold.fold_planes_gathered(rows, 2, 2)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        intersect_fold.intersection_planes_gathered(idx, km)
    flat = torch.zeros(2 * 32, dtype=torch.int32).as_subclass(FakeCuda)
    ptr = torch.zeros(1, dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        intersect_stream.fold_planes_stream(flat, flat, ptr, ptr, km, 2, 2, 6)
    w = torch.zeros((8, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        exactf64.probe_f64_ew(w, w, w, w)
    g = torch.zeros((1, 4, 128), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        exactf64.probe_f64_scan(g, g)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        opchain.probe_op_chain("u32_add_x1", w, w, 4)


def test_the_new_kernel_sources_are_listed_for_the_build(tmp_path, monkeypatch):
    """Every ``csrc/*.cu`` is a build target, the wrappers name the C entry
    points their sources export, and every shared header goes into every
    library's name, so an edited header never leaves a stale build."""
    from raxtax_tpu_torch.ops import _build

    stems = {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert stems == set(_build.KERNEL_SOURCES) and len(stems) == 11
    for entry, src, wrapper in (
        ("rx_fold_rows", "fold_rows.cu", "intersect_fold.py"),
        ("rx_fold_stream", "fold_stream.cu", "intersect_stream.py"),
        ("rx_probe_f64_ew", "probe_f64.cu", "exactf64.py"),
        ("rx_probe_f64_scan", "probe_f64.cu", "exactf64.py"),
        ("rx_probe_op_chain", "probe_ops.cu", "opchain.py"),
    ):
        assert entry in (PKG / "csrc" / src).read_text()
        assert f'"{entry}"' in (PKG / "ops" / wrapper).read_text()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (PKG / "csrc").iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {s: _build._lib_path(s) for s in _build.KERNEL_SOURCES}
    (csrc / "exactf64.cuh").write_text((csrc / "exactf64.cuh").read_text() + "\n")
    after = {s: _build._lib_path(s) for s in _build.KERNEL_SOURCES}
    assert all(before[s] != after[s] for s in before)
