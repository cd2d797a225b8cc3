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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'raxtax_tpu' or m.startswith('raxtax_tpu.')]\n"
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
    """No import of ``jax`` or of the JAX package anywhere in the port or in
    chip_smoke.py."""
    pat = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|raxtax_tpu)(\.|\s|$)", re.M
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

    from raxtax_tpu_torch.ops import exactscan, intersect_fold, planes

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
