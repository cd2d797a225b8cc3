"""Build and load the CUDA kernels under ``csrc/``.

Each ``*.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``.
All sources are compiled at once, one ``nvcc`` process each, into the
package's ``build/`` directory (not under version control); a library is
reused while its source and the headers it includes are unchanged. A failed
build raises with the compiler's output: there is no fallback for a CUDA
tensor.

The binding convention: every pointer and the stream are ``c_void_p``
(``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``),
sizes are ``c_int`` / ``c_longlong``, and every entry point returns
``cudaGetLastError()`` taken right after its launch; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "RAXTAX_TORCH_BUILD_DIR",
        Path(__file__).resolve().parent.parent / "build",
    )
)
KERNEL_SOURCES = (
    "fold_planes", "planes_hist", "planes_probs", "exact_cumsum",
    "fold_sparse", "planes_high", "dd_cumsum", "fold_rows", "fold_stream",
    "probe_f64", "probe_ops",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels cannot be built on this machine"
    )


def _headers(csrc: Path, name: str, seen: set | None = None) -> list[Path]:
    """The ``csrc`` headers that ``name`` includes with ``#include "..."``,
    directly or through another header, sorted."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                          (csrc / name).read_text(), re.M):
        if inc not in seen and (csrc / inc).is_file():
            seen.add(inc)
            _headers(csrc, inc, seen)
    return [csrc / h for h in sorted(seen)]


def _lib_path(stem: str, csrc: Path | None = None,
              out: Path | None = None) -> Path:
    """The library ``csrc/<stem>.cu`` builds into under ``out`` (by default
    the package's sources and build directory)."""
    csrc, out = csrc or CSRC, out or BUILD_DIR
    # the source and every header it includes go into the library's name: an
    # edited header rebuilds the libraries that include it, and only those
    h = hashlib.sha1()
    for src in (csrc / f"{stem}.cu", *_headers(csrc, f"{stem}.cu")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return out / f"lib{stem}_{h.hexdigest()[:12]}.so"


def build_all(stems=KERNEL_SOURCES, csrc: Path | None = None,
              out: Path | None = None) -> float:
    """Compile every source of ``stems`` under ``csrc`` that has no current
    library under ``out`` (by default the package's sources and build
    directory), all in parallel; nvcc's report goes to
    ``out/<stem>.nvcc.log``. Returns the wall seconds spent (0.0 when
    nothing was built)."""
    csrc, out = csrc or CSRC, out or BUILD_DIR
    todo = [s for s in stems if not _lib_path(s, csrc, out).is_file()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for stem in todo:
        lib = _lib_path(stem, csrc, out)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp),
               str(csrc / f"{stem}.cu")]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for stem, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        # registers / shared memory / spills per kernel, for later reading
        (out / f"{stem}.nvcc.log").write_text(log or "")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {stem}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.time() - t0


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (builds all on first use)."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(stem)))
        lib.rx_error_string.restype = ctypes.c_char_p
        lib.rx_error_string.argtypes = [ctypes.c_int]
        _libs[stem] = lib
    return lib


def entry(stem: str, name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` of ``csrc/<stem>.cu`` (by default one
    returning an int error code), with its argument types set (once)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(stem), name)
        fn.restype = restype
        fn.argtypes = argtypes
        _entries[name] = fn
    return fn


def kernel_wrappers() -> dict:
    """The thirteen kernels' wrappers by name. Each adds one to its
    ``launches`` where it launches its kernel, and nowhere else."""
    from .exactf64 import probe_f64_ew, probe_f64_scan
    from .exactscan import exact_cumsum
    from .intersect_fold import (
        fold_planes,
        fold_planes_gathered,
        fold_planes_sparse,
    )
    from .intersect_stream import fold_planes_stream
    from .opchain import probe_op_chain
    from .planes import (
        dd_cumsum,
        dd_cumsum_bitmajor,
        planes_high_counts,
        planes_histogram,
        planes_probs,
    )

    return {
        "fold_planes": fold_planes, "planes_hist": planes_histogram,
        "planes_probs": planes_probs, "exact_cumsum": exact_cumsum,
        "fold_planes_sparse": fold_planes_sparse,
        "planes_high": planes_high_counts, "dd_cumsum": dd_cumsum,
        "dd_cumsum_bitmajor": dd_cumsum_bitmajor,
        "fold_planes_gathered": fold_planes_gathered,
        "fold_planes_stream": fold_planes_stream,
        "probe_f64_ew": probe_f64_ew, "probe_f64_scan": probe_f64_scan,
        "probe_op_chain": probe_op_chain,
    }


def check(stem: str, code: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = load(stem).rx_error_string(code)
        raise RuntimeError(
            f"{what}: CUDA error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )


def require_cuda_tensor(t, dtype, name: str) -> None:
    """The checks every wrapper makes on a tensor it hands to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
