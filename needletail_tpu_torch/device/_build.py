"""Build and load the port's native code.

Each ``needletail_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into its
own shared library with a plain C interface under
``build/needletail_tpu_torch/`` at the repository root, and loads with
``ctypes``.  The build runs at first CUDA use, never at import, so a
CPU-only install needs no compiler.  All stale sources compile at once,
one ``nvcc`` process each.  A library newer than its source is reused.

The host framer ``csrc/framer.cpp`` builds the same way with the host C++
compiler (:func:`build_framer`), at the first framing call.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SOURCES", "NVCC_FLAGS", "CXX_FLAGS", "build_all", "build_framer", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "needletail_tpu_torch"

SOURCES = (
    "hash_keys", "histogram16", "compact_slots", "block_sort", "merge_spectra",
    "minimizer_sketch", "run_counts",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# no -march=native: SIMD comes from per-function target("avx2") clones
# behind a runtime CPU check in framer.cpp
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-Wextra")
FRAMER = "ntframer"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of needletail_tpu_torch are compiled at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build_all() -> Dict[str, str]:
    """Compile every stale kernel source, all ``nvcc`` processes at once.

    Returns ``{name: compiler output}`` for the sources it compiled (the
    ``-Xptxas -v`` lines give registers and shared memory per kernel).
    Raises ``RuntimeError`` with the compiler's output when one fails.
    """
    with _lock:
        return _build_locked()


def _build_locked() -> Dict[str, str]:
    todo = [name for name in SOURCES if _stale(name)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
        )
    logs: Dict[str, str] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        detail = "\n".join(f"--- {n}.cu ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, building first if
    needed.  Raises when CUDA, ``nvcc`` or the build is missing."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if name not in SOURCES:
                raise KeyError(f"no kernel source named {name!r}")
            _build_locked()
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def build_framer() -> Optional[Path]:
    """Path of the host framer library, compiling ``csrc/framer.cpp`` with
    ``$CXX`` (default ``g++``) when the library is missing or older than
    its source; None when the compiler or the build fails (the framers
    then run in pure Python)."""
    so = _lib_path(FRAMER)
    src = CSRC / "framer.cpp"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    # concurrent builds each write their own file; the last rename wins
    os.replace(tmp, so)
    return so
