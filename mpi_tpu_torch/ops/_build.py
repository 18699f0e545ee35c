"""Build the port's CUDA sources (``ops/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, then loaded with :mod:`ctypes`. The
library lands in ``mpi_tpu_torch/_build/`` (git-ignored) under a name keyed
by a hash of the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. A build or a load that fails raises:
there is no stub to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "build_log", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# -Xptxas -v writes each kernel's registers, shared memory and spills to
# the build log (build_log) without changing the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "mpi_tpu_torch: nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
        "kernels are built from ops/csrc at first use and need the CUDA "
        "toolkit")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return _lib_path(name)


def build_log(name: str) -> str:
    """nvcc's output (the ptxas resource report) from building ``name``."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every source in ``csrc/`` (or just ``names``) whose library
    is missing, one ``nvcc`` per source, all started together. Returns the
    names built. Raises ``RuntimeError`` naming each source that failed."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        final = _lib_path(name)
        # Unique temporary name, then an atomic rename: processes that
        # build the same source at once each leave a whole library.
        tmp = final.with_name(f".{final.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, final, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, final, tmp, proc in procs:
        log, _ = proc.communicate()
        final.with_suffix(".log").write_text(log)
        if proc.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, final)
    if failed:
        raise RuntimeError("mpi_tpu_torch: kernel build failed: "
                           + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib

