"""The port's native host code, built with ``g++`` at first use.

``dataloader.cpp`` is the port's own copy of the JAX package's
``native/dataloader.cpp`` (``dl_gather`` v1): the gather of a training
batch's token windows out of a corpus, widened to int32, in one ctypes call
that releases the interpreter lock (``data.py`` calls it from its prefetch
thread). It is compiled into ``mpi_tpu_torch/_build/`` (git-ignored), beside
the CUDA libraries of ``ops/_build.py``, under a name keyed by a hash of the
source and the flags, and loaded with :mod:`ctypes`. A build or a load that
fails raises: there is no quiet switch to the numpy gather.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR

__all__ = ["SOURCE", "GXX_FLAGS", "library_path", "dataloader"]

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_VERSION = 1  # dl_version() of the source this binding was written for

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of ``dataloader.cpp`` is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"dataloader-{digest[:16]}.so"


def _build(final: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("mpi_tpu_torch: g++ not found on PATH; the "
                           "native gather (native/dataloader.cpp) is built "
                           "at first use and needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Unique temporary name, then an atomic rename: processes that build
    # at once each leave a whole library.
    tmp = final.with_name(f".{final.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"mpi_tpu_torch: building native/dataloader.cpp "
                           f"failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, final)


def dataloader() -> ctypes.CDLL:
    """The loaded gather library, built first if needed. Raises
    ``RuntimeError`` if it cannot be built or is of another version."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.dl_gather.restype = ctypes.c_int
            lib.dl_gather.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
            lib.dl_version.restype = ctypes.c_int
            if lib.dl_version() != _VERSION:
                raise RuntimeError(f"mpi_tpu_torch: native dataloader "
                                   f"version {lib.dl_version()}, want "
                                   f"{_VERSION}")
            _LIB = lib
        return _LIB
