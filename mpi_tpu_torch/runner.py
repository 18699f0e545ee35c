"""Backend-selecting program entry: ``mpi_tpu_torch.run_main``.

Counterpart of ``mpi_tpu/runner.py`` for the port's one driver, ``cuda``:
a reference-style program runs SPMD with one thread per rank over the CUDA
devices::

    python prog.py --mpi-backend cuda --mpi-ranks 8
    python prog.py --mpi-ranks 4 --mpi-device cpu      # the plain paths

``--mpi-backend`` (env ``MPI_TPU_BACKEND``): ``cuda``, the default; the
JAX package's ``tcp``, ``xla`` and ``hybrid`` have no port yet (ROADMAP.md
Queue 1, item 10) and raise. ``--mpi-ranks`` (env ``MPI_TPU_RANKS``): the
rank count, shared round-robin over the visible CUDA devices (default: one
rank per device). ``--mpi-device``: put every rank on this device, as
``device="cpu"`` does for the port's other entry points; without it the
ranks need CUDA.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import api

__all__ = ["run_main", "selected_backend"]

FLAG_BACKEND = "mpi-backend"
FLAG_RANKS = "mpi-ranks"
FLAG_DEVICE = "mpi-device"
ENV_BACKEND = "MPI_TPU_BACKEND"
ENV_RANKS = "MPI_TPU_RANKS"


def _scan_argv(names: set, argv: Optional[Sequence[str]]) -> Dict[str, str]:
    """The given flags from argv, everything else ignored: ``-name value``,
    ``--name value``, ``-name=value`` or ``--name=value`` (a copy of
    ``mpi_tpu/flags.py:_scan_argv``)."""
    if argv is None:
        argv = sys.argv[1:]
    found: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("-"):
            body = tok.lstrip("-")
            if "=" in body:
                name, _, value = body.partition("=")
                if name in names:
                    found[name] = value
            elif body in names and i + 1 < len(argv):
                found[body] = argv[i + 1]
                i += 1
        i += 1
    return found


def selected_backend(argv: Optional[Sequence[str]] = None) -> str:
    found = _scan_argv({FLAG_BACKEND}, argv)
    choice = (found.get(FLAG_BACKEND) or os.environ.get(ENV_BACKEND)
              or "cuda").lower()
    if choice != "cuda":
        raise api.MpiError(
            f"mpi_tpu_torch: --{FLAG_BACKEND} {choice!r} is not ported; the "
            f"port has the cuda driver only (the tcp, xla and hybrid drivers "
            f"are ROADMAP.md Queue 1, item 10)")
    return choice


def run_main(main: Callable[[], Any],
             argv: Optional[Sequence[str]] = None) -> List[Any]:
    """Run a reference-style program under the cuda driver: ``main()``
    runs SPMD, one thread per rank. Returns the per-rank results."""
    from .backends.cuda import run_spmd

    selected_backend(argv)
    found = _scan_argv({FLAG_RANKS, FLAG_DEVICE}, argv)
    ranks_s = found.get(FLAG_RANKS) or os.environ.get(ENV_RANKS)
    n = None
    if ranks_s:
        try:
            n = int(ranks_s)
        except ValueError as exc:
            raise api.MpiError(
                f"mpi_tpu_torch: --{FLAG_RANKS} must be an integer, "
                f"got {ranks_s!r}") from exc
    device = found.get(FLAG_DEVICE) or None
    return run_spmd(main, n=n, device=device)
