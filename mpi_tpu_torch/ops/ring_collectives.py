"""Ring collectives over the ranks of a mesh: all-gather (kernel 5) and
all-reduce (kernel 6).

Counterpart of ``mpi_tpu/ops/ring_collectives.py``. There each device runs
the Pallas kernel on its own shard inside ``shard_map`` and pushes chunks to
its ring neighbour by remote DMA. Here a mesh's ranks may share one device
(:mod:`mpi_tpu_torch.parallel.mesh`), and each collective is ONE launch of a
hand-written CUDA kernel over all of them (``csrc/ring_collectives.cu``; see
the note there for its design and what bounds it). Both kernels are a
single pass that reads every input once and writes every output once: the
all-gather copies each chunk straight to every rank, which is what the
ring's hops leave there, and the all-reduce folds each chunk in the ring's
order, so both give the ring's bits.

Layouts follow the JAX global view, so one numpy array feeds both packages:

* :func:`ring_allreduce` takes ``contribs`` ``(n, m, ...)``, rank r's
  contribution at index r, and returns what every rank holds, ``(n, m,
  ...)``: JAX's ``shard_map(lambda v: ring_allreduce(v[0])[None])`` with
  ``P("rank")`` in and out. ``m`` must divide by n.
* :func:`ring_allreduce_sharded` returns the ``(m, ...)`` reduction and pads
  ``m`` to a multiple of n.
* :func:`ring_allreduce_ranks` takes a list of n per-rank tensors and
  returns n results, each its own tensor: the rank-thread driver's entry
  (``backends/cuda.py``), one launch on the ranks' own buffers.
* :func:`ring_allgather` takes ``x`` ``(n·c, ...)``, split over the ranks on
  axis 0, and returns every rank's gathered copy, ``(n, n·c, ...)``;
  :func:`ring_allgather_sharded` returns one ``(n·c, ...)`` copy.

The ring runs over every rank of the mesh in order. On a CUDA tensor the
wrappers launch the kernel (each counts its launches in ``.launches``) or
raise; on a CPU tensor they run the plain PyTorch version, which replays the
TPU kernel's hops; the kernels copy, or fold and round, in the same order,
so results agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from . import _build
from ..collectives_generic import combine
from ..parallel.mesh import RankMesh, mesh_device, rank_pointers

__all__ = ["ring_allgather", "ring_allreduce", "ring_allgather_sharded",
           "ring_allreduce_sharded", "ring_allreduce_ranks",
           "ring_allgather_plain", "ring_allreduce_plain",
           "ALLREDUCE_DTYPES"]

_OPS = ("sum", "max", "min", "prod")  # kernel 6's op codes, in order
ALLREDUCE_DTYPES = (torch.float32, torch.bfloat16)  # kernel 6 takes these


# --------------------------------------------------------------------------
# Plain versions: the TPU kernels' hops, replayed for all ranks at once.
# Within a hop no rank reads a chunk that another rank writes (see the note
# in csrc/ring_collectives.cu), so doing a hop's ranks together is doing
# them one by one.
# --------------------------------------------------------------------------

def ring_allreduce_plain(contribs: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
    """Every rank's result of the ring all-reduce of ``contribs`` ``(n, m,
    ...)`` with ``m % n == 0``: an n−1-hop reduce-scatter that folds
    ``local ⊕ arriving`` into chunk (r−t−1) mod n of rank r, rounding to the
    dtype at each hop, then an n−1-hop all-gather."""
    n = contribs.shape[0]
    if contribs.numel() == 0:
        return contribs.clone()
    out = contribs.reshape(n, n, -1).clone()  # [rank, chunk, elements]
    ranks = torch.arange(n, device=contribs.device)
    left = (ranks - 1) % n
    for t in range(n - 1):
        c = (ranks - t - 1) % n
        out[ranks, c] = combine(out[ranks, c], out[left, c], op)
    for t in range(n - 1):
        c = (ranks - t) % n
        out[ranks, c] = out[left, c]
    return out.reshape(contribs.shape)


def ring_allgather_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's gathered copy ``(n, n·c, ...)`` of ``x`` ``(n·c, ...)``:
    rank r starts with its own chunk and, in hop t, takes chunk (r−t−1) mod
    n from rank r−1."""
    chunks = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    out = torch.empty((n, *chunks.shape), dtype=x.dtype, device=x.device)
    ranks = torch.arange(n, device=x.device)
    left = (ranks - 1) % n
    out[ranks, ranks] = chunks
    for t in range(n - 1):
        c = (ranks - t - 1) % n
        out[ranks, c] = out[left, c]
    return out.reshape(n, *x.shape)


# --------------------------------------------------------------------------
# Kernels
# --------------------------------------------------------------------------

@functools.cache
def _kernel_lib():
    """The built library, with the C signatures declared once."""
    lib = _build.load("ring_collectives")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    i32, i64 = ctypes.c_int, ctypes.c_longlong
    lib.ring_allreduce.argtypes = [ptrs, ptrs, i32, i64, i32, i32,
                                   ctypes.c_void_p]
    lib.ring_allgather.argtypes = [ptrs, ptrs, i32, i64, i32,
                                   ctypes.c_void_p]
    lib.ring_allreduce.restype = lib.ring_allgather.restype = i32
    lib.ring_collectives_max_ranks.argtypes = []
    lib.ring_collectives_max_ranks.restype = i32
    lib.ring_collectives_error_string.argtypes = [i32]
    lib.ring_collectives_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_input(name: str, x: torch.Tensor, n: int,
                        max_ranks: int) -> None:
    if not x.is_contiguous():
        raise ValueError(f"mpi_tpu_torch: {name} needs a contiguous tensor")
    if n > max_ranks:
        raise ValueError(f"mpi_tpu_torch: {name} takes at most {max_ranks} "
                         f"ranks; the mesh has {n}")


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _kernel_lib().ring_collectives_error_string(err).decode()
        raise RuntimeError(f"mpi_tpu_torch: {name} kernel launch failed: "
                           f"{msg} (cudaError {err})")


def _check_allreduce_dtype(dtype: torch.dtype) -> None:
    if dtype not in ALLREDUCE_DTYPES:
        raise TypeError(f"mpi_tpu_torch: the ring all-reduce kernel takes "
                        f"float32 or bfloat16; got {dtype}")


def _run_allreduce(ins, outs, chunk: int, dtype: torch.dtype, op: str,
                   device: torch.device) -> None:
    """One launch of kernel 6 over per-rank pointer tables ``ins`` and
    ``outs`` (rank r's buffer at index r), ``chunk`` elements per rank and
    chunk, on ``device``'s current stream."""
    lib = _kernel_lib()
    n = len(ins)
    if n > lib.ring_collectives_max_ranks():
        raise ValueError(f"mpi_tpu_torch: ring_allreduce takes at most "
                         f"{lib.ring_collectives_max_ranks()} ranks; got {n}")
    with torch.cuda.device(device):
        err = lib.ring_allreduce(
            ins, outs, n, chunk, int(dtype == torch.bfloat16),
            _OPS.index(op), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(err, "ring_allreduce")
    ring_allreduce.launches += 1


def _launch_allreduce(contribs: torch.Tensor, op: str) -> torch.Tensor:
    _check_allreduce_dtype(contribs.dtype)
    n = contribs.shape[0]
    if not contribs.is_contiguous():
        raise ValueError("mpi_tpu_torch: ring_allreduce needs a contiguous "
                         "tensor")
    out = torch.empty_like(contribs)
    if out.numel() == 0:
        return out
    _run_allreduce(rank_pointers(contribs), rank_pointers(out),
                   contribs[0].numel() // n, contribs.dtype, op,
                   contribs.device)
    return out


def _launch_allgather(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.element_size() not in (2, 4):
        raise TypeError(f"mpi_tpu_torch: the ring all-gather kernel takes "
                        f"2- or 4-byte elements; got {x.dtype}")
    lib = _kernel_lib()
    _check_kernel_input("ring_allgather", x, n,
                        lib.ring_collectives_max_ranks())
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.ring_allgather(
            rank_pointers(x.reshape(n, -1)), rank_pointers(out), n,
            x.numel() // n, x.element_size(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "ring_allgather")
    ring_allgather.launches += 1
    return out


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------

def _check_contribs(contribs: torch.Tensor, n: int) -> None:
    if contribs.dim() < 2:
        raise ValueError(f"mpi_tpu_torch: contribs must be (n, m, ...); got "
                         f"shape {tuple(contribs.shape)}")
    if contribs.shape[0] != n:
        raise ValueError(
            f"mpi_tpu_torch: contribs leading axis {contribs.shape[0]} != "
            f"ring size {n}")


def ring_allreduce(contribs: torch.Tensor, mesh: RankMesh, op: str = "sum"
                   ) -> torch.Tensor:
    """All-reduce (``op`` in sum, max, min, prod) of ``contribs`` ``(n, m,
    ...)`` over the n ranks of ``mesh``; returns every rank's copy ``(n, m,
    ...)``. ``m`` must be divisible by n (:func:`ring_allreduce_sharded`
    pads). The reduction order is ring order: deterministic, but not the
    order of ``contribs.sum(0)``.

    CUDA tensors launch kernel 6 (float32 or bfloat16), one pass that
    reads each input once and writes each output once; CPU tensors run
    :func:`ring_allreduce_plain` (any dtype)."""
    if op not in _OPS:
        raise ValueError(f"mpi_tpu_torch: unknown ring op {op!r}")
    n = mesh.size
    _check_contribs(contribs, n)
    if contribs.shape[1] % n:
        raise ValueError(
            f"mpi_tpu_torch: ring_allreduce needs axis-0 divisible by ring "
            f"size {n}, got {contribs.shape[1]} (use ring_allreduce_sharded, "
            f"which pads)")
    if mesh_device(mesh, contribs, "ring_allreduce") == "cpu":
        return ring_allreduce_plain(contribs, op)
    return _launch_allreduce(contribs, op)


def ring_allgather(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Ring all-gather of ``x`` ``(n·c, ...)``, split over the n ranks of
    ``mesh`` on axis 0; returns every rank's copy ``(n, n·c, ...)``.

    CUDA tensors launch kernel 5 (2- or 4-byte elements), one pass that
    reads each input once and writes each copy once; CPU tensors run
    :func:`ring_allgather_plain` (any dtype)."""
    n = mesh.size
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"mpi_tpu_torch: ring_allgather splits axis 0 over "
                         f"ring size {n}; got shape {tuple(x.shape)}")
    if mesh_device(mesh, x, "ring_allgather") == "cpu":
        return ring_allgather_plain(x, n)
    return _launch_allgather(x, n)


def ring_allgather_sharded(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Global view: ``x`` split over the ranks on axis 0 → the gathered
    (replicated) result, one ``(n·c, ...)`` copy."""
    return ring_allgather(x, mesh)[0]


def ring_allreduce_sharded(contribs: torch.Tensor, mesh: RankMesh,
                           op: str = "sum") -> torch.Tensor:
    """Global view: ``contribs`` is ``(n, m, ...)``, rank i's contribution
    at index i, and the result is the ``(m, ...)`` reduction, replicated.
    Pads ``m`` to a multiple of the ring size and trims."""
    n = mesh.size
    _check_contribs(contribs, n)
    m = contribs.shape[1]
    pad = (-m) % n
    if pad:
        contribs = torch.cat([contribs, contribs.new_zeros(
            (n, pad, *contribs.shape[2:]))], dim=1)
    out = ring_allreduce(contribs, mesh, op)[0]
    return out[:m] if pad else out


def ring_allreduce_ranks(inputs: Sequence[torch.Tensor], op: str = "sum"
                         ) -> List[torch.Tensor]:
    """The ring all-reduce of ``inputs``, one tensor per rank in rank
    order, all of one shape and dtype on one device; returns one result per
    rank, each its own tensor of the input shape. The fold order is that of
    :func:`ring_allreduce` over the flattened payloads padded with zeros to
    a multiple of the rank count, which is the JAX package's canonical ring
    order (``collectives_generic.ring_combine``).

    CUDA tensors: one launch of kernel 6 on the ranks' own buffers through
    its per-rank pointer table, with no stack; a payload whose size does
    not divide by the rank count is first padded, with a copy. CPU tensors
    run :func:`ring_allreduce_plain` over the padded stack."""
    if op not in _OPS:
        raise ValueError(f"mpi_tpu_torch: unknown ring op {op!r}")
    n = len(inputs)
    if n == 0:
        raise ValueError("mpi_tpu_torch: ring_allreduce_ranks needs one "
                         "tensor per rank; got none")
    first = inputs[0]
    for r, x in enumerate(inputs):
        if (x.shape, x.dtype, x.device) != (first.shape, first.dtype,
                                             first.device):
            raise ValueError(
                f"mpi_tpu_torch: ring_allreduce_ranks: rank {r} holds "
                f"{tuple(x.shape)} {x.dtype} on {x.device}, rank 0 "
                f"{tuple(first.shape)} {first.dtype} on {first.device}")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mpi_tpu_torch: ring_allreduce_ranks runs on cuda "
                         f"(kernel) or cpu (plain); got {first.device}")
    size = first.numel()
    m = -(-size // n)  # elements per chunk; n chunks per rank
    pad = n * m - size
    if first.device.type == "cpu":
        stack = first.new_zeros((n, n * m))
        for r, x in enumerate(inputs):
            stack[r, :size] = x.reshape(-1)
        out = ring_allreduce_plain(stack, op)
        return [out[r, :size].reshape(first.shape).clone() for r in range(n)]
    _check_allreduce_dtype(first.dtype)
    flats = []
    for x in inputs:
        if not x.is_contiguous():
            raise ValueError("mpi_tpu_torch: ring_allreduce_ranks needs "
                             "contiguous tensors")
        flat = x.reshape(-1)
        flats.append(torch.cat([flat, flat.new_zeros(pad)]) if pad else flat)
    outs = [torch.empty(n * m, dtype=first.dtype, device=first.device)
            for _ in range(n)]
    if size:
        table = (ctypes.c_void_p * n)
        _run_allreduce(table(*[f.data_ptr() for f in flats]),
                       table(*[o.data_ptr() for o in outs]), m, first.dtype,
                       op, first.device)
    return [o[:size].view(first.shape) for o in outs]


ring_allreduce.launches = 0
ring_allgather.launches = 0
