"""Static point-to-point exchange between the ranks of a mesh.

Counterpart of ``mpi_tpu/parallel/p2p.py`` (all of it but ``DevicePipe``,
which belongs to the XLA backend). A communication *pattern* is a static
list of ``(src, dst)`` pairs; each rank sends at most once and receives at
most once, and a rank that receives nothing gets zeros (``lax.ppermute``'s
contract). Two levels, as in the JAX module:

1. :func:`exchange`, :func:`tagged_exchange` and :func:`exchange_sharded`:
   the pattern as plain PyTorch indexing, the counterpart of
   ``lax.ppermute`` outside any Pallas kernel.
2. :func:`sendrecv` and :func:`sendrecv_sharded`: the same pattern as ONE
   launch of a hand-written CUDA kernel over all ranks
   (``ops/csrc/sendrecv.cu``, kernel 7), the counterpart of
   ``pallas_sendrecv``'s remote DMA. CPU tensors run
   :func:`sendrecv_plain`, which replays the TPU kernel; CUDA tensors
   launch the kernel (counted in ``sendrecv.launches``) or raise.

Per-rank functions take and return the stacked view ``(n, ...)``, rank r's
block at index r; the ``*_sharded`` functions take the JAX global view
``(n·b, ...)``, split over the ranks on axis 0, and return the same shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import _build
from .mesh import RankMesh, mesh_device, rank_pointers

__all__ = ["exchange", "tagged_exchange", "exchange_sharded", "sendrecv",
           "sendrecv_sharded", "sendrecv_plain", "ring_hop", "ring_shift"]

Pair = Tuple[int, int]


def _check_pattern(perm: Sequence[Pair], n: Optional[int] = None
                   ) -> List[Pair]:
    """Misuse detection before anything runs: each rank sends at most once
    and receives at most once per channel, and (given ``n``) every rank is
    in range."""
    seen_src: Dict[int, int] = {}
    seen_dst: Dict[int, int] = {}
    out: List[Pair] = []
    for s, d in perm:
        s, d = int(s), int(d)
        if n is not None and not (0 <= s < n and 0 <= d < n):
            raise ValueError(
                f"mpi_tpu_torch: p2p pair ({s}, {d}) out of range [0, {n})")
        if s in seen_src:
            raise ValueError(
                f"mpi_tpu_torch: rank {s} sends twice in one channel "
                f"(to {seen_src[s]} and {d}) — use distinct tags "
                f"(mpi.go:122-125 uniqueness contract)")
        if d in seen_dst:
            raise ValueError(
                f"mpi_tpu_torch: rank {d} receives twice in one channel "
                f"(from {seen_dst[d]} and {s}) — use distinct tags "
                f"(mpi.go:153-156 uniqueness contract)")
        seen_src[s] = d
        seen_dst[d] = s
        out.append((s, d))
    return out


def _complete_permutation(perm: Sequence[Pair], n: int) -> List[Pair]:
    """Extend a partial pattern to a permutation of ``range(n)`` by matching
    idle senders to idle receivers in sorted order (the TPU kernel has every
    device run one DMA; the filler lands on ranks that are then zeroed)."""
    srcs = {s for s, _ in perm}
    dsts = {d for _, d in perm}
    idle_src = sorted(set(range(n)) - srcs)
    idle_dst = sorted(set(range(n)) - dsts)
    return list(perm) + list(zip(idle_src, idle_dst))


def _blocks(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """The stacked ``(n, b, ...)`` view of a global ``(n·b, ...)`` tensor."""
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(f"mpi_tpu_torch: {name} splits axis 0 over {n} "
                         f"ranks; got shape {tuple(x.shape)}")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _check_stacked(x: torch.Tensor, n: int, name: str) -> None:
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"mpi_tpu_torch: {name} wants one block per rank, "
                         f"({n}, ...); got shape {tuple(x.shape)}")


# --------------------------------------------------------------------------
# The pattern in plain PyTorch (lax.ppermute's counterpart)
# --------------------------------------------------------------------------

def exchange(x: torch.Tensor, perm: Sequence[Pair]) -> torch.Tensor:
    """One matched Send/Receive set: ``x`` is ``(n, ...)``, rank r's block
    at index r; ``(s, d)`` puts rank s's block on rank d. Ranks that receive
    nothing get zeros."""
    perm = _check_pattern(perm, x.shape[0] if x.dim() else 0)
    out = torch.zeros_like(x)
    if perm:
        src, dst = (torch.tensor(v, device=x.device) for v in zip(*perm))
        out[dst] = x[src]
    return out


def tagged_exchange(values: Dict[int, torch.Tensor],
                    sends: Dict[int, Sequence[Pair]]
                    ) -> Dict[int, torch.Tensor]:
    """Concurrent tagged channels: ``sends[tag]`` is channel ``tag``'s
    pattern and ``values[tag]`` its stacked ``(n, ...)`` payload. Returns
    ``{tag: received}``; payloads on different tags never mix."""
    if set(values) != set(sends):
        raise ValueError(
            f"mpi_tpu_torch: tagged_exchange values/sends tag mismatch: "
            f"{sorted(values)} vs {sorted(sends)}")
    return {tag: exchange(values[tag], sends[tag]) for tag in sorted(sends)}


def exchange_sharded(x: torch.Tensor, mesh: RankMesh,
                     perm: Sequence[Pair]) -> torch.Tensor:
    """Global view of :func:`exchange`: ``x`` ``(n·b, ...)``, one block per
    rank of ``mesh`` → the permuted global tensor."""
    blocks = _blocks(x, mesh.size, "exchange_sharded")
    mesh_device(mesh, x, "exchange_sharded")
    return exchange(blocks, perm).reshape(x.shape)


# --------------------------------------------------------------------------
# Kernel 7 and its plain version
# --------------------------------------------------------------------------

def sendrecv_plain(x: torch.Tensor, perm: Sequence[Pair]) -> torch.Tensor:
    """The TPU kernel replayed: every pair of the completed permutation
    moves its block, then ranks outside the real pattern are zeroed."""
    n = x.shape[0]
    perm = _check_pattern(perm, n)
    out = torch.empty_like(x)
    for s, d in _complete_permutation(perm, n):
        out[d] = x[s]
    real = {d for _, d in perm}
    for d in range(n):
        if d not in real:
            out[d] = 0
    return out


@functools.cache
def _kernel_lib():
    """The built library, with the C signatures declared once."""
    lib = _build.load("sendrecv")
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.sendrecv.argtypes = [ptrs, ptrs, ctypes.POINTER(ctypes.c_int),
                             ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p]
    lib.sendrecv.restype = ctypes.c_int
    lib.sendrecv_max_ranks.argtypes = []
    lib.sendrecv_max_ranks.restype = ctypes.c_int
    lib.sendrecv_error_string.argtypes = [ctypes.c_int]
    lib.sendrecv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, perm: List[Pair]) -> torch.Tensor:
    if x.element_size() not in (2, 4):
        raise TypeError(f"mpi_tpu_torch: the send/receive kernel takes 2- or "
                        f"4-byte elements; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("mpi_tpu_torch: sendrecv needs a contiguous tensor")
    lib = _kernel_lib()
    n = x.shape[0]
    if n > lib.sendrecv_max_ranks():
        raise ValueError(f"mpi_tpu_torch: sendrecv takes at most "
                         f"{lib.sendrecv_max_ranks()} ranks; got {n}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    src = [-1] * n
    for s, d in perm:
        src[d] = s
    with torch.cuda.device(x.device):
        err = lib.sendrecv(rank_pointers(x), rank_pointers(out),
                           (ctypes.c_int * n)(*src), n, x[0].numel(),
                           x.element_size(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"mpi_tpu_torch: sendrecv kernel launch failed: "
            f"{lib.sendrecv_error_string(err).decode()} (cudaError {err})")
    sendrecv.launches += 1
    return out


def sendrecv(x: torch.Tensor, mesh: RankMesh, perm: Sequence[Pair]
             ) -> torch.Tensor:
    """The static pattern ``perm`` as one kernel launch over the ranks of
    ``mesh`` (counterpart of ``pallas_sendrecv``). ``x`` is ``(n, ...)``,
    rank r's block at index r; semantics match :func:`exchange`
    (non-receivers get zeros).

    CUDA tensors launch kernel 7 (2- or 4-byte elements); CPU tensors run
    :func:`sendrecv_plain` (any dtype)."""
    n = mesh.size
    _check_stacked(x, n, "sendrecv")
    perm = _check_pattern(perm, n)
    if mesh_device(mesh, x, "sendrecv") == "cpu":
        return sendrecv_plain(x, perm)
    return _launch(x, perm)


def sendrecv_sharded(x: torch.Tensor, mesh: RankMesh, perm: Sequence[Pair]
                     ) -> torch.Tensor:
    """Global view of :func:`sendrecv`: ``x`` ``(n·b, ...)``, one block per
    rank of ``mesh`` → the permuted global tensor (counterpart of
    ``pallas_sendrecv_sharded``)."""
    blocks = _blocks(x, mesh.size, "sendrecv_sharded")
    return sendrecv(blocks, mesh, perm).reshape(x.shape)


sendrecv.launches = 0


def ring_hop(x: torch.Tensor, mesh: RankMesh, shift: int = 1) -> torch.Tensor:
    """Rank r's block of ``x`` ``(n, ...)`` to rank (r + shift) mod n: one
    kernel-7 launch (the block made contiguous first)."""
    n = mesh.size
    return sendrecv(x.contiguous(), mesh,
                    [(r, (r + shift) % n) for r in range(n)])


class _RingShift(torch.autograd.Function):
    """The hop with a gradient: its backward is the reverse hop."""

    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return ring_hop(x, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_hop(g, ctx.mesh, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, mesh: RankMesh, shift: int = 1
               ) -> torch.Tensor:
    """:func:`ring_hop` by ``shift`` ranks, differentiable: the ring
    attention fold's and the pipeline's hop (``lax.ppermute`` ``i → i+1 mod
    n`` in the JAX package) and the linear scan's (``pshift`` by ``d``),
    one kernel-7 launch forward and one backward, the reverse hop."""
    return _RingShift.apply(x, mesh, shift)
