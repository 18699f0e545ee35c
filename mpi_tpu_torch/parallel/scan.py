"""First-order linear scan, on one device and sequence-parallel over a
rank mesh: the state-space LM's recurrence (the SSM twin of ring
attention).

Counterpart of ``mpi_tpu/parallel/scan.py``. ``x_t = a_t·x_{t−1} + b_t``
with ``x_{−1} = 0``, in float32 or complex64, over the monoid

    (a2, b2) ∘ (a1, b1) = (a2·a1, a2·b1 + b2)

whose left operand is the EARLIER segment. The JAX package runs it with
``lax.associative_scan``; here :func:`linear_scan` is a Hillis-Steele
doubling scan in plain PyTorch: ⌈log2 s⌉ rounds of out-of-place
elementwise products, each position combined with the one ``d`` before it
(``d = 1, 2, 4, …``). The tree differs from XLA's, so the last bits do.

:func:`sharded_linear_scan` takes the stacked per-rank chunks ``(n, …)`` of
a sequence split over a mesh axis, rank r's chunk at index r (the layout
of :func:`~.ring_attention.ring_attention`), and runs JAX's three phases:

1. a local scan of every chunk (one :func:`linear_scan` over the stack),
   keeping the prefix products;
2. a Hillis-Steele inclusive scan of the chunk summaries across the ranks:
   ⌈log2 n⌉ rounds of two hops each (the a-summary and the b-summary, rank
   r to rank r + d), then one hop by one rank for the exclusive carry;
3. one elementwise fold, ``prods·carry_in + xs``, on ranks 1 … n−1 (rank
   0's carry is the identity, so its chunk is the local scan's, bit for
   bit).

Every hop is one launch of the send/receive kernel (kernel 7,
``ops/csrc/sendrecv.cu``) over the ranks on the card, through
:func:`~.p2p.ring_shift`, whose backward is the reverse hop: the sharded
scan is differentiable as JAX's is. Kernel 7 moves 2- and 4-byte
elements, so complex64 summaries hop as their ``torch.view_as_real``
float32 views. That is ``2·⌈log2 n⌉ + 1`` launches a scan, and none at
``n = 1``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .mesh import RankMesh, shared_ring
from .p2p import ring_shift

__all__ = ["linear_scan", "sharded_linear_scan"]


def _combine(left: Tuple[torch.Tensor, torch.Tensor],
             right: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``right ∘ left``: ``left`` the earlier segment."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _scan(a: torch.Tensor, b: torch.Tensor, dim: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along ``dim`` keeping both monoid components:
    ``(prods, xs)``, the prefix products of ``a`` and the scan itself."""
    if a.shape != b.shape:
        a = a.expand(b.shape)
    s = b.shape[dim]
    d = 1
    while d < s:
        head = (a.narrow(dim, 0, d), b.narrow(dim, 0, d))
        prev = (a.narrow(dim, 0, s - d), b.narrow(dim, 0, s - d))
        cur = (a.narrow(dim, d, s - d), b.narrow(dim, d, s - d))
        new_a, new_b = _combine(prev, cur)
        a = torch.cat([head[0], new_a], dim)
        b = torch.cat([head[1], new_b], dim)
        d *= 2
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """Single-device inclusive scan of ``x_t = a_t·x_{t−1} + b_t`` along
    ``dim`` (``x_{−1} = 0``); ``a`` may broadcast to ``b``'s shape. Returns
    ``x``, of ``b``'s shape."""
    return _scan(a, b, dim)[1]


def _hop(x: torch.Tensor, ring: RankMesh, shift: int) -> torch.Tensor:
    """Rank r's block of the stacked ``x`` to rank r + shift (mod n): one
    kernel-7 launch, complex values as their float32 pairs."""
    if x.is_complex():
        return torch.view_as_complex(
            ring_shift(torch.view_as_real(x), ring, shift))
    return ring_shift(x, ring, shift)


def sharded_linear_scan(a: torch.Tensor, b: torch.Tensor, mesh: RankMesh,
                        axis_name: str = "sp", dim: int = 0) -> torch.Tensor:
    """The inclusive scan of a sequence split over the ``axis_name`` ranks
    of ``mesh``. ``a`` and ``b`` are the stacked chunks ``(n, …)``, rank
    r's positions ``[r·s_local, (r+1)·s_local)`` at index r; ``dim`` is the
    sequence dimension of one chunk (JAX's ``axis`` inside ``shard_map``),
    so ``dim + 1`` of the stack. Returns every rank's chunk of the GLOBAL
    scan, stacked as the input. The ranks share one device (CUDA: kernel 7
    for every hop; CPU: its plain version); a mesh over several devices
    raises ``NotImplementedError``."""
    ring = shared_ring(mesh, axis_name, b, "sharded_linear_scan")
    n = ring.size
    if b.dim() < 2 or b.shape[0] != n:
        raise ValueError(f"mpi_tpu_torch: sharded_linear_scan wants one "
                         f"chunk per {axis_name!r} rank, ({n}, ...); got "
                         f"shape {tuple(b.shape)}")
    chunk_dims = b.dim() - 1
    if not -chunk_dims <= dim < chunk_dims:
        raise ValueError(f"mpi_tpu_torch: dim {dim} out of range for "
                         f"chunks of {chunk_dims} dimensions")
    seq = dim % chunk_dims + 1
    # Phase 1: the local scan of every chunk, both monoid components.
    prods, xs = _scan(a, b, seq)
    if n == 1:
        return xs
    last = xs.shape[seq] - 1
    acc_a, acc_b = prods.select(seq, last), xs.select(seq, last)

    # Phase 2: Hillis-Steele inclusive scan over the ranks, then a shift by
    # one rank for the exclusive carry (the identity into rank 0).
    ranks = torch.arange(n, device=b.device).reshape(
        n, *([1] * (acc_b.dim() - 1)))
    d = 1
    while d < n:
        in_a = _hop(acc_a, ring, d)
        in_b = _hop(acc_b, ring, d)
        take = ranks >= d
        new_a, new_b = _combine((in_a, in_b), (acc_a, acc_b))
        acc_a = torch.where(take, new_a, acc_a)
        acc_b = torch.where(take, new_b, acc_b)
        d *= 2
    carry_in = _hop(acc_b, ring, 1)

    # Phase 3: x_t = P_t·carry_in + x_t on ranks 1 … n−1.
    folded = prods[1:] * carry_in[1:].unsqueeze(seq) + xs[1:]
    return torch.cat([xs[:1], folded])
