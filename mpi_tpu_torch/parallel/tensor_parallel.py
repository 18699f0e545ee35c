"""Megatron's tensor-parallel operators over the ``tp`` axis of a rank mesh.

The JAX package has no module of this name. There :func:`param_specs`
(``mpi_tpu/models/transformer.py:176-205``) lays the tree out
Megatron-style (q, k, v and w1 split by columns over ``tp``, wo and w2 by
rows, the embedding by vocab rows) and GSPMD inserts the reductions that
layout implies. The port runs them itself, and this module holds them,
each over the tp ring of a :class:`RankMesh`
(:func:`~mpi_tpu_torch.parallel.mesh.axis_ring`) on kernel 6
(:func:`~mpi_tpu_torch.ops.ring_collectives.ring_allreduce`):

* :func:`tp_reduce` (Megatron's "g"): the forward all-reduces the ranks'
  partials ``(tp, ...)``; the backward hands the upstream gradient to each
  rank's partial, with no communication.
* :func:`tp_copy` (Megatron's "f"): the forward gives each tp rank its
  input, ``(tp, ...)``; the backward all-reduces the ranks' input-gradient
  partials.
* :func:`vocab_parallel_embed` and :func:`vocab_parallel_xent`: the lookup
  of a vocab-sharded table and the cross-entropy of vocab-parallel logits
  ``(tp, b, s, V/tp)``: the row max over kernel 6 with ``op="max"``, then
  Σexp(l − m) and the target logit (zero off its owner) summed in one
  launch. The ``(b, s, V)`` logits are never gathered.

:func:`tp_copy` and :func:`tp_reduce` take any ring: the Mixture-of-Experts
FFN runs them over one ring of the ``ep`` and ``tp`` axes (``tp_ring(mesh,
("ep", "tp"))``, ep·tp ranks), each rank its experts' slice of their d_ff
(:mod:`..models.moe`).

The ranks share one device. Kernel 6 writes every rank's copy of a
reduction, and every copy holds the same bits (one fold order); a
tp-replicated activation is held once, so the operators read copy 0, as
the FSDP gather reads its own rank's copy of kernel 5's output. bf16
partials are reduced in :data:`REDUCE_DTYPE` (float32): one rounding to
bf16 after the sum, nearer the single-device product's float32
accumulation than a bf16 ring's rounding at each hop, at twice the bytes.

Without a tp axis (``ring`` None) :func:`tp_copy` adds a tp dimension of
1, :func:`tp_reduce` takes it away and no kernel runs.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.ring_collectives import ring_allreduce
from .mesh import RankMesh, axis_ring

__all__ = ["REDUCE_DTYPE", "tp_ring", "tp_size", "tp_copy", "tp_reduce",
           "vocab_parallel_embed", "vocab_parallel_xent"]

# The dtype kernel 6 reduces bf16 partials in (float32 partials stay so).
REDUCE_DTYPE = torch.float32


def tp_ring(mesh: Optional[RankMesh],
            axis: Union[str, Tuple[str, ...]] = "tp"
            ) -> Optional[RankMesh]:
    """The ring of ``mesh``'s ``axis`` (at coordinate 0 of the other axes),
    or None where the mesh has no such axis above 1. A tuple of axes (the
    experts' ``("ep", "tp")``) gives one ring over those of them that are
    above 1 (:func:`~mpi_tpu_torch.parallel.mesh.axis_ring`)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    live = tuple(a for a in axes
                 if mesh is not None and mesh.shape.get(a, 1) > 1)
    if not live:
        return None
    return axis_ring(mesh, live[0] if len(live) == 1 else live)


def tp_size(ring: Optional[RankMesh]) -> int:
    """The number of tp ranks on ``ring`` (1 for None)."""
    return 1 if ring is None else ring.size


def _allreduce(partials: torch.Tensor, ring: RankMesh,
               op: str = "sum") -> torch.Tensor:
    """Copy 0 of kernel 6's all-reduce of ``partials`` ``(tp, ...)`` over
    ``ring``, of shape ``partials.shape[1:]`` and dtype: flattened, bf16
    cast to :data:`REDUCE_DTYPE`, padded with zeros to a multiple of tp."""
    n = ring.size
    flat = partials.reshape(n, -1)
    if flat.dtype == torch.bfloat16:
        flat = flat.to(REDUCE_DTYPE)
    m = flat.shape[1]
    if m % n:
        flat = F.pad(flat, (0, -m % n))
    out = ring_allreduce(flat.contiguous(), ring, op)[0]
    return out[:m].view(partials.shape[1:]).to(partials.dtype)


class _Reduce(torch.autograd.Function):
    """Megatron's "g" over ``ring``: see :func:`tp_reduce`."""

    @staticmethod
    def forward(ctx, partials, ring):
        ctx.n = ring.size
        return _allreduce(partials, ring)

    @staticmethod
    def backward(ctx, grad):
        return grad.expand(ctx.n, *grad.shape), None


class _Copy(torch.autograd.Function):
    """Megatron's "f" over ``ring``: see :func:`tp_copy`."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return x.expand(ring.size, *x.shape)

    @staticmethod
    def backward(ctx, grads):
        return _allreduce(grads, ctx.ring), None


def tp_reduce(partials: torch.Tensor,
              ring: Optional[RankMesh]) -> torch.Tensor:
    """The sum over the tp ranks of their partials ``(tp, ...)``, one
    kernel-6 launch (its plain version on the CPU); the backward gives
    every rank's partial the upstream gradient."""
    if ring is None:
        return partials[0]
    return _Reduce.apply(partials, ring)


def tp_copy(x: torch.Tensor, ring: Optional[RankMesh]) -> torch.Tensor:
    """``x`` for each tp rank, ``(tp, ...)`` (one tensor, expanded); the
    backward sums the ranks' gradient partials in one kernel-6 launch."""
    if ring is None:
        return x.unsqueeze(0)
    return _Copy.apply(x, ring)


def _owned(ids: torch.Tensor, n: int, rows: int):
    """Each tp rank's local index of ``ids`` in its range of ``rows``
    vocab rows, ``(n, ...)`` clamped into the range, and whether the rank
    owns the id."""
    local = ids.long()[None] - rows * torch.arange(
        n, device=ids.device).view(n, *([1] * ids.dim()))
    mine = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), mine


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         ring: Optional[RankMesh]) -> torch.Tensor:
    """The rows of ``table`` ``(V, d)`` at ``tokens`` ``(b, s)``, vocab
    split over the tp ranks: rank r looks up the tokens in its range
    ``[r·V/tp, (r+1)·V/tp)``, writes zeros for the others, and
    :func:`tp_reduce` sums the partials (one rank is nonzero per token, so
    the sum is exact)."""
    if ring is None:
        return table[tokens.long()]
    n = ring.size
    part = table.unflatten(0, (n, -1))
    local, mine = _owned(tokens, n, part.shape[1])
    ranks = torch.arange(n, device=tokens.device).view(n, 1, 1)
    rows = torch.where(mine[..., None], part[ranks, local], 0.0)
    return tp_reduce(rows, ring)


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        ring: RankMesh) -> torch.Tensor:
    """Mean next-token cross-entropy of vocab-parallel ``logits`` ``(tp,
    b, s, V/tp)`` (rank r's vocab range at index r) against ``targets``
    ``(b, s)``, in float32: ``log Σexp(l − m) + m − l_target`` with m the
    row max over every rank (kernel 6, ``op="max"``, no gradient: the
    result does not depend on it), then Σexp(l − m) and the target logit
    (zero off its owner) summed over the ranks in one kernel-6 launch."""
    n = ring.size
    l32 = logits.float()
    with torch.no_grad():
        m = _allreduce(l32.amax(-1), ring, "max")
    local, mine = _owned(targets, n, l32.shape[-1])
    tgt = torch.gather(l32, -1, local[..., None])[..., 0]
    parts = torch.stack([torch.exp(l32 - m[..., None]).sum(-1),
                         torch.where(mine, tgt, 0.0)], dim=1)
    sumexp, target = tp_reduce(parts, ring).unbind(0)
    return (torch.log(sumexp) + m - target).mean()
