"""Ulysses sequence parallelism: an all-to-all from sequence shards to
head shards and back.

Counterpart of ``mpi_tpu/parallel/ulysses.py``. Instead of rotating k/v
around the ring (:mod:`.ring_attention`), one all-to-all re-shards q/k/v
from sequence-sharded ``(b, s/n, h, d)`` to head-sharded ``(b, s, h/n,
d)``, each rank runs ordinary attention over the whole sequence for its
heads, and a second all-to-all restores the sequence sharding
(DeepSpeed-Ulysses). It needs ``heads % sp == 0``.

The per-rank function takes the stacked view ``(n, b, s_local, h, d)``
over a :class:`RankMesh` of ``n`` ranks, as the port's collectives do.
The all-to-all is :func:`~mpi_tpu_torch.parallel.collectives.alltoall`,
plain PyTorch (no TPU kernel exists for it) and differentiable by
autograd. The ranks share one device, so their head groups are the batch
of one attention call: ``flash`` launches kernel 1 once (kernels 2 and 3
once each in the backward) over all ranks.
"""

from __future__ import annotations

import torch

from ..ops.attention import blockwise_attention, flash_attention
from .mesh import RankMesh, shared_ring

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: RankMesh, causal: bool = True,
                      block_k: int = 128,
                      kernel_impl: str = "blockwise") -> torch.Tensor:
    """Stacked shards ``(n, b, s_local, h, d)`` over the ranks of ``mesh``
    (k and v with the same head count as q) → the same shape.

    ``kernel_impl`` is the attention run on the resharded full-sequence
    head groups: ``"blockwise"`` (:func:`blockwise_attention`, plain
    PyTorch) or ``"flash"`` (:func:`flash_attention`, kernels 1-3 on CUDA
    tensors)."""
    if kernel_impl == "flash":
        def attend(q_, k_, v_):
            return flash_attention(q_, k_, v_, causal)
    elif kernel_impl == "blockwise":
        def attend(q_, k_, v_):
            return blockwise_attention(q_, k_, v_, causal=causal,
                                       block_k=block_k)
    else:
        raise ValueError(
            f"mpi_tpu_torch: unknown ulysses kernel_impl {kernel_impl!r}: "
            f"expected blockwise|flash")
    n = mesh.size
    if q.dim() != 5 or q.shape[0] != n:
        raise ValueError(f"mpi_tpu_torch: ulysses wants stacked shards "
                         f"(n, b, s, h, d) over {n} ranks; got "
                         f"{tuple(q.shape)}")
    h = q.shape[3]
    if h % n:
        raise ValueError(
            f"mpi_tpu_torch: ulysses needs heads ({h}) divisible by the sp "
            f"axis size ({n}); use ring attention otherwise")

    # Imported here: collectives imports ops.ring_collectives, which
    # imports this package's mesh while the ops package initialises.
    from .collectives import alltoall

    def to_heads(x):  # (n, b, s/n, h, d) -> (n·b, s, h/n, d)
        x = alltoall(x, mesh, split_axis=2, concat_axis=1)
        return x.reshape(-1, *x.shape[2:]).contiguous()

    ctx = attend(to_heads(q), to_heads(k), to_heads(v))
    ctx = ctx.reshape(n, -1, *ctx.shape[1:])
    # (n, b, s, h/n, d) -> (n, b, s/n, h, d)
    return alltoall(ctx, mesh, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh: RankMesh,
                              axis_name: str = "sp", causal: bool = True,
                              kernel_impl: str = "blockwise") -> torch.Tensor:
    """Global ``(b, s, h, d)`` tensors in and out, Ulysses over the
    ``axis_name`` ranks of ``mesh``. As in
    :func:`~.ring_attention.ring_attention_sharded`, the ``dp`` ranks are
    the batch of the same calls, so the JAX function's ``batch_axis`` /
    ``head_axis`` have no counterpart."""
    ring = shared_ring(mesh, axis_name, q, "ulysses")
    n = ring.size
    b, s = q.shape[:2]
    if s % n:
        raise ValueError(f"mpi_tpu_torch: sequence {s} does not split over "
                         f"{n} ranks")

    def to_ranks(x):
        return x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1)

    out = ulysses_attention(*(to_ranks(x) for x in (q, k, v)), ring,
                            causal=causal, kernel_impl=kernel_impl)
    return out.transpose(0, 1).reshape(q.shape)
