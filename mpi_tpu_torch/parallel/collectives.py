"""Collectives over the ranks of a mesh, on the stacked view.

Counterpart of ``mpi_tpu/parallel/collectives.py``. There each function
runs inside ``shard_map`` on one rank's block and lowers to an XLA
collective. Here a function takes the stacked view ``(n, ...)`` over a
:class:`~mpi_tpu_torch.parallel.mesh.RankMesh`, rank r's block at index r,
as ``ops/ring_collectives.py`` and ``parallel/p2p.py`` do, and returns what
each rank holds, stacked the same way.

Two reduction flavours, as in the JAX module:

* **fast** (default): ``sum(0)``, ``amax(0)`` and ``amin(0)`` for psum,
  pmax and pmin, and the rank-order product for all_gather + prod;
* **deterministic**: :func:`tree_allreduce`, the canonical binomial tree of
  ``collectives_generic.tree_combine``, or :func:`ring_allreduce`, the
  canonical ring, for ``ring_eligible`` payloads: bitwise the JAX
  package's orders.

Routing on CUDA tensors: :func:`ring_allreduce` and
:func:`ring_reduce_scatter` launch kernel 6, :func:`allgather` kernel 5 and
:func:`pshift` kernel 7. The JAX functions lower to XLA collectives there,
not to Pallas; the port's kernels compute the same function bit for bit.
On CPU tensors each function runs its plain version. The rest is plain
PyTorch on the tensor's device.

A result replicated over the ranks (the fast and tree all-reduces,
:func:`bcast`, :func:`hierarchical_allreduce`) is a broadcast view of one
tensor (``expand``): read it, or clone it before writing. The kernel
routes give every rank its own copy, as the kernels write them.
"""

from __future__ import annotations

from typing import List

import torch

from ..collectives_generic import combine, ring_eligible, tree_combine
from ..ops.ring_collectives import ring_allgather
from ..ops.ring_collectives import ring_allreduce as _ring_allreduce
from .mesh import RankMesh, mesh_device
from .p2p import sendrecv

__all__ = ["OPS", "allreduce", "tree_allreduce", "ring_allreduce",
           "ring_reduce_scatter", "hierarchical_allreduce",
           "reduce_scatter", "allgather", "bcast", "alltoall",
           "prefix_reduce", "pshift"]

OPS = ("sum", "prod", "min", "max")


def _check_op(op: str) -> None:
    """Named ops only, a ValueError otherwise, as in the JAX module; the
    elementwise ops are ``collectives_generic.combine``'s."""
    if op not in OPS:
        raise ValueError(
            f"mpi_tpu_torch: unknown reduction op {op!r}; expected {OPS}")


def _stacked(x: torch.Tensor, mesh: RankMesh, name: str) -> int:
    """The rank count, after checking that ``x`` is ``(n, ...)`` on the
    mesh's device."""
    n = mesh.size
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"mpi_tpu_torch: {name} wants one block per rank, "
                         f"({n}, ...); got shape {tuple(x.shape)}")
    mesh_device(mesh, x, name)
    return n


def _fold(x: torch.Tensor, dim: int, op: str) -> torch.Tensor:
    """``x`` reduced over ``dim`` with the fast collective's op: psum,
    pmax, pmin, or the product in index order."""
    _check_op(op)
    if op == "sum":
        return x.sum(dim)
    if op == "max":
        return x.amax(dim)
    if op == "min":
        return x.amin(dim)
    return _rank_fold(x.movedim(dim, 0), op)


def _rank_fold(x: torch.Tensor, op: str) -> torch.Tensor:
    """Left fold of ``x``'s blocks over axis 0, in index order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = combine(acc, x[i], op)
    return acc


def _replicated(total: torch.Tensor, n: int) -> torch.Tensor:
    return total.unsqueeze(0).expand(n, *total.shape)


def allreduce(x: torch.Tensor, mesh: RankMesh, op: str = "sum",
              deterministic: bool = False) -> torch.Tensor:
    """Combine the ranks' blocks of ``x`` ``(n, ...)``; every rank gets the
    result. Fast: the reduction over axis 0 (the product in rank order).
    ``deterministic=True``: :func:`ring_allreduce` where ``ring_eligible``
    says so, else :func:`tree_allreduce`, for the canonical bits."""
    _check_op(op)
    n = _stacked(x, mesh, "allreduce")
    if deterministic:
        if ring_eligible(x[0].numel() * x.element_size(), x.dtype, n, op):
            return ring_allreduce(x, mesh, op)
        return tree_allreduce(x, mesh, op)
    return _replicated(_fold(x, 0, op), n)


def tree_allreduce(x: torch.Tensor, mesh: RankMesh, op: str = "sum"
                   ) -> torch.Tensor:
    """All-reduce in the canonical binomial-tree order (``r + d`` folded
    into ``r``, the lower rank's partial on the left), the order the JAX
    function's ppermute rounds replay; n − 1 elementwise ops."""
    _check_op(op)
    n = _stacked(x, mesh, "tree_allreduce")
    return _replicated(tree_combine(list(x.unbind(0)), op), n)


def ring_allreduce(x: torch.Tensor, mesh: RankMesh, op: str = "sum"
                   ) -> torch.Tensor:
    """Ring all-reduce in the canonical ring order: each rank's flattened
    block is padded with zeros to n equal chunks, and chunk b folds ranks b,
    b+1, ... left to right. Kernel 6 on CUDA (float32 or bf16), its plain
    version on the CPU."""
    _check_op(op)
    n = _stacked(x, mesh, "ring_allreduce")
    if n == 1:
        return x
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    pad = (-size) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    out = _ring_allreduce(flat.contiguous(), mesh, op)
    return out[:, :size].reshape(x.shape)


def ring_reduce_scatter(x: torch.Tensor, mesh: RankMesh, op: str = "sum"
                        ) -> torch.Tensor:
    """The ring's reduce-scatter: rank r gets block r of the reduction of
    the ranks' blocks, split on their leading axis (which must divide by
    n), in the canonical ring order. Kernel 6 folds every chunk in that
    order; rank r keeps its chunk."""
    _check_op(op)
    n = _stacked(x, mesh, "ring_reduce_scatter")
    if x.dim() < 2 or x.shape[1] % n:
        raise ValueError(
            f"mpi_tpu_torch: ring_reduce_scatter leading axis "
            f"{tuple(x.shape[1:])} must divide into {n} equal blocks")
    if n == 1:
        return x
    out = _ring_allreduce(x.reshape(n, -1).contiguous(), mesh, op)
    ranks = torch.arange(n, device=x.device)
    mine = out.reshape(n, n, -1)[ranks, ranks]
    return mine.reshape(n, x.shape[1] // n, *x.shape[2:])


def hierarchical_allreduce(x: torch.Tensor, mesh: RankMesh, op: str = "sum",
                           inner_axis: str = "inner",
                           outer_axis: str = "outer") -> torch.Tensor:
    """Two-level all-reduce over a 2-D mesh (:func:`~mpi_tpu_torch.
    parallel.mesh.make_mesh_2d`): reduce over ``inner_axis``, then over
    ``outer_axis``, as the JAX function's reduce-scatter / psum / all-gather
    (or composed per-axis all-reduces) does. ``x`` is ``(n, ...)`` in the
    mesh's row-major rank order."""
    _check_op(op)
    n = _stacked(x, mesh, "hierarchical_allreduce")
    axes = mesh.axis_names
    grid = x.reshape(*(mesh.shape[a] for a in axes), *x.shape[1:])
    inner = _fold(grid, axes.index(inner_axis), op)
    outer_dim = axes.index(outer_axis)
    if outer_dim > axes.index(inner_axis):
        outer_dim -= 1
    return _replicated(_fold(inner, outer_dim, op), n)


def reduce_scatter(x: torch.Tensor, mesh: RankMesh, op: str = "sum",
                   scatter_dimension: int = 0, tiled: bool = True,
                   deterministic: bool = False) -> torch.Tensor:
    """Reduce the ranks' blocks and leave rank r with block r of the
    result along ``scatter_dimension`` (of the per-rank shape).

    Fast: ``sum(0)`` (psum_scatter; ``tiled=False`` drops a scatter
    dimension of size n), other ops folded in rank order.
    ``deterministic=True`` gives the canonical order on dimension 0, tiled:
    :func:`ring_reduce_scatter` above the ``ring_eligible`` threshold, the
    tree all-reduce then rank r's slice below it."""
    _check_op(op)
    n = _stacked(x, mesh, "reduce_scatter")
    if deterministic:
        if scatter_dimension != 0 or not tiled:
            raise ValueError(
                "mpi_tpu_torch: deterministic reduce_scatter supports "
                "scatter_dimension=0, tiled=True (the driver contract)")
        if ring_eligible(x[0].numel() * x.element_size(), x.dtype, n, op):
            return ring_reduce_scatter(x, mesh, op)
        total = tree_combine(list(x.unbind(0)), op)
        shard = x.shape[1] // n
        return total[:n * shard].reshape(n, shard, *x.shape[2:])
    total = x.sum(0) if op == "sum" else _rank_fold(x, op)
    if op == "sum" and not tiled:
        return total.movedim(scatter_dimension, 0)
    shard = total.shape[scatter_dimension] // n
    blocks = total.narrow(scatter_dimension, 0, n * shard).unflatten(
        scatter_dimension, (n, shard))
    return blocks.movedim(scatter_dimension, 0)


def allgather(x: torch.Tensor, mesh: RankMesh, axis: int = 0,
              tiled: bool = False) -> torch.Tensor:
    """Every rank receives every rank's block in rank order: a new axis of
    size n at ``axis`` of the per-rank shape, or (``tiled``) the blocks
    concatenated along ``axis``. Kernel 5 on CUDA (2- or 4-byte elements),
    its plain version on the CPU."""
    n = _stacked(x, mesh, "allgather")
    shape = tuple(x.shape[1:])
    gathered = ring_allgather(x.reshape(-1), mesh).reshape(n, n, *shape)
    out = gathered.movedim(1, axis + 1)
    if tiled:
        out = out.flatten(axis + 1, axis + 2)
    return out


def bcast(x: torch.Tensor, mesh: RankMesh, root: int = 0) -> torch.Tensor:
    """Every rank receives rank ``root``'s block."""
    n = _stacked(x, mesh, "bcast")
    if not 0 <= root < n:
        raise ValueError(f"mpi_tpu_torch: bcast root {root} out of range "
                         f"[0, {n})")
    return _replicated(x[root], n)


def alltoall(x: torch.Tensor, mesh: RankMesh, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Personalized all-to-all: each rank's block splits along
    ``split_axis`` into n chunks, chunk j goes to rank j, and what arrives
    is concatenated along ``concat_axis`` in rank order (JAX's tiled
    ``all_to_all``)."""
    n = _stacked(x, mesh, "alltoall")
    if x.shape[split_axis + 1] % n:
        raise ValueError(
            f"mpi_tpu_torch: alltoall split axis {split_axis} of "
            f"{tuple(x.shape[1:])} must divide into {n} chunks")
    chunks = x.unflatten(split_axis + 1, (n, x.shape[split_axis + 1] // n))
    # (dst, src, ...): rank dst's chunks from every src, in src order.
    received = chunks.movedim(split_axis + 1, 0)
    return received.movedim(1, concat_axis + 1).flatten(concat_axis + 1,
                                                        concat_axis + 2)


def prefix_reduce(x: torch.Tensor, mesh: RankMesh, op: str = "sum",
                  exclusive: bool = False) -> torch.Tensor:
    """Prefix reduction over the ranks in rank order (MPI_Scan/Exscan):
    rank r gets ranks 0..r combined, or 0..r−1 with ``exclusive`` (rank 0
    then gets the op's identity). The left fold is the JAX function's
    ``lax.scan`` order."""
    _check_op(op)
    _stacked(x, mesh, "prefix_reduce")
    prefix: List[torch.Tensor] = [x[0]]
    for i in range(1, x.shape[0]):
        prefix.append(combine(prefix[-1], x[i], op))
    if not exclusive:
        return torch.stack(prefix)
    return torch.stack([_identity(x[0], op), *prefix[:-1]])


def _identity(like: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return torch.zeros_like(like)
    if op == "prod":
        return torch.ones_like(like)
    if like.is_floating_point():
        value = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(like.dtype)
        value = info.max if op == "min" else info.min
    return torch.full_like(like, value)


def pshift(x: torch.Tensor, mesh: RankMesh, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank r's block goes to rank (r + shift) mod n, which
    receives it from (r − shift) mod n. Kernel 7 on CUDA (2- or 4-byte
    elements), its plain version on the CPU."""
    n = _stacked(x, mesh, "pshift")
    return sendrecv(x, mesh, [(r, (r + shift) % n) for r in range(n)])

