"""Halo exchange for block-sharded arrays, and the Jacobi stencil sweeps.

Counterpart of ``mpi_tpu/parallel/halo.py``. The global array is cut into
blocks along one dimension per mesh axis, rank r's block at index r of a
stacked ``(n, ...)`` tensor over every rank of the mesh (row-major over
its axes, as the port's collectives take it). A rank fetches ``width``
boundary slices from its two neighbours along one axis: two patterns of
kernel 7 (:func:`~mpi_tpu_torch.parallel.p2p.sendrecv`), each one launch
over all ranks, where the JAX function runs two ``lax.ppermute`` hops
inside ``shard_map``. Each edge is made contiguous before its launch (an
edge on a block dimension other than the first is strided). Without
``periodic`` the patterns are partial and the outermost ranks receive
zeros, as from ``ppermute``; a non-zero ``fill_value`` is then written
into their halos.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .mesh import RANK_AXIS, RankMesh, _rank_grid
from .p2p import sendrecv

__all__ = ["halo_exchange", "jacobi_step_1d", "jacobi_step_2d"]


def _pattern(mesh: RankMesh, axis_name: str, shift: int,
             periodic: bool) -> Tuple[List[Tuple[int, int]], List[int]]:
    """The pattern that sends each rank's block to the rank ``shift``
    positions on along ``axis_name`` (its other coordinates the same,
    wrapping around with ``periodic``), and the ranks it leaves without a
    block."""
    grid, d = _rank_grid(mesh, axis_name)
    size = mesh.shape[axis_name]
    coord = torch.arange(size).view([-1 if i == d else 1 for i in
                                     range(grid.dim())]).expand_as(grid)
    coord = coord.reshape(-1).tolist()  # rank r's position on the axis
    dst = grid.roll(-shift, d).reshape(-1).tolist()
    if periodic:
        return list(enumerate(dst)), []
    return ([(r, dst[r]) for r, c in enumerate(coord)
             if 0 <= c + shift < size],
            [r for r, c in enumerate(coord) if not 0 <= c - shift < size])


def halo_exchange(x: torch.Tensor, mesh: RankMesh, width: int = 1,
                  dim: int = 0, axis_name: str = RANK_AXIS,
                  periodic: bool = False,
                  fill_value: float = 0.0) -> torch.Tensor:
    """Pad every rank's block with its neighbours' boundary slices.

    ``x`` is the stacked ``(n, ...)`` blocks of a global array sharded on
    block dimension ``dim`` over ``axis_name``; returns the blocks extended
    along ``dim`` to ``shape[dim] + 2·width``: ``width`` slices from the
    minus neighbour, the block, ``width`` from the plus neighbour.
    ``periodic`` wraps the ends; otherwise the outermost ranks get
    ``fill_value`` halos. Raises ``ValueError`` for a width under 1 or a
    block thinner than it."""
    if width < 1:
        raise ValueError(f"mpi_tpu_torch: halo width must be >= 1, got "
                         f"{width}")
    axis = dim + 1  # the stacked rank axis comes first
    extent = x.shape[axis]
    if extent < width:
        raise ValueError(
            f"mpi_tpu_torch: block extent {extent} on dim {dim} is smaller "
            f"than halo width {width}")
    fwd, first = _pattern(mesh, axis_name, 1, periodic)
    bwd, last = _pattern(mesh, axis_name, -1, periodic)
    # My high edge feeds the plus neighbour's low halo, my low edge the
    # minus neighbour's high halo.
    from_minus = sendrecv(x.narrow(axis, extent - width, width).contiguous(),
                          mesh, fwd)
    from_plus = sendrecv(x.narrow(axis, 0, width).contiguous(), mesh, bwd)
    if not periodic and fill_value != 0.0:
        from_minus[first] = fill_value
        from_plus[last] = fill_value
    return torch.cat([from_minus, x, from_plus], dim=axis)


def jacobi_step_1d(u: torch.Tensor, mesh: RankMesh,
                   axis_name: str = RANK_AXIS, periodic: bool = False,
                   boundary: Optional[float] = 0.0) -> torch.Tensor:
    """One 3-point Jacobi sweep ``u[i] <- (u[i-1] + u[i+1]) / 2`` over the
    stacked ``(n, b)`` blocks of a sharded line, the halos supplying the
    neighbours across ranks. ``boundary`` is the fixed Dirichlet value
    outside a non-periodic domain."""
    padded = halo_exchange(u, mesh, width=1, axis_name=axis_name,
                           periodic=periodic,
                           fill_value=0.0 if boundary is None else boundary)
    return (padded[:, :-2] + padded[:, 2:]) * 0.5


def jacobi_step_2d(u: torch.Tensor, mesh: RankMesh, row_axis: str = "row",
                   col_axis: str = "col", periodic: bool = False,
                   boundary: float = 0.0) -> torch.Tensor:
    """One 5-point Jacobi sweep ``u[i,j] <- (N + S + W + E) / 4`` over the
    stacked ``(n, bi, bj)`` blocks of a grid sharded over ``row_axis`` and
    ``col_axis``, each dimension's halos fetched over its own axis (the
    stencil needs no corner cells). The sum is taken in that order, as the
    JAX function takes it, so a dense sweep of the whole grid in the same
    order gives the same bits."""
    pr = halo_exchange(u, mesh, width=1, dim=0, axis_name=row_axis,
                       periodic=periodic, fill_value=boundary)
    pc = halo_exchange(u, mesh, width=1, dim=1, axis_name=col_axis,
                       periodic=periodic, fill_value=boundary)
    return (pr[:, :-2, :] + pr[:, 2:, :] + pc[:, :, :-2]
            + pc[:, :, 2:]) * 0.25
