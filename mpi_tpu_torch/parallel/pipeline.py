"""Pipeline parallelism over a mesh's ``pp`` axis: GPipe on kernel 7.

Counterpart of ``mpi_tpu/parallel/pipeline.py``. The layers are cut into
``S`` stages, stage s on pp rank s, and ``M`` microbatches stream through
them: at step t stage s works on microbatch ``t − s``, and the step ends
with one hop that hands every stage's activation to the next stage,
``i → i+1 mod S``. There the ranks are devices inside ``shard_map``, the
schedule one ``lax.scan`` and the hop ``lax.ppermute``; here the pp ranks
share one device (a :class:`RankMesh`, as the ring attention's sp ranks
do), the schedule is a Python loop over the ``M + S − 1`` steps, and the
hop is one kernel-7 launch over the stacked ``(S, ...)`` activations
(:func:`~mpi_tpu_torch.parallel.p2p.ring_shift`, its backward the reverse
hop).

The schedule is JAX's fill-drain (bubble fraction ``(S − 1)/(M + S −
1)``), with two differences that change no value: ``stage_fn`` runs only
on the active (stage, step) pairs, where JAX computes the bubble pairs
and zeroes them (so their values and gradients are zero either way), and
the last step sends nothing, where JAX's last ``ppermute`` delivers what
no step reads. A call thus runs ``stage_fn`` ``M · S`` times and launches
kernel 7 ``M + S − 2`` times forward and as many times backward.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import RankMesh, shared_ring
from .p2p import ring_shift
from .zero import tree_leaves, tree_with_leaves

__all__ = ["pipeline", "pipeline_sharded"]


def _stage(stage_params: Any, s: int) -> Any:
    """Stage s's slice of a tree whose leaves lead with the stage axis."""
    return tree_with_leaves(stage_params,
                            (x[s] for x in tree_leaves(stage_params)))


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params: Any, xs: torch.Tensor, mesh: RankMesh,
             axis_name: str = "pp",
             remat_stage: bool = False) -> torch.Tensor:
    """Stream the microbatches ``xs`` ``(M, ...)`` through the stages of
    ``mesh``'s ``axis_name`` ranks. Returns the stacked view ``(S, M,
    ...)``: every pp rank's copy of the last stage's outputs, as the JAX
    function returns them on every device (an expanded view of one
    tensor, through :func:`~mpi_tpu_torch.parallel.collectives.bcast`).

    ``stage_fn(params, x) -> y`` applies one stage to one microbatch (y of
    x's shape and dtype); ``stage_params`` is a tree (dicts and lists)
    whose leaves have a leading stage axis of size S, stage s's slice at
    index s. Stage 0 is fed ``xs``. ``remat_stage`` recomputes each
    (stage, microbatch) forward in the backward
    (``torch.utils.checkpoint``, where JAX has ``jax.checkpoint``).

    Raises ``ValueError`` for a mesh without the axis or leaves without a
    leading stage axis of its size, ``NotImplementedError`` for a mesh over
    several distinct devices (:func:`~mpi_tpu_torch.parallel.mesh.
    shared_ring`)."""
    ring = shared_ring(mesh, axis_name, xs, "pipeline")
    n, m_total = ring.size, xs.shape[0]
    for x in tree_leaves(stage_params):
        if x.dim() < 1 or x.shape[0] != n:
            raise ValueError(
                f"mpi_tpu_torch: pipeline stage parameters lead with the "
                f"{n} stages of {axis_name!r}; got a leaf of shape "
                f"{tuple(x.shape)}")
    if remat_stage:
        def run(p, x):
            return checkpoint(stage_fn, p, x, use_reentrant=False)
    else:
        run = stage_fn
    stages = [_stage(stage_params, s) for s in range(n)]
    zeros = torch.zeros_like(xs[0])
    arriving = None  # (S, ...): what the last hop handed each stage
    ys = []
    for t in range(m_total + n - 1):
        y = torch.stack([
            run(stages[s], xs[t] if s == 0 else arriving[s])
            if 0 <= t - s < m_total else zeros for s in range(n)])
        ys.append(y)
        if t < m_total + n - 2:
            arriving = ring_shift(y, ring)
    # Each rank's outputs of the steps at which the last stage emits
    # microbatch m (step m + S − 1), rank S − 1's sent to every rank.
    # (Imported here, as in the JAX module: parallel.collectives imports
    # the ring kernels, whose module imports this package.)
    from .collectives import bcast

    return bcast(torch.stack(ys[n - 1:], dim=1), ring, root=n - 1)


def pipeline_sharded(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stacked_params: Any, xs: torch.Tensor, mesh: RankMesh,
                     axis_name: str = "pp",
                     remat_stage: bool = False) -> torch.Tensor:
    """The JAX global view of :func:`pipeline`: ``stacked_params``' leaves
    lead with the stage axis (stage i's slice on pp rank i), ``xs`` is the
    ``(M, ...)`` microbatch stack, and the result is the ``(M, ...)``
    outputs of the last stage (replicated there, ``P()``)."""
    return pipeline(stage_fn, stacked_params, xs, mesh, axis_name,
                    remat_stage)[0]
