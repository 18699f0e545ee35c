"""The flagship LM trained under pipeline parallelism (pp).

Counterpart of ``mpi_tpu/models/pipeline_lm.py``: the flagship's blocks
over a mesh's ``pp`` axis through
:func:`~mpi_tpu_torch.parallel.pipeline.pipeline_sharded`. Stage i holds
``n_layers / pp`` consecutive blocks, each run through the port's own
:func:`~mpi_tpu_torch.models.transformer.block_body` with no mesh (with
``attention_impl="flash"``, kernels 1-3), and the microbatches' activations
move between stages on kernel 7. The embedding, the position table, the
final layernorm and the logits run once, as in JAX. The pp ranks share one
device (:class:`~mpi_tpu_torch.parallel.mesh.RankMesh`).

A stage's attention must be a per-device impl (dense, flash or
blockwise): the sequence-parallel impls reshard over ``sp`` and MoE routes
over ``ep``, and both belong to the sharded (non-pp) path. Such configs are
refused with the JAX package's ``ValueError``s.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel.mesh import RankMesh
from ..parallel.pipeline import pipeline_sharded
from ..parallel.zero import tree_leaves, tree_with_leaves
from .transformer import (TransformerConfig, _layernorm, block_body,
                          check_mesh, init_params, make_optimizer,
                          token_xent, train_state)

__all__ = ["stack_block_params", "init_pipelined_params",
           "forward_pipelined", "pipeline_loss_fn",
           "make_pipelined_train_step"]


def _pp_size(cfg: TransformerConfig, mesh: RankMesh, axis_name: str) -> int:
    """The number of stages, after the checks: ``mesh`` a :class:`RankMesh`
    on one device with the axis, ``cfg`` one that stages can run."""
    check_mesh(mesh, cfg)
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"mpi_tpu_torch: mesh {getattr(mesh, 'axis_names', None)} has "
            f"no {axis_name!r} axis for the pipelined flagship")
    pp = mesh.shape[axis_name]
    if cfg.n_layers % pp:
        raise ValueError(
            f"mpi_tpu_torch: n_layers={cfg.n_layers} must divide into "
            f"pp={pp} stages")
    if cfg.n_experts > 0:
        raise ValueError(
            "mpi_tpu_torch: MoE routes over the 'ep' axis — use the sharded "
            "(non-pp) path for expert parallelism")
    if cfg.attention_impl not in ("dense", "flash", "blockwise"):
        raise ValueError(
            f"mpi_tpu_torch: pipeline stages need a per-device attention "
            f"impl (dense|flash|blockwise), got {cfg.attention_impl!r}")
    return pp


def stack_block_params(params: Dict[str, Any], pp: int) -> Dict[str, Any]:
    """:func:`init_params`' list of blocks in pipeline layout: every leaf
    of ``"stages"`` gains the leading dimensions ``(pp,
    layers_per_stage)``, stage i's blocks at index i. The embedding,
    position table and final norm stay as they are."""
    blocks = params["blocks"]
    lps = len(blocks) // pp
    per_block = [tree_leaves(blk) for blk in blocks]
    stacked = (torch.stack(leaves).reshape(pp, lps, *leaves[0].shape)
               for leaves in zip(*per_block))
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["stages"] = tree_with_leaves(blocks[0], stacked)
    return out


def init_pipelined_params(cfg: TransformerConfig,
                          generator: torch.Generator, mesh: RankMesh,
                          axis_name: str = "pp") -> Dict[str, Any]:
    """:func:`init_params` from ``generator``, in pipeline layout
    (:func:`stack_block_params`), on the device of ``mesh``'s ranks."""
    pp = _pp_size(cfg, mesh, axis_name)
    return stack_block_params(init_params(cfg, generator, mesh.devices[0]),
                              pp)


def forward_pipelined(params: Dict[str, Any], tokens: torch.Tensor,
                      cfg: TransformerConfig, mesh: RankMesh,
                      microbatches: int = 4, axis_name: str = "pp",
                      remat_stage: bool = False) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab), the blocks run as
    a ``pp``-stage pipeline over ``microbatches`` microbatches of the batch
    (which they must divide). ``remat_stage`` or ``cfg.remat`` recomputes
    each stage in the backward."""
    _pp_size(cfg, mesh, axis_name)
    b, s = tokens.shape
    if b % microbatches:
        raise ValueError(
            f"mpi_tpu_torch: batch {b} not divisible by microbatches="
            f"{microbatches}")
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if not cfg.rope:
        x = x + params["pos"].to(cfg.dtype)[:s][None]
    xs = x.reshape(microbatches, b // microbatches, s, -1)

    def stage_fn(stage_params, mx):
        # One stage: its layers_per_stage blocks in order, each through
        # block_body, the one definition of a block.
        leaves = tree_leaves(stage_params)
        for layer in range(leaves[0].shape[0]):
            blk = tree_with_leaves(stage_params,
                                   (leaf[layer] for leaf in leaves))
            mx = block_body(mx, blk, cfg, None)[0]
        return mx

    ys = pipeline_sharded(stage_fn, params["stages"], xs, mesh,
                          axis_name=axis_name,
                          remat_stage=remat_stage or cfg.remat)
    x = ys.reshape(b, s, -1)
    x = _layernorm(x, params["final_ln"]["scale"].to(x.dtype),
                   params["final_ln"]["bias"].to(x.dtype))
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))


def pipeline_loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh: RankMesh,
                     microbatches: int = 4,
                     remat_stage: bool = False) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` (batch, seq + 1) through the
    pipelined forward, :func:`token_xent`'s form."""
    logits = forward_pipelined(params, tokens[:, :-1], cfg, mesh,
                               microbatches=microbatches,
                               remat_stage=remat_stage)
    return token_xent(logits, tokens[:, 1:])


def make_pipelined_train_step(cfg: TransformerConfig, mesh: RankMesh,
                              microbatches: int = 4,
                              learning_rate: float = 1e-3,
                              optimizer: str = "adamw",
                              axis_name: str = "pp",
                              remat_stage: bool = False
                              ) -> Tuple[Any, Any]:
    """``(init_state, step)`` for the pipelined flagship, the shape of
    :func:`~mpi_tpu_torch.models.transformer.make_train_parts`'s:
    ``init_state(generator)`` draws the parameters on the mesh's device
    (:func:`init_pipelined_params`), ``init_state.from_params(params)``
    takes a tree in pipeline layout as it is, and ``step(state, tokens) ->
    (state, loss)`` runs one optimizer step (adamw, adafactor or sgd at
    the constant ``learning_rate``, :func:`make_optimizer`) and updates
    the state in place; ``loss`` is a 0-dim float32 tensor on the
    device."""
    _pp_size(cfg, mesh, axis_name)
    build = make_optimizer(optimizer, learning_rate)

    def from_params(params: Dict[str, Any]) -> Dict[str, Any]:
        return train_state(params, build)

    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        return from_params(init_pipelined_params(cfg, generator, mesh,
                                                 axis_name))

    def step(state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[Dict[str, Any], torch.Tensor]:
        params, opt = state["params"], state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = pipeline_loss_fn(params, tokens.to(params["embed"].device),
                                cfg, mesh, microbatches=microbatches,
                                remat_stage=remat_stage)
        loss.backward()
        opt.step()
        return state, loss.detach()

    init_state.from_params = from_params
    return init_state, step
