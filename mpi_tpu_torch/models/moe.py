"""Mixture-of-Experts FFN, its experts split over a mesh's ``ep`` axis and
each expert's d_ff over its ``tp`` axis.

Counterpart of ``mpi_tpu/models/moe.py``: GShard-style top-k routing with
static shapes. Each token picks its ``top_k`` most probable experts, the
experts process fixed-capacity token buffers, and the choices that
overflow a buffer fall through the residual connection. Everything is
one-hot and einsum arithmetic, as there; no kernel of its own.

**Expert parallelism.** Tokens are not split over ``ep`` or ``tp``: every
ep and tp rank of a dp rank holds the same tokens, so the dispatch needs
no exchange (the JAX package's step on a ``("dp", "ep", "tp")`` mesh
compiles to all-reduces and all-gathers, no all-to-all). The router, its
softmax, the slot arithmetic, the dispatch and combine one-hots and the aux
statistics run once, on the activation the ranks share. The experts run on
one ring of the ep × tp ranks (``tp_ring(mesh, ("ep", "tp"))``, rank (e,
j) at place e·tp + j): rank (e, j) reads its ``E/ep`` experts' d_ff slice
j of ``w1e`` (columns) and ``w2e`` (rows) as views, fills its experts'
buffers from its copy of the activation
(:func:`~mpi_tpu_torch.parallel.tensor_parallel.tp_copy`: the backward
sums the ranks' gradients to it in one kernel-6 launch), runs its slice of
their GELU FFN, and contracts it with its experts' part of the combine into
a partial that :func:`~mpi_tpu_torch.parallel.tensor_parallel.tp_reduce`
sums over the ring in one kernel-6 launch, where GSPMD inserts one
all-reduce over both axes. The GELU is elementwise in d_ff, so each tp
slice's output is exact and the sum over j is the expert's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..parallel.mesh import RankMesh
from ..parallel.tensor_parallel import tp_copy, tp_reduce, tp_size
from ..utils.platform import resolve_device

__all__ = ["init_moe_params", "moe_specs", "moe_ffn", "moe_parts", "route",
           "aux_loss"]


def init_moe_params(d_model: int, d_ff: int, n_experts: int,
                    dtype: torch.dtype, generator: torch.Generator,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The router ``(d, E)`` and the experts' ``w1e (E, d, f)`` and ``w2e
    (E, f, d)``, ``N(0, 1) / sqrt(fan_in)`` from ``generator``, at
    ``dtype`` on ``device`` (the CUDA device unless the caller names
    another); the draws differ from ``jax.random``'s."""
    dev = resolve_device(device)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=dtype)

    return {
        "router": dense((d_model, n_experts), d_model),
        "w1e": dense((n_experts, d_model, d_ff), d_model),
        "w2e": dense((n_experts, d_ff, d_model), d_ff),
    }


def moe_specs() -> Dict[str, Tuple[Any, ...]]:
    """The specs of :func:`init_moe_params`'s tree, the JAX package's:
    experts over ``ep``, each expert's d_ff over ``tp``; the router
    replicated."""
    return {"router": (), "w1e": ("ep", None, "tp"),
            "w2e": ("ep", "tp", None)}


def route(x: torch.Tensor, router: Any, n_experts: int, capacity: int,
          top_k: int):
    """The routing of ``x`` ``(groups, n, d)`` (one group a batch row):
    ``(probs, topk_probs, topk_idx, kept, pos)``. ``probs`` are the float32
    router probabilities ``(G, N, E)``; ``topk_idx`` ``(G, N, K)`` the
    ``top_k`` most probable experts in falling order, the lower index
    first on a tie (``lax.top_k``'s order: a stable sort); ``pos`` each
    choice's slot in its expert's buffer, claimed choice-major (every
    token's first choice before any token's second) in token order, and
    ``kept`` whether that slot is within ``capacity``."""
    b, s, _ = x.shape
    logits = torch.einsum("gnd,de->gne", x, router.to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    topk_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :top_k]
    topk_probs = torch.gather(probs, -1, topk_idx)
    onehot = F.one_hot(topk_idx, n_experts)                  # (G, N, K, E)
    # Slot positions: an exclusive integer cumsum over the choices in
    # choice-major order (exact); pos[g, n, k] is the slot in the chosen
    # expert's group-g buffer.
    ordered = onehot.transpose(1, 2).reshape(b, top_k * s, n_experts)
    pos = ((torch.cumsum(ordered, dim=1) - ordered) * ordered).sum(-1)
    pos = pos.reshape(b, top_k, s).transpose(1, 2)            # (G, N, K)
    return probs, topk_probs, topk_idx, pos < capacity, pos


def moe_parts(x: torch.Tensor, params: Dict[str, Any], n_experts: int,
              capacity_factor: float = 1.25, top_k: int = 1,
              ring: Optional[RankMesh] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn`'s output and, in place of the aux loss, the
    statistics it is made of, ``(2, E)`` float32: each expert's fraction of
    first choices (no gradient) and its mean router probability.
    :func:`aux_loss` turns them into the loss; a data-parallel step first
    replaces the fractions by the global batch's."""
    b, s, _ = x.shape
    e = n_experts
    if not 1 <= top_k <= e:
        raise ValueError(
            f"mpi_tpu_torch: moe top_k={top_k} must be in [1, n_experts={e}]")
    capacity = max(1, int(math.ceil(top_k * s / e * capacity_factor)))
    probs, topk_probs, topk_idx, kept, pos = route(x, params["router"], e,
                                                   capacity, top_k)
    gates = torch.where(kept, topk_probs, 0.0)
    # dispatch[g, n, e', c] = 1 iff token (g, n) sits in slot c of expert
    # e''s group-g buffer (top_k gives distinct experts: no collision).
    slot = (pos[..., None] == torch.arange(capacity, device=x.device)
            ).float()                                         # (G, N, K, C)
    sel = (F.one_hot(topk_idx, e) * kept[..., None]).float()  # (G, N, K, E)
    dispatch = torch.einsum("gnke,gnkc->gnec", sel, slot)
    combine = torch.einsum("gnke,gnkc,gnk->gnec", sel, slot, gates)

    # Rank (u, j) of the ring: its experts' buffers from its copy of x,
    # its experts' FFN on its d_ff slice j, its part of the combine;
    # tp_reduce sums the ep·tp partials.
    tp = 1 if ring is None else ring.shape.get("tp", 1)
    ep = tp_size(ring) // tp
    xin = torch.einsum("gnuec,ujgnd->ujgecd",
                       dispatch.to(x.dtype).unflatten(2, (ep, -1)),
                       tp_copy(x, ring).unflatten(0, (ep, tp)))
    w1e = params["w1e"].to(x.dtype).unflatten(0, (ep, -1))
    h = F.gelu(torch.einsum("ujgecd,uedjf->ujgecf", xin,
                            w1e.unflatten(3, (tp, -1))),
               approximate="tanh")
    w2e = params["w2e"].to(x.dtype).unflatten(0, (ep, -1))
    y_e = torch.einsum("ujgecf,uejfd->ujgecd", h,
                       w2e.unflatten(2, (tp, -1)))
    partial = torch.einsum("gnuec,ujgecd->ujgnd",
                           combine.to(x.dtype).unflatten(2, (ep, -1)), y_e)
    y = tp_reduce(partial.flatten(0, 1), ring)

    # Load balance: first choices for any k (the GShard form).
    frac = F.one_hot(topk_idx[..., 0], e).float().mean(dim=(0, 1))
    return y, torch.stack([frac, probs.mean(dim=(0, 1))])


def aux_loss(stats: torch.Tensor) -> torch.Tensor:
    """The load-balance loss ``E · Σ_e frac_e · mean_prob_e`` of
    :func:`moe_parts`' statistics ``(..., 2, E)``, summed over any leading
    (layer) dimensions; 0 for ``E = 0``."""
    return stats.shape[-1] * (stats[..., 0, :] * stats[..., 1, :]).sum()


def moe_ffn(x: torch.Tensor, params: Dict[str, Any], n_experts: int,
            capacity_factor: float = 1.25, top_k: int = 1,
            ring: Optional[RankMesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN (``top_k=1`` is Switch) of ``x`` ``(batch,
    seq, d)``, routed within each batch row, with the experts split over
    the ep ranks of ``ring`` and their d_ff over its tp ranks (see the
    module note). Returns ``(y, aux)``: ``y`` of x's shape (a token whose
    every choice overflowed gets zeros) and the float32 load-balance loss,
    minimal at uniform routing.

    Each expert holds ``ceil(top_k · seq / E · capacity_factor)`` slots a
    group; the gates are the raw router probabilities of the choices that
    found a slot. The one-hots are float32 and cast to x's dtype, as the
    JAX package casts them, before the products with x and the experts'
    outputs; the router weight too, before the logits."""
    y, stats = moe_parts(x, params, n_experts, capacity_factor, top_k, ring)
    return y, aux_loss(stats)
