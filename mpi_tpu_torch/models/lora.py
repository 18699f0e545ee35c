"""LoRA: low-rank adaptation fine-tuning of the flagship model.

Counterpart of ``mpi_tpu/models/lora.py``. The base weights stay frozen
and each targeted projection learns a rank-``r`` delta ``ΔW = (alpha / r)
· A @ B``. The adapters are a tree beside the base, ``{"blocks": [{target:
{"a", "b"}}], "rank": r}``, with A ``(d_in, r)`` and B ``(r, d_out)``;
each projection weight is a matrix whose non-first axes are flattened into
B's columns (``wq``/``wk``/``wv`` ``(d, h, hd)``, ``wo`` ``(h, hd, d)``,
``w1`` ``(d, ff)``, ``w2`` ``(ff, d)``, the JAX package's layouts).

**The freeze.** The JAX step differentiates argument 0 (the adapters)
alone and holds the base behind ``stop_gradient``. Here the base enters
the step as ``x.detach()`` views (no copy), the merge ``base + ΔW`` runs
inside the step before :func:`~.transformer.loss_fn`, and the gradients
come from ``torch.autograd.grad`` on the adapter leaves. So a base whose
leaves require grad (one taken from :func:`~.transformer.make_train_parts`)
gets no ``.grad``, no optimizer moment and no change, and remat recomputes
each block on the merged weights. The optimizer holds the adapters alone.

Over a mesh the step runs ``loss_fn(merged, tokens, cfg, mesh)`` as JAX
does: the merged projections split over ``tp`` as the base's do (the
reductions on kernel 6), the sequence-parallel impls run over ``sp``, and
a ``dp`` axis above 1 runs every row in one pass (the base and adapters
are replicated over dp, so that pass gives the global loss and gradient).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..parallel.zero import tree_leaves, tree_with_leaves
from ..utils.platform import resolve_device
from .convert import _tensor
from .transformer import TransformerConfig, loss_fn, make_optimizer

__all__ = ["lora_init", "lora_delta", "merge_lora", "make_lora_train_parts",
           "make_lora_train_step", "count_params", "lora_from_jax"]

_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _check_targets(targets: Sequence[str]) -> Tuple[str, ...]:
    bad = [t for t in targets if t not in _TARGETS]
    if bad:
        raise ValueError(
            f"mpi_tpu_torch: unknown LoRA targets {bad}; choose from "
            f"{_TARGETS}")
    if not targets:
        raise ValueError("mpi_tpu_torch: LoRA needs at least one target")
    return tuple(targets)


def lora_init(params: Any, rank: int, targets: Sequence[str] = ("wq", "wv"),
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Adapters for every targeted projection of every block, on the
    device of the base's weights: A drawn from ``N(0, 1) / sqrt(d_in)``
    with ``generator`` (torch's default generator when None; the draws
    differ from ``jax.random``'s), B zeros, so the adapted model starts
    exactly at the base. A target a block lacks is skipped (``w1`` /
    ``w2`` in an MoE block)."""
    targets = _check_targets(targets)
    if rank < 1:
        raise ValueError(f"mpi_tpu_torch: LoRA rank must be >= 1, got {rank}")
    on = generator.device if generator is not None else None
    blocks = []
    for blk in params["blocks"]:
        entry: Dict[str, Dict[str, torch.Tensor]] = {}
        for t in targets:
            if t not in blk:
                continue
            w = blk[t]
            d_in, d_out = w.shape[0], math.prod(w.shape[1:])
            a = torch.randn((d_in, rank), generator=generator,
                            device=on) / math.sqrt(d_in)
            entry[t] = {"a": a.to(device=w.device, dtype=dtype),
                        "b": torch.zeros((rank, d_out), dtype=dtype,
                                         device=w.device)}
        blocks.append(entry)
    return {"blocks": blocks, "rank": rank}


def lora_delta(w: torch.Tensor, ab: Dict[str, torch.Tensor], alpha: float,
               rank: int) -> torch.Tensor:
    """ΔW reshaped to ``w``'s layout and dtype, scaled by alpha / rank."""
    delta = (ab["a"] @ ab["b"]) * (alpha / rank)
    return delta.reshape(w.shape).to(w.dtype)


def merge_lora(params: Any, lora: Dict[str, Any],
               alpha: float = 16.0) -> Any:
    """A new tree of ``params``'s structure with every adapter folded in
    (``W + ΔW``): the serving-time merge. ``params`` is not written."""
    rank = lora["rank"]
    merged_blocks = []
    for blk, entry in zip(params["blocks"], lora["blocks"]):
        new = dict(blk)
        for t, ab in entry.items():
            new[t] = blk[t] + lora_delta(blk[t], ab, alpha, rank)
        merged_blocks.append(new)
    out = dict(params)
    out["blocks"] = merged_blocks
    return out


def count_params(tree: Any) -> int:
    """Elements over the tensor leaves of ``tree`` (an adapter tree's
    ``"rank"`` is an int and counts nothing)."""
    return sum(x.numel() for x in tree_leaves(tree) if torch.is_tensor(x))


def make_lora_train_parts(cfg: TransformerConfig, base_params: Any,
                          rank: int = 8, alpha: float = 16.0,
                          targets: Sequence[str] = ("wq", "wv"),
                          mesh: Any = None, learning_rate: float = 1e-3,
                          optimizer: str = "adamw"):
    """``(init_state, step)`` of adapter-only training over the frozen
    ``base_params`` (see the module note).

    ``init_state(generator=None)`` draws fresh adapters (:func:`lora_init`)
    and returns ``{"lora", "opt"}``, the optimizer
    (:func:`~.transformer.make_optimizer`'s rules) over the adapter leaves
    alone; ``init_state.from_lora(lora)`` builds the state around a given
    adapter tree (from :func:`lora_from_jax`, say). ``step(state, tokens)
    -> (state, loss)`` runs one optimizer step on ``tokens`` (batch, seq +
    1) and updates the adapters in place; ``loss`` is a 0-dim float32
    tensor on the device."""
    targets = _check_targets(targets)
    build = make_optimizer(optimizer, learning_rate)
    frozen = tree_with_leaves(base_params, (x.detach() for x in
                                            tree_leaves(base_params)))

    def from_lora(lora: Dict[str, Any]) -> Dict[str, Any]:
        if lora["rank"] != rank:
            raise ValueError(f"mpi_tpu_torch: adapters of rank "
                             f"{lora['rank']}; this step trains rank {rank}")
        leaves = tree_leaves(lora["blocks"])
        for x in leaves:
            x.requires_grad_(True)
        return {"lora": lora, "opt": build(leaves)}

    def init_state(generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        return from_lora(lora_init(base_params, rank, targets,
                                   generator=generator))

    def step(state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[Dict[str, Any], torch.Tensor]:
        leaves = tree_leaves(state["lora"]["blocks"])
        merged = merge_lora(frozen, state["lora"], alpha)
        loss = loss_fn(merged, tokens.to(frozen["embed"].device), cfg, mesh)
        for x, g in zip(leaves, torch.autograd.grad(loss, leaves)):
            x.grad = g
        state["opt"].step()
        return state, loss.detach()

    init_state.from_lora = from_lora
    return init_state, step


# The JAX package jits its step under this name; the port runs eagerly, so
# the two names give the same step.
make_lora_train_step = make_lora_train_parts


def lora_from_jax(tree: Any, device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, Any]:
    """The port's adapter tree from the JAX package's (its ``lora_init``
    or a train state's ``"lora"``), whose arrays the caller has turned
    into numpy arrays: each A and B becomes a tensor of its own dtype on
    ``device`` (the CUDA device unless the caller names another), and
    ``"rank"`` is kept. Raises ``ValueError`` if an adapter's shapes do
    not hold the rank."""
    dev = resolve_device(device)
    rank = int(tree["rank"])
    blocks = []
    for entry in tree["blocks"]:
        blocks.append({t: {k: _tensor(v, dev, None) for k, v in ab.items()}
                       for t, ab in entry.items()})
        for t, ab in blocks[-1].items():
            if ab["a"].shape[1] != rank or ab["b"].shape[0] != rank:
                raise ValueError(
                    f"mpi_tpu_torch: adapter {t} has a {tuple(ab['a'].shape)}"
                    f" and b {tuple(ab['b'].shape)}; rank {rank}")
    return {"blocks": blocks, "rank": rank}
