"""Decoder-only Transformer LM on one device: forward, loss and training.

Counterpart of ``mpi_tpu/models/transformer.py``: the config, the parameter
tree, the forward pass, the next-token loss and one AdamW training step on
one device. The parameter tree and the einsum layouts are the JAX
package's (``wq (d, h, hd)``, ``wo (h, hd, d)``, ...), so the JAX tree
loads as it is (:mod:`.convert`) and the two compute the same thing.
``attention_impl="flash"`` runs the flash-attention kernels
(:mod:`..ops.attention`). Sharding, the other optimizers and schedules and
the Mixture-of-Experts FFN belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dense_attention, flash_attention
from ..utils.platform import resolve_device

__all__ = ["TransformerConfig", "init_params", "forward", "forward_with_aux",
           "apply_rope", "block_body", "token_xent", "loss_fn",
           "make_optimizer", "make_train_parts", "make_train_step"]

# attention_impl values of the JAX package that later slices port.
_LATER_IMPLS = {
    "blockwise": "the long-context slice (with the online-softmax fold "
                 "that ring attention shares)",
    "ring": "the long-context slice", "ring_flash": "the long-context slice",
    "zigzag": "the long-context slice",
    "zigzag_flash": "the long-context slice",
    "ulysses": "the long-context slice",
    "ulysses_flash": "the long-context slice",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config, with torch
    dtypes. ``attention_impl`` is the full-sequence attention: ``"dense"``
    (the oracle) or ``"flash"`` (the flash-attention kernels, forward and
    backward); ``decode_attention`` is the single-token decode
    step's: ``"dense"`` (einsum chain, the oracle) or ``"flash"`` (the
    flash-decode kernel). Prefill always takes the dense cached path."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.float32        # compute dtype
    param_dtype: torch.dtype = torch.float32  # stored parameters
    attention_impl: str = "dense"
    decode_attention: str = "dense"
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_top_k: int = 1
    remat: bool = False
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"mpi_tpu_torch: d_model {self.d_model} not "
                             f"divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if not 1 <= kv <= self.n_heads or self.n_heads % kv:
            raise ValueError(
                f"mpi_tpu_torch: n_kv_heads={kv} must divide n_heads="
                f"{self.n_heads}")
        return kv


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, Any]:
    """Initialise the parameter tree (plain dicts and a list of blocks, the
    JAX package's layout) from ``generator``, on ``device`` (the CUDA
    device unless the caller names another). Weights are
    ``N(0, 1) / sqrt(fan_in)``; the draws differ from ``jax.random``'s."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mpi_tpu_torch: Mixture-of-Experts blocks belong to a later "
            "slice of the port")
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=pd)

    def ones(n):
        return torch.ones(n, dtype=pd, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=pd, device=dev)

    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    hd, kv = cfg.head_dim, cfg.kv_heads
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d), d),
        "final_ln": {"scale": ones(d), "bias": zeros(d)},
        "blocks": [],
    }
    if not cfg.rope:  # rope needs no learned position table
        params["pos"] = dense((cfg.max_seq, d), d)
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": {"scale": ones(d), "bias": zeros(d)},
            "ln2": {"scale": ones(d), "bias": zeros(d)},
            "wq": dense((d, h, hd), d),
            "wk": dense((d, kv, hd), d),
            "wv": dense((d, kv, hd), d),
            "wo": dense((h, hd, d), d),
            "w1": dense((d, f), d),
            "w2": dense((f, d), f),
        })
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding: rotate each half-dim pair of ``x``
    ``(b, s, h, hd)`` by its position's phase. ``positions`` is ``(s,)``
    global positions. Phases in float32, result cast back to x's dtype."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError(f"mpi_tpu_torch: rope needs an even head_dim, "
                         f"got {hd}")
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs  # (s, half)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def repeat_kv_heads(k, v, cfg: TransformerConfig):
    """Expand GQA k/v ``(b, s, kv_heads, hd)`` to ``n_heads`` for the dense
    full-sequence attention, which expects equal head counts."""
    group = cfg.n_heads // cfg.kv_heads
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return k, v


def _attention(x, blk, cfg: TransformerConfig):
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, blk["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, blk["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, blk["wv"].to(x.dtype))
    if cfg.rope:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    impl = cfg.attention_impl
    if impl in _LATER_IMPLS:
        raise NotImplementedError(
            f"mpi_tpu_torch: attention_impl={impl!r} is not ported yet; it "
            f"comes with {_LATER_IMPLS[impl]}")
    if impl == "flash":
        # The kernels read grouped kv heads natively: no repeat.
        ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              cfg.causal)
    elif impl == "dense":
        k, v = repeat_kv_heads(k, v, cfg)
        ctx = dense_attention(q, k, v, causal=cfg.causal)
    else:
        raise ValueError(f"mpi_tpu_torch: unknown attention_impl {impl!r}")
    return torch.einsum("bshk,hkd->bsd", ctx, blk["wo"].to(x.dtype))


def _ffn(x, blk, cfg: TransformerConfig):
    """Position-wise dense FFN with tanh-GELU (``jax.nn.gelu``'s default)."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "mpi_tpu_torch: Mixture-of-Experts FFN belongs to a later slice "
            "of the port")
    h = F.gelu(torch.einsum("bsd,df->bsf", x, blk["w1"].to(x.dtype)),
               approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, blk["w2"].to(x.dtype))


def block_body(x, blk, cfg: TransformerConfig):
    """One pre-norm transformer block (attention and FFN residuals)."""
    h = _layernorm(x, blk["ln1"]["scale"].to(x.dtype),
                   blk["ln1"]["bias"].to(x.dtype))
    x = x + _attention(h, blk, cfg)
    h = _layernorm(x, blk["ln2"]["scale"].to(x.dtype),
                   blk["ln2"]["bias"].to(x.dtype))
    return x + _ffn(h, blk, cfg)


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: TransformerConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (batch, seq) → (logits (batch, seq, vocab), aux loss), on the
    device the parameters lie on. The aux loss is the MoE load-balance
    penalty, 0 for the dense FFN (the only one ported). With
    ``cfg.remat`` each block is recomputed in the backward pass
    (``torch.utils.checkpoint``, where JAX has ``jax.checkpoint``)."""
    s = tokens.shape[1]
    tokens = tokens.long()
    x = params["embed"].to(cfg.dtype)[tokens]
    if not cfg.rope:
        x = x + params["pos"].to(cfg.dtype)[:s][None]
    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(block_body, x, blk, cfg, use_reentrant=False)
        else:
            x = block_body(x, blk, cfg)
    x = _layernorm(x, params["final_ln"]["scale"].to(x.dtype),
                   params["final_ln"]["bias"].to(x.dtype))
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab), on the device the
    parameters lie on."""
    return forward_with_aux(params, tokens, cfg)[0]


def token_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy as ``logsumexp − target_logit`` in
    float32: the (b, s, vocab) log-softmax is never materialised."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, -1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` (batch, seq + 1), mean over
    every predicted position, plus ``moe_aux_coef`` times the aux loss."""
    logits, aux = forward_with_aux(params, tokens[:, :-1], cfg)
    return token_xent(logits, tokens[:, 1:]) + cfg.moe_aux_coef * aux


# --------------------------------------------------------------------------
# Training step
# --------------------------------------------------------------------------

# What a later slice of the port brings, for each option it refuses now.
_OPTIMIZER_SLICE = "the optimizer slice (optax's rules, ported)"
_SHARDED_SLICE = "the sharded-training slice"


def make_optimizer(optimizer: str = "adamw", learning_rate: float = 1e-3,
                   warmup_steps: int = 0, total_steps: Optional[int] = None
                   ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """A builder ``leaves -> torch.optim.Optimizer`` for ``optimizer``.

    Only ``"adamw"`` at a constant ``learning_rate`` is ported: the rule of
    ``optax.adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4 on every leaf; torch's own default decay is 1e-2). adafactor, sgd
    and the warmup / cosine schedules raise ``NotImplementedError``."""
    if optimizer in ("adafactor", "sgd"):
        raise NotImplementedError(
            f"mpi_tpu_torch: optimizer={optimizer!r} is not ported yet; it "
            f"comes with {_OPTIMIZER_SLICE}")
    if optimizer != "adamw":
        raise ValueError(f"mpi_tpu_torch: unknown optimizer {optimizer!r}: "
                         f"expected adamw|adafactor|sgd")
    if warmup_steps or total_steps is not None:
        raise NotImplementedError(
            f"mpi_tpu_torch: learning-rate schedules (warmup_steps, "
            f"total_steps) are not ported yet; they come with "
            f"{_OPTIMIZER_SLICE}")

    def build(leaves: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(leaves, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    return build


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for key in tree for x in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in _leaves(node)]
    return [tree]


def make_train_parts(cfg: TransformerConfig, mesh: Any = None,
                     learning_rate: float = 1e-3, grad_accum: int = 1,
                     optimizer: str = "adamw", warmup_steps: int = 0,
                     total_steps: Optional[int] = None,
                     zero1: bool = False, fsdp: bool = False):
    """Build ``(init_state, step)`` for one device.

    ``init_state(generator, device=None)`` draws fresh parameters
    (:func:`init_params`, float32 masters at ``cfg.param_dtype`` on the
    CUDA device unless ``device`` names another) and returns
    ``{"params", "opt"}``; ``init_state.from_params(params)`` builds the
    state around a given tree instead (from :func:`params_from_jax`, say),
    taking its tensors as they are. ``step(state, tokens) -> (state,
    loss)`` runs one optimizer step on ``tokens`` (batch, seq + 1) and
    updates the state in place (the JAX step returns a new state and
    donates the old); ``loss`` is a 0-dim float32 tensor on the device.

    ``grad_accum=k`` averages the gradients of ``k`` microbatches before
    one update; the batch must divide by ``k``. The optimizer options are
    :func:`make_optimizer`'s. A mesh, ``zero1`` and ``fsdp`` raise
    ``NotImplementedError``."""
    if grad_accum < 1:
        raise ValueError(f"mpi_tpu_torch: grad_accum must be >= 1, got "
                         f"{grad_accum}")
    for name, on in (("a mesh", mesh is not None), ("zero1", zero1),
                     ("fsdp", fsdp)):
        if on:
            raise NotImplementedError(
                f"mpi_tpu_torch: {name} is not ported yet; it comes with "
                f"{_SHARDED_SLICE}")
    build = make_optimizer(optimizer, learning_rate, warmup_steps,
                           total_steps)

    def from_params(params: Dict[str, Any]) -> Dict[str, Any]:
        leaves = _leaves(params)
        for x in leaves:
            if not x.is_floating_point():
                raise TypeError(f"mpi_tpu_torch: cannot train a "
                                f"{x.dtype} parameter")
            x.requires_grad_(True)
        return {"params": params, "opt": build(leaves)}

    def init_state(generator: torch.Generator,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
        return from_params(init_params(cfg, generator, device))

    init_state.from_params = from_params

    def step(state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[Dict[str, Any], torch.Tensor]:
        params, opt = state["params"], state["opt"]
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"mpi_tpu_torch: batch {b} not divisible by "
                             f"grad_accum={grad_accum}")
        tokens = tokens.to(params["embed"].device)
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for micro in tokens.chunk(grad_accum):
            micro_loss = loss_fn(params, micro, cfg) / grad_accum
            micro_loss.backward()
            loss += micro_loss.detach()
        opt.step()
        return state, loss

    return init_state, step


def make_train_step(cfg: TransformerConfig, mesh: Any = None,
                    learning_rate: float = 1e-3, grad_accum: int = 1,
                    optimizer: str = "adamw", warmup_steps: int = 0,
                    total_steps: Optional[int] = None,
                    zero1: bool = False, fsdp: bool = False):
    """``(init_state, step)`` as :func:`make_train_parts` builds them. The
    JAX package jits its step here; the port runs eagerly, so the two
    names give the same step."""
    return make_train_parts(cfg, mesh=mesh, learning_rate=learning_rate,
                            grad_accum=grad_accum, optimizer=optimizer,
                            warmup_steps=warmup_steps,
                            total_steps=total_steps, zero1=zero1, fsdp=fsdp)
