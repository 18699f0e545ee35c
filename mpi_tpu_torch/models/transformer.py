"""Decoder-only Transformer LM, single-device inference half.

Counterpart of ``mpi_tpu/models/transformer.py``: the config, the parameter
tree, and the forward pass on one device. The parameter tree and the einsum
layouts are the JAX package's (``wq (d, h, hd)``, ``wo (h, hd, d)``, ...),
so the JAX tree loads as it is (:mod:`.convert`) and the two compute the
same thing. Sharding, the training step and the Mixture-of-Experts FFN
belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..ops.attention import dense_attention
from ..utils.platform import resolve_device

__all__ = ["TransformerConfig", "init_params", "forward", "apply_rope",
           "block_body"]

# attention_impl values of the JAX package that later slices port.
_LATER_IMPLS = {
    "flash": "the training slice (flash forward and backward kernels)",
    "blockwise": "the training slice",
    "ring": "the long-context slice", "ring_flash": "the long-context slice",
    "zigzag": "the long-context slice",
    "zigzag_flash": "the long-context slice",
    "ulysses": "the long-context slice",
    "ulysses_flash": "the long-context slice",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config, with torch
    dtypes. ``attention_impl`` is the full-sequence attention (only
    ``"dense"`` so far); ``decode_attention`` is the single-token decode
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
    if impl != "dense":
        raise ValueError(f"mpi_tpu_torch: unknown attention_impl {impl!r}")
    k, v = repeat_kv_heads(k, v, cfg)
    ctx = dense_attention(q, k, v, causal=cfg.causal)
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


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab), on the device the
    parameters lie on."""
    s = tokens.shape[1]
    tokens = tokens.long()
    x = params["embed"].to(cfg.dtype)[tokens]
    if not cfg.rope:
        x = x + params["pos"].to(cfg.dtype)[:s][None]
    for blk in params["blocks"]:
        x = block_body(x, blk, cfg)
    x = _layernorm(x, params["final_ln"]["scale"].to(x.dtype),
                   params["final_ln"]["bias"].to(x.dtype))
    return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
