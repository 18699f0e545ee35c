"""Autoregressive generation with a KV cache, the flagship's serving path.

Counterpart of ``mpi_tpu/models/generate.py``. The cache is a preallocated
static-shape ``(batch, max_seq, kv_heads, head_dim)`` pair per layer,
written in place at ``n_valid`` (the JAX package returns an updated copy;
here :func:`prefill` and :func:`decode_step` mutate the cache they are
given and return it). The JAX package's ``lax.scan`` over decode steps is a
Python loop. Prefill takes the dense cached path; each single-token decode
step takes the flash-decode kernel when ``cfg.decode_attention ==
"flash"``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..ops.attention import NEG_INF
from ..ops.decode_attention import flash_decode_attention
from ..utils.platform import resolve_device
from .quant import embed_lookup, logits_matmul
from .transformer import TransformerConfig, _ffn, _layernorm, apply_rope

__all__ = ["prefill", "decode_step", "generate"]

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def _proj_qkv(x, blk, cfg: TransformerConfig, n_valid: int):
    """q/k/v projections for tokens starting at absolute position
    ``n_valid``; under rope, q and k are rotated here, so k enters the
    cache already rotated."""
    q = torch.einsum("bsd,dhk->bshk", x, blk["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, blk["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, blk["wv"].to(x.dtype))
    if cfg.rope:
        pos = n_valid + torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _attend_cached(q, k_cache, v_cache, n_valid: int,
                   cfg: TransformerConfig):
    """q: (b, s_q, h, hd) attends to cache positions [0, n_valid + s_q)
    with causal offsets; cache: (b, max_seq, kv_heads, hd). GQA stays
    grouped through the contraction, so each kv head is read once."""
    b, s_q, h, hd = q.shape
    if cfg.decode_attention not in ("dense", "flash"):
        # Loud on an unknown value: a silent default would hide a
        # misconfiguration on the hot path.
        raise ValueError(
            f"mpi_tpu_torch: unknown decode_attention "
            f"{cfg.decode_attention!r}: expected dense|flash")
    if s_q == 1 and cfg.decode_attention == "flash":
        out = flash_decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                     n_valid)
        return out[:, None]
    kv = cfg.kv_heads
    group = h // kv
    qg = q.reshape(b, s_q, kv, group, hd)
    logits = torch.einsum("bsKgk,btKk->bKgst", qg, k_cache) * (
        1.0 / math.sqrt(cfg.head_dim))
    t = k_cache.shape[1]
    # query i sits at absolute position n_valid + i; it may see cache
    # columns 0 .. n_valid + i.
    rows = n_valid + torch.arange(s_q, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    logits = logits.masked_fill(cols > rows, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    ctx = torch.einsum("bKgst,btKk->bsKgk", probs.to(q.dtype), v_cache)
    return ctx.reshape(b, s_q, h, hd)


def _forward_cached(params, tokens: torch.Tensor, cache: Cache,
                    n_valid: int, cfg: TransformerConfig):
    """Run ``tokens`` (b, s) starting at absolute position ``n_valid``,
    writing their k/v into ``cache`` in place. Returns (logits, cache)."""
    s = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens.long(), cfg.dtype)
    if not cfg.rope:
        x = x + params["pos"].to(cfg.dtype)[n_valid:n_valid + s][None]
    for blk, (k_cache, v_cache) in zip(params["blocks"], cache):
        h = _layernorm(x, blk["ln1"]["scale"].to(x.dtype),
                       blk["ln1"]["bias"].to(x.dtype))
        q, k, v = _proj_qkv(h, blk, cfg, n_valid)
        k_cache[:, n_valid:n_valid + s] = k
        v_cache[:, n_valid:n_valid + s] = v
        ctx = _attend_cached(q, k_cache, v_cache, n_valid, cfg)
        x = x + torch.einsum("bshk,hkd->bsd", ctx, blk["wo"].to(x.dtype))
        h = _layernorm(x, blk["ln2"]["scale"].to(x.dtype),
                       blk["ln2"]["bias"].to(x.dtype))
        x = x + _ffn(h, blk, cfg)[0]  # the aux is for training alone
    x = _layernorm(x, params["final_ln"]["scale"].to(x.dtype),
                   params["final_ln"]["bias"].to(x.dtype))
    return logits_matmul(x, params["embed"]), cache


def _empty_cache(cfg: TransformerConfig, batch: int,
                 device: torch.device) -> Cache:
    # kv_heads, not n_heads: GQA shrinks the cache by the group factor.
    shape = (batch, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def _device_of(params: Dict[str, Any]) -> torch.device:
    return params["embed"].device  # a tensor or a QTensor


def prefill(params, prompt: torch.Tensor, cfg: TransformerConfig):
    """Batched prompt pass. Returns (last_logits (b, vocab), cache)."""
    cache = _empty_cache(cfg, prompt.shape[0], _device_of(params))
    logits, cache = _forward_cached(params, prompt, cache, 0, cfg)
    return logits[:, -1], cache


def decode_step(params, token: torch.Tensor, cache: Cache, n_valid: int,
                cfg: TransformerConfig):
    """One incremental step: ``token`` (b,) at absolute position
    ``n_valid``. Returns (logits (b, vocab), cache)."""
    logits, cache = _forward_cached(params, token[:, None], cache,
                                    n_valid, cfg)
    return logits[:, 0], cache


@torch.no_grad()
def generate(params, prompt: torch.Tensor, cfg: TransformerConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` (b, s).

    ``temperature == 0`` is greedy argmax; otherwise samples from the
    tempered softmax with ``generator`` (required). Runs on ``device`` (the
    CUDA device unless the caller names another), where ``params`` must
    lie. Returns (b, max_new_tokens) int64.

    The first new token comes from the prefill's logits, so
    ``max_new_tokens - 1`` decode steps follow (the JAX package's scan runs
    one more step whose logits it discards)."""
    if prompt.shape[1] + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"mpi_tpu_torch: prompt {prompt.shape[1]} + {max_new_tokens} "
            f"new tokens exceeds max_seq {cfg.max_seq}")
    if temperature > 0 and generator is None:
        raise ValueError("mpi_tpu_torch: sampling (temperature > 0) needs a "
                         "generator")
    dev = resolve_device(device)
    if _device_of(params).type != dev.type:
        raise ValueError(f"mpi_tpu_torch: params lie on "
                         f"{_device_of(params)}, generate runs on {dev}")
    prompt = prompt.to(dev)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs.to(generator.device), 1,
                                     generator=generator)[:, 0].to(dev)
        return torch.argmax(logits, dim=-1)

    logits, cache = prefill(params, prompt, cfg)
    n_valid = prompt.shape[1]
    toks = []
    for i in range(max_new_tokens):
        tok = pick(logits)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, tok, cache, n_valid, cfg)
            n_valid += 1
    return torch.stack(toks, dim=1)
