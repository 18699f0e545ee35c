"""Prompt-lookup speculative decoding: greedy decode that verifies several
drafted tokens in one forward.

Counterpart of ``mpi_tpu/models/speculative.py``. The draft is prompt
lookup (n-gram retrieval): the tokens that followed the most recent
earlier occurrence of the last ``ngram`` committed tokens. Each round
feeds ``[pending, d_1..d_m]`` at ``n_valid`` through the cached forward,
whose argmaxes ``g_1..g_{m+1}`` are the greedy continuations; the round
commits ``pending, d_1..d_k`` (``k`` the index of the first draft token
that greedy rejects, ``m`` when none is) and the new pending token is
``g_{k+1}``, so a round nets at least one token. The output is greedy
under this path's own argmaxes: it equals :func:`generate`'s wherever the
argmax is stable across the two paths' forward shapes (``m + 1`` queries
here, one there), which holds in float32 and may flip at a near-tie of
bf16 logits.

Where the JAX package runs a ``lax.while_loop`` under ``jit`` and vmaps a
one-row engine over the batch, here the rows run one after another, each
on its own batch-1 cache from :func:`prefill` that the verify forward
writes in place, and the round loop is a Python loop. Every verify
forward feeds ``m + 1 >= 2`` queries, so it takes the dense cached
attention (``generate._attend_cached``), as the prefill does: this path
launches no hand-written kernel.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional, Union

import torch

from ..utils.platform import resolve_device
from .generate import _device_of, prefill
from .transformer import TransformerConfig

__all__ = ["generate_lookahead"]

# The module, not the function of the same name that the package exports.
# The verify forward is looked up on it at each call.
_cached = importlib.import_module(".generate", __package__)


def _find_draft(buf: torch.Tensor, n_valid: int, ngram: int,
                draft_len: int) -> torch.Tensor:
    """Prompt-lookup draft: the ``draft_len`` tokens that followed the most
    recent earlier occurrence of the last ``ngram`` committed tokens.
    ``buf`` is the (L,) token buffer; positions >= ``n_valid`` are garbage.
    Returns (draft_len,) tokens on ``buf``'s device, garbage where no match
    exists or the match runs past ``n_valid``: verification rejects it."""
    L = buf.shape[0]
    idx = torch.arange(L, device=buf.device)
    key = buf[(n_valid - ngram + torch.arange(ngram, device=buf.device)) % L]
    # Window t matches iff buf[t + j] == key[j] for every j. Its start must
    # sit strictly before the key's (n_valid - ngram): that excludes the
    # trivial self-match and admits a match overlapping the key.
    eq = torch.stack([torch.roll(buf, -j) == key[j]
                      for j in range(ngram)]).all(0)
    valid = idx < max(n_valid - ngram, 0)
    p = torch.where(eq & valid, idx, -1).max()   # the most recent match
    start = torch.where(p >= 0, p + ngram, 0)    # the draft follows it
    return buf[(start + torch.arange(draft_len, device=buf.device)) % L]


def _accepted(draft: torch.Tensor, greedy: torch.Tensor) -> torch.Tensor:
    """``k``, 0-dim: the index of the first draft token that differs from
    greedy's (``greedy[i]`` continues after ``fed[i]``), ``m`` when every
    one matches. argmin takes the first index on ties."""
    match = draft == greedy
    return torch.cat([match, match.new_zeros(1)]).int().argmin()


def _row(params, prompt_row: torch.Tensor, cfg: TransformerConfig,
         max_new_tokens: int, draft_len: int, ngram: int) -> torch.Tensor:
    """One row's ``max_new_tokens`` greedy tokens, on its own cache."""
    s = prompt_row.shape[0]
    last, cache = prefill(params, prompt_row[None], cfg)
    pending = last[0].argmax()
    buf = torch.zeros(cfg.max_seq, dtype=torch.long, device=last.device)
    buf[:s] = prompt_row
    n_valid, produced = s, 0
    while produced < max_new_tokens:
        # pending is committed: place it so the n-gram key reads it.
        buf[n_valid] = pending
        draft = _find_draft(buf, n_valid + 1, ngram, draft_len)
        fed = torch.cat([pending[None], draft])
        # The cache rows past n_valid that a rejected draft wrote are
        # masked (query i sees columns <= n_valid + i) and the next round
        # writes over them at the same offsets.
        logits, cache = _cached._forward_cached(params, fed[None], cache,
                                                n_valid, cfg)
        greedy = logits[0].argmax(-1)
        # The round's one host sync: n_valid advances as a Python int.
        k = int(_accepted(draft, greedy[:draft_len]))
        take = min(k + 1, max_new_tokens - produced)
        buf[n_valid:n_valid + take] = fed[:take]
        pending = greedy[k]
        n_valid += take
        produced += take
    return buf[s:s + max_new_tokens]


@torch.no_grad()
def generate_lookahead(params: Any, prompt: torch.Tensor,
                       cfg: TransformerConfig, max_new_tokens: int,
                       draft_len: int = 4, ngram: int = 2,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> torch.Tensor:
    """Greedy generation of ``max_new_tokens`` continuations of ``prompt``
    (b, s), ``draft_len`` drafted tokens verified per forward, ``ngram``
    the lookup key's length. Runs on ``device`` (the CUDA device unless the
    caller names another), where ``params`` must lie. Returns
    (b, max_new_tokens) int64."""
    b, s = prompt.shape
    if ngram < 1 or draft_len < 1:
        raise ValueError("mpi_tpu_torch: ngram and draft_len must be >= 1")
    if ngram > s:
        raise ValueError(
            f"mpi_tpu_torch: ngram {ngram} longer than the prompt ({s})")
    # A round writes draft_len + 1 positions from at most
    # s + max_new_tokens - 1, so the cache, the buffer and the learned
    # position table (whose slice would silently come up short) must hold
    # the overhang.
    need = s + max_new_tokens + draft_len + 1
    if need > cfg.max_seq:
        raise ValueError(
            f"mpi_tpu_torch: prompt {s} + {max_new_tokens} new + draft "
            f"overhang {draft_len + 1} needs max_seq >= {need}, have "
            f"{cfg.max_seq}")
    dev = resolve_device(device)
    if _device_of(params).type != dev.type:
        raise ValueError(f"mpi_tpu_torch: params lie on "
                         f"{_device_of(params)}, generate_lookahead runs on "
                         f"{dev}")
    prompt = prompt.to(dev).long()
    return torch.stack([_row(params, row, cfg, max_new_tokens, draft_len,
                             ngram) for row in prompt])
