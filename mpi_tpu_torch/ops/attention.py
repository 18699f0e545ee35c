"""Dense attention, the correctness oracle (counterpart of the dense part of
``mpi_tpu/ops/attention.py``).

The flash-attention family (forward kernel and its two backward kernels)
belongs to the training slice of the port and is not here yet.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "dense_attention"]

NEG_INF = -1e30  # finite mask value: keeps exp() well-defined everywhere


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Materialised-logits attention. q/k/v ``(b, s, h, d)`` with equal
    head counts; softmax in float32, probabilities cast back to q's dtype
    before the PV product, as the JAX oracle does."""
    logits = torch.einsum("bshk,bthk->bhst", q, k) * (1.0 / math.sqrt(
        q.shape[-1]))
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhst,bthk->bshk", probs.to(q.dtype), v)
