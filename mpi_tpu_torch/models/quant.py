"""Weight-only int8 quantization for serving the flagship model.

Counterpart of ``mpi_tpu/models/quant.py``. Matmul weights become int8 with
a per-output-channel (last axis) absmax scale; activations stay in the
compute dtype. Every weight consumer in the model calls
``.to(compute_dtype)`` on its weight leaf, and :class:`QTensor` answers that
(and the JAX-named ``astype``) by dequantizing, so the float and quantized
paths share one forward. The embedding's gather and the tied logits product
keep the table int8 (:func:`embed_lookup`, :func:`logits_matmul`).

What gets quantized: floating-point leaves with ``ndim >= 2`` except the
additive position table ``pos``. Layernorm scales and biases stay as they
are.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["QTensor", "quantize_params", "quantize", "dequantize",
           "embed_lookup", "logits_matmul"]


class QTensor:
    """int8 values ``q`` and their float32 per-last-axis-channel ``scale``
    (shape ``(1, ..., 1, channels)``)."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def deq(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize to ``dtype``."""
        return self.q.to(dtype) * self.scale.to(dtype)

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        return self.deq(dtype)

    # Weight consumers call .to(compute_dtype), as on a plain tensor.
    to = astype


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric per-channel (last axis) absmax int8 quantization. Rounds
    half to even, as ``jnp.round`` does."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(t: QTensor, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    return t.deq(dtype)


def embed_lookup(emb: Any, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Token-embedding gather; an int8 table stays int8 until after the
    gather, so only the needed rows are read."""
    if isinstance(emb, QTensor):
        return emb.q[tokens].to(dtype) * emb.scale.reshape(-1).to(dtype)
    return emb.to(dtype)[tokens]


def logits_matmul(x: torch.Tensor, emb: Any) -> torch.Tensor:
    """Tied-embedding logits ``x @ emb.T``; for an int8 table the
    per-channel scale is folded into the activations."""
    if isinstance(emb, QTensor):
        scaled = x * emb.scale.reshape(-1).to(x.dtype)
        return torch.einsum("bsd,vd->bsv", scaled, emb.q.to(x.dtype))
    return torch.einsum("bsd,vd->bsv", x, emb.to(x.dtype))


def _should_quantize(path: str, leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.dim() < 2 or not leaf.is_floating_point():
        return False
    # Additive positional table: tiny, precision-sensitive — skip.
    return path.split("/")[-1] != "pos"


def quantize_params(params: Any) -> Any:
    """Return ``params`` with every matmul weight replaced by a
    :class:`QTensor` (see the module doc for the selection rule)."""
    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        if _should_quantize(path, node):
            return quantize(node)
        return node

    return walk(params, "")
