"""Carry the JAX package's parameter tree over to the port.

The JAX package keeps its parameters as nested dicts and lists of arrays
(its ``init_params``), and a quantized tree holds ``QTensor`` named tuples
``(q, scale)``. Given that tree as **numpy arrays** (the
caller runs ``np.asarray`` over the JAX leaves), :func:`params_from_jax`
builds the port's tree of the same layout, so both packages compute the
same function. The port imports neither ``jax`` nor ``mpi_tpu`` for this.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..utils.platform import resolve_device
from .quant import QTensor
from .transformer import TransformerConfig

__all__ = ["params_from_jax"]


def _tensor(arr: Any, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch view
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype if t.is_floating_point()
                else None)


def params_from_jax(tree: Any, cfg: TransformerConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Any:
    """The port's parameters from a JAX parameter tree of numpy arrays.

    Float leaves become ``cfg.param_dtype`` tensors on ``device`` (the
    CUDA device unless the caller names another); a ``(q, scale)`` tuple
    becomes a :class:`QTensor` with its int8 values and float32 scale as
    they are. Raises ``ValueError`` if the tree's embedding or block count
    disagree with ``cfg``."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):  # QTensor(q, scale)
            q, scale = node
            return QTensor(_tensor(q, dev, None),
                           _tensor(scale, dev, torch.float32))
        return _tensor(node, dev, cfg.param_dtype)

    params = walk(tree)
    embed = params["embed"]
    if tuple(embed.shape) != (cfg.vocab, cfg.d_model) or \
            len(params["blocks"]) != cfg.n_layers:
        raise ValueError(
            f"mpi_tpu_torch: tree has embed {tuple(embed.shape)} and "
            f"{len(params['blocks'])} blocks; cfg wants "
            f"({cfg.vocab}, {cfg.d_model}) and {cfg.n_layers}")
    return params
