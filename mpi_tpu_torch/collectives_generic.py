"""The canonical reduction orders, on tensors, numpy arrays and scalars.

A copy of the part of ``mpi_tpu/collectives_generic.py`` that fixes the
order in which a collective combines the ranks' payloads, which is what
makes the drivers agree bit for bit:

* :func:`tree_combine` (``collectives_generic.py:156``): the binomial tree.
  In round k (distance d = 2**k) every rank r with ``r % 2d == 0`` and
  ``r + d < n`` takes ``acc[r] = op(acc[r], acc[r + d])``, the lower rank's
  partial on the left.
* :func:`ring_combine` (``:393``): the ring, block b folding ranks b, b+1,
  ... left to right.
* :func:`canonical_combine` (``:381``) and :func:`ring_eligible` (``:288``)
  pick between them by the shared size rule, :data:`RING_MIN_BYTES`, read
  from the same ``MPI_TPU_RING_MIN_BYTES`` variable with the same "never"
  default, so both packages pick the same order at every size.

On tensors :func:`combine` uses the torch op of the same name, which rounds
each elementwise result to the dtype as numpy (and ml_dtypes' bfloat16)
does; :func:`tree_combine` folds a list of tensors round by round in place
of the list, with no stack. The wire algorithms (reduce, ring_allreduce
over send/receive, ...) wait for a wire driver.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Union

import numpy as np
import torch

from .api import MpiError

__all__ = ["OpLike", "check_op", "combine", "tree_combine", "ring_combine",
           "canonical_combine", "ring_eligible", "RING_MIN_BYTES"]

# A reduction op: a built-in name or an associative user callable
# (the MPI_Op_create analogue; see check_op).
OpLike = Union[str, Callable[[Any, Any], Any]]

_OPS: dict = {"sum": np.add, "prod": np.multiply, "min": np.minimum,
              "max": np.maximum}
_TORCH_OPS: dict = {"sum": torch.add, "prod": torch.mul,
                    "min": torch.minimum, "max": torch.maximum}


def check_op(op) -> None:
    """Validate a reduction op: a built-in name or a callable ``op(a, b)``
    (associative; the canonical orders keep rank order, so it need not
    commute). Called on every rank before any communication."""
    if callable(op):
        return
    if op not in _OPS:
        raise MpiError(f"mpi_tpu_torch: unknown reduction op {op!r}; "
                       f"expected one of {sorted(_OPS)} or a callable "
                       f"op(a, b) -> combined")


def combine(a: Any, b: Any, op: OpLike) -> Any:
    """``op(a, b)`` elementwise, keeping the dtype. Two tensors combine with
    the torch op on their device; anything else with the numpy op, as the
    JAX package does."""
    check_op(op)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape != b.shape:
            raise MpiError(
                f"mpi_tpu_torch: reduction shape mismatch across ranks: "
                f"{tuple(a.shape)} vs {tuple(b.shape)}")
        out = op(a, b) if callable(op) else _TORCH_OPS[op](a, b)
        if not isinstance(out, torch.Tensor) or out.shape != a.shape:
            raise MpiError(
                f"mpi_tpu_torch: user reduction op changed the payload: "
                f"{tuple(a.shape)} -> {getattr(out, 'shape', type(out))}")
        return out
    fn = op if callable(op) else _OPS[op]
    an, bn = np.asarray(a), np.asarray(b)
    if an.shape != bn.shape:
        raise MpiError(
            f"mpi_tpu_torch: reduction shape mismatch across ranks: "
            f"{an.shape} vs {bn.shape}")
    out = np.asarray(fn(an, bn))
    if out.shape != an.shape:
        raise MpiError(
            f"mpi_tpu_torch: user reduction op changed the payload shape: "
            f"{an.shape} -> {out.shape}")
    if np.isscalar(a) or an.ndim == 0:
        return out[()] if isinstance(out, np.ndarray) else out
    return out


def tree_combine(slots: List[Any], op: OpLike) -> Any:
    """Fold rank-ordered ``slots`` in the canonical binomial-tree order.

    Tensors stay tensors: the list is folded round by round with one
    elementwise op per pair (n - 1 in all) and no stack; the inputs are not
    written. ``n == 1`` returns the payload itself. Other payloads fold as
    numpy arrays."""
    check_op(op)
    if all(isinstance(s, torch.Tensor) for s in slots):
        acc = list(slots)
    else:
        acc = [np.asarray(s) for s in slots]
    n, d = len(acc), 1
    while d < n:
        for r in range(0, n, 2 * d):
            if r + d < n:
                acc[r] = combine(acc[r], acc[r + d], op)
                if not isinstance(acc[r], torch.Tensor):
                    acc[r] = np.asarray(acc[r])
        d *= 2
    return acc[0]


# Large numeric payloads may switch from the tree to the ring, but only
# when the user opts in: the default is never, as in the JAX package
# (collectives_generic.py:232-270 says why). Every rank must see the same
# value; a malformed one is a loud no-op.
_RING_MIN_NEVER = 1 << 62
try:
    RING_MIN_BYTES = int(os.environ.get("MPI_TPU_RING_MIN_BYTES",
                                        str(_RING_MIN_NEVER)))
except ValueError:
    import warnings

    warnings.warn(
        f"mpi_tpu_torch: MPI_TPU_RING_MIN_BYTES="
        f"{os.environ['MPI_TPU_RING_MIN_BYTES']!r} is not an integer "
        f"byte count — ring dispatch stays OFF",
        RuntimeWarning, stacklevel=1)
    RING_MIN_BYTES = _RING_MIN_NEVER


def _ring_dtype_ok(dtype) -> bool:
    """Real, integer and bool dtypes, bfloat16 included: ``torch.bfloat16``
    for tensors, ml_dtypes' bfloat16 (numpy kind 'V') for arrays."""
    if isinstance(dtype, torch.dtype):
        return not dtype.is_complex
    d = np.dtype(dtype)
    if d.kind in "fiub":
        return True
    try:
        import ml_dtypes
    except ImportError:
        return False
    return d == np.dtype(ml_dtypes.bfloat16)


def ring_eligible(nbytes: int, dtype, n: int, op) -> bool:
    """The one algorithm-selection rule, the JAX package's verbatim:
    named ops on at least 3 ranks, real dtypes, ``nbytes >=
    RING_MIN_BYTES``. Callable ops and complex dtypes stay on the tree."""
    return (isinstance(op, str) and n >= 3
            and _ring_dtype_ok(dtype)
            and nbytes >= RING_MIN_BYTES)


def canonical_combine(slots: List[Any], op: OpLike) -> np.ndarray:
    """Host fold of numpy payloads in the canonical order the wire
    algorithms use: ring for ``ring_eligible`` payloads, tree otherwise."""
    first = np.asarray(slots[0])
    if ring_eligible(first.nbytes, first.dtype, len(slots), op):
        return ring_combine(slots, op)
    return tree_combine(slots, op)


def ring_combine(slots: List[Any], op: OpLike) -> np.ndarray:
    """Host replay of the ring all-reduce's canonical order on numpy
    payloads: the flat payload is padded to n equal blocks, and block b
    folds ranks b, b+1, ... left to right."""
    check_op(op)
    arrs = [np.asarray(s) for s in slots]
    n = len(arrs)
    if n == 1:
        return arrs[0].copy()
    shape, size = arrs[0].shape, arrs[0].size
    m = -(-size // n)
    padded = np.zeros((n, n * m), dtype=arrs[0].dtype)
    for r, a in enumerate(arrs):
        padded[r, :size] = a.reshape(-1)
    blocks = padded.reshape(n, n, m)  # [rank, block, elem]
    out = np.empty((n, m), dtype=arrs[0].dtype)
    for b in range(n):
        acc = blocks[b, b]
        for k in range(1, n):
            acc = np.asarray(combine(acc, blocks[(b + k) % n, b], op))
        out[b] = acc
    return out.reshape(-1)[:size].reshape(shape)
