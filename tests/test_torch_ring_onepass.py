"""The single-pass order of the all-reduce kernel, held against the ring.

The CUDA all-reduce kernel (``csrc/ring_collectives.cu``) does not replay
the TPU kernel's reduce-scatter and all-gather hops: it reads the n inputs
once and, for each output chunk c, folds them in the order the ring's
reduce-scatter folds them, ``acc = x[c]``, then ``acc = x[(c + k) mod n] ⊕
acc`` for k = 1 … n − 1 (local operand first, rounded to the dtype at every
step), and writes acc to every rank. :func:`onepass_allreduce` below writes
that order out in plain PyTorch, and these tests hold it bit for bit against
``ring_allreduce_plain``, the ring's hops replayed, on the CPU. So the order
is proven before the kernel runs; the CUDA-gated tests hold the kernel
against the same plain version on the card.

Tolerance 0: the same operations in the same order, rounded the same way
(NaN compared by position).
"""

import numpy as np
import pytest
import torch

from mpi_tpu_torch.ops.ring_collectives import (ring_allreduce_plain,
                                                ring_allreduce_sharded)
from mpi_tpu_torch.parallel import make_mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fold(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sum":
        return a + b
    if op == "prod":
        return a * b
    return torch.maximum(a, b) if op == "max" else torch.minimum(a, b)


def onepass_allreduce(contribs: torch.Tensor, op: str) -> torch.Tensor:
    """Every rank's result ``(n, m, ...)``: chunk c of the output is
    x[c + n − 1] ⊕ (… ⊕ (x[c + 1] ⊕ x[c])), indices mod n, each fold in
    the dtype of ``contribs``."""
    n = contribs.shape[0]
    chunks = contribs.reshape(n, n, -1)  # [rank, chunk, elements]
    out = torch.empty_like(chunks)
    for c in range(n):
        acc = chunks[c, c]
        for k in range(1, n):
            acc = _fold(chunks[(c + k) % n, c], acc, op)
        out[:, c] = acc
    return out.reshape(contribs.shape)


def _contribs(n, m, op, dtype, seed):
    rng = np.random.default_rng(seed)
    if op == "prod":  # keep the product of n factors in range
        x = rng.uniform(0.5, 1.5, (n, m, 3))
    else:
        x = rng.standard_normal((n, m, 3))
    return torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype])


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaNs compared by position."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.masked_fill(nan, 0).view(ints),
                       b.masked_fill(nan, 0).view(ints))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 64])
def test_onepass_order_equals_the_ring(n, op, dtype):
    x = _contribs(n, 2 * n, op, dtype, seed=n)
    got = onepass_allreduce(x, op)
    assert _same(got, ring_allreduce_plain(x, op))
    assert all(_same(got[0], got[r]) for r in range(n))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["max", "min"])
def test_onepass_order_propagates_nan_as_the_ring(op, dtype):
    x = _contribs(5, 10, op, dtype, seed=5)
    x[2, 3, 1] = float("nan")
    x[4, 7, 0] = float("nan")
    got = onepass_allreduce(x, op)
    assert torch.isnan(got[:, 3, 1]).all() and torch.isnan(got[:, 7, 0]).all()
    assert _same(got, ring_allreduce_plain(x, op))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_onepass_order_through_the_padding_path(dtype):
    # m = 5 is no multiple of n = 4: ring_allreduce_sharded pads to 8.
    x = _contribs(4, 5, "sum", dtype, seed=11)
    padded = torch.cat([x, x.new_zeros(4, 3, 3)], dim=1)
    got = ring_allreduce_sharded(x, make_mesh(devices=["cpu"] * 4))
    assert _same(onepass_allreduce(padded, "sum")[0, :5], got)
