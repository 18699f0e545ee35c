"""The port's flash-decode attention against the JAX package's.

The same numpy inputs go through ``mpi_tpu.ops.decode_attention`` (the
Pallas kernel, in interpret mode on the CPU as the JAX tests run it) and
through ``mpi_tpu_torch.ops.decode_attention`` on CPU tensors (its plain
version). Cases mirror tests/test_decode_attention.py, plus the empty live
prefix (``n_valid = -1``), where the Pallas kernel skips every block and
gives a zero output with lse ~ -1e30.

Tolerance: float32 atol = rtol = 1e-5 (summation order only); bfloat16
outputs 1e-2 (one bf16 ulp is 2**-8 relative, and p is rounded to bf16 at
each block's running max in the kernel but at the global max in the plain
version).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.ops.decode_attention import \
    flash_decode_attention as jax_decode  # noqa: E402
from mpi_tpu_torch.ops.decode_attention import (  # noqa: E402
    NEG_INF, flash_decode_attention, flash_decode_attention_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(b, t, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


# n_valid is traced, so each shape compiles once across its n_valid cases.
_jax_decode = jax.jit(jax_decode, static_argnames=("block_k", "with_lse"))


def _both(q, k, v, n_valid, block_k=16, jdtype=jnp.float32,
          tdtype=torch.float32):
    jo, jl = _jax_decode(*(jnp.asarray(x, jdtype) for x in (q, k, v)),
                         jnp.int32(n_valid), block_k=block_k, with_lse=True)
    to, tl = flash_decode_attention(
        *(torch.from_numpy(x).to(tdtype) for x in (q, k, v)), n_valid,
        with_lse=True)
    return (np.asarray(jo, np.float32), np.asarray(jl)), (to, tl)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("n_valid", [0, 5, 63])
def test_head_layouts(h, kv, n_valid):
    (jo, jl), (to, tl) = _both(*_rand(2, 64, h, kv, 32), n_valid)
    assert to.shape == (2, h, 32) and tl.shape == (2, h)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("n_valid", [15, 16, 17, 31, 32, 95])
def test_block_boundary_positions(n_valid):
    # n_valid at, one before and one past a JAX block edge.
    (jo, jl), (to, tl) = _both(*_rand(1, 96, 4, 4, 16, seed=1), n_valid)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("n_valid", [20, 49])
def test_non_multiple_cache_length(n_valid):
    (jo, jl), (to, tl) = _both(*_rand(2, 50, 4, 2, 32, seed=2), n_valid)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_empty_live_prefix_gives_zero_and_neg_inf_lse(h, kv):
    (jo, jl), (to, tl) = _both(*_rand(2, 32, h, kv, 16, seed=4), -1)
    np.testing.assert_array_equal(jo, 0.0)
    np.testing.assert_array_equal(to.numpy(), 0.0)
    assert (jl < 0.99 * NEG_INF).all() and (tl.numpy() < 0.99 * NEG_INF).all()
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


def test_bf16_dtype_roundtrip():
    q, k, v = _rand(1, 32, 4, 4, 32, seed=3)
    (jo, jl), (to, tl) = _both(q, k, v, 31, block_k=512,
                               jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(), jo, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


def test_with_lse_false_returns_the_output_only():
    q, k, v = (torch.from_numpy(x) for x in _rand(2, 24, 4, 2, 16, seed=5))
    out = flash_decode_attention(q, k, v, 11)
    ref, _ = flash_decode_attention_plain(q, k, v, 11)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_bad_head_ratio_rejected():
    q, k, v = (torch.from_numpy(x) for x in _rand(1, 16, 4, 4, 8))
    with pytest.raises(ValueError, match="divisible"):
        flash_decode_attention(q, k[:, :, :3], v[:, :, :3], 3)
