"""The port's flash attention (plain path, CPU) against the JAX package's.

The same numpy inputs go to both. JAX runs its Pallas flash kernels in
interpret mode on the CPU, as its own tests do; a ragged length passes
small blocks on the JAX side only (its kernels need blocks that divide the
sequence; the port's take any length). Checked: out and lse
(``flash_attention_with_lse``), the gradients of ``flash_attention``
(``jax.vjp`` against ``torch.autograd``), ``flash_chunk_bwd`` and
``flash_bwd_dq_delta`` (dq, and delta against a numpy rowsum), over
causal / non-causal x MHA / GQA (kv 2, kv 1) x even / ragged length x
float32 / bf16.

Tolerances. float32: atol = rtol = 1e-5 for out and lse, 1e-4 for
gradients (summation order only). bf16: the inputs and outputs are bf16
(one ulp is 2**-8 relative) and the JAX kernel rounds p to bf16 at each
key block's running max where the plain version rounds it at the row's
global max, so out gets atol = rtol = 2e-2, lse (float32 in both) 1e-3,
and gradients, which go through two bf16 roundings (p or ds, then the
output), atol = rtol = 2e-2 (the largest difference seen is 2**-7).
delta = rowsum(dout * out) is float32 from the stored values on both sides
and differs by summation order only: atol = rtol = 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.ops import attention as jax_attention  # noqa: E402
from mpi_tpu_torch.ops import (dense_attention, flash_attention,  # noqa
                               flash_attention_bwd_plain,
                               flash_attention_fwd_plain,
                               flash_attention_with_lse, flash_bwd_dkv,
                               flash_bwd_dq, flash_bwd_dq_delta,
                               flash_chunk_bwd, flash_fwd)

B, H, D = 2, 4, 16
TOL = {
    "float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                "grad": (1e-4, 1e-4)},
    "bfloat16": {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-3),
                 "grad": (2e-2, 2e-2)},
}
DELTA_TOL = (1e-5, 1e-5)
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# name -> (s, JAX block size): "ragged" is no multiple of the port's tiles.
LENGTHS = {"even": (32, None), "ragged": (40, 8)}


def _arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    raw = [rng.standard_normal(shape).astype(np.float32) for shape in shapes]
    jx = [jnp.asarray(a, dtype=JAX_DTYPE[dtype]) for a in raw]
    # The torch copies hold the very values JAX holds (bf16-rounded alike).
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        TORCH_DTYPE[dtype]) for a in jx]
    return jx, tx


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().detach().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol[0], rtol=tol[1])


def _qkv(s, t, kv, dtype, seed=0):
    return _arrays([(B, s, H, D), (B, t, kv, D), (B, t, kv, D),
                    (B, s, H, D)], dtype, seed)


CASES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
GRID = [pytest.mark.parametrize("causal", [True, False]),
        pytest.mark.parametrize("kv", [H, 2, 1], ids=["mha", "kv2", "kv1"]),
        pytest.mark.parametrize("length", list(LENGTHS)), CASES]


def _grid(fn):
    for mark in GRID:
        fn = mark(fn)
    return fn


@_grid
def test_forward_out_and_lse_match_jax(causal, kv, length, dtype):
    s, blk = LENGTHS[length]
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkv(s, s, kv, dtype)
    want_out, want_lse = jax_attention.flash_attention_with_lse(
        jq, jk, jv, causal, blk, blk)
    out, lse = flash_attention_with_lse(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, s)
    _close(out, want_out, TOL[dtype]["out"])
    _close(lse, want_lse, TOL[dtype]["lse"])


@_grid
def test_gradients_match_jax_vjp(causal, kv, length, dtype):
    s, blk = LENGTHS[length]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _qkv(s, s, kv, dtype, seed=1)
    out_j, vjp = jax.vjp(
        lambda q, k, v: jax_attention.flash_attention(q, k, v, causal, blk,
                                                      blk), jq, jk, jv)
    want = vjp(jg)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(tg)
    _close(out, out_j, TOL[dtype]["out"])
    for name, x, w in zip("qkv", leaves, want):
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape, name
        _close(x.grad, w, TOL[dtype]["grad"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [H, 2, 1], ids=["mha", "kv2", "kv1"])
@pytest.mark.parametrize("s,t,blk", [(32, 32, None), (32, 48, 16),
                                     (40, 24, 8)],
                         ids=["square", "longer_kv", "ragged"])
@CASES
def test_chunk_bwd_matches_jax(causal, kv, s, t, blk, dtype):
    """One (query chunk, kv chunk) pair, s != t included: the backward
    kernels' contract against the global softmax rows. Kernel 2 computing
    delta from out (``flash_bwd_dq_delta``) gives the same dq, and delta
    agrees with a numpy rowsum of dout * out."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _qkv(s, t, kv, dtype, seed=2)
    j_out, j_lse = jax_attention.flash_attention_with_lse(jq, jk, jv, causal,
                                                          blk, blk)
    want = jax_attention.flash_chunk_bwd(jq, jk, jv, j_out, j_lse, jg,
                                         causal, blk, blk)
    out = torch.from_numpy(_np(j_out)).to(tq.dtype)
    lse = torch.from_numpy(_np(j_lse))
    got = flash_chunk_bwd(tq, tk, tv, out, lse, tg, causal)
    for x, w in zip(got, want):
        _close(x, w, TOL[dtype]["grad"])
    dq, delta = flash_bwd_dq_delta(tq, tk, tv, tg, lse, out, causal)
    assert dq.dtype == tq.dtype and dq.shape == tq.shape
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (B, H, s)
    _close(dq, want[0], TOL[dtype]["grad"])
    want_delta = (_np(jg) * _np(j_out)).sum(-1).transpose(0, 2, 1)
    _close(delta, want_delta, DELTA_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_matches_dense_oracle(causal):
    (_, _, _, _), (tq, tk, tv, _) = _qkv(24, 24, H, "float32", seed=3)
    out, _ = flash_attention_fwd_plain(tq, tk, tv, causal)
    _close(out, dense_attention(tq, tk, tv, causal), TOL["float32"]["out"])


def test_kernel_wrappers_on_cpu_are_the_plain_versions():
    (_, _, _, _), (tq, tk, tv, tg) = _qkv(24, 24, 2, "float32", seed=4)
    out, lse = flash_fwd(tq, tk, tv, True)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, True)
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(flash_bwd_dq(tq, tk, tv, tg, lse, delta), dq)
    got_dk, got_dv = flash_bwd_dkv(tq, tk, tv, tg, lse, delta)
    torch.testing.assert_close(got_dk, dk)
    torch.testing.assert_close(got_dv, dv)


def test_indivisible_heads_and_bad_rows_raise():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, k, k)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="lse/delta"):
        flash_bwd_dq(q, k, k, q, torch.zeros(1, 4, 7), torch.zeros(1, 4, 8))
