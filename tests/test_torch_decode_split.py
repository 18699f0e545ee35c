"""The split-key schedule of the flash-decode kernel, held against the plain
version and the JAX package's kernel on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``) splits the t cache positions
of each (b, kv head) over a cluster of S = ``kernel_splits(...)`` blocks:
block r takes positions ``[r t // S, (r + 1) t // S)`` of the live prefix,
leaves its partial softmax state (m, l, acc) in shared memory, and block 0
merges the S partials in rank order. :func:`split_replay` below writes that
schedule out in plain PyTorch, and these tests hold it against
``flash_decode_attention_plain`` and against the JAX
``flash_decode_attention`` (its Pallas kernel in interpret mode, as
tests/test_torch_decode_attention.py runs it) on the same numpy inputs. So
the split and the merge are proven before the kernel runs; the CUDA-gated
tests hold the kernel against the plain version on the card.

Tolerance: float32 atol = rtol = 1e-5, summation order only.
"""

import functools
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.ops.decode_attention import \
    flash_decode_attention as jax_decode  # noqa: E402
from mpi_tpu_torch.ops.decode_attention import (  # noqa: E402
    NEG_INF, _load_unit, flash_decode_attention, flash_decode_attention_plain,
    kernel_splits)

TOL = dict(rtol=1e-5, atol=1e-5)
B, KV, HD, T = 2, 2, 32, 52  # t = 52: no split boundary is a multiple of 8

_jax_decode = jax.jit(jax_decode, static_argnames=("block_k", "with_lse"))


def split_replay(q, k, v, n_valid, splits):
    """(out, lse) of the kernel's schedule: each block's (m, l, acc) over
    its positions of the live prefix in the plain arithmetic (float32
    state, p rounded to v's dtype for PV), an empty block (m = -1e30,
    l = 0, acc = 0) past it, and the merge in rank order."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).float()
    n_live = max(0, min(n_valid + 1, t))
    parts = []
    for r in range(splits):
        lo, hi = r * t // splits, min(n_live, (r + 1) * t // splits)
        if hi <= lo:
            m = torch.full(qg.shape[:3], NEG_INF)
            parts.append((m, torch.zeros_like(m), torch.zeros_like(qg)))
            continue
        s = torch.einsum("bKgk,btKk->bKgt", qg, k[:, lo:hi].float()) * (
            1.0 / math.sqrt(hd))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bKgt,btKk->bKgk", p.to(v.dtype).float(),
                           v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1), acc))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lt = torch.zeros_like(mx)
    acc = torch.zeros_like(qg)
    for m, l, a in parts:
        w = torch.exp(m - mx)
        lt = lt + l * w
        acc = acc + a * w[..., None]
    lt = lt.clamp_min(1e-30)
    return ((acc / lt[..., None]).to(q.dtype).reshape(b, h, hd),
            (mx + torch.log(lt)).reshape(b, h))


def _inputs(group):
    rng = np.random.default_rng(group)
    h = KV * group
    return (rng.standard_normal((B, h, HD)).astype(np.float32),
            rng.standard_normal((B, T, KV, HD)).astype(np.float32),
            rng.standard_normal((B, T, KV, HD)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_result(group, n_valid):
    jo, jl = _jax_decode(*(jnp.asarray(x) for x in _inputs(group)),
                         jnp.int32(n_valid), block_k=16, with_lse=True)
    return np.asarray(jo), np.asarray(jl)


def _n_valid(case, splits):
    edge = T // splits if splits > 1 else T // 2  # the first split's end
    return {"empty": -1, "first": 0, "before_edge": edge - 1,
            "at_edge": edge, "last": T - 1}[case]


@pytest.mark.parametrize("case", ["empty", "first", "before_edge",
                                  "at_edge", "last"])
@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_replay_matches_plain_and_jax(splits, group, case):
    n_valid = _n_valid(case, splits)
    q, k, v = (torch.from_numpy(x) for x in _inputs(group))
    out, lse = split_replay(q, k, v, n_valid, splits)
    ref, ref_lse = flash_decode_attention_plain(q, k, v, n_valid)
    torch.testing.assert_close(out, ref, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)
    jo, jl = _jax_result(group, n_valid)
    np.testing.assert_allclose(out.numpy(), jo, **TOL)
    np.testing.assert_allclose(lse.numpy(), jl, **TOL)
    if n_valid < 0:  # every split empty
        assert (out == 0).all() and (lse < -1e29).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_kernel_splits_invariants(hd, dtype):
    unit = _load_unit(dtype, hd)
    assert unit > 0
    for b in (1, 2, 8, 64):
        for kv in (1, 2, 8):
            for group in (1, 2, 3, 4, 8, 16):
                for t in (1, 17, 64, 200, 256, 4096, 8192):
                    for sms in (1, 132):
                        s = kernel_splits(b, kv, kv * group, t, hd, dtype,
                                          sms)
                        assert 1 <= s <= 8
                        assert s == 1 or b * kv * -(-group // min(
                            8, 1 << (group - 1).bit_length())) * s <= sms
                        spans = [(r + 1) * t // s - r * t // s
                                 for r in range(s)]
                        assert s == 1 or min(spans) >= 4 * unit, (
                            b, kv, group, t, sms, s, spans)


def test_kernel_splits_at_the_flagship_decode_shape():
    # b 8, h = kv 8, hd 128, bf16 on 132 SMs: one block per (b, kv head)
    # at t 256 (64 blocks of four 64-key load units: no cluster), 2 per
    # cluster from t 512, 128 blocks.
    assert _load_unit(torch.bfloat16, 128) == 64
    assert kernel_splits(8, 8, 8, 256, 128, torch.bfloat16, 132) == 1
    assert kernel_splits(8, 8, 8, 512, 128, torch.bfloat16, 132) == 2
    assert kernel_splits(8, 8, 8, 8192, 128, torch.bfloat16, 132) == 2
    # One cluster of few rows takes all 8 blocks; a short cache one.
    assert kernel_splits(1, 1, 8, 4096, 128, torch.bfloat16, 132) == 8
    assert kernel_splits(1, 1, 8, 1024, 128, torch.bfloat16, 132) == 4


@pytest.mark.parametrize("n_valid", [-1, 0, 17, T - 1, T + 5])
def test_tensor_n_valid_gives_the_int_result(n_valid):
    q, k, v = (torch.from_numpy(x) for x in _inputs(2))
    want = flash_decode_attention(q, k, v, n_valid, with_lse=True)
    got = flash_decode_attention(q, k, v, torch.tensor(n_valid,
                                                       dtype=torch.int32),
                                 with_lse=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
