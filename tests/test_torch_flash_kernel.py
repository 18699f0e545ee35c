"""The CUDA flash-attention kernels (forward, dq, dk/dv) against their plain
PyTorch versions, on the card. Skips where there is no CUDA device (the
kernels have no CPU mode).

Tolerances as in chip_smoke.py. float32: the kernels sum in another order
than cuBLAS, so out and lse get atol = rtol = 1e-5 and the gradients, sums
over up to a thousand rows, atol = rtol = 1e-4. bfloat16: the forward
kernel rounds p to bf16 at each key tile's running max where the plain
version rounds it at the row's global max, and every output is bf16 (one
ulp is 2**-8 relative), so out and the gradients get atol = rtol = 2e-2;
lse is float32 in both and gets 1e-3. delta = rowsum(dout * out), which
kernel 2 computes in float32 from the stored values as the plain version
does, differs by summation order only: atol = rtol = 1e-5 in both dtypes.
"""

import pytest
import torch

from mpi_tpu_torch.ops.attention import (_bwd_plain, _delta,
                                         flash_attention,
                                         flash_attention_bwd_plain,
                                         flash_attention_fwd_plain,
                                         flash_bwd_dkv, flash_bwd_dq,
                                         flash_bwd_dq_delta,
                                         flash_chunk_bwd, flash_fwd)

TOL = {torch.float32: {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                       "grad": (1e-4, 1e-4)},
       torch.bfloat16: {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-3),
                        "grad": (2e-2, 2e-2)}}
DELTA_TOL = (1e-5, 1e-5)
SHAPES = [  # (b, s, t, h, hk, d, causal)
    (2, 256, 256, 8, 8, 128, True),     # flagship heads, short
    (2, 256, 256, 8, 2, 128, True),     # GQA
    (2, 200, 200, 4, 1, 64, True),      # MQA, ragged, head_dim 64
    (1, 1000, 1000, 2, 2, 128, False),  # ragged, non-causal
    (2, 96, 160, 4, 2, 64, False),      # s != t: a ring chunk
    (1, 160, 96, 4, 4, 128, True),      # s > t, causal
    (8193, 64, 64, 8, 8, 64, True),     # b * h = 65544 > grid y's 65535
    (8, 1024, 1024, 8, 8, 128, True),   # the flagship training shape
    (2, 127, 127, 4, 4, 128, True),     # around the 128-row and 128-key
    (2, 129, 129, 4, 2, 128, True),     # tiles and the backward's 64-row
    (1, 257, 257, 4, 4, 64, False),     # tiles
    (2, 129, 257, 4, 2, 128, True),     # s < t, causal
    (1, 257, 127, 4, 4, 64, True),      # s > t, causal
    (2, 256, 256, 8, 2, 64, True),      # GQA at head_dim 64
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,causal", SHAPES)
def test_kernels_match_plain(cuda, dtype, b, s, t, h, hk, d, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, g = (torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(b, t, hk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    tol = TOL[dtype]
    counts = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out, lse = flash_fwd(q, k, v, causal)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=tol["out"][0], rtol=tol["out"][1])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"][0],
                               rtol=tol["lse"][1])
    # The backward on the plain forward's rows, so both sides see one
    # softmax.
    got = flash_chunk_bwd(q, k, v, ref_out, ref_lse, g, causal)
    want = flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, g, causal)
    torch.cuda.synchronize()
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        torch.testing.assert_close(x.float(), w.float(),
                                   atol=tol["grad"][0], rtol=tol["grad"][1],
                                   msg=lambda m, n=name: f"{n}: {m}")
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)


def _inputs(cuda, dtype, b, s, t, h, hk, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, g = (torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(b, t, hk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    return q, k, v, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,causal", SHAPES)
def test_dq_with_delta_matches_plain(cuda, dtype, b, s, t, h, hk, d,
                                     causal):
    """Kernel 2 computing delta itself: dq against the plain backward, and
    delta against the plain rowsum; with the plain delta given instead,
    kernel 2 gives the same dq."""
    q, k, v, g = _inputs(cuda, dtype, b, s, t, h, hk, d, seed=3)
    out, lse = flash_attention_fwd_plain(q, k, v, causal)
    before = flash_bwd_dq.launches
    dq, delta = flash_bwd_dq_delta(q, k, v, g, lse, out, causal)
    assert flash_bwd_dq.launches == before + 1
    want_delta = _delta(out, g)
    want_dq = _bwd_plain(q, k, v, g, lse, want_delta, causal)[0]
    given = flash_bwd_dq(q, k, v, g, lse, want_delta, causal)
    torch.cuda.synchronize()
    assert delta.dtype == torch.float32 and delta.shape == (b, h, s)
    torch.testing.assert_close(delta, want_delta, atol=DELTA_TOL[0],
                               rtol=DELTA_TOL[1])
    atol, rtol = TOL[dtype]["grad"]
    assert dq.dtype == dtype and dq.shape == q.shape
    torch.testing.assert_close(dq.float(), want_dq.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(given.float(), want_dq.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hk,d,causal", [
    (8, 1024, 1024, 8, 8, 128, True),
    (2, 129, 257, 4, 2, 128, True),
    (1, 257, 257, 4, 1, 64, False),
])
def test_backward_repeats_bitwise(cuda, dtype, b, s, t, h, hk, d, causal):
    """Each gradient is written once, with no atomics: two calls on the
    same inputs give the same bits."""
    q, k, v, g = _inputs(cuda, dtype, b, s, t, h, hk, d, seed=4)
    out, lse = flash_fwd(q, k, v, causal)
    first = flash_chunk_bwd(q, k, v, out, lse, g, causal)
    second = flash_chunk_bwd(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x.float()).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_is_one_launch_per_call(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 200, 4, 128, generator=gen, device=cuda).to(
        dtype) for _ in range(3))
    for i in range(3):
        before = flash_fwd.launches
        flash_fwd(q, k, v, causal=bool(i % 2))
        assert flash_fwd.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_autograd_function_launches_all_three(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_(True) for _ in range(3))
    counts = (flash_fwd.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert all(bool(torch.isfinite(x.grad.float()).all()) for x in (q, k, v))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_fwd(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q, q, q)
