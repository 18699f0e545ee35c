"""The CUDA flash-decode kernel against its plain PyTorch version, on the
card. Skips where there is no CUDA device (the kernel has no CPU mode).

Tolerances as in chip_smoke.py: float32 atol = rtol = 1e-5 (summation
order); bfloat16 out atol 2e-2, rtol 1e-2 (p rounded to bf16 at each key
group's running max, output rounded to bf16), lse atol 1e-3.
"""

import pytest
import torch

from mpi_tpu_torch.ops.decode_attention import (
    _load_unit, _sm_count, flash_decode_attention,
    flash_decode_attention_plain, kernel_splits, kernel_tile)

TOL = {torch.float32: ((1e-5, 1e-5), (1e-5, 1e-5)),
       torch.bfloat16: ((2e-2, 1e-2), (1e-3, 1e-5))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,t", [(8, 8, 8, 128, 256),
                                         (2, 8, 2, 64, 200),
                                         (2, 16, 1, 64, 100),
                                         (3, 12, 4, 256, 90)])
def test_kernel_matches_plain(cuda, dtype, b, h, kv, hd, t):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    (out_tol, lse_tol) = TOL[dtype]
    tile = kernel_tile(dtype, hd)
    assert tile == _load_unit(dtype, hd)
    for n_valid in (-1, 0, tile - 1, tile, t - 1):
        before = flash_decode_attention.launches
        out, lse = flash_decode_attention(q, k, v, n_valid, with_lse=True)
        ref, ref_lse = flash_decode_attention_plain(q, k, v, n_valid)
        torch.cuda.synchronize()
        assert flash_decode_attention.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=out_tol[0], rtol=out_tol[1])
        torch.testing.assert_close(lse, ref_lse, atol=lse_tol[0],
                                   rtol=lse_tol[1])


def _n_valid_cases(b, h, kv, hd, t, dtype):
    """-1, 0, t - 1, the load unit's edges, and each split edge - 1 and
    edge of the split the wrapper picks."""
    s = kernel_splits(b, kv, h, t, hd, dtype, _sm_count(0))
    unit = _load_unit(dtype, hd)
    edges = [r * t // s for r in range(1, s)]
    cases = {-1, 0, unit - 1, unit, t - 1, *edges, *(e - 1 for e in edges)}
    return s, sorted(n for n in cases if n < t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,hd,t", [(8, 8, 8, 128, 4096),
                                         (1, 8, 2, 128, 4096),
                                         (1, 32, 2, 64, 4000),
                                         (2, 4, 4, 256, 777)])
def test_kernel_splits_match_plain_and_repeat(cuda, dtype, b, h, kv, hd, t):
    """Shapes with several blocks per cluster, n_valid at every split edge
    (empty trailing splits included), a device n_valid, and bitwise
    repeats."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    (out_tol, lse_tol) = TOL[dtype]
    splits, cases = _n_valid_cases(b, h, kv, hd, t, dtype)
    assert splits > 1
    for n_valid in cases:
        out, lse = flash_decode_attention(q, k, v, n_valid, with_lse=True)
        dev_n = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
        before = flash_decode_attention.launches
        out2, lse2 = flash_decode_attention(q, k, v, dev_n, with_lse=True)
        assert flash_decode_attention.launches == before + 1
        ref, ref_lse = flash_decode_attention_plain(q, k, v, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(out, out2) and torch.equal(lse, lse2), n_valid
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=out_tol[0], rtol=out_tol[1])
        torch.testing.assert_close(lse, ref_lse, atol=lse_tol[0],
                                   rtol=lse_tol[1])
        if n_valid < 0:
            assert (out == 0).all() and (lse < -1e29).all()


@pytest.mark.cuda
def test_device_n_valid_needs_no_host_value(cuda):
    """n_valid on the card, written by a kernel that is still queued: the
    launch takes its pointer, and the result is the one for its value."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, 8, 128, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, 512, 8, 128, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    n = torch.zeros((), dtype=torch.int32, device=cuda)
    torch.cuda._sleep(10_000_000)
    n.fill_(300)
    out = flash_decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_decode_attention(q, k, v, 300))
    with pytest.raises(TypeError, match="int32"):
        flash_decode_attention(q, k, v, n.to(torch.int64))
