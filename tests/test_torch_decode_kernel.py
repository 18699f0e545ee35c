"""The CUDA flash-decode kernel against its plain PyTorch version, on the
card. Skips where there is no CUDA device (the kernel has no CPU mode).

Tolerances as in chip_smoke.py: float32 atol = rtol = 1e-5 (summation
order); bfloat16 out atol 2e-2, rtol 1e-2 (p rounded to bf16 at each tile's
running max, output rounded to bf16), lse atol 1e-3.
"""

import pytest
import torch

from mpi_tpu_torch.ops.decode_attention import (
    flash_decode_attention, flash_decode_attention_plain, kernel_tile)

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
