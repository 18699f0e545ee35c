"""The state-space LM's sequence-parallel path on the card: kernel 7 at the
linear scan's summary shape against its plain version, the sharded scan
and ``ssm_forward_sp`` with every hop on kernel 7, and greedy decode.
Skips where there is no CUDA device (the kernel has no CPU mode); the CPU
parity with the JAX package is in ``test_torch_scan.py`` and
``test_torch_ssm.py``.

Tolerances, float32 with TF32 off: the scan on the card against the same
scan on the CPU atol = rtol = 3e-5 (``tests/test_ssm.py``'s complex scan
tolerance: the card's complex products fuse multiply-adds where the CPU's
may not); the sp forward against one device 3e-3, ``tests/test_ssm.py``'s.
Kernel 7 and rank 0's chunk are held bitwise.
"""

import math

import pytest
import torch

from mpi_tpu_torch.models import (SsmConfig, init_ssm_params, ssm_decode,
                                  ssm_forward, ssm_forward_sp)
from mpi_tpu_torch.parallel import (linear_scan, make_mesh, sendrecv,
                                    sendrecv_plain, sharded_linear_scan)

SCAN_TOL = dict(atol=3e-5, rtol=3e-5)
SP_TOL = dict(atol=3e-3, rtol=3e-3)
CFG = SsmConfig(vocab=512, d_model=128, n_layers=2, d_state=64, d_ff=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


def _hops(n):
    return 0 if n == 1 else 2 * math.ceil(math.log2(n)) + 1


def _coeffs(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mod = 0.5 + 0.49 * torch.rand(shape, generator=gen, device=dev)
    phase = 3 * torch.rand(shape, generator=gen, device=dev)
    b = torch.complex(torch.randn(shape, generator=gen, device=dev),
                      torch.randn(shape, generator=gen, device=dev))
    return torch.polar(mod, phase), b


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, 2, 4, -1])
def test_hop_at_the_summary_shape_matches_plain(cuda, shift):
    """(8 ranks, batch 8, d_state 256) complex64 as float32 pairs."""
    gen = torch.Generator(device=cuda).manual_seed(shift)
    x = torch.randn(8, 8, 256, 2, generator=gen, device=cuda)
    perm = [(r, (r + shift) % 8) for r in range(8)]
    mesh = make_mesh(axis="sp", devices=[cuda] * 8)
    before = sendrecv.launches
    got = sendrecv(x, mesh, perm)
    assert sendrecv.launches == before + 1
    assert torch.equal(got, sendrecv_plain(x, perm))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_scan_on_the_card(cuda, n):
    a, b = _coeffs((n, 4, 64, 32), cuda, seed=n)
    mesh = make_mesh(axis="sp", devices=[cuda] * n)
    before = sendrecv.launches
    got = sharded_linear_scan(a, b, mesh, dim=1)
    torch.cuda.synchronize()
    assert sendrecv.launches - before == _hops(n)
    whole = linear_scan(torch.cat(list(a), 1), torch.cat(list(b), 1), dim=1)
    torch.testing.assert_close(torch.cat(list(got), 1), whole, **SCAN_TOL)
    cpu = sharded_linear_scan(a.cpu(), b.cpu(), make_mesh(
        axis="sp", devices=["cpu"] * n), dim=1)
    torch.testing.assert_close(got.cpu(), cpu, **SCAN_TOL)
    assert torch.equal(got[0], linear_scan(a[0], b[0], dim=1))


@pytest.mark.cuda
def test_sharded_scan_backward_hops_on_the_card(cuda):
    n = 8
    a, b = _coeffs((n, 2, 16, 8), cuda, seed=11)
    a.requires_grad_()
    b.requires_grad_()
    mesh = make_mesh(axis="sp", devices=[cuda] * n)
    out = sharded_linear_scan(a, b, mesh, dim=1)
    before = sendrecv.launches
    out.real.sum().backward()
    torch.cuda.synchronize()
    # Every hop but the last round's a-summary, which reaches no output.
    assert sendrecv.launches - before == _hops(n) - 1
    a_cpu = a.detach().cpu().requires_grad_()
    b_cpu = b.detach().cpu().requires_grad_()
    sharded_linear_scan(a_cpu, b_cpu, make_mesh(
        axis="sp", devices=["cpu"] * n), dim=1).real.sum().backward()
    torch.testing.assert_close(a.grad.cpu(), a_cpu.grad, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(b.grad.cpu(), b_cpu.grad, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_forward_sp_and_decode_on_the_card(cuda):
    n = 8
    params = init_ssm_params(CFG, torch.Generator().manual_seed(0), cuda)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, CFG.vocab, (2, n * 32), generator=gen)
    mesh = make_mesh(axis="sp", devices=[cuda] * n)
    with torch.no_grad():
        one = ssm_forward(CFG, params, toks)
        before = sendrecv.launches
        got = ssm_forward_sp(CFG, params, toks, mesh)
        torch.cuda.synchronize()
        assert sendrecv.launches - before == CFG.n_layers * _hops(n)
        torch.testing.assert_close(got, one, **SP_TOL)
        out = ssm_decode(CFG, params, toks[:, :16], 24)
        full = ssm_forward(CFG, params, out[:, :-1])
    assert out.shape == (2, 40) and out.device.type == "cuda"
    assert torch.equal(out[:, 16:], full[:, 15:].argmax(-1))
