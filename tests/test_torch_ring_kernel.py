"""Kernels 5-7 (ring all-gather, all-reduce, static send/receive) against
their plain PyTorch versions, on the card. Skips where there is no CUDA
device: the kernels have no CPU mode.

Tolerance 0. The send/receive kernel takes the same hops in the same order
as its plain version. The all-gather kernel is one pass that copies each
chunk straight to every rank, which is what the plain version's hops leave
there, since each hop only copies. The all-reduce kernel is one pass,
but folds each chunk in the ring's order and rounds to the working dtype at
each fold, as the plain version's hops do (tests/test_torch_ring_onepass.py
proves the order on the CPU). So the outputs must be equal bit for bit; the
one exception is a NaN's payload (the kernel rounds a bf16 NaN to the
canonical one of the cvt instruction, PyTorch to its own), so NaNs are
compared by position.
"""

import pytest
import torch

from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                ring_allgather_plain,
                                                ring_allreduce,
                                                ring_allreduce_plain,
                                                ring_allreduce_sharded)
from mpi_tpu_torch.parallel import make_mesh, sendrecv, sendrecv_plain

N_PATTERN = 8
PATTERNS = {
    "ring": [(r, (r + 1) % N_PATTERN) for r in range(N_PATTERN)],
    "reverse_ring": [(r, (r - 1) % N_PATTERN) for r in range(N_PATTERN)],
    "partial": [(0, 4), (4, 0), (2, 3)],
    "self_pair": [(1, 1), (0, 5), (5, 0), (6, 7)],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, NaNs compared by position."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.masked_fill(nan, 0).view(ints),
                       b.masked_fill(nan, 0).view(ints))


def _contribs(cuda, n, rows, inner, op, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if op == "prod":  # keep the product of n factors in range
        x = torch.rand(n, rows, inner, generator=g, device=cuda) + 0.5
    else:
        x = torch.randn(n, rows, inner, generator=g, device=cuda)
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 64])
@pytest.mark.parametrize("rows,inner", [(2, 3), (512, 8)])
def test_allreduce_kernel_matches_plain(cuda, n, op, dtype, rows, inner):
    # rows 2 x inner 3: chunks of 6 elements, element-wide path; rows 512 x
    # inner 8: 16-byte path.
    x = _contribs(cuda, n, rows * n, inner, op, dtype, seed=n)
    mesh = make_mesh(devices=[cuda] * n)
    before = ring_allreduce.launches
    got = ring_allreduce(x, mesh, op)
    want = ring_allreduce_plain(x, op)
    torch.cuda.synchronize()
    assert ring_allreduce.launches == before + 1
    assert same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allreduce_kernel_padding_path(cuda, dtype):
    x = _contribs(cuda, 4, 5, 3, "sum", dtype, seed=11)
    mesh = make_mesh(devices=[cuda] * 4)
    got = ring_allreduce_sharded(x, mesh)
    padded = torch.cat([x, x.new_zeros(4, 3, 3)], dim=1)
    assert same(got, ring_allreduce_plain(padded)[0, :5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["max", "min"])
def test_allreduce_kernel_propagates_nan(cuda, op, dtype):
    x = _contribs(cuda, 4, 8, 3, op, dtype, seed=5)
    x[2, 3, 1] = float("nan")
    got = ring_allreduce(x, make_mesh(devices=[cuda] * 4), op)
    assert torch.isnan(got[:, 3, 1]).all()
    assert same(got, ring_allreduce_plain(x, op))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 8])
def test_allreduce_kernel_unaligned_buffers(cuda, n, dtype):
    # Chunks of 64 elements but buffers that start 1 element past 16 bytes:
    # the element-wide path, though every chunk is a multiple of 16 bytes.
    x = _contribs(cuda, n, 64 * n + 1, 1, "sum", dtype, seed=n)
    x = x.reshape(-1)[1:1 + n * 64 * n].reshape(n, 64 * n)
    assert x.data_ptr() % 16
    mesh = make_mesh(devices=[cuda] * n)
    before = ring_allreduce.launches
    got = ring_allreduce(x, mesh)
    torch.cuda.synchronize()
    assert ring_allreduce.launches == before + 1
    assert same(got, ring_allreduce_plain(x))


@pytest.mark.cuda
def test_allreduce_kernel_large_grid(cuda):
    # More work per hop than the resident grid covers in one pass.
    x = _contribs(cuda, 8, 8 * 40_000, 16, "sum", torch.float32, seed=3)
    got = ring_allreduce(x, make_mesh(devices=[cuda] * 8))
    assert same(got, ring_allreduce_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("rows,inner", [(3, 2), (1024, 8)])
def test_allgather_kernel_matches_plain(cuda, n, dtype, rows, inner):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randn(rows * n, inner, generator=g, device=cuda) * 100
         ).to(dtype)
    mesh = make_mesh(devices=[cuda] * n)
    before = ring_allgather.launches
    got = ring_allgather(x, mesh)
    want = ring_allgather_plain(x, n)
    torch.cuda.synchronize()
    assert ring_allgather.launches == before + 1
    assert same(got, want)
    assert all(torch.equal(got[r], x) for r in range(n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 8])
def test_allgather_kernel_unaligned_buffers(cuda, n, dtype):
    # Chunks of 64 elements but an input that starts 1 element past 16
    # bytes: the element-wide path, though every chunk is a multiple of 16
    # bytes.
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(64 * n + 1, generator=g, device=cuda).to(dtype)[1:]
    assert x.data_ptr() % 16
    mesh = make_mesh(devices=[cuda] * n)
    before = ring_allgather.launches
    got = ring_allgather(x, mesh)
    torch.cuda.synchronize()
    assert ring_allgather.launches == before + 1
    assert same(got, ring_allgather_plain(x, n))
    assert all(torch.equal(got[r], x) for r in range(n))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [3_000_000, 3_000_001])
def test_allgather_kernel_large_grid(cuda, chunk):
    # More units per chunk than the resident grid covers in one batch, on
    # the 16-byte path (chunk 3_000_000) and the element path.
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(8 * chunk, generator=g, device=cuda).to(torch.bfloat16)
    got = ring_allgather(x, make_mesh(devices=[cuda] * 8))
    assert same(got, ring_allgather_plain(x, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("block", [(8, 128), (3, 5)])
def test_sendrecv_kernel_matches_plain(cuda, pattern, dtype, block):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(N_PATTERN, *block, generator=g, device=cuda).to(dtype)
    mesh = make_mesh(devices=[cuda] * N_PATTERN)
    before = sendrecv.launches
    got = sendrecv(x, mesh, PATTERNS[pattern])
    want = sendrecv_plain(x, PATTERNS[pattern])
    torch.cuda.synchronize()
    assert sendrecv.launches == before + 1
    assert same(got, want)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    mesh = make_mesh(devices=[cuda] * 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ring_allreduce(torch.zeros(2, 4, dtype=torch.float64, device=cuda),
                       mesh)
    with pytest.raises(TypeError, match="2- or 4-byte"):
        ring_allgather(torch.zeros(4, dtype=torch.int8, device=cuda), mesh)
    with pytest.raises(TypeError, match="2- or 4-byte"):
        sendrecv(torch.zeros(2, 3, dtype=torch.float64, device=cuda), mesh,
                 [(0, 1)])
    with pytest.raises(ValueError, match="contiguous"):
        ring_allreduce(torch.zeros(4, 2, device=cuda).t(), mesh)
