"""The pipeline's and the halo exchange's hops on the card: kernel 7
(``parallel/p2p.py:sendrecv``) against its plain version at the shapes
and patterns the two layers give it, the pipelined flagship's steps
against the same steps on the CPU, and the Jacobi sweeps against the CPU's
bit for bit. Skips where there is no CUDA device (the kernels have no CPU
mode); the CPU parity with the JAX package is in ``test_torch_pipeline.py``
and ``test_torch_halo.py``.

Tolerances: kernel 7 and the sweeps 0 (a hop is a copy; the sweeps add
the same float32 values in the same order on both devices); the
flagship's losses atol = rtol = 1e-5 (float32, summation order of cuBLAS
and the flash kernels against the CPU's, as ``test_torch_train.py``
explains).
"""

import pytest
import torch

from mpi_tpu_torch.models import (TransformerConfig, init_pipelined_params,
                                  make_pipelined_train_step)
from mpi_tpu_torch.ops.attention import flash_fwd
from mpi_tpu_torch.parallel import (RankMesh, jacobi_step_1d, jacobi_step_2d,
                                    make_mesh, sendrecv, sendrecv_plain)
from mpi_tpu_torch.parallel.halo import _pattern
from mpi_tpu_torch.parallel.p2p import ring_hop
from mpi_tpu_torch.parallel.zero import tree_leaves

LOSS = dict(atol=1e-5, rtol=1e-5)
CFG = TransformerConfig(vocab=64, d_model=256, n_heads=4, n_layers=4,
                        d_ff=256, max_seq=65, attention_impl="flash")
PP, MICRO = 4, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_hop_matches_plain(cuda, dtype):
    """The pipeline's hop, i → i+1 mod S over the stacked (S, mb, s, d)
    activations, and its backward's reverse hop: kernel 7's bits are the
    plain version's."""
    x = torch.randn(PP, 2, 64, 256, generator=torch.Generator().manual_seed(
        0)).to(dtype)
    mesh = make_mesh(axis="pp", devices=[cuda] * PP)
    for shift in (1, -1):
        before = sendrecv.launches
        got = ring_hop(x.to(cuda), mesh, shift)
        assert sendrecv.launches == before + 1
        want = sendrecv_plain(x, [(r, (r + shift) % PP) for r in range(PP)])
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
def test_halo_edges_match_plain(cuda, periodic):
    """Both halos of a (2, 4) row × col mesh: the row edges (contiguous)
    and the column edges (strided, made contiguous), each pattern partial
    or periodic, kernel 7 against the plain version."""
    mesh = RankMesh([cuda] * 8, ("row", "col"), (2, 4))
    u = torch.randn(8, 16, 24, generator=torch.Generator().manual_seed(1))
    for axis, edge in (("row", u[:, -1:, :]), ("col", u[:, :, -1:])):
        for shift in (1, -1):
            pairs, _ = _pattern(mesh, axis, shift, periodic)
            got = sendrecv(edge.contiguous().to(cuda), mesh, pairs)
            assert torch.equal(got.cpu(),
                               sendrecv_plain(edge.contiguous(), pairs))


def _pp_train(dev, steps=2):
    """(losses, parameters, launches of kernels 1 and 7 a step) of the
    pipelined flagship over PP ranks of ``dev``."""
    mesh = make_mesh(axis="pp", devices=[dev] * PP)
    init_state, step = make_pipelined_train_step(CFG, mesh,
                                                 microbatches=MICRO)
    state = init_state.from_params(init_pipelined_params(
        CFG, torch.Generator().manual_seed(0), mesh))
    tokens = torch.randint(0, CFG.vocab, (8, CFG.max_seq),
                           generator=torch.Generator().manual_seed(1))
    losses, launches = [], []
    for _ in range(steps):
        before = (flash_fwd.launches, sendrecv.launches)
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append((flash_fwd.launches - before[0],
                         sendrecv.launches - before[1]))
    return losses, [x.detach().cpu() for x in tree_leaves(state["params"])], \
        launches


@pytest.mark.cuda
def test_pipelined_flagship_on_the_card_matches_the_cpu(cuda):
    """Two AdamW steps over pp 4 with 4 microbatches on the card against
    the same steps on the CPU. Counted from the code: kernel 1 once per
    microbatch and layer, kernel 7 M + S − 2 hops forward and as many
    backward."""
    losses, _, launches = _pp_train(cuda)
    want, _, _ = _pp_train(torch.device("cpu"))
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(want),
                               **LOSS)
    assert launches == [(MICRO * CFG.n_layers,
                         2 * (MICRO + PP - 2))] * 2


@pytest.mark.cuda
def test_jacobi_sweeps_on_the_card_match_the_cpu(cuda):
    """20 sweeps in 2-D over a (2, 4) mesh and in 1-D over 8 ranks, on the
    card and on the CPU, bit for bit; kernel 7 launches 4 a 2-D sweep and
    2 a 1-D sweep."""
    gen = torch.Generator().manual_seed(2)
    u2 = torch.randn(8, 32, 16, generator=gen)
    u1 = torch.randn(8, 64, generator=gen)
    for step, u, mesh_of, per_sweep in (
            (jacobi_step_2d, u2,
             lambda d: RankMesh([d] * 8, ("row", "col"), (2, 4)), 4),
            (jacobi_step_1d, u1, lambda d: make_mesh(devices=[d] * 8), 2)):
        got, want = u.to(cuda), u
        before = sendrecv.launches
        for _ in range(20):
            got = step(got, mesh_of(cuda), periodic=False)
            want = step(want, mesh_of("cpu"), periodic=False)
        assert sendrecv.launches - before == 20 * per_sweep
        assert torch.equal(got.cpu(), want)
