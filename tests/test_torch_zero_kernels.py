"""Data-parallel training on the card: plain dp, ZeRO-1 and FSDP over 8 dp
ranks of one CUDA device (kernel 6 reduces the gradients, kernel 5 gathers
parameters, kernels 1-3 run each rank's attention) against the same steps
on the CPU (the kernels' plain versions), and the sharded modes against
plain dp bit for bit. Skips where there is no CUDA device (the kernels
have no CPU mode); the CPU parity with the JAX package is in
``test_torch_zero.py``.

Tolerances, float32 and from summation order (cuBLAS and the flash
kernels against the CPU's products): losses atol = rtol = 1e-5,
parameters after two AdamW steps atol 1e-4, rtol 1e-5, as
``test_torch_train.py`` explains.
"""

import pytest
import torch

from mpi_tpu_torch.models import TransformerConfig, make_train_step
from mpi_tpu_torch.models.transformer import full_params
from mpi_tpu_torch.ops.attention import flash_fwd
from mpi_tpu_torch.ops.ring_collectives import ring_allgather, ring_allreduce
from mpi_tpu_torch.parallel import RankMesh
from mpi_tpu_torch.parallel.zero import tree_leaves

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
CFG = TransformerConfig(vocab=64, d_model=256, n_heads=4, n_layers=2,
                        d_ff=256, max_seq=65, attention_impl="flash")
MODES = {"dp": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
N = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


def _train(dev, mode, steps=2):
    """(losses, full parameters, launches of kernels 1, 5 and 6 a step)."""
    init_state, step = make_train_step(
        CFG, mesh=RankMesh([dev] * N, ("dp",)), **MODES[mode])
    state = init_state(torch.Generator().manual_seed(0), dev)
    tokens = torch.randint(0, CFG.vocab, (N, CFG.max_seq),
                           generator=torch.Generator().manual_seed(1))
    losses, launches = [], []
    for _ in range(steps):
        before = (flash_fwd.launches, ring_allgather.launches,
                  ring_allreduce.launches)
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append(tuple(c - b for c, b in zip(
            (flash_fwd.launches, ring_allgather.launches,
             ring_allreduce.launches), before)))
    return losses, [x.detach().cpu() for x in tree_leaves(full_params(state))], \
        launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_dp_step_on_the_card_matches_the_cpu(cuda, mode):
    losses, params, launches = _train(cuda, mode)
    want_losses, want_params, _ = _train(torch.device("cpu"), mode)
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want_losses), **LOSS)
    for got, want in zip(params, want_params):
        torch.testing.assert_close(got, want, **PARAMS)
    # Counted from the code: every rank runs kernel 1 once per layer; one
    # kernel-6 launch; kernel 5 once (zero1) or, per rank, for the top
    # group and each block (fsdp). Every leaf of CFG divides by 8.
    k5 = {"dp": 0, "zero1": 1, "fsdp": N * (1 + CFG.n_layers)}[mode]
    assert launches == [(N * CFG.n_layers, k5, 1)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_give_plain_dps_bits_on_the_card(cuda, mode):
    losses, params, _ = _train(cuda, mode)
    want_losses, want_params, _ = _train(cuda, "dp")
    assert losses == want_losses
    for got, want in zip(params, want_params):
        assert torch.equal(got, want)
