"""The Mixture-of-Experts flagship on the card against the same runs on the
CPU (the kernels' plain versions): training on one device and over
``("dp", "ep")`` meshes of one CUDA device's ranks (kernels 1-3 in the
attention, kernel 6 summing the experts' partial outputs), and greedy
generation (kernel 4 for each decode step). Skips where there is no CUDA
device (the kernels have no CPU mode); the CPU parity with the JAX package
is in ``test_torch_moe.py`` and ``test_torch_expert_parallel.py``.

float32 throughout. Tolerances from summation order (cuBLAS and the
kernels against the CPU's products): losses atol = rtol = 1e-5, parameters
after three sgd steps atol 1e-4, rtol 1e-5, as
``test_torch_tensor_parallel_kernels.py`` explains. A rounding difference
near a tie would flip a token's expert; the routing decisions are compared
first, so such a flip shows as itself.
"""

import importlib

import pytest
import torch

from mpi_tpu_torch.models import (TransformerConfig, generate, init_params,
                                  make_train_step)
from mpi_tpu_torch.ops.attention import flash_fwd
from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
from mpi_tpu_torch.ops.ring_collectives import ring_allreduce
from mpi_tpu_torch.parallel import RankMesh
from mpi_tpu_torch.parallel.zero import tree_leaves

moe = importlib.import_module("mpi_tpu_torch.models.moe")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
CFG = TransformerConfig(vocab=64, d_model=256, n_heads=4, n_layers=2,
                        d_ff=256, max_seq=65, attention_impl="flash",
                        decode_attention="flash", n_experts=4, moe_top_k=2)
MESHES = {"one": None, "ep4": (1, 4), "dp2_ep2": (2, 2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


def _routes(monkeypatch):
    """Each routing's (topk_idx, kept), recorded in call order."""
    seen, route = [], moe.route

    def recording(*args):
        out = route(*args)
        seen.append((out[2].cpu(), out[3].cpu()))
        return out

    monkeypatch.setattr(moe, "route", recording)
    return seen


def _train(dev, name, steps=3):
    """(losses, full parameters, launches of kernels 1 and 6 a step)."""
    shape = MESHES[name]
    mesh = None if shape is None else RankMesh(
        [dev] * (shape[0] * shape[1]), ("dp", "ep"), shape)
    init_state, step = make_train_step(CFG, mesh=mesh, optimizer="sgd")
    state = init_state(torch.Generator().manual_seed(0), dev)
    tokens = torch.randint(0, CFG.vocab, (4, CFG.max_seq),
                           generator=torch.Generator().manual_seed(1))
    losses, launches = [], []
    for _ in range(steps):
        before = (flash_fwd.launches, ring_allreduce.launches)
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append((flash_fwd.launches - before[0],
                         ring_allreduce.launches - before[1]))
    return (losses, [x.detach().cpu() for x in tree_leaves(state["params"])],
            launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MESHES))
def test_moe_step_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    seen = _routes(monkeypatch)
    losses, params, launches = _train(cuda, name)
    card_routes = list(seen)
    seen.clear()
    want_losses, want_params, _ = _train(torch.device("cpu"), name)
    assert len(card_routes) == len(seen)
    for (i1, k1), (i2, k2) in zip(card_routes, seen):
        assert torch.equal(i1, i2) and torch.equal(k1, k2)
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want_losses), **LOSS)
    for got, want in zip(params, want_params):
        torch.testing.assert_close(got, want, **PARAMS)
    # Counted from the code: each dp rank runs kernel 1 once a layer and,
    # under ep, kernel 6 twice a layer (the experts' partial outputs, the
    # gradient to their input); a dp axis above 1 adds the fractions of
    # first choices and the gradient bucket.
    dp, ep = MESHES[name] or (1, 1)
    k6 = dp * 2 * CFG.n_layers * (ep > 1) + 2 * (dp > 1)
    assert launches == [(dp * CFG.n_layers, k6)] * 3


@pytest.mark.cuda
def test_moe_generate_on_the_card_matches_the_cpu(cuda, monkeypatch):
    seen = _routes(monkeypatch)
    prompt = torch.randint(0, CFG.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(2))
    params = init_params(CFG, torch.Generator().manual_seed(0), cuda)
    before = flash_decode_attention.launches
    got = generate(params, prompt, CFG, 12)
    assert flash_decode_attention.launches - before == CFG.n_layers * 11
    card_routes = list(seen)
    seen.clear()
    cpu_params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    want = generate(cpu_params, prompt, CFG, 12, device="cpu")
    assert len(card_routes) == len(seen)
    for (i1, k1), (i2, k2) in zip(card_routes, seen):
        assert torch.equal(i1, i2) and torch.equal(k1, k2)
    assert torch.equal(got.cpu(), want)
