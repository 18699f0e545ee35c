"""The Mixture-of-Experts flagship on the card against the same runs on the
CPU (the kernels' plain versions): training on one device, over ``("dp",
"ep")`` meshes of one CUDA device's ranks (kernels 1-3 in the attention,
kernel 6 summing the experts' partial outputs), over a ``("dp", "ep",
"tp")`` mesh (kernel 6 over the ep × tp ring and the attention's tp ring)
and under FSDP on (dp, ep) = (4, 2) (kernel 5 gathering each rank's
groups, kernel 6 reduce-scattering the gradients), and greedy generation
(kernel 4 for each decode step). Skips where there is no CUDA
device (the kernels have no CPU mode); the CPU parity with the JAX package
is in ``test_torch_moe.py``, ``test_torch_expert_parallel.py``,
``test_torch_expert_tp.py`` and ``test_torch_expert_zero.py``.

float32 throughout. Tolerances from summation order (cuBLAS and the
kernels against the CPU's products): losses atol = rtol = 1e-5, parameters
after three sgd steps atol 1e-4, rtol 1e-5, as
``test_torch_tensor_parallel_kernels.py`` explains. A rounding difference
near a tie would flip a token's expert; the routing decisions are compared
first, so such a flip shows as itself.
"""

import importlib
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from mpi_tpu_torch.models import (TransformerConfig, full_params, generate,
                                  init_params, make_train_step)
from mpi_tpu_torch.ops.attention import flash_fwd
from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
from mpi_tpu_torch.ops.ring_collectives import ring_allgather, ring_allreduce
from mpi_tpu_torch.parallel import RankMesh
from mpi_tpu_torch.parallel.zero import tree_leaves

moe = importlib.import_module("mpi_tpu_torch.models.moe")
# chip_smoke.py's launch count of an MoE step (its stdlib-only top level
# loads here without the card).
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
CFG = TransformerConfig(vocab=64, d_model=256, n_heads=4, n_layers=2,
                        d_ff=256, max_seq=65, attention_impl="flash",
                        decode_attention="flash", n_experts=4, moe_top_k=2)
# name -> (shape, axes, make_train_step flags)
MESHES = {"one": None, "ep4": ((1, 4), ("dp", "ep"), {}),
          "dp2_ep2": ((2, 2), ("dp", "ep"), {}),
          "ep4_tp2": ((1, 4, 2), ("dp", "ep", "tp"), {}),
          "fsdp_dp4_ep2": ((4, 2), ("dp", "ep"), {"fsdp": True})}


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
    """(losses, full parameters, launches of kernels 1, 6 and 5 a step,
    the launches a step counted from the code)."""
    shape, axes, flags = MESHES[name] or ((), (), {})
    mesh = RankMesh([dev] * math.prod(shape), axes, shape) if shape else None
    init_state, step = make_train_step(CFG, mesh=mesh, optimizer="sgd",
                                       **flags)
    state = init_state(torch.Generator().manual_seed(0), dev)
    want = smoke.moe_step_launches(
        CFG.n_layers, *(shape or (1,)), mode=next(iter(flags), "dp"),
        rest=state["layout"].rest if "layout" in state else 0)
    tokens = torch.randint(0, CFG.vocab, (4, CFG.max_seq),
                           generator=torch.Generator().manual_seed(1))
    wrappers = (flash_fwd, ring_allreduce, ring_allgather)
    losses, launches = [], []
    for _ in range(steps):
        before = [w.launches for w in wrappers]
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append(tuple(w.launches - b
                              for w, b in zip(wrappers, before)))
    return (losses,
            [x.detach().cpu() for x in tree_leaves(full_params(state))],
            launches, (want[0], want[3], want[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MESHES))
def test_moe_step_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    seen = _routes(monkeypatch)
    losses, params, launches, want_launches = _train(cuda, name)
    card_routes = list(seen)
    seen.clear()
    want_losses, want_params, _, _ = _train(torch.device("cpu"), name)
    assert len(card_routes) == len(seen)
    for (i1, k1), (i2, k2) in zip(card_routes, seen):
        assert torch.equal(i1, i2) and torch.equal(k1, k2)
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want_losses), **LOSS)
    for got, want in zip(params, want_params):
        torch.testing.assert_close(got, want, **PARAMS)
    assert launches == [want_launches] * 3


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
