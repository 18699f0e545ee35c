"""The port's experts split over ``ep`` and each expert's d_ff over ``tp``,
against the JAX package's training on the same meshes, on the CPU.

The JAX side runs ``make_train_step(cfg, mesh=Mesh(..., ("dp", "ep",
"tp")))`` on conftest's virtual CPU devices, where GSPMD shards ``w1e``
as ``("ep", None, "tp")`` and ``w2e`` as ``("ep", "tp", None)`` and
inserts the reductions; the port runs ``make_train_step`` on a
``RankMesh`` of the same shape on ``"cpu"``, where rank (e, j) of the ep
× tp ring runs experts ``[e·E/ep, (e+1)·E/ep)`` on d_ff slice j and
kernel 6's plain version sums the ep·tp partials, from the same initial
parameters (the JAX tree through ``params_from_jax``) and the same numpy
tokens. Meshes (dp, ep, tp) = (1, 4, 2) and (2, 2, 2).

Tolerances, float32 and from summation order, as in
``tests/test_torch_expert_parallel.py``: losses atol = rtol = 1e-5,
parameters after three AdamW steps atol 1e-4, rtol 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu_torch.models import (TransformerConfig,  # noqa: E402
                                  make_train_step, params_from_jax,
                                  rank_state)
from mpi_tpu_torch.ops import ring_collectives  # noqa: E402
from mpi_tpu_torch.ops.ring_collectives import ring_allreduce  # noqa: E402
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.mesh import axis_ring  # noqa: E402
from mpi_tpu_torch.parallel.tensor_parallel import tp_ring  # noqa: E402

tpm = importlib.import_module("mpi_tpu_torch.parallel.tensor_parallel")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17, n_experts=4, moe_aux_coef=1.0)
AXES = ("dp", "ep", "tp")
MESHES = {"ep4_tp2": (1, 4, 2), "dp2_ep2_tp2": (2, 2, 2)}
STEPS = 3
# (mesh, top_k, grad_accum)
CASES = [("ep4_tp2", 2, 1), ("dp2_ep2_tp2", 2, 1), ("ep4_tp2", 1, 2)]


def _tokens():
    return np.random.default_rng(11).integers(
        0, MODEL["vocab"], (4, MODEL["max_seq"])).astype(np.int32)


def _port_mesh(name):
    shape = MESHES[name]
    return RankMesh(["cpu"] * int(np.prod(shape)), AXES, shape)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps here are many tiny ops: one intra-op thread runs
    them fastest, and the setting is put back for the next module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk(port_tree, jax_tree):
    if isinstance(port_tree, dict):
        return [p for k in port_tree
                for p in _walk(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [p for a, b in zip(port_tree, jax_tree) for p in _walk(a, b)]
    return [(port_tree, jax_tree)]


@pytest.fixture(scope="module")
def jax_runs():
    """A cache (mesh, top_k, grad_accum) -> (initial params, the losses of
    STEPS steps, the parameters after them, the shape of device 0's shard
    of each parameter and of each AdamW first moment), from JAX's jitted
    step, each computed once."""
    cache = {}

    def get(mesh_name, top_k, grad_accum):
        key = (mesh_name, top_k, grad_accum)
        if key not in cache:
            shape = MESHES[mesh_name]
            mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                        .reshape(shape), AXES)
            init_state, step = jax_make_train_step(
                JaxConfig(**MODEL, moe_top_k=top_k), mesh=mesh,
                grad_accum=grad_accum)
            state = init_state(jax.random.PRNGKey(top_k))
            params0 = jax.tree.map(np.asarray, state["params"])
            batch = jax.device_put(jnp.asarray(_tokens()),
                                   NamedSharding(mesh, P("dp", None)))
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))

            def shard_shape(x):
                return tuple(x.addressable_shards[0].data.shape)

            cache[key] = (params0, losses,
                          jax.tree.map(np.asarray, state["params"]),
                          jax.tree.map(shard_shape, state["params"]),
                          jax.tree.map(shard_shape, state["opt"][0].mu))
        return cache[key]

    return get


def _port_run(params0, mesh_name, top_k, grad_accum):
    cfg = TransformerConfig(**MODEL, moe_top_k=top_k)
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       grad_accum=grad_accum)
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    toks = torch.from_numpy(_tokens())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("mesh_name,top_k,grad_accum", CASES)
def test_three_steps_match_jax(jax_runs, mesh_name, top_k, grad_accum):
    """Losses of three AdamW steps and the parameters after them against
    JAX's step on the same (dp, ep, tp) mesh shape."""
    params0, want_losses, want_params, _, _ = jax_runs(mesh_name, top_k,
                                                       grad_accum)
    state, losses = _port_run(params0, mesh_name, top_k, grad_accum)
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(state["params"], want_params):
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_shards_have_jax_shapes(jax_runs, mesh_name):
    """What each (dp, ep, tp) coordinate holds, every parameter and AdamW
    first moment, has the shape of JAX's shard on device 0 after the steps
    (the split is even, so every device's shard has that shape): ``w1e``
    ``(E/ep, d, f/tp)``, ``w2e`` ``(E/ep, f/tp, d)``, the attention's
    heads and the embedding's vocab over tp. The router is the exception
    ``tests/test_torch_expert_parallel.py`` names: the port gives it
    whole."""
    params0, _, _, param_shapes, mu_shapes = jax_runs(mesh_name, 2, 1)
    state, _ = _port_run(params0, mesh_name, 2, 1)
    dp, ep, tp = MESHES[mesh_name]
    e_k, f_k = MODEL["n_experts"] // ep, MODEL["d_ff"] // tp
    for r in range(dp):
        for e in range(ep):
            for j in range(tp):
                held = rank_state(state, r, tp_rank=j, ep_rank=e)
                for what, want_tree in (("params", param_shapes),
                                        ("exp_avg", mu_shapes)):
                    for blk in held[what]["blocks"]:
                        router = blk["moe"].pop("router")
                        assert tuple(router.shape) == (
                            MODEL["d_model"], MODEL["n_experts"])
                    want_tree = {**want_tree, "blocks": [
                        {**blk, "moe": {k: v for k, v in blk["moe"].items()
                                        if k != "router"}}
                        for blk in want_tree["blocks"]]}
                    for got, want in _walk(held[what], want_tree):
                        assert tuple(got.shape) == want, (what, r, e, j)
                moe = held["params"]["blocks"][0]["moe"]
                assert tuple(moe["w1e"].shape) == (e_k, MODEL["d_model"],
                                                   f_k)
                # Coordinate (e, j): experts [e·E/ep, (e+1)·E/ep), d_ff
                # slice j.
                full = state["params"]["blocks"][0]["moe"]
                assert torch.equal(moe["w1e"], full["w1e"][
                    e * e_k:(e + 1) * e_k, :, j * f_k:(j + 1) * f_k])
                assert torch.equal(moe["w2e"], full["w2e"][
                    e * e_k:(e + 1) * e_k, j * f_k:(j + 1) * f_k])


def test_tp_zero_partials_alone_miss_jax(jax_runs, monkeypatch):
    """The control: the experts' partials summed over the ep ranks at tp
    coordinate 0 alone (the other half of each expert's d_ff dropped, in
    the forward and in the copy's backward) misses JAX's losses."""
    def tp_zero(contribs, ring, op="sum"):
        if ring.shape.get("tp", 1) > 1 and "ep" in ring.shape:
            tp = ring.shape["tp"]
            keep = (torch.arange(ring.size) % tp == 0).to(contribs.dtype)
            contribs = contribs * keep.view(-1, *[1] * (contribs.dim() - 1))
        return ring_allreduce(contribs, ring, op)

    monkeypatch.setattr(tpm, "ring_allreduce", tp_zero)
    params0, want = jax_runs("ep4_tp2", 2, 1)[:2]
    _, losses = _port_run(params0, "ep4_tp2", 2, 1)
    misses = [abs(g - w) - (LOSS["atol"] + LOSS["rtol"] * abs(w))
              for g, w in zip(losses, want)]
    assert max(misses) > 0, (losses, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_kernel_6_counts_on_the_cpu(mesh_name, monkeypatch):
    """On the CPU kernel 6 launches nothing; its plain version runs, per
    step and dp rank: a layer, twice over the ep × tp ring on the experts'
    ``(ep·tp, …)`` partials (their sum forward, the gradient to their
    input backward) and twice over the tp ring for the attention (likewise
    forward and backward); twice for the embedding lookup and the logits'
    copy, and twice for the vocab-parallel cross-entropy (its row max and
    its sums); with dp above 1, once for the fractions of first choices
    and once for the gradient bucket. Every rank's copy of each result
    holds the same bits."""
    calls, same = [], []
    plain = ring_collectives.ring_allreduce_plain

    def counted(contribs, op="sum"):
        out = plain(contribs, op)
        calls.append(tuple(contribs.shape))
        same.append(all(torch.equal(out[0], out[r])
                        for r in range(1, out.shape[0])))
        return out

    monkeypatch.setattr(ring_collectives, "ring_allreduce_plain", counted)
    cfg = TransformerConfig(**MODEL, moe_top_k=2)
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name))
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    launches = ring_allreduce.launches
    tokens = torch.from_numpy(_tokens())
    step(state, tokens)
    dp, ep, tp = MESHES[mesh_name]
    layers = MODEL["n_layers"]
    assert ring_allreduce.launches == launches
    assert len(calls) == dp * (4 * layers + 4) + 2 * (dp > 1)
    assert all(same)
    # The experts' partials: (b/dp, seq, d) a rank, padded to ep·tp.
    m = tokens.shape[0] // dp * (MODEL["max_seq"] - 1) * MODEL["d_model"]
    assert calls.count((ep * tp, m)) == dp * 2 * layers
    if dp > 1:  # the fractions (dp, L·E)
        assert (dp, layers * MODEL["n_experts"]) in calls


def test_expert_ring_is_ep_by_tp_row_major():
    """The experts' ring of a (dp, ep, tp) mesh: the ep·tp ranks at dp
    coordinate 0, rank (e, j) at place e·tp + j; without a tp axis above 1
    it is the ep ring, and the tp ring alone without ep."""
    mesh = RankMesh([f"cpu:{i}" for i in range(8)], AXES, (2, 2, 2))
    ring = tp_ring(mesh, ("ep", "tp"))
    assert [d.index for d in ring.devices] == [0, 1, 2, 3]
    assert ring.size == 4 and ring.shape == {"ep": 2, "tp": 2}
    assert axis_ring(mesh, ("tp", "dp")).devices == [
        mesh.devices[r] for r in (0, 1, 4, 5)]
    ep_only = RankMesh(["cpu"] * 4, AXES, (1, 4, 1))
    assert tp_ring(ep_only, ("ep", "tp")).shape == {"ep": 4}
    tp_only = RankMesh(["cpu"] * 2, AXES, (1, 1, 2))
    assert tp_ring(tp_only, ("ep", "tp")).shape == {"tp": 2}
    assert tp_ring(RankMesh(["cpu"] * 2, ("dp",)), ("ep", "tp")) is None
