"""The port's expert-parallel training against the JAX package's, on the CPU.

The JAX side runs ``make_train_step(cfg, mesh=Mesh(..., ("dp", "ep")))``
on conftest's virtual CPU devices, where GSPMD shards the experts over
``ep`` and inserts the reductions; the port runs ``make_train_step`` on a
``RankMesh`` of the same shape on ``"cpu"``, where each ep rank runs its
experts and kernel 6's plain version sums their partial outputs, from the
same initial parameters (the JAX tree through ``params_from_jax``) and the
same numpy tokens. Meshes (dp, ep) = (1, 4) and (2, 4).

Two places where a per-rank loss gives JAX's answer only for a dense model
are held here against controls that must miss: the aux penalty's
fractions of first choices are the global batch's (a per-rank penalty
misses), and ``grad_accum`` microbatches are consecutive rows of the
global batch, each split over dp (the rows of the port's earlier split, each
dp rank's rows cut into microbatches, miss).

Tolerances, float32 and from summation order: losses atol = rtol = 1e-5,
parameters after three AdamW steps atol 1e-4, rtol 1e-5
(``tests/test_torch_train.py`` explains the last), tighter than
``tests/test_moe.py``'s rtol 1e-4, atol 1e-5 between JAX's own sharded and
single-device steps.
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
from mpi_tpu_torch.models import (TransformerConfig, loss_fn,  # noqa: E402
                                  make_train_step, params_from_jax,
                                  rank_state)
from mpi_tpu_torch.ops import ring_collectives  # noqa: E402
from mpi_tpu_torch.ops.ring_collectives import ring_allreduce  # noqa: E402
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402

transformer = importlib.import_module("mpi_tpu_torch.models.transformer")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
# moe_aux_coef 1: the penalty's share of the loss large enough that the
# per-rank control's miss shows in the loss, not only in its gradient.
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17, n_experts=4, moe_aux_coef=1.0)
MESHES = {"ep4": (1, 4), "dp2_ep4": (2, 4)}
AXES = ("dp", "ep")
STEPS = 3
# (mesh, top_k, grad_accum)
CASES = [("ep4", 2, 1), ("dp2_ep4", 2, 1), ("dp2_ep4", 1, 2)]


def _tokens():
    return np.random.default_rng(11).integers(
        0, MODEL["vocab"], (4, MODEL["max_seq"])).astype(np.int32)


def _port_mesh(name):
    shape = MESHES[name]
    return RankMesh(["cpu"] * (shape[0] * shape[1]), AXES, shape)


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
    of each parameter and of each AdamW first moment), from JAX's
    step."""
    cache = {}

    def get(mesh_name, top_k, grad_accum):
        key = (mesh_name, top_k, grad_accum)
        if key not in cache:
            shape = MESHES[mesh_name]
            mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]])
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


def _port_run(params0, mesh_name, top_k, grad_accum, tokens=None):
    cfg = TransformerConfig(**MODEL, moe_top_k=top_k)
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       grad_accum=grad_accum)
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    toks = torch.from_numpy(_tokens() if tokens is None else tokens)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_shards_have_jax_shapes(jax_runs, mesh_name):
    """What each (dp, ep) coordinate holds, every parameter and every AdamW
    moment, has the shape of JAX's shard on device 0 after the steps (the
    split is even, so every device's shard has that shape): ``w1e`` /
    ``w2e`` and their moments hold n_experts / ep experts, the rest whole.
    The router is the one exception: its spec is replicated (``moe_specs``)
    and the port gives it whole, where JAX's jitted step, whose output
    shardings are left to GSPMD, returns it split over ep along its
    experts."""
    params0, _, _, param_shapes, mu_shapes = jax_runs(mesh_name, 2, 1)
    state, _ = _port_run(params0, mesh_name, 2, 1)
    dp, ep = MESHES[mesh_name]
    expert_shapes = set()
    for r in range(dp):
        for e in range(ep):
            held = rank_state(state, r, ep_rank=e)
            assert set(held) == {"params", "exp_avg", "exp_avg_sq"}
            for what, want_tree in (("params", param_shapes),
                                    ("exp_avg", mu_shapes),
                                    ("exp_avg_sq", mu_shapes)):
                routers = [blk["moe"].pop("router")
                           for blk in held[what]["blocks"]]
                assert all(tuple(x.shape) == (MODEL["d_model"],
                                              MODEL["n_experts"])
                           for x in routers), (what, r, e)
                want_tree = {**want_tree, "blocks": [
                    {**blk, "moe": {k: v for k, v in blk["moe"].items()
                                    if k != "router"}}
                    for blk in want_tree["blocks"]]}
                for got, want in _walk(held[what], want_tree):
                    assert tuple(got.shape) == want, (what, r, e)
            w1e = held["params"]["blocks"][0]["moe"]["w1e"]
            expert_shapes.add(tuple(w1e.shape))
            # Coordinate e holds experts [e·E/ep, (e+1)·E/ep).
            k = MODEL["n_experts"] // ep
            full = state["params"]["blocks"][0]["moe"]["w1e"]
            assert torch.equal(w1e, full[e * k:(e + 1) * k])
    assert expert_shapes == {(MODEL["n_experts"] // ep, MODEL["d_model"],
                              MODEL["d_ff"])}


def _misses(got, want):
    """How far each loss falls outside LOSS of JAX's (> 0: outside)."""
    return [abs(g - w) - (LOSS["atol"] + LOSS["rtol"] * abs(w))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("mesh_name,top_k,grad_accum", CASES)
def test_three_steps_match_jax(jax_runs, mesh_name, top_k, grad_accum):
    """Losses of three AdamW steps and the parameters after them against
    JAX's step on the same mesh shape."""
    params0, want_losses, want_params, _, _ = jax_runs(mesh_name, top_k,
                                                       grad_accum)
    state, losses = _port_run(params0, mesh_name, top_k, grad_accum)
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(state["params"], want_params):
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


def test_per_rank_aux_misses_jax(jax_runs, monkeypatch):
    """The control: each dp rank's loss with its own aux penalty (its own
    fractions of first choices) misses JAX's losses by more than LOSS."""
    def per_rank(self, state, inputs, rows):
        for r in range(self.dp):
            yield loss_fn(state["params"], rows[r], self.cfg,
                          self.rank_meshes[r])

    monkeypatch.setattr(transformer._DataParallel, "_rank_losses", per_rank)
    params0, want = jax_runs("dp2_ep4", 2, 1)[:2]
    _, losses = _port_run(params0, "dp2_ep4", 2, 1)
    assert max(_misses(losses, want)) > 0, (losses, want)


def test_per_rank_microbatch_rows_miss_jax(jax_runs):
    """The control: the rows of the port's earlier split (dp rank r's rows
    ``[r·b/dp, (r+1)·b/dp)`` cut into ``grad_accum`` microbatches), fed
    to the step as a permuted batch, miss JAX's losses by more than LOSS:
    with experts each microbatch's penalty depends on which rows share
    it."""
    params0, want = jax_runs("dp2_ep4", 1, 2)[:2]
    b, dp, k = 4, 2, 2
    # New split: microbatch j, rank r holds rows j·b/k + r·b/(k·dp). Place
    # the old split's (r, j) rows there.
    old = _tokens().reshape(dp, k, b // (dp * k), -1)
    permuted = old.transpose(1, 0, 2, 3).reshape(b, -1)
    assert not np.array_equal(permuted, _tokens())
    _, losses = _port_run(params0, "dp2_ep4", 1, 2, tokens=permuted)
    assert max(_misses(losses, want)) > 0, (losses, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_kernel_6_counts_on_the_cpu(mesh_name, monkeypatch):
    """On the CPU kernel 6 launches nothing; its plain version runs, per
    step, per dp rank and layer, once for the experts' combine and once
    for the gradient to their input, and with dp above 1 once for the
    fractions of first choices and once for the gradient bucket. Every
    rank's copy of each result holds the same bits."""
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
    step(state, torch.from_numpy(_tokens()))
    dp, ep = MESHES[mesh_name]
    assert ring_allreduce.launches == launches
    assert len(calls) == dp * 2 * MODEL["n_layers"] + 2 * (dp > 1)
    assert all(same)
    ep_shapes = [s for s in calls if s[0] == ep]
    assert len(ep_shapes) == dp * 2 * MODEL["n_layers"]
    if dp > 1:  # the fractions (dp, L·E) and the bucket
        assert (dp, MODEL["n_layers"] * MODEL["n_experts"]) in calls


def test_ep_must_divide_the_experts():
    cfg = TransformerConfig(**MODEL)
    mesh = RankMesh(["cpu"] * 3, AXES, (1, 3))
    with pytest.raises(ValueError, match="ep=3 must divide n_experts=4"):
        make_train_step(cfg, mesh=mesh)


def test_tp_must_divide_d_ff_with_experts():
    """With experts a tp axis splits each expert's d_ff: a tp that does
    not divide it raises, as for the dense FFN."""
    cfg = TransformerConfig(**{**MODEL, "d_ff": 66})
    mesh = RankMesh(["cpu"] * 8, ("dp", "ep", "tp"), (1, 2, 4))
    with pytest.raises(ValueError, match="tp=4 must divide d_ff=66"):
        make_train_step(cfg, mesh=mesh)
