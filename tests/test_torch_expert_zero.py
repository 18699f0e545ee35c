"""The port's experts under ZeRO-1 and FSDP against the JAX package's
training on the same meshes, on the CPU.

The JAX side runs ``make_train_step(cfg, mesh=Mesh(...), zero1=... |
fsdp=...)`` on conftest's virtual CPU devices; the port runs
``make_train_step`` on a ``RankMesh`` of the same shape on ``"cpu"`` (the
kernels' plain versions) from the same initial parameters (the JAX tree
through ``params_from_jax``) and the same numpy tokens: zero1 on (dp, ep)
= (2, 4), fsdp on (4, 2) (the JAX package's own fsdp mesh for the MoE),
fsdp with adafactor on (4, 2), and fsdp and zero1 under remat on (dp, ep,
tp) = (2, 2, 2). Each dp rank's forward gathers its blocks, every rank's
forward runs before the fractions of first choices are summed over the dp
ring, and the gradients meet in the reduce-scatter.

The adafactor case widens d_model and d_ff to 128 (one layer, to keep
JAX's compile short): optax factors a leaf's second moment only where two
of its dimensions are at least 128, so the experts' ``(E, d, f)`` leaves
are factored there, over their last two dimensions, as the whole-leaf
path must reproduce.

Tolerances, float32 and from summation order, as in
``tests/test_torch_expert_parallel.py``: losses atol = rtol = 1e-5,
parameters after three steps atol 1e-4, rtol 1e-5.
"""

import concurrent.futures
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
                                  make_train_step, params_from_jax)
from mpi_tpu_torch.models.transformer import (full_params,  # noqa: E402
                                              rank_state)
from mpi_tpu_torch.ops.ring_collectives import (  # noqa: E402
    ring_allgather, ring_allreduce)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

transformer = importlib.import_module("mpi_tpu_torch.models.transformer")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17, n_experts=4, moe_aux_coef=1.0, moe_top_k=2)
WIDE = dict(MODEL, d_model=128, d_ff=128, n_layers=1)
MESHES = {"dp2_ep4": ((2, 4), ("dp", "ep")),
          "dp4_ep2": ((4, 2), ("dp", "ep")),
          "dp2_ep2_tp2": ((2, 2, 2), ("dp", "ep", "tp"))}
# name -> (mesh, flags, optimizer, remat)
CASES = {
    "zero1": ("dp2_ep4", {"zero1": True}, "adamw", False),
    "fsdp": ("dp4_ep2", {"fsdp": True}, "adamw", False),
    "fsdp_adafactor": ("dp4_ep2", {"fsdp": True}, "adafactor", False),
    "fsdp_tp": ("dp2_ep2_tp2", {"fsdp": True}, "adamw", False),
    "zero1_tp_remat": ("dp2_ep2_tp2", {"zero1": True}, "adamw", True),
}
STEPS = 3


def _tokens():
    return np.random.default_rng(11).integers(
        0, MODEL["vocab"], (8, MODEL["max_seq"])).astype(np.int32)


def _model(case):
    _, _, optimizer, remat = CASES[case]
    return dict(WIDE if optimizer == "adafactor" else MODEL, remat=remat)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return RankMesh(["cpu"] * int(np.prod(shape)), axes, shape)


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
    """case -> (initial params, the losses of STEPS steps, the parameters
    after them, the shape of device 0's shard of each parameter and, for
    AdamW, of each first moment), from JAX's jitted step. Every case's
    state is built first and its step compiled, the compiles in threads
    (XLA compiles without the GIL); then the cases run one at a time."""
    prepared = {}
    for case, (mesh_name, flags, optimizer, _) in CASES.items():
        shape, axes = MESHES[mesh_name]
        mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                    .reshape(shape), axes)
        init_state, step = jax_make_train_step(
            JaxConfig(**_model(case)), mesh=mesh, optimizer=optimizer,
            **flags)
        batch = jax.device_put(jnp.asarray(_tokens()),
                               NamedSharding(mesh, P("dp", None)))
        prepared[case] = (step, init_state(jax.random.PRNGKey(5)), batch)
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        list(pool.map(lambda p: p[0].lower(*p[1:]).compile(),
                      prepared.values()))

    def shard_shape(x):
        return tuple(x.addressable_shards[0].data.shape)

    runs = {}
    for case, (step, state, batch) in prepared.items():
        params0 = jax.tree.map(np.asarray, state["params"])
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        mu = (jax.tree.map(shard_shape, state["opt"][0].mu)
              if CASES[case][2] == "adamw" else None)
        runs[case] = (params0, losses,
                      jax.tree.map(np.asarray, state["params"]),
                      jax.tree.map(shard_shape, state["params"]), mu)
    return runs


def _port_run(params0, case, mode=None):
    """STEPS steps of ``case`` (with ``mode``'s flags in its place where
    given: ``"dp"`` for plain dp) from ``params0``: (state, losses)."""
    mesh_name, flags, optimizer, _ = CASES[case]
    if mode is not None:
        flags = {} if mode == "dp" else {mode: True}
    cfg = TransformerConfig(**_model(case))
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       optimizer=optimizer, **flags)
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    toks = torch.from_numpy(_tokens())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, toks)
        losses.append(loss.item())
    return state, losses


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(jax_runs, case):
    """Losses of three steps and the full parameters after them against
    JAX's step with the same mesh, flags and optimizer."""
    params0, want_losses, want_params, _, _ = jax_runs[case]
    state, losses = _port_run(params0, case)
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(full_params(state), want_params):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_give_plain_dps_bits(jax_runs, mode):
    """On (dp, ep) = (4, 2) every leaf of MODEL has a dimension dp claims
    (the router's d_model too), so zero1 and fsdp pack the same bucket as
    plain dp and kernel 6's plain version folds each value in the same ring
    order: the same losses and parameters, bit for bit."""
    params0 = jax_runs["fsdp"][0]
    plain, plain_losses = _port_run(params0, "fsdp", "dp")
    state, losses = _port_run(params0, "fsdp", mode)
    assert state["layout"].rest == plain["layout"].rest == 0
    assert losses == plain_losses
    for got, want in zip(tree_leaves(full_params(state)),
                         tree_leaves(full_params(plain))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["zero1", "fsdp", "fsdp_tp",
                                  "zero1_tp_remat"])
def test_rank_shards_have_jax_shapes(jax_runs, case):
    """What each (dp, ep, tp) coordinate holds has the shape of JAX's shard
    on device 0 (the split is even): its AdamW first moment under zero1 and
    fsdp, and its parameters under fsdp, where dp claims the first free
    dimension of ``w1e``'s ``("ep", None, "tp")``: ``(E/ep, d/dp, f/tp)``.
    The router too: dp claims its d_model, ``(d/dp, E)``, as in JAX."""
    params0, _, _, param_shapes, mu_shapes = jax_runs[case]
    state, _ = _port_run(params0, case)
    mesh = state["mesh"]
    dp, ep, tp = (mesh.shape.get(a, 1) for a in ("dp", "ep", "tp"))
    trees = [("exp_avg", mu_shapes)]
    if "fsdp" in CASES[case][1]:
        trees.append(("params", param_shapes))
    for r in range(dp):
        for e in range(ep):
            for j in range(tp):
                held = rank_state(state, r, tp_rank=j, ep_rank=e)
                for what, want_tree in trees:
                    for got, want in _walk(held[what], want_tree):
                        assert tuple(got.shape) == want, (what, r, e, j)
    moe = rank_state(state, 0)["exp_avg"]["blocks"][0]["moe"]
    d = MODEL["d_model"]
    assert tuple(moe["router"].shape) == (d // dp, MODEL["n_experts"])
    assert tuple(moe["w1e"].shape) == (MODEL["n_experts"] // ep, d // dp,
                                       MODEL["d_ff"] // tp)


@pytest.mark.parametrize("case", ["fsdp", "fsdp_tp", "zero1_tp_remat"])
def test_full_params_round_trips(jax_runs, case):
    """``full_params`` of a state just built from a tree gives that tree
    back, bit for bit: fsdp's pieces of the experts' leaves put back
    together, zero1's full leaves as they are."""
    params0 = jax_runs[case][0]
    cfg = TransformerConfig(**_model(case))
    mesh_name, flags, optimizer, _ = CASES[case]
    init_state, _ = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                    optimizer=optimizer, **flags)
    tree = params_from_jax(params0, cfg, device="cpu")
    want = [x.detach().clone() for x in tree_leaves(tree)]
    state = init_state.from_params(tree)
    got = tree_leaves(full_params(state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["zero1", "fsdp"])
def test_rank_zero_gradient_alone_misses_jax(jax_runs, case, monkeypatch):
    """The faulty control: the reduce-scatter replaced by rank 0's
    gradient alone. The first loss comes before any update and agrees; the
    next ones miss JAX's by more than LOSS."""
    def rank_zero(x, mesh, op="sum"):
        return (x[0] * mesh.size).reshape(mesh.size, -1)

    monkeypatch.setattr(transformer, "ring_reduce_scatter", rank_zero)
    params0, want = jax_runs[case][:2]
    _, losses = _port_run(params0, case)
    np.testing.assert_allclose(losses[0], want[0], **LOSS)
    gaps = [abs(g - w) - (LOSS["atol"] + LOSS["rtol"] * abs(w))
            for g, w in zip(losses[1:], want[1:])]
    assert min(gaps) > 0, (losses, want)


@pytest.mark.parametrize("case", ["zero1", "fsdp_tp"])
def test_cpu_steps_count_no_kernel_launch(jax_runs, case):
    """On the CPU neither kernel 5 nor kernel 6 launches: their plain
    versions run."""
    before = (ring_allgather.launches, ring_allreduce.launches)
    _port_run(jax_runs[case][0], case)
    assert (ring_allgather.launches, ring_allreduce.launches) == before
