"""adafactor under ZeRO-1 and FSDP: the port's data-parallel step against
the JAX package's, on the CPU.

The JAX side runs ``make_train_step(cfg, mesh=..., optimizer="adafactor",
zero1=... | fsdp=...)`` on conftest's 8 virtual CPU devices; the port runs
``make_train_step`` on a ``RankMesh`` of 8 ranks on ``"cpu"`` (the
kernels' plain versions) from the same initial parameters and the same
numpy tokens, over ``make_mesh_nd(8)`` (dp, sp, tp = 2, 2, 2) and a dp-8
mesh. The widths (d_model 128, d_ff 256, vocab 256) give the embedding,
w1 and w2 two dimensions of at least 128, so optax factors their second
moment into a row and a column; the rest keep a full one. On dp 8 the
position table is sharded on its dimension 1.

Tolerances are ``tests/test_torch_train.py``'s, float32 and from
summation order: losses atol = rtol = 1e-5, parameters after three steps
atol 1e-4, rtol 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu_torch.models import (TransformerConfig, make_mesh_nd,  # noqa
                                  make_train_step, params_from_jax)
from mpi_tpu_torch.models.transformer import (full_params,  # noqa: E402
                                              rank_state)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=256, d_model=128, n_heads=4, n_layers=1, d_ff=256,
             max_seq=17)
MESHES = {"nd8": ((2, 2, 2), ("dp", "sp", "tp")), "dp8": ((8,), ("dp",))}
MODES = {"zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
LR = 1e-2
STEPS = 3


def _jax_mesh(name):
    if name == "nd8":
        return jax_make_mesh_nd(8, devices=jax.devices()[:8])
    shape, axes = MESHES[name]
    return Mesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)


def _port_mesh(name):
    if name == "nd8":
        return make_mesh_nd(8, devices=["cpu"] * 8)
    shape, axes = MESHES[name]
    return RankMesh(["cpu"] * 8, axes, shape)


def _tokens():
    return np.random.default_rng(13).integers(
        0, MODEL["vocab"], (8, MODEL["max_seq"])).astype(np.int32)


def _walk(port_tree, jax_tree):
    """(port leaf, JAX leaf) pairs, matched by key."""
    if isinstance(port_tree, dict):
        return [pair for k in port_tree
                for pair in _walk(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [pair for p, j in zip(port_tree, jax_tree)
                for pair in _walk(p, j)]
    return [(port_tree, jax_tree)]


@pytest.fixture(scope="module")
def jax_runs():
    """(mesh, mode) -> (initial params, losses of three steps, parameters
    after them, {moment: (global shape, device 0's shard shape) tree})."""
    cfg = JaxConfig(**MODEL)
    tok = _tokens()
    out = {}
    for mesh_name in MESHES:
        mesh = _jax_mesh(mesh_name)
        batch = jax.device_put(jnp.asarray(tok),
                               NamedSharding(mesh, P("dp", None)))
        for mode, kw in MODES.items():
            init_state, step = jax_make_train_step(
                cfg, mesh=mesh, optimizer="adafactor", learning_rate=LR,
                **kw)
            state = init_state(jax.random.PRNGKey(4))
            params0 = jax.tree.map(np.asarray, state["params"])
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))
            factored = state["opt"][0]  # optax's FactoredState
            shapes = {what: jax.tree.map(
                lambda x: (tuple(x.shape),
                           tuple(x.addressable_shards[0].data.shape)),
                getattr(factored, what)) for what in ("v_row", "v_col", "v")}
            out[mesh_name, mode] = (params0, losses,
                                    jax.tree.map(np.asarray,
                                                 state["params"]), shapes)
    return out


def _port_run(params0, mesh_name, flags):
    cfg = TransformerConfig(**MODEL)
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       optimizer="adafactor",
                                       learning_rate=LR, **flags)
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    tok = torch.from_numpy(_tokens())
    losses = [float(step(state, tok)[1]) for _ in range(STEPS)]
    return state, losses


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_three_steps_match_jax(jax_runs, mesh_name, mode):
    """Losses of three adafactor steps and the full parameters after them
    against JAX's step with the same flags."""
    params0, want_losses, want_params, _ = jax_runs[mesh_name, mode]
    state, losses = _port_run(params0, mesh_name, MODES[mode])
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(full_params(state), want_params):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_state_moments(jax_runs, mesh_name, mode):
    """What each (dp, tp) coordinate holds of adafactor's state: the full
    moment ``v`` as the rank's piece, of the shape of JAX's shard on that
    rank's device (the split is even, so on device 0's); the factored
    moments ``v_row`` and ``v_col`` whole, of JAX's global shapes (JAX
    shards them over dp as well)."""
    params0, _, _, shapes = jax_runs[mesh_name, mode]
    state, _ = _port_run(params0, mesh_name, MODES[mode])
    mesh = _port_mesh(mesh_name)
    factored = 0
    for r in range(mesh.shape["dp"]):
        for t in range(mesh.shape.get("tp", 1)):
            held = rank_state(state, r, t)
            assert set(held) == {"params", "v_row", "v_col", "v"}
            for got, (whole, shard) in _walk(held["v"], shapes["v"]):
                assert tuple(got.shape) == shard, (r, t)
            for what in ("v_row", "v_col"):
                for got, (whole, _) in _walk(held[what], shapes[what]):
                    assert tuple(got.shape) == whole, (what, r, t)
                    factored += got.numel() > 1
    assert factored  # some leaf is factored at these widths


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_modes_give_plain_dps_bits(jax_runs, mode):
    """Every leaf is sharded on dp 8 (the position table on dimension 1),
    so zero1 and fsdp fold the same bucket as plain dp, and the rule sees
    the same whole leaves and gradients: the same losses and parameters,
    bit for bit."""
    params0 = jax_runs["dp8", mode][0]
    plain, plain_losses = _port_run(params0, "dp8", {})
    state, losses = _port_run(params0, "dp8", MODES[mode])
    assert state["layout"].rest == plain["layout"].rest == 0
    assert losses == plain_losses
    for got, want in zip(tree_leaves(full_params(state)),
                         tree_leaves(full_params(plain))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_one_slice_pieces_give_plain_dps_bits(mode):
    """Pieces one slice thick (wo (4, 8, 32) over dp 8 on its dimension 1,
    8 blocks of them): the rule puts each whole leaf back as a new
    contiguous tensor, so its reductions fold as plain dp's do over the
    leaf itself, and the modes give the same bits (a view of the pieces
    folded in another order and moved a wo by one ulp)."""
    cfg = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=8,
                            d_ff=64, max_seq=17)
    tok = torch.from_numpy(_tokens() % 64)
    runs = []
    for flags in ({}, MODES[mode]):
        init_state, step = make_train_step(
            cfg, mesh=RankMesh(["cpu"] * 8, ("dp",)), optimizer="adafactor",
            learning_rate=LR, **flags)
        state = init_state(torch.Generator().manual_seed(0), "cpu")
        losses = [float(step(state, tok)[1]) for _ in range(STEPS)]
        runs.append((losses, tree_leaves(full_params(state))))
    assert runs[1][0] == runs[0][0]
    for got, want in zip(runs[1][1], runs[0][1]):
        assert torch.equal(got, want)

