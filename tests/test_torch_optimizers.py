"""The port's optimizers and schedules (``models/optimizers.py``) against
optax 0.2.6, and the training step with each against the JAX package's,
on the CPU.

Rule by rule: the same float32 leaves and gradients (numpy, from a seed)
go through ``optax.adamw`` / ``optax.sgd(momentum=0.9)`` /
``optax.adafactor`` and through ``make_optimizer``'s builder, three updates
each, at a constant rate, with linear warmup and with warmup plus cosine
decay. The leaves include factored shapes (two dimensions of at least 128,
2-D and 3-D), which the models at test widths do not have. Tolerances:
float32 rounding, parameters and moments atol 1e-6, rtol 1e-5 (the rules
are the same arithmetic in another order); the schedules rtol 1e-6.

Model steps: three steps of ``make_train_step(optimizer=...,
warmup_steps=..., total_steps=...)`` against JAX's, on one device and on
``make_mesh_nd(8)``, at ``tests/test_torch_train.py``'s tolerances.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_optimizer as jax_make_optimizer  # noqa
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu_torch.models import (TransformerConfig, make_mesh_nd,  # noqa
                                  make_optimizer, make_train_parts,
                                  make_train_step, params_from_jax,
                                  rank_state)
from mpi_tpu_torch.models.optimizers import (  # noqa: E402
    factored_dims, learning_rate_schedule)
from mpi_tpu_torch.models.transformer import full_params  # noqa: E402
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

RULE = dict(atol=1e-6, rtol=1e-5)
LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
# (300,) and (64, 127) are not factored; (130, 200) is, over dims 0 and 1;
# (150, 8, 129) over dims 2 and 0, as optax's wq (1024, 8, 128) would be.
SHAPES = [(300,), (64, 127), (130, 200), (150, 8, 129)]
SCHEDULES = {"constant": (0, None), "warmup": (2, None), "cosine": (1, 4)}
OPTIMIZERS = ["adamw", "sgd", "adafactor"]
LR = 1e-2
MODEL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=17)
STEPS = 3


def _leaves_and_grads(seed=0):
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal(s).astype(np.float32) * 0.1
              for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return leaves, grads


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_each_rule_matches_optax_leaf_by_leaf(name, schedule):
    """Three updates of every leaf, and (adafactor) its row, column and
    full second moments, against optax's."""
    warmup, total = SCHEDULES[schedule]
    leaves, grads = _leaves_and_grads()
    tx = jax_make_optimizer(name, LR, warmup, total)
    params = [jnp.asarray(x) for x in leaves]
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                   params)
        params = optax.apply_updates(params, updates)

    mine = [torch.from_numpy(x.copy()) for x in leaves]
    opt = make_optimizer(name, LR, warmup, total)(mine)
    for g in grads:
        for x, gx in zip(mine, g):
            x.grad = torch.from_numpy(gx)
        opt.step()
    for got, want in zip(mine, params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RULE)
    if name == "adafactor":
        fac = state[0]
        for x, vr, vc, v in zip(mine, fac.v_row, fac.v_col, fac.v):
            held = opt.state[x]
            assert held["step"] == STEPS
            for key, want in (("v_row", vr), ("v_col", vc), ("v", v)):
                assert tuple(held[key].shape) == want.shape, key
                np.testing.assert_allclose(held[key].numpy(),
                                           np.asarray(want), **RULE)


def test_factored_dims_follow_optax():
    assert factored_dims((1024, 8, 128)) == (2, 0)
    assert factored_dims((130, 200)) == (0, 1)
    assert factored_dims((64, 127)) is None
    assert factored_dims((300,)) is None


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 5), (3, 10), (4, None),
                                          (1, None)])
def test_schedules_match_optax_at_every_count(warmup, total):
    """The rate at counts 0 ... total + 2 (the JAX package's choice:
    warmup-cosine with total_steps, linear warmup without)."""
    if total is not None:
        want = optax.warmup_cosine_decay_schedule(
            0.0, LR, max(warmup, 1), total, 0.1 * LR)
    else:
        want = optax.linear_schedule(0.0, LR, warmup)
    got = learning_rate_schedule(LR, warmup, total)
    for count in range(0, (total or warmup) + 3):
        np.testing.assert_allclose(got(count),
                                   float(want(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0  # the first update's rate under warmup
    assert learning_rate_schedule(LR) is None
    with pytest.raises(ValueError, match="decay steps"):
        learning_rate_schedule(LR, 5, 5)


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_restored_optimizer_continues_the_schedule(name, k):
    """The update count is in the optimizer's state_dict: an optimizer
    restored at count k sets the rates that an unbroken one sets at k,
    k + 1, ... (optax's count, restored with its state), not those of
    counts 0, 1, ... as a fresh one would."""
    build = make_optimizer(name, LR, 2, 8)
    schedule = learning_rate_schedule(LR, 2, 8)

    def rates(opt, leaf, n):
        out = []
        for _ in range(n):
            leaf.grad = torch.ones_like(leaf)
            opt.step()
            out.append(opt.param_groups[0]["lr"])
        return out

    leaf = torch.zeros(4, requires_grad=True)
    unbroken = build([leaf])
    rates(unbroken, leaf, k)
    saved = unbroken.state_dict()
    want = rates(unbroken, leaf, 4)
    assert want == [schedule(c) for c in range(k, k + 4)]

    other = torch.zeros(4, requires_grad=True)
    restored = build([other])
    restored.load_state_dict(saved)
    assert rates(restored, other, 4) == want
    fresh = build([torch.zeros(4, requires_grad=True)])
    assert rates(fresh, fresh.param_groups[0]["params"][0], 4) != want


# --------------------------------------------------------------------------
# Model steps against JAX
# --------------------------------------------------------------------------

STEP_CASES = {  # name -> (optimizer, warmup_steps, total_steps, mesh, mode)
    "adafactor": ("adafactor", 0, None, None, {}),
    "sgd": ("sgd", 0, None, None, {}),
    "adamw-warmup": ("adamw", 2, None, None, {}),
    "adafactor-cosine": ("adafactor", 1, 5, None, {}),
    "sgd-cosine": ("sgd", 2, 6, None, {}),
    "nd8-adafactor-cosine": ("adafactor", 1, 4, "nd8", {}),
    "nd8-sgd-warmup-zero1": ("sgd", 2, None, "nd8", {"zero1": True}),
    "nd8-adamw-cosine-fsdp": ("adamw", 1, 4, "nd8", {"fsdp": True}),
}


def _tokens():
    return np.random.default_rng(21).integers(
        0, MODEL["vocab"], (8, MODEL["max_seq"])).astype(np.int32)


def _walk(port_tree, jax_tree):
    if isinstance(port_tree, dict):
        return [pair for k in port_tree
                for pair in _walk(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [pair for p, j in zip(port_tree, jax_tree)
                for pair in _walk(p, j)]
    return [(port_tree, jax_tree)]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_jax(case):
    optimizer, warmup, total, mesh_name, flags = STEP_CASES[case]
    kw = dict(optimizer=optimizer, learning_rate=LR, warmup_steps=warmup,
              total_steps=total, **flags)
    tok = _tokens()
    jmesh = None if mesh_name is None else jax_make_mesh_nd(
        8, devices=jax.devices()[:8])
    j_init, j_step = jax_make_train_step(JaxConfig(**MODEL), mesh=jmesh,
                                         **kw)
    j_state = j_init(jax.random.PRNGKey(9))
    params0 = jax.tree.map(np.asarray, j_state["params"])
    batch = jnp.asarray(tok) if jmesh is None else jax.device_put(
        jnp.asarray(tok), NamedSharding(jmesh, P("dp", None)))
    want = []
    for _ in range(STEPS):
        j_state, loss = j_step(j_state, batch)
        want.append(float(loss))

    cfg = TransformerConfig(**MODEL)
    mesh = None if mesh_name is None else make_mesh_nd(8,
                                                       devices=["cpu"] * 8)
    init_state, step = make_train_step(cfg, mesh=mesh, **kw)
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    losses = [float(step(state, torch.from_numpy(tok))[1])
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want, **LOSS)
    for got, w in _walk(full_params(state),
                        jax.tree.map(np.asarray, j_state["params"])):
        np.testing.assert_allclose(got.detach().numpy(), w, **PARAMS)


@pytest.mark.parametrize("flag", ["zero1", "fsdp"])
def test_adafactor_under_zero1_or_fsdp_raises(flag):
    """Both packages build adafactor with zero1 or fsdp, and neither
    raises: the port runs the rule over whole leaves put back together
    from the dp shards (``tests/test_torch_adafactor_sharded.py`` holds it
    against JAX's step). One port step keeps adafactor's moments."""
    jax_make_train_step(JaxConfig(**MODEL), optimizer="adafactor",
                        mesh=jax_make_mesh_nd(8, devices=jax.devices()[:8]),
                        **{flag: True})
    init_state, step = make_train_parts(
        TransformerConfig(**MODEL), optimizer="adafactor",
        mesh=RankMesh(["cpu"] * 8, ("dp",)), **{flag: True})
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    _, loss = step(state, torch.from_numpy(_tokens()))
    assert np.isfinite(float(loss))
    assert set(rank_state(state, 0)) == {"params", "v_row", "v_col", "v"}


def test_state_names_and_adafactor_bytes():
    """rank_state's names follow the optimizer, and adafactor's state is
    under 0.6 of AdamW's (the JAX package's test_models check)."""
    cfg = TransformerConfig(**MODEL)
    tok = torch.from_numpy(_tokens())
    held = {}
    for name in OPTIMIZERS:
        init_state, step = make_train_step(cfg, optimizer=name)
        state = init_state(torch.Generator().manual_seed(0), "cpu")
        step(state, tok)
        held[name] = rank_state(state, 0)
    assert set(held["adamw"]) == {"params", "exp_avg", "exp_avg_sq"}
    assert set(held["sgd"]) == {"params", "momentum_buffer"}
    assert set(held["adafactor"]) == {"params", "v_row", "v_col", "v"}

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    def opt_bytes(name):
        return sum(nbytes(v) for k, v in held[name].items() if k != "params")

    assert opt_bytes("adafactor") < 0.6 * opt_bytes("adamw")
