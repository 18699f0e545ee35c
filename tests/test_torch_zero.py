"""The port's data-parallel training (plain dp, ZeRO-1, FSDP) against the
JAX package's, on the CPU.

The JAX side runs ``make_train_step(cfg, mesh=..., zero1=..., fsdp=...)``
on conftest's 8 virtual CPU devices, each step built once per module; the
port runs ``make_train_step`` on a ``RankMesh`` of 8 ranks on ``"cpu"``
(the kernels' plain versions), from the same initial parameters (the JAX
tree through ``params_from_jax``) and the same numpy tokens. Two meshes:
``make_mesh_nd(8)``, dp × sp × tp (2, 2, 2), and dp alone (8,).

The config (d_model 36, 4 heads of 9, d_ff 64) leaves some leaves with no
dimension divisible by 8 (the norms, q/k/v/o, the position table): on the
dp-8 mesh they stay replicated and take the replicated path, while on the
(2, 2, 2) mesh every leaf is sharded.

Tolerances are ``tests/test_torch_train.py``'s, float32 and from
summation order: losses atol = rtol = 1e-5, parameters after three AdamW
steps atol 1e-4, rtol 1e-5 (the first AdamW update lr·g/(|g| + eps) turns
a rounding difference of 1e-9 in a gradient near 0 into up to 1e-4 in its
parameter).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.models.transformer import (  # noqa: E402
    sane_param_specs as jax_sane_param_specs)
from mpi_tpu.parallel import zero as jzero  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, init_params,  # noqa
                                  make_mesh_nd, make_train_step,
                                  params_from_jax)
from mpi_tpu_torch.models.transformer import (full_params,  # noqa: E402
                                              rank_state, sane_param_specs)
from mpi_tpu_torch.ops import ring_collectives  # noqa: E402
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel import zero as tzero  # noqa: E402
from mpi_tpu_torch.parallel.mesh import axis_ring, axis_slice  # noqa: E402

transformer = importlib.import_module("mpi_tpu_torch.models.transformer")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=36, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
MESHES = {"nd8": ((2, 2, 2), ("dp", "sp", "tp")), "dp8": ((8,), ("dp",))}
MODES = {"dp": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
STEPS = 3


def _jax_mesh(name):
    shape, axes = MESHES[name]
    if name == "nd8":
        return jax_make_mesh_nd(8, devices=jax.devices()[:8])
    return Mesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)


def _port_mesh(name):
    shape, axes = MESHES[name]
    if name == "nd8":
        return make_mesh_nd(8, devices=["cpu"] * 8)
    return RankMesh(["cpu"] * 8, axes, shape)


def _tokens():
    return np.random.default_rng(5).integers(
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
    """(mesh, mode) -> (initial params, the losses of three steps, the
    parameters after them, the shape of rank 0's shard of each moment and
    of each parameter), from JAX's make_train_step."""
    cfg = JaxConfig(**MODEL)
    tok = _tokens()
    out = {}
    for mesh_name in MESHES:
        mesh = _jax_mesh(mesh_name)
        batch = jax.device_put(jnp.asarray(tok),
                               NamedSharding(mesh, P("dp", None)))
        for mode, kw in MODES.items():
            init_state, step = jax_make_train_step(cfg, mesh=mesh, **kw)
            state = init_state(jax.random.PRNGKey(3))
            params0 = jax.tree.map(np.asarray, state["params"])
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))

            def shard_shape(x):
                return tuple(x.addressable_shards[0].data.shape)

            out[mesh_name, mode] = (
                params0, losses, jax.tree.map(np.asarray, state["params"]),
                jax.tree.map(shard_shape, state["opt"][0].mu),
                jax.tree.map(shard_shape, state["params"]))
    return out


def _port_run(jax_runs, mesh_name, mode):
    params0, _, _, _, _ = jax_runs[mesh_name, mode]
    cfg = TransformerConfig(**MODEL)
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       **MODES[mode])
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    tok = torch.from_numpy(_tokens())
    losses = [float(step(state, tok)[1]) for _ in range(STEPS)]
    return state, losses


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------

LAYOUT_MESHES = {"dp8": (8,), "nd8": (2, 2, 2), "dp4_tp2": (4, 1, 2)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(LAYOUT_MESHES))
def test_zero1_and_fsdp_specs_match_jax(mesh_name, variant):
    """For every leaf, the port's zero1_specs (the moments) and fsdp_specs
    (the parameters) equal the JAX functions' specs."""
    shape = LAYOUT_MESHES[mesh_name]
    axes = ("dp",) if len(shape) == 1 else ("dp", "sp", "tp")
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)
    tmesh = RankMesh(["cpu"] * 8, axes, shape)
    kw = {**MODEL, **VARIANTS[variant]}
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0), jcfg))
    jopt = jax.eval_shape(optax.adamw(1e-3).init, jparams)
    jspecs = jax_sane_param_specs(jcfg, jparams, jmesh)
    jz = jzero.zero1_specs(jparams, jspecs, jopt, jmesh)[0].mu
    jf = jzero.fsdp_specs(jparams, jspecs, jmesh)
    tparams = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tspecs = sane_param_specs(tcfg, tparams, tmesh)
    tz = tzero.zero1_specs(tparams, tspecs, tparams, tmesh)
    tf = tzero.fsdp_specs(tparams, tspecs, tmesh)
    pairs = _walk(tparams, jparams)
    claimed = 0
    for got_tree, want_tree in ((tz, jz), (tf, jf)):
        for (x, _), (got, want) in zip(pairs, _walk(got_tree, want_tree)):
            want = tuple(want) + (None,) * (x.dim() - len(want))
            assert got == want, (tuple(x.shape), got, want)
            claimed += "dp" in got
    assert claimed  # the rule claimed dp somewhere


def test_wo_claims_dp_after_tp():
    """wo (h, hd, d): dp on dimension 1 under tp, on dimension 0 without."""
    cfg = TransformerConfig(**{**MODEL, "d_model": 64, "n_heads": 8})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for mesh, dim in ((RankMesh(["cpu"] * 8, ("dp", "sp", "tp"), (2, 2, 2)),
                       1), (RankMesh(["cpu"] * 8, ("dp",)), 0)):
        specs = tzero.fsdp_specs(params, sane_param_specs(cfg, params, mesh),
                                 mesh)
        assert tzero.spec_dim(specs["blocks"][0]["wo"]) == dim


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_pieces_are_rank_shards_and_unshard_inverts(dim):
    x = torch.arange(4 * 6 * 8.0).reshape(4, 6, 8)
    n = 2
    pieces = tzero.pieces_view(x, dim, n)
    k = x.shape[dim] // n
    for r in range(n):
        assert torch.equal(pieces[r], x.narrow(dim, r * k, k))
    assert torch.equal(tzero.unshard(pieces.contiguous(), dim), x)


# --------------------------------------------------------------------------
# The sub-meshes
# --------------------------------------------------------------------------

def test_dp_ring_and_rank_meshes_are_row_major():
    devs = [f"cpu:{i}" for i in range(8)]  # distinct names to tell ranks
    mesh = RankMesh(devs, ("dp", "sp", "tp"), (2, 2, 2))
    ring = axis_ring(mesh, "dp")
    assert ring.axis_names == ("dp",) and ring.size == 2
    assert [str(d) for d in ring.devices] == ["cpu:0", "cpu:4"]
    sub = axis_slice(mesh, "dp", 1)
    assert sub.axis_names == ("sp", "tp") and sub.shape == {"sp": 2, "tp": 2}
    assert [str(d) for d in sub.devices] == devs[4:]
    alone = axis_slice(RankMesh(devs, ("dp",)), "dp", 3)
    assert alone.axis_names == () and [str(d) for d in alone.devices] == [
        "cpu:3"]
    with pytest.raises(ValueError, match="no 'dp' axis"):
        axis_ring(RankMesh(devs, ("sp",)), "dp")


# --------------------------------------------------------------------------
# Steps against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_three_steps_match_jax(jax_runs, mesh_name, mode):
    """Losses of three steps and the full parameters after them (put back
    together on both sides) against JAX's step with the same flags."""
    _, want_losses, want_params, _, _ = jax_runs[mesh_name, mode]
    state, losses = _port_run(jax_runs, mesh_name, mode)
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(full_params(state), want_params):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


def test_fsdp_under_remat_matches_jax(monkeypatch):
    """fsdp with remat=True on the dp-8 mesh against JAX's remat step: the
    losses of three steps and the full parameters after them, so the
    gradient that flows through each block's second gather (in the
    backward's replay) is checked, not the first loss alone. Each rank
    gathers the top group once and every block twice a step."""
    kw = {**MODEL, "remat": True}
    mesh = _jax_mesh("dp8")
    batch = jax.device_put(jnp.asarray(_tokens()),
                           NamedSharding(mesh, P("dp", None)))
    init_state, step = jax_make_train_step(JaxConfig(**kw), mesh=mesh,
                                           fsdp=True)
    state = init_state(jax.random.PRNGKey(3))
    params0 = jax.tree.map(np.asarray, state["params"])
    want_losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        want_losses.append(float(loss))
    want_params = jax.tree.map(np.asarray, state["params"])

    gathers = []

    def counted(x, ring):
        gathers.append(x.numel())
        return ring_collectives.ring_allgather(x, ring)

    monkeypatch.setattr(transformer, "ring_allgather", counted)
    cfg = TransformerConfig(**kw)
    init_state, step = make_train_step(cfg, mesh=_port_mesh("dp8"),
                                       fsdp=True)
    tstate = init_state.from_params(params_from_jax(params0, cfg,
                                                    device="cpu"))
    tok = torch.from_numpy(_tokens())
    losses = [float(step(tstate, tok)[1]) for _ in range(STEPS)]
    assert len(gathers) == STEPS * 8 * (1 + 2 * MODEL["n_layers"])
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(full_params(tstate), want_params):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_give_plain_dps_bits(jax_runs, mode):
    """Where every leaf is sharded (the (2, 2, 2) mesh), zero1 and fsdp
    pack the same bucket as plain dp and kernel 6's plain version folds
    each value in the same ring order: the same losses and parameters, bit
    for bit. (With replicated leaves, plain dp reduces them in the same
    launch as the shards, so the chunks, and the fold orders, differ.)"""
    plain, plain_losses = _port_run(jax_runs, "nd8", "dp")
    state, losses = _port_run(jax_runs, "nd8", mode)
    assert state["layout"].rest == plain["layout"].rest == 0
    assert losses == plain_losses
    for got, want in zip(tzero.tree_leaves(full_params(state)),
                         tzero.tree_leaves(full_params(plain))):
        assert torch.equal(got, want)


def test_rank_zero_gradient_alone_misses_jax(jax_runs, monkeypatch):
    """The faulty control: the plain dp step with its reduction replaced
    by rank 0's gradient alone. The first loss is computed before any
    update and agrees; the next ones miss JAX's by more than LOSS."""
    def rank_zero(contribs, mesh, op="sum"):
        return contribs[:1].expand_as(contribs) * mesh.size

    monkeypatch.setattr(transformer, "ring_allreduce", rank_zero)
    _, want, _, _, _ = jax_runs["dp8", "dp"]
    _, losses = _port_run(jax_runs, "dp8", "dp")
    np.testing.assert_allclose(losses[0], want[0], **LOSS)
    gaps = [abs(g - w) - (LOSS["atol"] + LOSS["rtol"] * abs(w))
            for g, w in zip(losses[1:], want[1:])]
    assert min(gaps) > 0, (losses, want)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_shards_have_jax_shapes(jax_runs, mesh_name, mode):
    """What each (dp, tp) coordinate holds, its moment shard (and, under
    fsdp, parameter shard), has the shape of JAX's shard on that rank's
    device (the split is even, so on device 0's)."""
    _, _, _, mu_shapes, param_shapes = jax_runs[mesh_name, mode]
    state, _ = _port_run(jax_runs, mesh_name, mode)
    mesh = _port_mesh(mesh_name)
    for r in range(mesh.shape["dp"]):
        for t in range(mesh.shape.get("tp", 1)):
            held = rank_state(state, r, t)
            for what, want_tree in (("exp_avg", mu_shapes),
                                    ("params", param_shapes)):
                if what == "params" and mode == "zero1":
                    continue  # zero1 keeps the parameters whole
                for got, want in _walk(held[what], want_tree):
                    assert tuple(got.shape) == want, (what, r, t)


def test_sharded_state_holds_one_dp_th():
    """Moment bytes per rank under zero1, parameter bytes under fsdp: 1/dp
    of plain dp's, up to the replicated leaves, which every rank holds."""
    cfg = TransformerConfig(**MODEL)
    mesh = RankMesh(["cpu"] * 8, ("dp",))
    tok = torch.from_numpy(_tokens())

    def nbytes(tree):
        return sum(x.numel() * x.element_size()
                   for x in tzero.tree_leaves(tree))

    held = {}
    for mode in MODES:
        init_state, step = make_train_step(cfg, mesh=mesh, **MODES[mode])
        state = init_state(torch.Generator().manual_seed(0), "cpu")
        step(state, tok)
        held[mode] = [rank_state(state, r) for r in range(8)]
        layout = state["layout"]
    rest = layout.rest * 4
    assert rest  # this config has replicated leaves on dp 8
    plain = nbytes(held["dp"][0]["exp_avg"])
    for r in range(8):
        assert nbytes(held["zero1"][r]["exp_avg"]) == (plain - rest) // 8 \
            + rest
        assert nbytes(held["fsdp"][r]["params"]) == (plain - rest) // 8 \
            + rest
        assert nbytes(held["dp"][r]["params"]) == plain


# --------------------------------------------------------------------------
# Refusals and launches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    ({"zero1": True}, "dp"),
    ({"fsdp": True}, "dp"),
    ({"zero1": True, "mesh": RankMesh(["cpu"] * 2, ("sp",))}, "dp"),
    ({"zero1": True, "fsdp": True,
      "mesh": RankMesh(["cpu"] * 2, ("dp",))}, "subsumes"),
])
def test_refusals_match_jax(kwargs, match):
    cfg = TransformerConfig(**MODEL)
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, **kwargs)


def test_indivisible_batch_raises():
    cfg = TransformerConfig(**MODEL)
    init_state, step = make_train_step(
        cfg, mesh=RankMesh(["cpu"] * 4, ("dp",)), grad_accum=2)
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="dp=4 x grad_accum=2"):
        step(state, torch.from_numpy(_tokens()[:4]))


@pytest.mark.parametrize("mode", list(MODES))
def test_grad_accum_splits_each_ranks_rows(mode):
    """grad_accum=2 over dp 4: each rank's two rows as two microbatches,
    the same update as one pass over them to float32 rounding."""
    cfg = TransformerConfig(**MODEL)
    mesh = RankMesh(["cpu"] * 4, ("dp",))
    tok = torch.from_numpy(_tokens())
    runs = []
    for k in (1, 2):
        init_state, step = make_train_step(cfg, mesh=mesh, grad_accum=k,
                                           **MODES[mode])
        state = init_state(torch.Generator().manual_seed(0), "cpu")
        losses = [float(step(state, tok)[1]) for _ in range(2)]
        runs.append((losses, tzero.tree_leaves(full_params(state))))
    np.testing.assert_allclose(runs[1][0], runs[0][0], **LOSS)
    for got, want in zip(runs[1][1], runs[0][1]):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), **PARAMS)


@pytest.mark.parametrize("mode", list(MODES))
def test_cpu_steps_count_no_kernel_launch(mode):
    cfg = TransformerConfig(**{**MODEL, "n_layers": 1})
    init_state, step = make_train_step(
        cfg, mesh=RankMesh(["cpu"] * 4, ("dp",)), **MODES[mode])
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    before = (ring_collectives.ring_allreduce.launches,
              ring_collectives.ring_allgather.launches)
    step(state, torch.from_numpy(_tokens()[:4]))
    assert (ring_collectives.ring_allreduce.launches,
            ring_collectives.ring_allgather.launches) == before
