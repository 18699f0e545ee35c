"""The port's pipeline layer (``parallel/pipeline.py``) and the pipelined
flagship (``models/pipeline_lm.py``) against the JAX package's, on the CPU.

The JAX side runs ``pipeline_sharded``, ``pipeline_loss_fn`` and
``make_pipelined_train_step`` over a ``("pp",)`` mesh of conftest's
virtual CPU devices; the port runs its twins over a ``RankMesh`` of pp
ranks on ``"cpu"`` (the hop's plain version), from the same numpy inputs
and parameters. The flagship is ``tests/test_pipeline.py``'s (vocab 64,
d_model 32, 4 heads, 4 layers, d_ff 64), dense attention: JAX's flash
runs Pallas in interpret mode.

Tolerances, float32, from summation order: the generic pipeline's
outputs rtol 1e-5, atol 1e-6 and gradients rtol 1e-4, atol 1e-5
(``tests/test_pipeline.py``'s); the flagship's losses atol = rtol = 1e-5,
gradients atol 1e-5, rtol 1e-4, and parameters after three steps atol
1e-4, rtol 1e-5 (``tests/test_torch_train.py``: AdamW's first update
lr·g/(|g| + eps) turns a rounding difference of 1e-9 in a gradient near 0
into up to 1e-4 in its parameter).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_pipelined_train_step as jax_make_pp  # noqa
from mpi_tpu.models import stack_block_params as jax_stack  # noqa: E402
from mpi_tpu.models.pipeline_lm import (  # noqa: E402
    pipeline_loss_fn as jax_pp_loss)
from mpi_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_sharded as jax_pipeline_sharded)
from mpi_tpu_torch.models import (TransformerConfig,  # noqa: E402
                                  forward_pipelined, init_pipelined_params,
                                  loss_fn, make_pipelined_train_step,
                                  params_from_jax, pipeline_loss_fn,
                                  stack_block_params)
from mpi_tpu_torch.parallel import (RankMesh, make_mesh,  # noqa: E402
                                    pipeline, pipeline_sharded)
from mpi_tpu_torch.parallel import p2p  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

pipeline_module = importlib.import_module("mpi_tpu_torch.parallel.pipeline")

OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(atol=1e-5, rtol=1e-5)
FLAG_GRAD = dict(atol=1e-5, rtol=1e-4)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq=32)
STEPS = 3
D = 8


def _jax_mesh(n, axis="pp"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _port_mesh(n, axis="pp"):
    return make_mesh(axis=axis, devices=["cpu"] * n)


# --------------------------------------------------------------------------
# The generic pipeline
# --------------------------------------------------------------------------

def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _port_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _stage_inputs(n_stages, n_micro, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((n_stages, D, D)) / np.sqrt(D)
                    ).astype(np.float32),
              "b": (0.01 * rng.standard_normal((n_stages, D))
                    ).astype(np.float32)}
    xs = rng.standard_normal((n_micro, 3, D)).astype(np.float32)
    return params, xs


def _port_tree(params):
    return {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in params.items()}


def _jax_value_and_grads(params, xs, n, remat=False):
    """JAX's outputs, and the gradients of sum(sin(outputs)) with respect
    to the stage parameters and xs."""
    mesh = _jax_mesh(n)

    def run(p, x):
        return jax_pipeline_sharded(_jax_stage, p, x, mesh,
                                    remat_stage=remat)

    out = jax.jit(run)(params, xs)
    grads = jax.jit(jax.grad(lambda p, x: jnp.sum(jnp.sin(run(p, x))),
                             argnums=(0, 1)))(params, xs)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _port_value_and_grads(params, xs, n, remat=False):
    tree = _port_tree(params)
    x = torch.from_numpy(xs).requires_grad_(True)
    out = pipeline_sharded(_port_stage, tree, x, _port_mesh(n),
                           remat_stage=remat)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), ({k: v.grad.numpy() for k, v in
                                   tree.items()}, x.grad.numpy())


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4), (8, 3),
                                              (4, 1)])
def test_pipeline_matches_jax(n_stages, n_micro):
    """Outputs and gradients (stage parameters and inputs) of the tanh
    stage, ``tests/test_pipeline.py``'s, against JAX's
    pipeline_sharded."""
    params, xs = _stage_inputs(n_stages, n_micro)
    want, (want_p, want_x) = _jax_value_and_grads(params, xs, n_stages)
    got, (got_p, got_x) = _port_value_and_grads(params, xs, n_stages)
    np.testing.assert_allclose(got, want, **OUT)
    for k in params:
        np.testing.assert_allclose(got_p[k], want_p[k], **GRAD)
    np.testing.assert_allclose(got_x, want_x, **GRAD)


def test_remat_stage_gradients_match_jax_and_plain():
    """remat_stage recomputes each (stage, microbatch) forward in the
    backward: the same gradients as the stored schedule, bit for bit, and
    as JAX's remat pipeline."""
    params, xs = _stage_inputs(4, 6, seed=3)
    _, (want_p, want_x) = _jax_value_and_grads(params, xs, 4, remat=True)
    _, (plain_p, plain_x) = _port_value_and_grads(params, xs, 4)
    _, (got_p, got_x) = _port_value_and_grads(params, xs, 4, remat=True)
    for k in params:
        np.testing.assert_array_equal(got_p[k], plain_p[k])
        np.testing.assert_allclose(got_p[k], want_p[k], **GRAD)
    np.testing.assert_array_equal(got_x, plain_x)
    np.testing.assert_allclose(got_x, want_x, **GRAD)


def test_stacked_view_is_every_ranks_copy():
    """pipeline returns the stacked (S, M, ...) view: every pp rank holds
    the last stage's outputs, as JAX's per-device body returns them."""
    params, xs = _stage_inputs(4, 3)
    stacked = pipeline(_port_stage, _port_tree(params), torch.from_numpy(xs),
                       _port_mesh(4))
    assert stacked.shape == (4, *xs.shape)
    for r in range(4):
        assert torch.equal(stacked[r], stacked[3])


def test_hops_and_stage_calls_counted(monkeypatch):
    """One call with S stages and M microbatches runs stage_fn M·S times
    (the active pairs alone) and kernel 7's hop M + S − 2 times forward,
    as many backward (the reverse hop)."""
    n, m = 4, 5
    params, xs = _stage_inputs(n, m)
    hops, calls = [], []

    def counted_hop(x, mesh, shift=1):
        hops.append(shift)
        return p2p.sendrecv(x.contiguous(), mesh,
                            [(r, (r + shift) % n) for r in range(n)])

    def stage(p, x):
        calls.append(1)
        return _port_stage(p, x)

    monkeypatch.setattr(p2p, "ring_hop", counted_hop)
    tree = _port_tree(params)
    out = pipeline_sharded(stage, tree, torch.from_numpy(xs), _port_mesh(n))
    assert len(calls) == m * n and hops == [1] * (m + n - 2)
    out.sum().backward()
    assert hops == [1] * (m + n - 2) + [-1] * (m + n - 2)


def test_missing_axis_raises():
    params, xs = _stage_inputs(2, 2)
    with pytest.raises(ValueError, match="no 'pp' axis"):
        pipeline_sharded(_port_stage, _port_tree(params),
                         torch.from_numpy(xs), _port_mesh(2, axis="stage"))
    with pytest.raises(ValueError, match="lead with the 4 stages"):
        pipeline_sharded(_port_stage, _port_tree(params),
                         torch.from_numpy(xs), _port_mesh(4))
    with pytest.raises(NotImplementedError, match="several devices"):
        pipeline_sharded(_port_stage, _port_tree(params),
                         torch.from_numpy(xs),
                         RankMesh(["cpu", "cuda:0"], ("pp",)))


# --------------------------------------------------------------------------
# The pipelined flagship
# --------------------------------------------------------------------------

def _tokens():
    return np.random.default_rng(0).integers(
        0, MODEL["vocab"], (8, 17)).astype(np.int32)


def _jax_tree(pp):
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(**MODEL))
    return jax.tree.map(np.asarray, params), jax.tree.map(
        np.asarray, jax_stack(params, pp))


def _walk(port_tree, jax_tree):
    if isinstance(port_tree, dict):
        return [pair for k in port_tree
                for pair in _walk(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [pair for p, j in zip(port_tree, jax_tree)
                for pair in _walk(p, j)]
    return [(port_tree, jax_tree)]


def _grads(loss, tree):
    leaves = tree_leaves(tree)
    for x in leaves:
        x.requires_grad_(True)
    value = loss(tree)
    value.backward()
    return float(value.detach()), [x.grad.numpy() for x in leaves]


def _regrad(params):
    """The tree of ``params``' gradients."""
    if isinstance(params, dict):
        return {k: _regrad(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_regrad(v) for v in params]
    return params.grad


@pytest.mark.parametrize("pp", [4, 2])
def test_flagship_loss_and_grads_match_jax_and_sequential(pp):
    """The pipelined loss and every gradient against JAX's
    pipeline_loss_fn, and against the port's own sequential loss_fn on the
    same weights (its gradients restacked)."""
    flat, stages = _jax_tree(pp)
    tok = _tokens()
    jcfg = JaxConfig(**MODEL)
    mesh = _jax_mesh(pp)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, t: jax_pp_loss(p, t, jcfg, mesh)))(
        jax.tree.map(jnp.asarray, stages), jnp.asarray(tok))
    cfg = TransformerConfig(**MODEL)
    tokens = torch.from_numpy(tok)
    got, got_g = _grads(lambda p: pipeline_loss_fn(p, tokens, cfg,
                                                   _port_mesh(pp)),
                        params_from_jax(stages, cfg, device="cpu"))
    seq_params = params_from_jax(flat, cfg, device="cpu")
    seq, seq_g = _grads(lambda p: loss_fn(p, tokens, cfg), seq_params)
    np.testing.assert_allclose(got, float(want), **LOSS)
    np.testing.assert_allclose(got, seq, **LOSS)
    for g, w in zip(got_g, tree_leaves(jax.tree.map(np.asarray, want_g))):
        np.testing.assert_allclose(g, w, **FLAG_GRAD)
    restacked = stack_block_params(_regrad(seq_params), pp)
    for g, w in zip(got_g, tree_leaves(restacked)):
        np.testing.assert_allclose(g, w.numpy(), **FLAG_GRAD)


OPT_CASES = {"adamw": 1e-3, "adafactor": 1e-2, "sgd": 1e-2}


@pytest.mark.parametrize("optimizer", list(OPT_CASES))
def test_three_steps_match_jax(optimizer):
    """Three steps of make_pipelined_train_step (pp 4, 4 microbatches)
    against JAX's from the same weights: losses and parameters."""
    lr = OPT_CASES[optimizer]
    jcfg = JaxConfig(**MODEL)
    mesh = _jax_mesh(4)
    init_state, step = jax_make_pp(jcfg, mesh, learning_rate=lr,
                                   optimizer=optimizer)
    state = init_state(jax.random.PRNGKey(1))
    params0 = jax.tree.map(np.asarray, state["params"])
    tok = _tokens()
    want = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(tok))
        want.append(float(loss))
    cfg = TransformerConfig(**MODEL)
    t_init, t_step = make_pipelined_train_step(cfg, _port_mesh(4),
                                               learning_rate=lr,
                                               optimizer=optimizer)
    tstate = t_init.from_params(params_from_jax(params0, cfg, device="cpu"))
    losses = [float(t_step(tstate, torch.from_numpy(tok))[1])
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want, **LOSS)
    assert losses[-1] < losses[0]
    for got, w in _walk(tstate["params"],
                        jax.tree.map(np.asarray, state["params"])):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.detach().numpy(), w, **PARAMS)


def test_late_hop_misses_jax(monkeypatch):
    """The faulty control: a hop that delivers the previous step's
    activations, so stage s + 1 takes its microbatch one step late. The
    first loss already misses JAX's by more than LOSS."""
    _, stages = _jax_tree(4)
    tok = _tokens()
    jcfg, mesh = JaxConfig(**MODEL), _jax_mesh(4)
    want = jax.jit(lambda p, t: jax_pp_loss(p, t, jcfg, mesh))(
        jax.tree.map(jnp.asarray, stages), jnp.asarray(tok))
    held = []
    real = pipeline_module.ring_shift

    def late(y, ring):
        held.append(y)
        return real(held[-2] if len(held) > 1 else torch.zeros_like(y), ring)

    monkeypatch.setattr(pipeline_module, "ring_shift", late)
    cfg = TransformerConfig(**MODEL)
    got = float(pipeline_loss_fn(params_from_jax(stages, cfg, device="cpu"),
                                 torch.from_numpy(tok), cfg, _port_mesh(4)))
    assert abs(got - float(want)) > LOSS["atol"] + LOSS["rtol"] * abs(
        float(want)), (got, float(want))


def test_plain_flash_matches_dense():
    """The flagship's stages with attention_impl="flash" (the flash
    kernels' plain versions on the CPU) against dense attention: loss and
    gradients."""
    cfg = TransformerConfig(**MODEL)
    fcfg = TransformerConfig(**MODEL, attention_impl="flash")
    mesh = _port_mesh(2)
    tokens = torch.from_numpy(_tokens())
    params = init_pipelined_params(cfg, torch.Generator().manual_seed(2),
                                   mesh)
    dense, dense_g = _grads(lambda p: pipeline_loss_fn(p, tokens, cfg, mesh),
                            params)
    for x in tree_leaves(params):
        x.grad = None
    flash, flash_g = _grads(lambda p: pipeline_loss_fn(p, tokens, fcfg,
                                                       mesh), params)
    np.testing.assert_allclose(flash, dense, **LOSS)
    for g, w in zip(flash_g, dense_g):
        np.testing.assert_allclose(g, w, **FLAG_GRAD)


def test_init_and_forward_shapes():
    cfg = TransformerConfig(**MODEL)
    params = init_pipelined_params(cfg, torch.Generator().manual_seed(0),
                                   _port_mesh(4))
    assert params["stages"]["wq"].shape == (4, 1, 32, 4, 8)
    assert "blocks" not in params and params["embed"].device.type == "cpu"
    logits = forward_pipelined(params, torch.from_numpy(_tokens()[:, :-1]),
                               cfg, _port_mesh(4), microbatches=2)
    assert logits.shape == (8, 16, 64)
    with pytest.raises(ValueError, match="microbatches"):
        forward_pipelined(params, torch.from_numpy(_tokens()), cfg,
                          _port_mesh(4), microbatches=3)


def test_params_from_jax_takes_a_stages_tree():
    """A JAX stages tree carries across; one whose stage split does not
    make n_layers is refused."""
    _, stages = _jax_tree(2)
    cfg = TransformerConfig(**MODEL)
    params = params_from_jax(stages, cfg, device="cpu")
    for got, want in _walk(params, stages):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="stages"):
        params_from_jax(stages, TransformerConfig(**{**MODEL,
                                                     "n_layers": 2}),
                        device="cpu")


@pytest.mark.parametrize("change,match", [
    ({"n_layers": 3}, "stages"),
    ({"n_experts": 2}, "ep"),
    ({"attention_impl": "ring"}, "per-device"),
])
def test_invalid_configs_rejected(change, match):
    """The JAX package's three refusals, with its words."""
    jcfg = JaxConfig(**{**MODEL, **change})
    with pytest.raises(ValueError, match=match):
        jax_make_pp(jcfg, _jax_mesh(4))[0](jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        init_pipelined_params(TransformerConfig(**{**MODEL, **change}),
                              torch.Generator().manual_seed(0),
                              _port_mesh(4))
