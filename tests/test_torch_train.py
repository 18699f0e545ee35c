"""The port's training slice against the JAX package's, on the CPU.

The JAX ``init_params`` tree goes to the port through ``params_from_jax``
(as numpy arrays), then the same token ids go through both packages, in
float32, at a small size (d_model 64, 2 layers, seq 32). JAX's flash
attention runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances, all float32 and all from summation order:
* loss atol = rtol = 1e-5, every gradient leaf atol 1e-5, rtol 1e-4 (the
  largest differences seen are 1e-6 and 1e-7);
* after AdamW steps the losses agree to 1e-5 and the parameters to atol
  1e-4, rtol 1e-5. The first AdamW update is lr * g / (|g| + eps), whose
  slope near g = 0 is lr / eps = 1e5, so a gradient element of about 1e-8
  turns a rounding difference of 1e-9 into up to 1e-4 in its parameter;
  the largest differences seen are 5e-6 in the loss and 7e-6 in a
  parameter.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.models.transformer import loss_fn as jax_loss_fn  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, loss_fn,  # noqa: E402
                                  make_optimizer, make_train_parts,
                                  make_train_step, params_from_jax,
                                  token_xent)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402

LOSS = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
PARAMS = dict(atol=1e-4, rtol=1e-5)
BASE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=33)
VARIANTS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
IMPLS = ["dense", "flash"]


def _configs(variant, impl, **extra):
    kw = {**BASE, **VARIANTS[variant], "attention_impl": impl, **extra}
    return JaxConfig(**kw), TransformerConfig(**kw)


def _tokens(b=4, s=33, seed=0):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, s)).astype(np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for node in tree for x in _leaves(node)]
    return [tree]


def _jax_leaves(tree):
    """JAX leaves in the port's traversal order (dict insertion order;
    jax.tree sorts dict keys)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _jax_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for node in tree for x in _jax_leaves(node)]
    return [np.asarray(tree)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def trees():
    """variant -> the JAX init_params tree."""
    return {v: jax_init(jax.random.PRNGKey(i), _configs(v, "dense")[0])
            for i, v in enumerate(VARIANTS)}


def _port(tree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                           device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_gradient_match_jax(trees, variant, impl):
    jcfg, tcfg = _configs(variant, impl)
    tok = _tokens()
    want_loss, want_grads = jax.value_and_grad(jax_loss_fn)(
        trees[variant], jnp.asarray(tok), jcfg)
    params = _port(trees[variant], tcfg)
    leaves = _leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(tok), tcfg)
    loss.backward()
    _close(loss, want_loss, LOSS)
    want = _jax_leaves(want_grads)
    assert len(want) == len(leaves)
    for x, w in zip(leaves, want):
        assert x.grad.shape == w.shape
        _close(x.grad, w, GRAD)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_adamw_steps_match_jax(variant, impl):
    """Losses of three steps and the parameters after them, against the
    JAX step (optax.adamw at lr 1e-3, weight decay 1e-4)."""
    jcfg, tcfg = _configs(variant, impl)
    tok = _tokens(seed=1)
    j_init, j_step = jax_make_train_step(jcfg)
    j_state = j_init(jax.random.PRNGKey(7))
    init_state, step = make_train_step(tcfg)
    state = init_state.from_params(_port(j_state["params"], tcfg))
    for _ in range(3):
        j_state, j_loss = j_step(j_state, jnp.asarray(tok))
        state, loss = step(state, torch.from_numpy(tok))
        _close(loss, j_loss, LOSS)
    for x, w in zip(_leaves(state["params"]),
                    _jax_leaves(j_state["params"])):
        _close(x, w, PARAMS)


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_gives_the_same_gradients(trees, impl):
    _, tcfg = _configs("gqa", impl)
    _, rcfg = _configs("gqa", impl, remat=True)
    tok = torch.from_numpy(_tokens(seed=2))
    grads = []
    for cfg in (tcfg, rcfg):
        params = _port(trees["gqa"], cfg)
        leaves = _leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss_fn(params, tok, cfg).backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_grad_accum_matches_full_batch(trees, impl):
    """Two microbatches average to the full batch's gradient, so one
    update gives the same parameters (as tests/test_models.py checks for
    the JAX step)."""
    _, tcfg = _configs("mha", impl)
    tok = torch.from_numpy(_tokens(seed=3))
    results = []
    for k in (1, 2):
        init_state, step = make_train_step(tcfg, grad_accum=k)
        state = init_state.from_params(_port(trees["mha"], tcfg))
        state, loss = step(state, tok)
        results.append((loss, _leaves(state["params"])))
    (l1, p1), (l2, p2) = results
    torch.testing.assert_close(l1, l2, atol=1e-6, rtol=1e-5)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_fresh_state_trains_on_cpu():
    _, tcfg = _configs("gqa", "flash")
    init_state, step = make_train_step(tcfg, learning_rate=1e-2)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    assert set(state) == {"params", "opt"}
    assert all(x.dtype == torch.float32 and x.requires_grad and x.is_leaf
               for x in _leaves(state["params"]))
    tok = torch.from_numpy(_tokens(seed=4))
    losses = [float(step(state, tok)[1]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_params_from_jax_gives_float32_master_leaves(trees):
    _, tcfg = _configs("mha", "flash", dtype=torch.bfloat16)
    params = _port(trees["mha"], tcfg)
    leaves = _leaves(params)
    assert all(x.dtype == torch.float32 and x.is_leaf for x in leaves)
    init_state, step = make_train_step(tcfg)
    state = init_state.from_params(params)
    assert all(x.requires_grad for x in leaves)
    state, loss = step(state, torch.from_numpy(_tokens(seed=5)))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(x.grad is not None and x.grad.dtype == torch.float32
               for x in leaves)


def test_token_xent_is_mean_logsumexp_minus_target():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(
        np.float32))
    targets = torch.from_numpy(rng.integers(0, 7, (2, 5)))
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 7),
                                             targets.reshape(-1))
    torch.testing.assert_close(token_xent(logits, targets), want)


def test_indivisible_batch_raises(trees):
    _, tcfg = _configs("mha", "dense")
    init_state, step = make_train_step(tcfg, grad_accum=3)
    state = init_state.from_params(_port(trees["mha"], tcfg))
    with pytest.raises(ValueError, match="divisible"):
        step(state, torch.from_numpy(_tokens()))
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(tcfg, grad_accum=0)


@pytest.mark.parametrize("kwargs,match", [
    # A mesh whose ranks lie on distinct devices; another object than a
    # RankMesh raises TypeError (checked in the body).
    ({"mesh": RankMesh(["cpu", "cuda:0"], ("sp",))}, "NVLink peer path"),
])
def test_unported_options_raise(kwargs, match):
    _, tcfg = _configs("mha", "dense")
    with pytest.raises(NotImplementedError, match=match):
        make_train_parts(tcfg, **kwargs)
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match="RankMesh"):
            make_train_parts(tcfg, mesh=object())


@pytest.mark.parametrize("kwargs", [{"zero1": True}, {"fsdp": True}])
def test_sharding_without_a_dp_axis_raises(kwargs):
    """zero1 and fsdp need a mesh with a dp axis: ValueError, as the JAX
    package raises."""
    _, tcfg = _configs("mha", "dense")
    with pytest.raises(ValueError, match="'dp' axis"):
        make_train_parts(tcfg, **kwargs)
    with pytest.raises(ValueError, match="'dp' axis"):
        make_train_parts(tcfg, mesh=RankMesh(["cpu"] * 2, ("sp",)),
                         **kwargs)


@pytest.mark.parametrize("flags", [
    [], ["--zero1"], ["--fsdp"], ["--tp", "2"],
    ["--optimizer", "adafactor", "--warmup-steps", "1"],
    ["--optimizer", "sgd", "--tp", "2", "--fsdp"]])
def test_train_cli_data_parallel_on_cpu(flags, capsys):
    """``python -m mpi_tpu_torch.train --dp 2`` (and with ``--zero1``,
    ``--fsdp``, ``--tp 2`` or another optimizer and schedule) at tiny
    widths on the CPU: two ranks of a dp mesh, finite losses."""
    from mpi_tpu_torch import train

    assert train.main(["--layers", "1", "--seq", "16", "--batch", "2",
                       "--steps", "2", "--dp", "2", "--device", "cpu",
                       *flags]) == 0
    out = capsys.readouterr().out
    assert "dp=2" in out and "step 1 loss" in out


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")
