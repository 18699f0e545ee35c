"""The port's state-space LM training against the JAX package's, on the CPU.

Mirrors ``tests/test_ssm.py``'s ``TestTraining`` at its config (vocab 61,
d_model 32, 2 layers, d_state 16, d_ff 64) and holds the port to JAX:
JAX's parameters go over through ``ssm_params_from_jax``, then the same
numpy tokens go through ``jax.grad`` of JAX's loss and the port's, and
through both packages' ``make_ssm_train_step`` (JAX's jitted), on one
device and data-parallel (JAX's on ``make_mesh(n, axis="dp")``, the port's
on n ``dp`` ranks on the CPU, where kernel 6 takes its plain version). The
twin of ``examples/ssm.py`` runs as a program.

Tolerances. Gradients, float32: atol = rtol = 1e-4, the scan's gradient
tolerance of ``tests/test_torch_scan.py`` (each gradient sums s products
through the two packages' differently ordered scans; 5.6e-7 is
measured). Three steps, float32: losses atol = rtol = 1e-5; parameters
atol 1e-4, rtol 1e-5 (AdamW's first update is lr · g / (|g| + eps), whose
slope near g = 0 is lr / eps: a rounding difference in a tiny gradient
element moves its parameter by up to 1e-4 at lr 1e-3; as
``tests/test_torch_vit.py``). bf16 compute: losses rtol 5e-3 (the loss
is a float32 mean over 160 positions of bf16 logits whose products round
in other orders; 2.4e-4 is measured); parameters by their relative L2 gap
||p - p_jax|| / ||p_jax - p0|| at most 0.1 (element by element bf16
rounding flips the sign of tiny gradients, and AdamW's update is about lr
· sign(g), so single elements part by up to 2 lr a step; the gap is 0.044,
and JAX's own bf16 step lies 0.051 from its float32 step). The dp step
against the one-device step and JAX's mesh step: loss rtol 1e-5,
``tests/test_ssm.py``'s own, and the parameters at the float32 step
tolerance (1.1e-7 and 4.8e-7 are measured). The faulty control (each
rank's copy of the bucket its own gradient, not the sum) must miss both:
its second and third losses are 1.3e-2 and 2.6e-2 off, its parameters
6e-3.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import SsmConfig as JaxSsmConfig  # noqa: E402
from mpi_tpu.models import make_ssm_train_step as jax_train  # noqa: E402
from mpi_tpu.models import ssm_forward as jax_forward  # noqa: E402
from mpi_tpu.models.transformer import token_xent as jax_xent  # noqa: E402
from mpi_tpu.parallel import linear_scan as jax_linear_scan  # noqa: E402
from mpi_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mpi_tpu_torch.models import (SsmConfig, make_ssm_train_step,  # noqa
                                  ssm_params_from_jax)
from mpi_tpu_torch.ops import attention, decode_attention  # noqa: E402
from mpi_tpu_torch.ops import ring_collectives  # noqa: E402
from mpi_tpu_torch.parallel import (RankMesh, linear_scan,  # noqa: E402
                                    make_mesh, sendrecv)
from mpi_tpu_torch.parallel.zero import (tree_leaves,  # noqa: E402
                                         tree_with_leaves)

ssm_mod = importlib.import_module("mpi_tpu_torch.models.ssm")

ROOT = Path(__file__).resolve().parent.parent
MODEL = dict(vocab=61, d_model=32, n_layers=2, d_state=16, d_ff=64)
JCFG = JaxSsmConfig(**MODEL)
CFG = SsmConfig(**MODEL)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
BF16_LOSS = dict(atol=0, rtol=5e-3)
BF16_PARAM_REL = 0.1
DP_LOSS = dict(atol=0, rtol=1e-5)
STEPS = 3
CPU = "cpu"


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)) \
        .astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _leaf_pairs(port, want):
    """(path, port leaf, JAX leaf) of every parameter, matched by key."""
    def walk(a, b, where):
        if isinstance(a, dict):
            return [p for k in a for p in walk(a[k], b[k], f"{where}/{k}")]
        if isinstance(a, list):
            return [p for i, (x, y) in enumerate(zip(a, b))
                    for p in walk(x, y, f"{where}/{i}")]
        return [(where, a, b)]

    return walk(port, want, "")


def _check_params(port, want, tol):
    pairs = _leaf_pairs(port, want)
    assert len(pairs) == len(jax.tree.leaves(want)) == 4 + 2 * 13
    for where, x, w in pairs:
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(w),
                                   err_msg=where, **tol)


@pytest.fixture(scope="module")
def jax_runs():
    """A cache (optimizer, dtype, dp, batch) -> (initial parameters, the
    tokens, STEPS losses, the parameters after them) of JAX's
    make_ssm_train_step (on ``make_mesh(dp, axis="dp")`` when dp > 0),
    filled on first use."""
    cache = {}

    def get(optimizer="adamw", dtype=jnp.float32, dp=0, batch=8):
        key = (optimizer, dtype, dp, batch)
        if key not in cache:
            jcfg = dataclasses.replace(JCFG, dtype=dtype)
            init_state, step = jax_train(jcfg, optimizer=optimizer)
            state = _np(init_state(jax.random.PRNGKey(2)))
            params0 = state["params"]
            if dp:  # the same initial state, replicated over the mesh
                mesh = jax_make_mesh(dp, axis="dp")
                _, step = jax_train(jcfg, optimizer=optimizer, mesh=mesh)
                state = jax.device_put(state, NamedSharding(mesh, P()))
            toks = _tokens(batch, 21, seed=13)
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, jnp.asarray(toks))
                losses.append(float(loss))
            assert int(state["step"]) == STEPS
            cache[key] = (params0, toks, losses, _np(state["params"]))
        return cache[key]

    return get


def _port_steps(params0, toks, cfg=CFG, optimizer="adamw", mesh=None,
                steps=STEPS):
    init_state, step = make_ssm_train_step(cfg, optimizer=optimizer,
                                           mesh=mesh)
    state = init_state.from_params(ssm_params_from_jax(params0, cfg, CPU))
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.from_numpy(toks))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        losses.append(float(loss))
    assert state["step"] == steps
    return state, losses


def _dp_mesh(n):
    return make_mesh(axis="dp", devices=[CPU] * n)


# ---- the gradient -----------------------------------------------------------

def test_gradient_matches_jax_on_every_leaf(jax_runs):
    params0, _, _, _ = jax_runs()
    toks = _tokens(4, 25, seed=5)

    def jax_loss(p, t):
        return jax_xent(jax_forward(JCFG, p, t[:, :-1]), t[:, 1:])

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree.map(jnp.asarray, params0), jnp.asarray(toks))
    params = ssm_params_from_jax(params0, CFG, CPU)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss = ssm_mod._loss(CFG, params, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, want_loss, LOSS)
    grad_tree = tree_with_leaves(params, iter(grads))
    pairs = _leaf_pairs(grad_tree, _np(want))
    for where, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w, err_msg=where, **GRAD_TOL)
    # The decay's leaves get a real gradient through the complex scan.
    for blk in grad_tree["blocks"]:
        assert float(blk["nu_log"].abs().max()) > 1e-4
        assert float(blk["theta_log"].abs().max()) > 1e-4


def test_broadcast_decay_gradient_through_the_scan():
    """lam (h,) built from real leaves, broadcast over (b, s, h) complex
    drives: the scan's backward sums the decay's gradient over b and s as
    ``jax.grad`` does through ``broadcast_to``."""
    rng = np.random.default_rng(3)
    b, s, h = 2, 13, 5
    nu = rng.uniform(-2.0, 0.0, h).astype(np.float32)
    theta = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    re, im = (rng.standard_normal((b, s, h)).astype(np.float32)
              for _ in range(2))
    w1, w2 = (rng.standard_normal((b, s, h)).astype(np.float32)
              for _ in range(2))

    def jax_f(nu, theta, re, im):
        lam = jnp.exp(-jnp.exp(nu) + 1j * jnp.exp(theta))
        x = jax_linear_scan(jnp.broadcast_to(lam, (b, s, h)),
                            re + 1j * im, axis=1)
        return jnp.sum(x.real * w1 + x.imag * w2)

    want = jax.jit(jax.grad(jax_f, argnums=(0, 1, 2, 3)))(nu, theta, re, im)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (nu, theta, re, im)]
    lam = torch.exp(torch.complex(-torch.exp(leaves[0]),
                                  torch.exp(leaves[1])))
    x = linear_scan(lam, torch.complex(leaves[2], leaves[3]), dim=1)
    out = (x.real * torch.from_numpy(w1) + x.imag * torch.from_numpy(w2)
           ).sum()
    for g, w in zip(torch.autograd.grad(out, leaves), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


# ---- steps on one device ----------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_three_steps_match_jax(jax_runs, optimizer):
    params0, toks, want_losses, want_params = jax_runs(optimizer)
    state, losses = _port_steps(params0, toks, optimizer=optimizer)
    _close(torch.tensor(losses), want_losses, LOSS)
    assert losses[-1] < losses[0]
    _check_params(state["params"], want_params, PARAMS)


def test_bf16_steps_match_jax(jax_runs):
    params0, toks, want_losses, want_params = jax_runs(dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    state, losses = _port_steps(params0, toks, cfg)
    _close(torch.tensor(losses), want_losses, BF16_LOSS)
    # The masters stay float32.
    assert all(x.dtype == torch.float32
               for x in tree_leaves(state["params"]))
    start = dict((w, p) for w, p, _ in _leaf_pairs(params0, params0))
    gap = moved = 0.0
    for where, x, w in _leaf_pairs(state["params"], want_params):
        w = np.asarray(w, np.float64)
        gap += float(((x.detach().double().numpy() - w) ** 2).sum())
        moved += float(((w - start[where]) ** 2).sum())
    assert (gap / moved) ** 0.5 <= BF16_PARAM_REL


def test_loss_decreases():
    """The twin of ``tests/test_ssm.py::TestTraining::test_loss_decreases``
    (the port's own draws)."""
    init_state, step = make_ssm_train_step(CFG, learning_rate=3e-3)
    state = init_state(torch.Generator().manual_seed(1), CPU)
    assert state["step"] == 0
    toks = torch.from_numpy(_tokens(4, 33, seed=11))
    losses = [float(step(state, toks)[1]) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.8, losses
    assert state["step"] == 12


def test_from_params_builds_the_state_around_the_tree(jax_runs):
    params0, _, _, _ = jax_runs()
    params = ssm_params_from_jax(params0, CFG, CPU)
    init_state, _ = make_ssm_train_step(CFG)
    state = init_state.from_params(params)
    assert state["params"] is params and state["step"] == 0
    assert all(x.requires_grad for x in tree_leaves(params))


# ---- data parallel ----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_dp_step_matches_jax_mesh_and_one_device(jax_runs, n):
    """The twin of ``test_dp_sharded_step_matches_single`` at n ranks, over
    three steps, the parameters held too."""
    params0, toks, want_losses, want_params = jax_runs(dp=n)
    _, _, one_losses, one_params = jax_runs()
    state, losses = _port_steps(params0, toks, mesh=_dp_mesh(n))
    _, port_one = _port_steps(params0, toks)
    _close(torch.tensor(losses), want_losses, DP_LOSS)
    _close(torch.tensor(losses), one_losses, DP_LOSS)
    _close(torch.tensor(losses), port_one, DP_LOSS)
    _check_params(state["params"], want_params, PARAMS)
    _check_params(state["params"], one_params, PARAMS)


def test_other_mesh_axes_carry_nothing(jax_runs):
    """A (dp 2, sp 2) mesh trains as a dp-2 mesh, bit for bit; a dp axis
    of 1 is the one-device step."""
    params0, toks, want_losses, _ = jax_runs(dp=2)
    state2, losses2 = _port_steps(params0, toks, mesh=_dp_mesh(2))
    mesh = RankMesh([CPU] * 4, ("dp", "sp"), (2, 2))
    state, losses = _port_steps(params0, toks, mesh=mesh)
    assert losses == losses2
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(state2["params"])))
    _close(torch.tensor(losses), want_losses, DP_LOSS)
    state1, losses1 = _port_steps(params0, toks, mesh=_dp_mesh(1))
    _, one = _port_steps(params0, toks)
    assert losses1 == one


def test_rank0_gradient_control_misses(jax_runs, monkeypatch):
    """Each rank's copy of the bucket its own gradient times n, as if it
    were the sum: the step then takes rank 0's gradient alone."""
    params0, toks, want_losses, want_params = jax_runs(dp=4)
    monkeypatch.setattr(ssm_mod, "ring_allreduce",
                        lambda contribs, ring, op="sum":
                        contribs * ring.size)
    state, losses = _port_steps(params0, toks, mesh=_dp_mesh(4))
    # The first loss is computed before any update; the later ones miss.
    _close(torch.tensor(losses[:1]), want_losses[:1], DP_LOSS)
    assert not np.allclose(losses[1:], want_losses[1:], **DP_LOSS)
    pairs = _leaf_pairs(state["params"], want_params)
    assert not all(np.allclose(x.detach().numpy(), w, **PARAMS)
                   for _, x, w in pairs)


def test_refusals():
    toks = torch.from_numpy(_tokens(6, 9))
    init_state, step = make_ssm_train_step(CFG, mesh=_dp_mesh(4))
    state = init_state(torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="batch 6 not divisible by dp=4"):
        step(state, toks)
    with pytest.raises(ValueError, match="'dp' axis"):
        make_ssm_train_step(CFG, mesh=make_mesh(axis="sp",
                                                devices=[CPU] * 2))
    with pytest.raises(TypeError, match="RankMesh"):
        make_ssm_train_step(CFG, mesh=object())
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_ssm_train_step(CFG, optimizer="lion")


def test_cpu_steps_count_no_kernel_launch():
    wrappers = [attention.flash_fwd, attention.flash_bwd_dq,
                attention.flash_bwd_dkv,
                decode_attention.flash_decode_attention,
                ring_collectives.ring_allgather,
                ring_collectives.ring_allreduce, sendrecv]
    before = [w.launches for w in wrappers]
    toks = torch.from_numpy(_tokens(4, 9))
    for mesh in (None, _dp_mesh(4)):
        init_state, step = make_ssm_train_step(CFG, mesh=mesh)
        step(init_state(torch.Generator().manual_seed(0), CPU), toks)
    assert [w.launches for w in wrappers] == before


# ---- the example ------------------------------------------------------------

def test_example_runs_on_the_cpu():
    # One thread: the model is tiny, and the test workers share the cores.
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.examples.ssm", "--device",
         CPU, "--sp", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ssm example OK" in res.stdout
