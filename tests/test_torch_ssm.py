"""The port's state-space LM against the JAX package's, on the CPU.

Mirrors ``tests/test_ssm.py``'s forward, decode, prefill and
sequence-parallel classes at its config (vocab 61, d_model 32, 2 layers,
d_state 16, d_ff 64) and holds the port to JAX: JAX's parameters go over
through ``ssm_params_from_jax``, then the same numpy tokens go through
both packages' ``ssm_forward``, ``ssm_forward_sp`` (JAX's under
``shard_map`` on ``make_mesh(n, axis="sp")``), ``ssm_step``,
``ssm_prefill`` and ``ssm_decode``. Training is held in
``test_torch_ssm_train.py``.

Tolerances. Port against JAX, float32: atol = rtol = 3e-5, the complex
scan's tolerance of ``tests/test_ssm.py`` (the logits come through two
such scans, and the two packages' scans combine in different trees; about
1e-5 is measured). bf16 compute: atol 5e-2, rtol 2e-2 (one bf16 step at
the logits' size 2-4 is 1.6e-2; the products round in other orders).
Within the port: sequential steps against the scan 2e-3 and the sp
forward against one device 3e-3, ``tests/test_ssm.py``'s own; causality
``tests/test_ssm.py``'s 1e-5.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import SsmConfig as JaxSsmConfig  # noqa: E402
from mpi_tpu.models import init_ssm_params as _jax_init  # noqa: E402
from mpi_tpu.models import init_ssm_state as jax_init_state  # noqa: E402
from mpi_tpu.models import ssm_decode as jax_decode  # noqa: E402
from mpi_tpu.models import ssm_forward as _jax_forward  # noqa: E402
from mpi_tpu.models import ssm_forward_sp as jax_forward_sp  # noqa: E402
from mpi_tpu.models import ssm_prefill as _jax_prefill  # noqa: E402
from mpi_tpu.models import ssm_step as jax_step  # noqa: E402
from mpi_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mpi_tpu_torch.models import (SsmConfig, init_ssm_params,  # noqa: E402
                                  init_ssm_state, ssm_decode, ssm_forward,
                                  ssm_forward_sp, ssm_params_from_jax,
                                  ssm_prefill, ssm_step)
from mpi_tpu_torch.parallel import make_mesh  # noqa: E402

MODEL = dict(vocab=61, d_model=32, n_layers=2, d_state=16, d_ff=64)
JCFG = JaxSsmConfig(**MODEL)
CFG = SsmConfig(**MODEL)
JAX_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=5e-2, rtol=2e-2)
STEP_TOL = dict(atol=2e-3, rtol=2e-3)
SP_TOL = dict(atol=3e-3, rtol=3e-3)
CAUSAL_TOL = dict(atol=1e-5, rtol=1e-5)
CPU = "cpu"
# Jitted: eager dispatch of JAX's scans took seconds a call.
jax_init = jax.jit(_jax_init, static_argnums=0)
jax_forward = jax.jit(_jax_forward, static_argnums=0)
jax_prefill = jax.jit(_jax_prefill, static_argnums=0)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return ssm_params_from_jax(jax.tree.map(np.asarray, jparams), CFG, CPU)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)) \
        .astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---- the forward ------------------------------------------------------------

@pytest.mark.parametrize("b,s,seed", [(2, 17, 0), (1, 257, 7)])
def test_forward_matches_jax(jparams, params, b, s, seed):
    toks = _tokens(b, s, seed)
    want = jax_forward(JCFG, jparams, jnp.asarray(toks))
    got = ssm_forward(CFG, params, torch.from_numpy(toks), device=CPU)
    assert got.shape == (b, s, CFG.vocab) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _close(got, want, JAX_TOL)


def test_bf16_forward_matches_jax(jparams, params):
    toks = _tokens(2, 33, seed=2)
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    want = jax_forward(jcfg, jparams, jnp.asarray(toks)).astype(jnp.float32)
    got = ssm_forward(cfg, params, torch.from_numpy(toks), device=CPU)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_strictly_causal(params):
    """Changing token t changes no logit before t, and some after."""
    toks = torch.from_numpy(_tokens(1, 12, seed=3))
    base = ssm_forward(CFG, params, toks, device=CPU)
    bumped = toks.clone()
    bumped[0, 7] = (bumped[0, 7] + 1) % CFG.vocab
    out = ssm_forward(CFG, params, bumped, device=CPU)
    torch.testing.assert_close(out[:, :7], base[:, :7], **CAUSAL_TOL)
    assert not torch.allclose(out[:, 7:], base[:, 7:])


# ---- step, prefill, decode --------------------------------------------------

def test_steps_and_prefill_match_jax(jparams, params):
    toks = _tokens(2, 11, seed=41)
    j_state, t_state = jax_init_state(JCFG, 2), init_ssm_state(CFG, 2, CPU)
    assert [s.dtype for s in t_state] == [torch.complex64] * CFG.n_layers
    step = jax.jit(lambda st, t: jax_step(JCFG, jparams, st, t))
    full = ssm_forward(CFG, params, torch.from_numpy(toks), device=CPU)
    for i in range(toks.shape[1]):
        j_state, j_logits = step(j_state, jnp.asarray(toks[:, i]))
        t_state, t_logits = ssm_step(CFG, params, t_state,
                                     torch.from_numpy(toks[:, i]),
                                     device=CPU)
        _close(t_logits, j_logits, JAX_TOL)
        # The step is the scan's recurrence carried explicitly.
        torch.testing.assert_close(t_logits, full[:, i], **STEP_TOL)
    for got, want in zip(t_state, j_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    p_state, p_logits = ssm_prefill(CFG, params, torch.from_numpy(toks),
                                    device=CPU)
    jp_state, jp_logits = jax_prefill(JCFG, jparams, jnp.asarray(toks))
    _close(p_logits, jp_logits, JAX_TOL)
    for got, want, seq in zip(p_state, jp_state, t_state):
        assert got.shape == (2, CFG.d_state) and got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
        torch.testing.assert_close(got, seq, **STEP_TOL)
    torch.testing.assert_close(p_logits, t_logits, **STEP_TOL)


@pytest.mark.parametrize("b,p,n_new,seed", [(2, 6, 5, 17), (1, 5, 12, 19)])
def test_decode_matches_jax_and_the_teacher_forced_argmax(jparams, params,
                                                          b, p, n_new, seed):
    prompt = _tokens(b, p, seed)
    want = np.asarray(jax_decode(JCFG, jparams, jnp.asarray(prompt), n_new))
    got = ssm_decode(CFG, params, torch.from_numpy(prompt).long(), n_new,
                     device=CPU)
    assert got.shape == (b, p + n_new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # Greedy: each new token is the argmax of the full forward over what
    # came before it.
    full = ssm_forward(CFG, params, got[:, :-1], device=CPU)
    torch.testing.assert_close(got[:, p:], full[:, p - 1:].argmax(-1))
    again = ssm_decode(CFG, params, torch.from_numpy(prompt).long(), n_new,
                       device=CPU)
    assert torch.equal(got, again)


def test_zero_new_tokens_and_empty_prompt(params):
    prompt = torch.from_numpy(_tokens(1, 4)).long()
    for n_new in (0, -1):
        assert torch.equal(ssm_decode(CFG, params, prompt, n_new,
                                      device=CPU), prompt)
    empty = torch.zeros((2, 0), dtype=torch.long)
    out = ssm_decode(CFG, params, empty, 5, device=CPU)
    assert out.shape == (2, 0)


# ---- sequence parallel ------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
def test_forward_sp_matches_jax(jparams, params, n):
    toks = _tokens(2, n * 8, seed=31)
    body = jax.shard_map(
        lambda t: jax_forward_sp(JCFG, jparams, t, "sp"),
        mesh=jax_make_mesh(n, axis="sp"), in_specs=P(None, "sp"),
        out_specs=P(None, "sp"), check_vma=False)
    want = jax.jit(body)(jnp.asarray(toks))
    mesh = make_mesh(n, axis="sp", devices=[CPU] * n)
    got = ssm_forward_sp(CFG, params, torch.from_numpy(toks), mesh,
                         device=CPU)
    assert got.shape == (2, n * 8, CFG.vocab)
    _close(got, want, JAX_TOL)
    one = ssm_forward(CFG, params, torch.from_numpy(toks), device=CPU)
    torch.testing.assert_close(got, one, **SP_TOL)


def test_forward_sp_on_a_mesh_with_other_axes(params):
    """The sp ring of a (dp, sp) mesh; one sp rank is the plain forward."""
    from mpi_tpu_torch.parallel import RankMesh

    toks = torch.from_numpy(_tokens(2, 24, seed=5))
    one = ssm_forward(CFG, params, toks, device=CPU)
    mesh = RankMesh([CPU] * 6, ("dp", "sp"), (2, 3))
    got = ssm_forward_sp(CFG, params, toks, mesh, device=CPU)
    torch.testing.assert_close(got, one, **SP_TOL)
    single = make_mesh(1, axis="sp", devices=[CPU])
    assert torch.equal(ssm_forward_sp(CFG, params, toks, single, device=CPU),
                       one)


def test_forward_sp_refusals(params):
    toks = torch.from_numpy(_tokens(2, 10))
    with pytest.raises(ValueError, match="does not split over 4"):
        ssm_forward_sp(CFG, params, toks,
                       make_mesh(4, axis="sp", devices=[CPU] * 4), device=CPU)
    with pytest.raises(ValueError, match="has no 'sp' axis"):
        ssm_forward_sp(CFG, params, toks,
                       make_mesh(2, axis="dp", devices=[CPU] * 2), device=CPU)


# ---- parameters -------------------------------------------------------------

def test_init_ranges_and_shapes():
    cfg = dataclasses.replace(CFG, d_state=4096)
    params = init_ssm_params(cfg, torch.Generator().manual_seed(3), CPU)
    for blk in params["blocks"]:
        lam_abs = torch.exp(-torch.exp(blk["nu_log"].double()))
        theta = torch.exp(blk["theta_log"].double())
        # float32 storage: the log round trip moves a draw by an ulp or so.
        assert float(lam_abs.min()) >= cfg.r_min - 1e-6
        assert float(lam_abs.max()) < cfg.r_max + 1e-6
        assert float(theta.min()) >= 1e-6 * (1 - 1e-6)
        assert float(theta.max()) < math.pi
        assert bool(torch.isfinite(blk["theta_log"]).all())
        # Spread over the range, not bunched at one end.
        assert float(lam_abs.max()) > 0.98 and float(lam_abs.min()) < 0.45
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          jax_init(JaxSsmConfig(**{**MODEL, "d_state": 4096}),
                                   jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), params) == shapes
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(params))


def test_params_from_jax_refuses_a_tree_that_disagrees(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match=r"nu_log has shape \(16,\); "
                                         r"cfg wants \(8,\)"):
        ssm_params_from_jax(tree, dataclasses.replace(CFG, d_state=8), CPU)
    with pytest.raises(ValueError, match="embed has shape"):
        ssm_params_from_jax(tree, dataclasses.replace(CFG, vocab=64), CPU)
    with pytest.raises(ValueError, match="3 layers"):
        ssm_params_from_jax(tree, dataclasses.replace(CFG, n_layers=3), CPU)
    bad = {**tree, "extra": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="holds"):
        ssm_params_from_jax(bad, CFG, CPU)


def test_entry_points_refuse_params_on_another_device(params):
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: ssm_forward(CFG, params, toks, device="meta"),
                 lambda: ssm_prefill(CFG, params, toks, device="meta"),
                 lambda: ssm_decode(CFG, params, toks, 2, device="meta")):
        with pytest.raises(ValueError, match="params lie on"):
            call()


def test_serve_runs_the_ssm_row(capsys):
    """serve.py's fourth row, the twin of ``examples/serve.py``'s: the
    small SSM's recurrent decode beside the flagship's rows (one layer of
    the flagship's widths, on the CPU)."""
    from mpi_tpu_torch import serve

    assert serve.main(["--layers", "1", "--batch", "2", "--prompt-len", "8",
                       "--tokens", "4", "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "ssm decode (no KV cache)" in out
    assert "outputs in vocab: True" in out
