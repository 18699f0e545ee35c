"""The port's Mixture-of-Experts against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``mpi_tpu.models.moe.moe_ffn`` and ``mpi_tpu_torch.models.moe.moe_ffn``;
the flagship with experts goes through both packages' loss, training step
and greedy generation from one JAX parameter tree (``params_from_jax``).

Routing is discontinuous: a rounding difference near a tie flips an expert
and moves a token's output by O(1). So each ``moe_ffn`` case first holds
the port's routing decisions (each choice's expert, ``topk_idx``, and
whether it found a slot, ``kept``) equal to the JAX package's, element for
element, then the outputs. Tolerances, float32 and from summation order:
``moe_ffn``'s ``y`` and aux rtol 1e-5 and its gradients rtol 1e-4, each
with an atol of 1e-6 (``y``) or 1e-5 (gradients) times the largest element
of the array it compares (the biased cases feed the router x = 10 and give
outputs near 300, whose float32 sums round at about 3e-5); the model's
losses atol = rtol = 1e-5, its gradients atol 1e-5, rtol 1e-4; parameters
after three AdamW steps atol 1e-4, rtol 1e-5 (``tests/test_torch_train.py``
explains the last).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import generate as jax_generate  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.models import quantize_params as jax_quantize  # noqa: E402
from mpi_tpu.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from mpi_tpu.models.transformer import loss_fn as jax_loss_fn  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, generate,  # noqa: E402
                                  init_moe_params, init_params, loss_fn,
                                  make_train_step, moe_ffn, moe_specs,
                                  params_from_jax, quantize_params)
from mpi_tpu_torch.models import moe as port_moe  # noqa: E402
from mpi_tpu_torch.models.quant import QTensor  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

OUT = dict(atol=1e-6, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17, n_experts=4)
# moe_ffn cases: (experts, top_k, capacity_factor, router bias, seq).
# "biased" routes every token to expert 0 (a logit of 1000) and leaves
# experts 1-3 tied at 0, so top-2's second choice is a three-way tie
# (lax.top_k: the lower index); "choice-major" is the JAX test's two
# experts, first choice 0 and second 1 for every token, 3 slots for 6
# tokens.
FFN_CASES = {
    "top1-high-capacity": (4, 1, 4.0, None, 8),
    "top2-high-capacity": (4, 2, 4.0, None, 8),
    "top2-default": (4, 2, 1.25, None, 8),
    "top1-biased-overflow": (4, 1, 0.3, "biased", 8),
    "top2-biased-overflow": (4, 2, 0.3, "biased", 8),
    "top2-choice-major": (2, 2, 0.5, "choice-major", 6),
}


def _ffn_inputs(case, d=8, f=16, b=2, seed=0):
    """(numpy params, numpy x, experts, top_k, capacity_factor)."""
    e, k, cf, bias, s = FFN_CASES[case]
    rng = np.random.default_rng(seed)
    params = {
        "router": rng.standard_normal((d, e)).astype(np.float32) / d ** .5,
        "w1e": rng.standard_normal((e, d, f)).astype(np.float32) / d ** .5,
        "w2e": rng.standard_normal((e, f, d)).astype(np.float32) / f ** .5,
    }
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    if bias == "biased":
        params["router"] = np.zeros_like(params["router"])
        params["router"][0, 0] = 100.0
        x[..., 0] = 10.0
    elif bias == "choice-major":
        params["router"] = np.zeros_like(params["router"])
        params["router"][0] = [5.0, 1.0]
        x[..., 0] = 1.0
    return params, x, e, k, cf


def _jax_route(x, router, e, k, cf):
    """``mpi_tpu/models/moe.py:87-104``'s routing, in jnp: (topk_idx,
    kept)."""
    b, s, _ = x.shape
    capacity = max(1, int(math.ceil(k * s / e * cf)))
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", x, router).astype(
        jnp.float32), axis=-1)
    _, idx = lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    ordered = onehot.transpose(0, 2, 1, 3).reshape(b, k * s, e)
    pos = jnp.einsum("gme,gme->gm", jnp.cumsum(ordered, axis=1) - ordered,
                     ordered).reshape(b, k, s).transpose(0, 2, 1)
    return np.asarray(idx), np.asarray(pos < capacity)


def _close_scaled(got, want, atol, rtol):
    """assert_allclose with ``atol`` relative to the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1.0))


def _port_tensors(params, x):
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    return tp, torch.from_numpy(x.copy()).requires_grad_(True)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_routes_and_computes_as_jax(case):
    params, x, e, k, cf = _ffn_inputs(case)
    want_idx, want_kept = _jax_route(jnp.asarray(x),
                                     jnp.asarray(params["router"]), e, k, cf)
    capacity = max(1, int(math.ceil(k * x.shape[1] / e * cf)))
    _, _, idx, kept, _ = port_moe.route(torch.from_numpy(x),
                                        torch.from_numpy(params["router"]),
                                        e, capacity, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    if case.endswith("overflow") or case.endswith("choice-major"):
        assert not want_kept.all()  # the case overflows

    # The objective: y against a fixed cotangent, plus the aux penalty.
    ct = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jax_obj(p, xx):
        y, aux = jax_moe_ffn(xx, p, e, capacity_factor=cf, top_k=k)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (wy, waux)), (wgp, wgx) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp, tx = _port_tensors(params, x)
    y, aux = moe_ffn(tx, tp, e, capacity_factor=cf, top_k=k)
    assert y.shape == tx.shape and aux.dtype == torch.float32
    _close_scaled(y.detach().numpy(), wy, **OUT)
    _close_scaled(aux.item(), waux, **OUT)
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    _close_scaled(tx.grad.numpy(), wgx, **GRAD)
    for name in ("router", "w1e", "w2e"):
        _close_scaled(tp[name].grad.numpy(), wgp[name], **GRAD)


@pytest.mark.parametrize("top_k", [0, 5])
def test_top_k_out_of_range_raises(top_k):
    params, x, e, _, _ = _ffn_inputs("top2-default")
    tp, tx = _port_tensors(params, x)
    with pytest.raises(ValueError, match="top_k"):
        moe_ffn(tx, tp, e, top_k=top_k)


def test_init_and_specs_follow_the_jax_tree():
    """A block with experts holds ``moe`` and no w1/w2; the shapes and the
    specs are the JAX package's."""
    cfg = TransformerConfig(**MODEL)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                              JaxConfig(**MODEL)))
    for blk, jblk in zip(params["blocks"], jparams["blocks"]):
        assert set(blk) == set(jblk) and "w1" not in blk
        for name in ("router", "w1e", "w2e"):
            assert tuple(blk["moe"][name].shape) == jblk["moe"][name].shape
    own = init_moe_params(32, 64, 4, torch.bfloat16,
                          torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        "router": ((32, 4), torch.bfloat16),
        "w1e": ((4, 32, 64), torch.bfloat16),
        "w2e": ((4, 64, 32), torch.bfloat16)}
    assert moe_specs() == {"router": (), "w1e": ("ep", None, "tp"),
                           "w2e": ("ep", "tp", None)}


# --------------------------------------------------------------------------
# The flagship with experts
# --------------------------------------------------------------------------

def _tokens(b=4, s=17, seed=1):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab"], (b, s)).astype(np.int32)


def _pairs(port_tree, jax_tree):
    if isinstance(port_tree, dict):
        return [p for k in port_tree
                for p in _pairs(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [p for a, b in zip(port_tree, jax_tree) for p in _pairs(a, b)]
    return [(port_tree, jax_tree)]


@pytest.fixture(scope="module")
def trees():
    """top_k -> the JAX init_params tree of the MoE flagship, numpy."""
    return {k: jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init(key, JaxConfig(**MODEL)))(
            jax.random.PRNGKey(3 + k))) for k in (1, 2)}


@pytest.fixture(scope="module")
def jax_grads(trees):
    """top_k -> JAX's loss and gradients on ``_tokens()`` (remat computes
    the same function, so one compile serves both)."""
    return {k: jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=2)(
        jax.tree.map(jnp.asarray, trees[k]), jnp.asarray(_tokens()),
        JaxConfig(**MODEL, moe_top_k=k)) for k in (1, 2)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_loss_and_gradients_match_jax(trees, jax_grads, top_k, remat):
    """The loss with its aux penalty and every leaf's gradient, with and
    without remat (the aux statistics come out of the recomputed block)."""
    toks = _tokens()
    wl, wg = jax_grads[top_k]
    cfg = TransformerConfig(**MODEL, moe_top_k=top_k, remat=remat)
    params = params_from_jax(trees[top_k], cfg, device="cpu")
    for x in tree_leaves(params):
        x.requires_grad_(True)
    loss = loss_fn(params, torch.from_numpy(toks), cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), **LOSS)
    pairs = _pairs(params, jax.tree.map(np.asarray, wg))
    assert len(pairs) == 4 + 11 * MODEL["n_layers"]
    for x, w in pairs:
        np.testing.assert_allclose(x.grad.numpy(), w, **GRAD)


@pytest.mark.parametrize("top_k,grad_accum", [(1, 1), (2, 2)])
def test_three_adamw_steps_match_jax(top_k, grad_accum):
    """Three one-device AdamW steps (lr 1e-3, the rate PARAMS was set
    for) from JAX's initial state; with ``grad_accum=2`` each microbatch's
    aux penalty is its own, as JAX's."""
    kw = {**MODEL, "moe_top_k": top_k}
    toks = _tokens()
    init_j, step_j = jax_make_train_step(JaxConfig(**kw),
                                         grad_accum=grad_accum)
    jstate = init_j(jax.random.PRNGKey(top_k))
    cfg = TransformerConfig(**kw)
    init_p, step_p = make_train_step(cfg, grad_accum=grad_accum)
    pstate = init_p.from_params(params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu"))
    for _ in range(3):
        jstate, jl = step_j(jstate, jnp.asarray(toks))
        pstate, pl = step_p(pstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(pl), float(jl), **LOSS)
    for x, w in _pairs(pstate["params"],
                       jax.tree.map(np.asarray, jstate["params"])):
        np.testing.assert_allclose(x.detach().numpy(), w, **PARAMS)


@pytest.mark.parametrize("top_k,quantized", [(1, False), (2, False),
                                             (2, True)])
def test_greedy_generate_matches_jax(trees, top_k, quantized):
    """Greedy tokens, the prompt routed with capacity from its length and
    each decode step one token a group; int8 router and experts through
    ``QTensor``."""
    kw = {**MODEL, "moe_top_k": top_k}
    jcfg = JaxConfig(**kw)
    jp = jax.tree.map(jnp.asarray, trees[top_k])
    if quantized:
        jp = jax_quantize(jp)
    prompt = _tokens(b=2, s=6, seed=2)
    want = np.asarray(jax.jit(lambda p, t: jax_generate(p, t, jcfg, 8))(
        jp, jnp.asarray(prompt)))
    cfg = TransformerConfig(**kw)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    if quantized:
        # The port's own quantize_params gives the same int8 experts.
        own = quantize_params(params_from_jax(trees[top_k], cfg,
                                              device="cpu"))
        for got, want_q in zip(own["blocks"], params["blocks"]):
            for name in ("router", "w1e", "w2e"):
                assert isinstance(want_q["moe"][name], QTensor)
                np.testing.assert_array_equal(got["moe"][name].q.numpy(),
                                              want_q["moe"][name].q.numpy())
                np.testing.assert_array_equal(
                    got["moe"][name].scale.numpy(),
                    want_q["moe"][name].scale.numpy())
    for impl in ("dense", "flash"):
        got = generate(params, torch.from_numpy(prompt),
                       TransformerConfig(**kw, decode_attention=impl), 8,
                       device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
