"""The port's serving slice against the JAX package's.

The JAX ``init_params`` tree goes to the port through ``params_from_jax``
(as numpy arrays); then the same token ids go through both packages.
float32 throughout; logits compared at atol 1e-4 (rtol 1e-5), the
summation-order slack of two float32 implementations over 2 layers.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import forward as jax_forward  # noqa: E402
from mpi_tpu.models import generate as jax_generate  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import quantize_params as jax_quantize  # noqa: E402
from mpi_tpu.models.generate import decode_step as jax_decode_step  # noqa
from mpi_tpu.models.generate import prefill as jax_prefill  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, decode_step,  # noqa
                                  forward, generate, params_from_jax,
                                  prefill, quantize_params)

LOGITS = dict(atol=1e-4, rtol=1e-5)
BASE = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=32)
VARIANTS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "rope": {"rope": True},
}


def _configs(variant, **extra):
    kw = {**BASE, **VARIANTS[variant], **extra}
    return JaxConfig(**kw), TransformerConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """variant -> (jax cfg, jax params, port cfg, port params)."""
    out = {}
    for i, variant in enumerate(VARIANTS):
        jcfg, tcfg = _configs(variant)
        jp = jax_init(jax.random.PRNGKey(i), jcfg)
        out[variant] = (jcfg, jp, tcfg,
                        params_from_jax(_np_tree(jp), tcfg, device="cpu"))
    return out


def _tokens(b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab"], (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(models, variant):
    jcfg, jp, tcfg, tp = models[variant]
    toks = _tokens()
    want = np.asarray(jax_forward(jp, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(forward(tp, _t(toks), tcfg).numpy(), want,
                               **LOGITS)


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_steps_match_jax(models, variant,
                                            decode_attention):
    jcfg, jp, tcfg, tp = models[variant]
    tcfg = TransformerConfig(**{**BASE, **VARIANTS[variant],
                                "decode_attention": decode_attention})
    toks = _tokens(s=10, seed=1)
    jl, jcache = jax_prefill(jp, jnp.asarray(toks[:, :6]), jcfg)
    tl, tcache = prefill(tp, _t(toks[:, :6]), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    step = jax.jit(jax_decode_step, static_argnums=4)
    for n_valid in range(6, 10):
        jl, jcache = step(jp, jnp.asarray(toks[:, n_valid]), jcache,
                          jnp.int32(n_valid), jcfg)
        tl, tcache = decode_step(tp, _t(toks[:, n_valid]), tcache, n_valid,
                                 tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_dense_and_flash_match_jax(models, variant):
    jcfg, jp, _, tp = models[variant]
    prompt = _tokens(s=5, seed=2)
    want = np.asarray(jax.jit(
        lambda p, t: jax_generate(p, t, jcfg, 8))(jp, jnp.asarray(prompt)))
    for impl in ("dense", "flash"):
        tcfg = TransformerConfig(**{**BASE, **VARIANTS[variant],
                                    "decode_attention": impl})
        got = generate(tp, _t(prompt), tcfg, 8, device="cpu")
        assert got.shape == (2, 8) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_params_matches_jax_bit_for_bit(models):
    _, jp, tcfg, tp = models["mha"]
    jq = _np_tree(jax_quantize(jp))
    tq = quantize_params(tp)
    pairs = [(jq["embed"], tq["embed"])] + [
        (jb[name], tb[name]) for jb, tb in zip(jq["blocks"], tq["blocks"])
        for name in ("wq", "wk", "wv", "wo", "w1", "w2")]
    for jt, tt in pairs:
        np.testing.assert_array_equal(tt.q.numpy(), jt.q)
        np.testing.assert_array_equal(tt.scale.numpy(), jt.scale)
    # Skipped as in the JAX package: 1-D leaves and the position table.
    assert isinstance(tq["pos"], torch.Tensor)
    assert isinstance(tq["blocks"][0]["ln1"]["scale"], torch.Tensor)


def test_int8_path_matches_jax(models):
    jcfg, jp, tcfg, _ = models["mha"]
    jq = jax_quantize(jp)
    tq = params_from_jax(_np_tree(jq), tcfg, device="cpu")
    toks = _tokens(s=6, seed=3)
    jl, _ = jax_prefill(jq, jnp.asarray(toks), jcfg)
    tl, _ = prefill(tq, _t(toks), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    want = np.asarray(jax.jit(
        lambda p, t: jax_generate(p, t, jcfg, 6))(jq, jnp.asarray(toks)))
    fcfg = TransformerConfig(**{**BASE, "decode_attention": "flash"})
    got = generate(tq, _t(toks), fcfg, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
def test_incremental_decode_matches_full_forward(models, decode_attention):
    """Prefill + N decode steps give the logits of one full forward."""
    _, _, _, tp = models["mha"]
    tcfg = TransformerConfig(**{**BASE, "decode_attention":
                                decode_attention})
    toks = _t(_tokens(s=12, seed=4))
    full = forward(tp, toks, tcfg)
    last, cache = prefill(tp, toks[:, :5], tcfg)
    np.testing.assert_allclose(last.numpy(), full[:, 4].numpy(), rtol=1e-4,
                               atol=1e-5)
    for n_valid in range(5, 12):
        step, cache = decode_step(tp, toks[:, n_valid], cache, n_valid, tcfg)
        np.testing.assert_allclose(step.numpy(), full[:, n_valid].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_sampling_is_deterministic_under_a_generator(models):
    _, _, tcfg, tp = models["mha"]
    prompt = _t(_tokens(s=4))

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(tp, prompt, tcfg, 6, temperature=0.8, generator=g,
                        device="cpu")

    torch.testing.assert_close(sample(7), sample(7), rtol=0, atol=0)
    assert not torch.equal(sample(7), sample(8))


def test_overflowing_max_seq_raises(models):
    _, _, tcfg, tp = models["mha"]
    with pytest.raises(ValueError, match="exceeds max_seq"):
        generate(tp, _t(_tokens(s=30)), tcfg, 3, device="cpu")


def test_sampling_without_generator_raises(models):
    _, _, tcfg, tp = models["mha"]
    with pytest.raises(ValueError, match="needs a generator"):
        generate(tp, _t(_tokens(s=4)), tcfg, 2, temperature=0.5,
                 device="cpu")


def test_unknown_decode_attention_raises(models):
    _, _, _, tp = models["mha"]
    tcfg = TransformerConfig(**{**BASE, "decode_attention": "Flash"})
    with pytest.raises(ValueError, match="decode_attention"):
        generate(tp, _t(_tokens(s=4)), tcfg, 2, device="cpu")


def test_flash_attention_impl_is_not_ported_yet(models):
    """``attention_impl="flash"`` runs the flash path and gives the JAX
    forward's logits; the full-sequence impls still to port raise,
    naming the slice that brings them."""
    _, jp, _, tp = models["mha"]
    toks = _tokens(s=8)
    kw = {**BASE, "attention_impl": "flash"}
    want = np.asarray(jax_forward(jp, jnp.asarray(toks), JaxConfig(**kw)))
    np.testing.assert_allclose(
        forward(tp, _t(toks), TransformerConfig(**kw)).numpy(), want,
        **LOGITS)
    for impl in ("blockwise", "ring"):
        tcfg = TransformerConfig(**{**BASE, "attention_impl": impl})
        with pytest.raises(NotImplementedError, match="long-context slice"):
            forward(tp, _t(_tokens(s=4)), tcfg)


def test_params_from_jax_rejects_a_mismatched_config(models):
    _, jp, _, _ = models["mha"]
    with pytest.raises(ValueError, match="cfg wants"):
        params_from_jax(_np_tree(jp), TransformerConfig(
            **{**BASE, "n_layers": 3}), device="cpu")
