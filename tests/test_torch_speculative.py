"""The port's prompt-lookup speculative decoding against the JAX package's.

The JAX ``init_params`` tree goes to the port through ``params_from_jax``;
the same numpy prompts go through JAX's ``generate_lookahead`` (and its
``generate``) and the port's, float32 on the CPU. Tokens must be equal:
speculation is an execution strategy, so the port's output is the JAX
package's token for token, and greedy decode's. ``_find_draft`` is held
against JAX's on seeded buffers, draft for draft.

JAX compiles its ``lax.while_loop`` under ``vmap`` for each configuration,
so each JAX call is jitted whole (eager dispatch took several times as
long) and each JAX result is computed once, in a module-scoped fixture.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import generate as jax_generate  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models.speculative import _find_draft as jax_find_draft  # noqa
from mpi_tpu.models.speculative import (  # noqa: E402
    generate_lookahead as jax_lookahead)
from mpi_tpu_torch import serve  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, forward,  # noqa: E402
                                  generate, generate_lookahead,
                                  params_from_jax)

spec = importlib.import_module("mpi_tpu_torch.models.speculative")
gen_mod = importlib.import_module("mpi_tpu_torch.models.generate")

# tests/test_speculative.py's two configurations: learned positions and
# MHA; GQA with rope.
MHA = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)
ROPE = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=80, n_kv_heads=2, rope=True)
# name -> (config, params seed, prompt, new tokens, draft_len, ngram)
PHRASE = np.asarray([5, 9, 2, 7, 11, 3], dtype=np.int32)
CASES = {
    "mha_random": (MHA, 0, "random", 20, 4, 2),
    "rope_repetitive": (ROPE, 4, "repetitive", 24, 6, 3),
}
GRID = [(1, 1), (3, 2), (8, 4)]
GRID_NEW = 16


def _prompt(kind, rows=2, seed=0, s=16, vocab=64):
    if kind == "repetitive":
        return np.tile(PHRASE, 4)[None].repeat(rows, 0)
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, s)).astype(np.int32)


def _port(kw, jp, **extra):
    cfg = TransformerConfig(**{**kw, **extra})
    return cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")


@pytest.fixture(scope="module")
def jax_cases():
    """name -> (JAX params, prompt, JAX's generate_lookahead tokens)."""
    out = {}
    for name, (kw, seed, kind, new, m, ngram) in CASES.items():
        cfg = JaxConfig(**kw)
        jp = jax_init(jax.random.PRNGKey(seed), cfg)
        prompt = _prompt(kind, vocab=kw["vocab"])
        run = jax.jit(lambda p, x: jax_lookahead(p, x, cfg, new, draft_len=m,
                                                 ngram=ngram))
        toks = run(jp, jnp.asarray(prompt))
        out[name] = (jp, prompt, np.asarray(toks))
    return out


@pytest.fixture(scope="module")
def grid_case():
    """tests/test_speculative.py's grid: params seed 2, one row of 12
    prompt tokens; JAX's and the port's generate, each computed once."""
    cfg = JaxConfig(**MHA)
    jp = jax_init(jax.random.PRNGKey(2), cfg)
    prompt = _prompt("random", rows=1, seed=3, s=12)
    run = jax.jit(lambda p, x: jax_generate(p, x, cfg, GRID_NEW))
    want = np.asarray(run(jp, jnp.asarray(prompt)))
    tcfg, tp = _port(MHA, jp)
    port = generate(tp, torch.from_numpy(prompt), tcfg, GRID_NEW,
                    device="cpu").numpy()
    return tcfg, tp, prompt, want, port


@pytest.mark.parametrize("decode_attention", ["dense", "flash"])
@pytest.mark.parametrize("name", list(CASES))
def test_tokens_equal_jax(jax_cases, name, decode_attention):
    kw, _, _, new, m, ngram = CASES[name]
    jp, prompt, want = jax_cases[name]
    cfg, tp = _port(kw, jp, decode_attention=decode_attention)
    got = generate_lookahead(tp, torch.from_numpy(prompt), cfg, new,
                             draft_len=m, ngram=ngram, device="cpu")
    assert got.shape == (prompt.shape[0], new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("draft_len,ngram", GRID)
def test_grid_equals_both_generates(grid_case, draft_len, ngram):
    cfg, tp, prompt, want, port = grid_case
    np.testing.assert_array_equal(port, want)
    got = generate_lookahead(tp, torch.from_numpy(prompt), cfg, GRID_NEW,
                             draft_len=draft_len, ngram=ngram, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _buffers():
    """name -> (buf, n_valid, ngram, draft_len), seeded random tokens with
    the pattern planted; L 32, vocab 1000, so no chance match."""
    rng = np.random.default_rng(7)

    def fresh():
        return rng.permutation(1000)[:32].astype(np.int32)

    out = {"no_match": (fresh(), 20, 2, 4)}
    buf = fresh()
    buf[17:20] = 5  # key (5, 5) at 18; the window at 17 overlaps it
    out["overlapping"] = (buf, 20, 2, 4)
    buf = fresh()
    buf[18:21] = buf[0:3]  # the key occurs only at index 0
    out["at_zero"] = (buf, 21, 3, 5)
    buf = fresh()
    for t in (2, 9, 14):  # three matches; 14 is the most recent
        buf[t:t + 2] = buf[22:24]
    out["most_recent"] = (buf, 24, 2, 6)
    buf = fresh()
    buf[28:30] = buf[30:32]  # draft from 30 runs past L: wraps to 0
    out["wraps"] = (buf, 32, 2, 4)
    return out


@pytest.mark.parametrize("name", list(_buffers()))
def test_find_draft_equals_jax(name):
    buf, n_valid, ngram, draft_len = _buffers()[name]
    want = np.asarray(jax.jit(jax_find_draft, static_argnums=(2, 3))(
        jnp.asarray(buf), jnp.int32(n_valid), ngram, draft_len))
    got = spec._find_draft(torch.from_numpy(buf).long(), n_valid, ngram,
                           draft_len)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "no_match":
        np.testing.assert_array_equal(want, buf[:draft_len])
    if name == "most_recent":
        np.testing.assert_array_equal(want, buf[16:16 + draft_len])


@pytest.fixture(scope="module")
def small():
    cfg = TransformerConfig(**MHA)
    return cfg, params_from_jax(
        jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                          JaxConfig(**MHA))), cfg,
        device="cpu")


@pytest.mark.parametrize("kwargs,s,match", [
    ({"max_new_tokens": 96}, 16, "max_seq"),
    ({"max_new_tokens": 4, "ngram": 5}, 4, "ngram"),
    ({"max_new_tokens": 4, "draft_len": 0}, 16, "draft_len|>= 1"),
    # Both wrong: the >= 1 check comes first, as in the JAX package.
    ({"max_new_tokens": 96, "ngram": 0}, 16, ">= 1"),
])
def test_refusals(small, kwargs, s, match):
    cfg, tp = small
    prompt = torch.from_numpy(_prompt("random", rows=1, s=s))
    with pytest.raises(ValueError, match=match):
        generate_lookahead(tp, prompt, cfg, device="cpu", **kwargs)


def test_cache_reuse_after_rejected_then_accepted_rounds(small, monkeypatch):
    """Rounds with k = 0 (every draft rejected: m stale cache rows past the
    new n_valid) alternate with rounds with k = m (every draft committed,
    the rows written over): each verify forward's logits equal one
    uncached forward of the committed prefix and the fed tokens."""
    cfg, tp = small
    m = 4
    script, calls = [], []
    forward_cached = gen_mod._forward_cached

    def scripted(draft, greedy):
        script.append(0 if len(script) % 2 == 0 else m)
        return torch.tensor(script[-1])

    def recorded(params, tokens, cache, n_valid, cfg_):
        logits, cache = forward_cached(params, tokens, cache, n_valid, cfg_)
        if n_valid > 0:  # a verify forward, not the prefill
            calls.append((tokens[0].clone(), n_valid, logits[0].clone()))
        return logits, cache

    monkeypatch.setattr(spec, "_accepted", scripted)
    monkeypatch.setattr(gen_mod, "_forward_cached", recorded)
    prompt = torch.from_numpy(_prompt("random", rows=1, seed=5))
    out = generate_lookahead(tp, prompt, cfg, 20, draft_len=m, device="cpu")
    seq = torch.cat([prompt.long(), out], dim=1)[0]
    assert script[:4] == [0, m, 0, m] and len(calls) == len(script) >= 4
    for fed, n_valid, logits in calls:
        full = forward(tp, torch.cat([seq[:n_valid], fed])[None], cfg)[0]
        torch.testing.assert_close(logits, full[n_valid:], atol=1e-5,
                                   rtol=1e-5)


def test_accept_all_control_differs_from_generate(small, monkeypatch):
    """The control: an engine that commits every draft token (k = m)
    gives other tokens than greedy decode on a random prompt."""
    cfg, tp = small
    prompt = torch.from_numpy(_prompt("random", rows=2, seed=1))
    want = generate(tp, prompt, cfg, 20, device="cpu")
    monkeypatch.setattr(spec, "_accepted",
                        lambda draft, greedy: torch.tensor(draft.shape[0]))
    got = generate_lookahead(tp, prompt, cfg, 20, device="cpu")
    assert not torch.equal(got, want)


def test_serve_runs_the_speculative_row(capsys):
    """serve.py's --draft-len and --ngram: max_seq holds the overhang, and
    the speculative row prints its agreement with greedy (one layer of the
    flagship's widths, bf16, on the CPU)."""
    assert serve.main(["--layers", "1", "--batch", "1", "--prompt-len", "8",
                       "--tokens", "4", "--draft-len", "5", "--ngram", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "speculative decode" in out
    assert "speculative agreement with bf16 greedy:" in out
