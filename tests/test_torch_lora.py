"""The port's LoRA fine-tuning against the JAX package's, on the CPU.

Mirrors ``tests/test_lora.py`` (zero-init identity, the footprint, the
refusals, falling loss, merge against the next step's loss, the FFN
targets, a sharded base on ``make_mesh_nd(8)``), and holds the port to
JAX: the JAX base goes over through ``params_from_jax`` and JAX's adapters
(its ``init_state``'s ``"lora"``) through ``lora_from_jax``, then the same
numpy tokens go through both packages' ``make_lora_train_step``, in
float32, at ``tests/test_lora.py``'s size (vocab 64, d 32, 4 heads, 2
layers, d_ff 64).

Tolerances are ``tests/test_torch_train.py``'s, float32 and from summation
order: losses atol = rtol = 1e-5; adapters after three steps atol 1e-4,
rtol 1e-5 (the first AdamW update is lr · g / (|g| + eps), whose slope
near g = 0 is lr / eps, so a rounding difference in a tiny gradient
element moves its parameter by up to 1e-4 at lr 1e-3). The merge: atol =
rtol = 1e-6 (a rank-4 product in float32, another summation order).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.models.lora import lora_init as jax_lora_init  # noqa: E402
from mpi_tpu.models.lora import (  # noqa: E402
    make_lora_train_step as jax_make_lora_train_step)
from mpi_tpu.models.lora import merge_lora as jax_merge_lora  # noqa: E402
from mpi_tpu_torch import train  # noqa: E402
from mpi_tpu_torch.models import (TransformerConfig, count_params,  # noqa
                                  forward, init_params, lora_from_jax,
                                  lora_init, loss_fn, make_lora_train_parts,
                                  make_lora_train_step, make_mesh_nd,
                                  make_train_step, merge_lora,
                                  params_from_jax)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

tensor_parallel = importlib.import_module(
    "mpi_tpu_torch.parallel.tensor_parallel")

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MERGE = dict(atol=1e-6, rtol=1e-6)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=32)
STEPS = 3
# case -> (extra config, optimizer); "tp4" runs the port over a (1, 1, 4)
# mesh against JAX on one device, "nd8" both over make_mesh_nd(8).
CASES = {"adamw": ({}, "adamw"), "adafactor": ({}, "adafactor"),
         "sgd": ({}, "sgd"), "tp4": ({}, "adamw"), "nd8": ({}, "adamw"),
         "moe": ({"n_experts": 4, "moe_top_k": 2}, "adamw"),
         "remat": ({"remat": True}, "adamw")}


def _cfgs(**extra):
    kw = {**MODEL, **extra}
    return JaxConfig(**kw), TransformerConfig(**kw)


def _tokens(batch=4, seq=17, seed=1):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab"], (batch, seq)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _adapter_pairs(port_lora, jax_lora):
    """(port leaf, JAX leaf) of every adapter, matched by key."""
    return [(ab[k], jax_lora["blocks"][i][t][k])
            for i, entry in enumerate(port_lora["blocks"])
            for t, ab in entry.items() for k in ab]


@pytest.fixture(scope="module")
def jax_runs():
    """A cache case -> (base tree, initial adapters, the losses of three
    steps, the adapters after them), filled on first use from JAX's
    make_lora_train_step. "tp4" is the one-device AdamW run."""
    cache = {}

    def get(case):
        case = "adamw" if case == "tp4" else case
        if case not in cache:
            extra, opt = CASES[case]
            jcfg, _ = _cfgs(**extra)
            mesh = None
            if case == "nd8":
                mesh = jax_make_mesh_nd(8)
                init_full, _ = jax_make_train_step(jcfg, mesh=mesh)
                base = init_full(jax.random.PRNGKey(0))["params"]
            else:
                base = jax_init(jax.random.PRNGKey(0), jcfg)
            init_state, step = jax_make_lora_train_step(
                jcfg, base, rank=4, mesh=mesh, optimizer=opt)
            state = init_state(jax.random.PRNGKey(4))
            lora0 = _np(state["lora"])
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, jnp.asarray(_tokens()))
                losses.append(float(loss))
            cache[case] = (_np(base), lora0, losses, _np(state["lora"]))
        return cache[case]

    return get


def _port_run(jax_runs, case, mesh=None):
    """The port's three steps from JAX's base and adapters: (state,
    losses)."""
    base_np, lora0, _, _ = jax_runs(case)
    extra, opt = CASES[case]
    _, cfg = _cfgs(**extra)
    init_state, step = make_lora_train_step(
        cfg, params_from_jax(base_np, cfg, device="cpu"), rank=4,
        mesh=mesh, optimizer=opt)
    state = init_state.from_lora(lora_from_jax(lora0, "cpu"))
    tok = torch.from_numpy(_tokens())
    return state, [float(step(state, tok)[1]) for _ in range(STEPS)]


# --------------------------------------------------------------------------
# Adapters and the merge
# --------------------------------------------------------------------------

def test_zero_init_is_identity():
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = lora_init(params, 4, generator=torch.Generator().manual_seed(1))
    merged = merge_lora(params, lora)
    toks = torch.from_numpy(_tokens()[:, :-1])
    assert torch.equal(forward(params, toks, cfg), forward(merged, toks, cfg))


def test_trainable_footprint_is_tiny():
    # Realistic shapes: rank-8 q/v adapters on a d512 model sit under 1%
    # of the full parameter count.
    cfg = TransformerConfig(vocab=1024, d_model=512, n_heads=8, n_layers=2,
                            d_ff=2048, max_seq=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = lora_init(params, 8, generator=torch.Generator().manual_seed(1))
    assert count_params(lora) == count_params(lora["blocks"]) == \
        2 * 2 * (512 * 8 + 8 * 512)
    assert count_params(lora["blocks"]) < 0.01 * count_params(params)


def test_bad_targets_and_rank_rejected():
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora_init(params, 4, targets=("wz",))
    with pytest.raises(ValueError, match="at least one target"):
        lora_init(params, 4, targets=())
    with pytest.raises(ValueError, match="rank"):
        lora_init(params, 0)
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        make_lora_train_parts(cfg, params, targets=("wq", "w3"))
    init_state, _ = make_lora_train_parts(cfg, params, rank=4)
    with pytest.raises(ValueError, match="rank 2"):
        init_state.from_lora(lora_init(params, 2))


def test_custom_targets_cover_ffn():
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = lora_init(params, 2, targets=("w1", "w2", "wo"))
    assert set(lora["blocks"][0]) == {"w1", "w2", "wo"}
    merged = merge_lora(params, lora)
    assert merged["blocks"][0]["w1"].shape == params["blocks"][0]["w1"].shape


@pytest.mark.parametrize("targets", [("wq", "wv"), ("wk", "wo"),
                                     ("w1", "w2")])
def test_merge_matches_jax(targets):
    """JAX's adapters with nonzero B (drawn with numpy), merged by both
    packages: every leaf of the merged trees agrees, and the port's base is
    not written."""
    jcfg, cfg = _cfgs()
    tree = jax_init(jax.random.PRNGKey(0), jcfg)
    lora = _np(jax_lora_init(jax.random.PRNGKey(1), tree, 4, targets))
    rng = np.random.default_rng(5)
    for entry in lora["blocks"]:
        for ab in entry.values():
            ab["b"] = rng.normal(size=ab["b"].shape).astype(np.float32)
    want = jax_merge_lora(tree, jax.tree.map(jnp.asarray, lora), alpha=8.0)
    base = params_from_jax(_np(tree), cfg, device="cpu")
    before = [x.clone() for x in tree_leaves(base)]
    got = merge_lora(base, lora_from_jax(lora, "cpu"), alpha=8.0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base), before))
    for blk_got, blk_want, blk in zip(got["blocks"], want["blocks"],
                                      base["blocks"]):
        for t in ("wq", "wk", "wv", "wo", "w1", "w2"):
            _close(blk_got[t], blk_want[t], MERGE)
            assert (blk_got[t] is blk[t]) == (t not in targets)
        assert blk_got["ln1"] is blk["ln1"]


def test_lora_from_jax_keeps_the_tree():
    jcfg, _ = _cfgs()
    tree = jax_init(jax.random.PRNGKey(0), jcfg)
    lora = _np(jax_lora_init(jax.random.PRNGKey(1), tree, 4))
    got = lora_from_jax(lora, "cpu")
    assert got["rank"] == 4 and isinstance(got["rank"], int)
    assert [set(e) for e in got["blocks"]] == [{"wq", "wv"}] * 2
    for x, w in _adapter_pairs(got, lora):
        assert x.dtype == torch.float32 and torch.equal(x, torch.from_numpy(np.array(w)))
    lora["blocks"][0]["wq"]["b"] = lora["blocks"][0]["wq"]["b"][:2]
    with pytest.raises(ValueError, match="rank 4"):
        lora_from_jax(lora, "cpu")


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def test_adapter_only_training_reduces_loss():
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_state, step = make_lora_train_step(cfg, params, rank=8,
                                            learning_rate=5e-2)
    state = init_state(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens())
    losses = [float(step(state, toks)[1]) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.05, losses
    # the state holds adapters only: no base-params copy to drift
    assert set(state) == {"lora", "opt"}


def test_merge_matches_adapted_training_loss():
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_state, step = make_lora_train_step(cfg, params, rank=4, alpha=16.0,
                                            learning_rate=5e-2)
    state = init_state(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens())
    for _ in range(3):
        state, _ = step(state, toks)
    with torch.no_grad():
        merged_loss = float(loss_fn(merge_lora(params, state["lora"], 16.0),
                                    toks, cfg))
    _, next_loss = step(state, toks)
    assert merged_loss == pytest.approx(float(next_loss), rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(jax_runs, case):
    """Three steps of the port against JAX's from the same base, adapters
    and tokens: one device with each optimizer, the port over a (1, 1, 4)
    tp mesh against one JAX device, both over make_mesh_nd(8) (JAX's base
    from its sharded init), the MoE flagship (wq/wv; w1/w2 are absent from
    its blocks), and remat."""
    mesh = {"tp4": RankMesh(["cpu"] * 4, ("dp", "sp", "tp"), (1, 1, 4)),
            "nd8": make_mesh_nd(8, devices=["cpu"] * 8)}.get(case)
    _, _, want_losses, want_lora = jax_runs(case)
    state, losses = _port_run(jax_runs, case, mesh)
    _close(torch.tensor(losses), want_losses, LOSS)
    assert losses[-1] < losses[0]
    pairs = _adapter_pairs(state["lora"], want_lora)
    assert len(pairs) == 4 * MODEL["n_layers"]
    for x, w in pairs:
        _close(x, w, PARAMS)
    if case == "remat":  # the same bits as the step without remat
        plain, plain_losses = _port_run(jax_runs, "adamw")
        assert losses == plain_losses
        for (x, _), (y, _) in zip(pairs, _adapter_pairs(plain["lora"],
                                                        want_lora)):
            assert torch.equal(x, y)


def test_frozen_base_gets_no_grad_and_keeps_every_bit():
    """A base taken from make_train_step's state (its leaves require grad)
    gets no .grad and no changed bit, and the optimizer holds moments for
    the adapters alone."""
    _, cfg = _cfgs()
    init_full, _ = make_train_step(cfg)
    full = init_full(torch.Generator().manual_seed(0), device="cpu")
    base = full["params"]
    assert all(x.requires_grad for x in tree_leaves(base))
    before = [x.detach().clone() for x in tree_leaves(base)]
    init_state, step = make_lora_train_step(cfg, base, rank=4,
                                            learning_rate=5e-2)
    state = init_state(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_tokens())
    for _ in range(3):
        state, _ = step(state, toks)
    for x, b in zip(tree_leaves(base), before):
        assert x.grad is None and torch.equal(x.detach(), b)
    adapters = tree_leaves(state["lora"]["blocks"])
    opt = state["opt"]
    assert {id(p) for p in opt.state} == {id(x) for x in adapters}
    moments = sum(t.numel() for held in opt.state.values()
                  for k, t in held.items() if k != "step")
    assert moments == 2 * count_params(state["lora"])
    assert not full["opt"].state


def test_tp_step_launches_kernel_6_as_counted(monkeypatch):
    """A LoRA step over tp 4 calls kernel 6 (its plain version here) 4 ·
    layers + 3 times: the full step's 4 · layers + 4 less the copy before
    layer 0's q/k/v, whose input (the frozen embedding) needs no
    gradient."""
    calls = [0]
    sound = tensor_parallel.ring_allreduce

    def counted(*args, **kw):
        calls[0] += 1
        return sound(*args, **kw)

    monkeypatch.setattr(tensor_parallel, "ring_allreduce", counted)
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_state, step = make_lora_train_step(
        cfg, params, rank=4,
        mesh=RankMesh(["cpu"] * 4, ("dp", "sp", "tp"), (1, 1, 4)))
    state = init_state(torch.Generator().manual_seed(1))
    step(state, torch.from_numpy(_tokens()))
    assert calls[0] == 4 * MODEL["n_layers"] + 3


# --------------------------------------------------------------------------
# train.py --lora / --sample
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--lora", "4"], []])
def test_train_cli_samples_on_cpu(flags, capsys):
    assert train.main(["--sample", "4", "--layers", "2", "--seq", "64",
                       "--batch", "2", "--steps", "2", "--device", "cpu",
                       *flags]) == 0
    out = capsys.readouterr().out
    assert f"lora={flags[1] if flags else 0} sample=4" in out
    sampled = [line for line in out.splitlines()
               if line.startswith("sampled:")]
    assert len(sampled) == 1
    toks = eval(sampled[0].split(":", 1)[1])
    assert len(toks) == 4 and all(0 <= t < 8192 for t in toks)


@pytest.mark.parametrize("vocab", [64, 8192])
def test_sample_prompt_is_jax_examples_prompt(vocab):
    """examples/train.py prompts --sample with SyntheticLM(vocab, 1, 8,
    seed=99)'s step 0; the port's trainer draws the same tokens."""
    from mpi_tpu.data import SyntheticLM

    want = SyntheticLM(vocab, 1, train.PROMPT_LEN, seed=99)(0)
    got = train.sample_prompt(vocab)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flags, name", [
    (["--grad-accum", "2"], "--grad-accum"),
    (["--warmup-steps", "1"], "--warmup-steps"),
    (["--dp", "2", "--zero1"], "--zero1"),
    (["--dp", "2", "--fsdp"], "--fsdp")])
def test_train_cli_lora_refusals(flags, name):
    with pytest.raises(SystemExit, match=f"--lora does not support {name}"):
        train.main(["--lora", "4", "--device", "cpu", *flags])


def test_train_cli_refuses_a_sample_past_max_seq():
    with pytest.raises(SystemExit) as err:
        train.main(["--sample", "60", "--seq", "64", "--device", "cpu"])
    assert err.value.code == 2
