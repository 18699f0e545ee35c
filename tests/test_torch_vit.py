"""The port's Vision Transformer against the JAX package's, on one device,
on the CPU.

Mirrors ``tests/test_vit.py`` (shapes and the image-shape refusal, flash
against dense for the non-causal encoder, the position symmetry, falling
loss) and holds the port to JAX: JAX's parameters go over through
``vit_params_from_jax``, then the same numpy images go through both
packages' ``forward_vit`` and ``make_vit_train_step``, at
``tests/test_vit.py``'s size (16 × 16 × 3 images, patch 4, 7 classes, d 32,
4 heads, 2 layers, d_ff 64). JAX's flash runs as its own tests run it on
the CPU; the port's flash wrappers take their plain versions there.

Tolerances, float32 throughout: logits with dense attention atol = rtol =
1e-5 (summation order); with flash 2e-4, ``tests/test_vit.py:45``'s flash
against dense. Three steps: losses atol = rtol = 1e-5; parameters atol
1e-4, rtol 1e-5 (the first AdamW update is lr · g / (|g| + eps), whose
slope near g = 0 is lr / eps, so a rounding difference in a tiny gradient
element moves its parameter by up to 1e-4 at lr 1e-3; as
``tests/test_torch_lora.py``). The position symmetry: ``tests/test_vit.py``'s
rtol 1e-4, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpi_tpu.models import ViTConfig as JaxViTConfig  # noqa: E402
from mpi_tpu.models import forward_vit as jax_forward_vit  # noqa: E402
from mpi_tpu.models import init_vit_params as jax_init_vit_params  # noqa
from mpi_tpu.models import (  # noqa: E402
    make_vit_train_step as jax_make_vit_train_step)
from mpi_tpu_torch.models import (ViTConfig, forward_vit,  # noqa: E402
                                  init_vit_params, make_vit_train_step,
                                  vit_loss_fn, vit_params_from_jax)
from mpi_tpu_torch.models import vit as vit_mod  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

LOGITS = dict(atol=1e-5, rtol=1e-5)
FLASH = dict(atol=2e-4, rtol=2e-4)
LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
SYMMETRY = dict(atol=1e-5, rtol=1e-4)
MODEL = dict(image_size=16, patch_size=4, channels=3, n_classes=7,
             d_model=32, n_heads=4, n_layers=2, d_ff=64)
STEPS = 3


@dataclasses.dataclass(frozen=True)
class CausalViT(ViTConfig):
    """The faulty control: the same model with a causal encoder stack."""

    @property
    def inner(self):
        return dataclasses.replace(super().inner, causal=True)


def _cfgs(**extra):
    kw = {**MODEL, **extra}
    return JaxViTConfig(**kw), ViTConfig(**kw)


def _images(b=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 7, b).astype(np.int32)
    return x, y


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _port(params_np, cfg):
    return vit_params_from_jax(params_np, cfg, device="cpu")


def _leaf_pairs(port, want):
    """(port leaf, JAX leaf) of every parameter, matched by key."""
    def walk(a, b):
        if isinstance(a, dict):
            return [p for k in a for p in walk(a[k], b[k])]
        if isinstance(a, list):
            return [p for x, y in zip(a, b) for p in walk(x, y)]
        return [(a, b)]

    return walk(port, want)


def _cpu_params(cfg, seed=0):
    return init_vit_params(cfg, torch.Generator().manual_seed(seed), "cpu")


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def test_forward_shapes_and_patchify_order():
    _, cfg = _cfgs()
    params = _cpu_params(cfg)
    assert "embed" not in params
    assert tuple(params["patch"].shape) == (48, 32)
    assert tuple(params["pos"].shape) == (16, 32)
    logits = forward_vit(params, torch.from_numpy(_images(3)[0]), cfg)
    assert logits.shape == (3, 7) and logits.dtype == torch.float32
    with pytest.raises(ValueError, match="expected 16x16x3"):
        forward_vit(params, torch.zeros(2, 8, 8, 3), cfg)
    with pytest.raises(ValueError, match="not divisible by patch_size"):
        ViTConfig(image_size=15, patch_size=4)
    # Row-major patches: patch (i, j) holds pixels [4i, 4i+4) x [4j, 4j+4),
    # each flattened (row, column, channel), as the JAX package lays them.
    imgs = torch.arange(16 * 16 * 3, dtype=torch.float32).reshape(1, 16, 16,
                                                                   3)
    patches = vit_mod._patchify(imgs, cfg)
    assert torch.equal(patches[0, 1 * 4 + 2],
                       imgs[0, 4:8, 8:12].reshape(-1))


def test_forward_matches_jax():
    """JAX's parameters and images through both packages' forward_vit:
    dense attention, then flash (JAX's Pallas kernel in interpret mode,
    the port's plain version)."""
    jcfg, cfg = _cfgs()
    tree = jax_init_vit_params(jax.random.PRNGKey(1), jcfg)
    params = _port(_np(tree), cfg)
    imgs, _ = _images(2, seed=3)
    for impl, tol in (("dense", LOGITS), ("flash", FLASH)):
        want = jax_forward_vit(tree, imgs,
                               dataclasses.replace(jcfg, attention_impl=impl))
        got = forward_vit(params, torch.from_numpy(imgs),
                          dataclasses.replace(cfg, attention_impl=impl))
        _close(got, want, tol)


def test_flash_noncausal_matches_dense():
    """The encoder runs the flash path with causal=False: its logits and
    gradients are dense attention's; the causal control's are not."""
    _, cfg = _cfgs()
    params = _cpu_params(cfg, 1)
    imgs, labels = (torch.from_numpy(a) for a in _images(2, seed=3))
    flash_cfg = dataclasses.replace(cfg, attention_impl="flash")
    dense = forward_vit(params, imgs, cfg)
    _close(forward_vit(params, imgs, flash_cfg), dense.numpy(), FLASH)
    causal = forward_vit(params, imgs, CausalViT(**MODEL,
                                                 attention_impl="flash"))
    assert not torch.allclose(causal, dense, **FLASH)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    grads = [torch.autograd.grad(vit_loss_fn(params, (imgs, labels), c),
                                 leaves) for c in (cfg, flash_cfg)]
    for a, b in zip(*grads):
        _close(a, b.numpy(), FLASH)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bidirectional_attention_is_position_symmetric(impl):
    """With a zeroed position table the logits do not change when the
    patches are permuted (the image's top and bottom halves swapped);
    under a causal mask they do."""
    _, cfg = _cfgs(attention_impl=impl)
    params = dict(_cpu_params(cfg, 2))
    params["pos"] = torch.zeros_like(params["pos"])
    imgs = np.random.default_rng(5).standard_normal(
        (1, 16, 16, 3)).astype(np.float32)
    swapped = np.concatenate([imgs[:, 8:], imgs[:, :8]], axis=1)
    a, b = (forward_vit(params, torch.from_numpy(x), cfg)
            for x in (imgs, swapped))
    _close(a, b.numpy(), SYMMETRY)
    causal = CausalViT(**MODEL, attention_impl=impl)
    a, b = (forward_vit(params, torch.from_numpy(x), causal)
            for x in (imgs, swapped))
    assert not torch.allclose(a, b, **SYMMETRY)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """A cache optimizer -> (initial parameters, three losses, parameters
    after them) of JAX's make_vit_train_step, filled on first use."""
    cache = {}

    def get(optimizer):
        if optimizer not in cache:
            jcfg, _ = _cfgs()
            init_state, step = jax_make_vit_train_step(jcfg,
                                                       optimizer=optimizer)
            state = init_state(jax.random.PRNGKey(0))
            params0 = _np(state["params"])
            batch = _images(8)
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))
            cache[optimizer] = (params0, losses, _np(state["params"]))
        return cache[optimizer]

    return get


def _port_steps(params_np, cfg, optimizer="adamw", steps=STEPS, mesh=None):
    init_state, step = make_vit_train_step(cfg, mesh=mesh,
                                           optimizer=optimizer)
    state = init_state.from_params(_port(params_np, cfg))
    batch = tuple(torch.from_numpy(a) for a in _images(8))
    return state, [float(step(state, batch)[1]) for _ in range(steps)]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_three_steps_match_jax(jax_runs, optimizer):
    params0, want_losses, want_params = jax_runs(optimizer)
    _, cfg = _cfgs()
    state, losses = _port_steps(params0, cfg, optimizer)
    _close(torch.tensor(losses), want_losses, LOSS)
    assert losses[-1] < losses[0]
    pairs = _leaf_pairs(state["params"], want_params)
    assert len(pairs) == len(jax.tree.leaves(want_params)) == 6 + 10 * 2
    for x, w in pairs:
        _close(x, w, PARAMS)


def test_remat_matches_plain(jax_runs):
    """remat recomputes each block in the backward: the same logits, and
    three steps with the same bits as the plain steps."""
    params0, want_losses, _ = jax_runs("adamw")
    _, cfg = _cfgs()
    rcfg = dataclasses.replace(cfg, remat=True)
    params = _port(params0, cfg)
    imgs = torch.from_numpy(_images(4, seed=9)[0])
    assert torch.equal(forward_vit(params, imgs, rcfg),
                       forward_vit(params, imgs, cfg))
    rstate, rlosses = _port_steps(params0, rcfg)
    state, losses = _port_steps(params0, cfg)
    assert rlosses == losses
    _close(torch.tensor(rlosses), want_losses, LOSS)
    for x, y in zip(tree_leaves(rstate["params"]),
                    tree_leaves(state["params"])):
        assert torch.equal(x, y)


def test_training_reduces_loss():
    """tests/test_vit.py's run: five steps at lr 1e-2 from fresh
    parameters; the first loss near ln 7 (near-uniform logits)."""
    _, cfg = _cfgs()
    init_state, step = make_vit_train_step(cfg, learning_rate=1e-2)
    state = init_state(torch.Generator().manual_seed(0), device="cpu")
    assert set(state) == {"params", "opt"}
    batch = tuple(torch.from_numpy(a) for a in _images(8))
    losses = [float(step(state, batch)[1]) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert losses[0] == pytest.approx(np.log(7), rel=0.3)


def test_from_params_builds_the_state_around_the_tree():
    _, cfg = _cfgs()
    init_state, step = make_vit_train_step(cfg)
    params = _cpu_params(cfg, 3)
    state = init_state.from_params(params)
    assert state["params"] is params
    assert all(x.requires_grad for x in tree_leaves(params))
    fresh = init_state(torch.Generator().manual_seed(3), device="cpu")
    batch = tuple(torch.from_numpy(a) for a in _images(4))
    assert float(step(state, batch)[1]) == float(step(fresh, batch)[1])
    for x, y in zip(tree_leaves(state["params"]),
                    tree_leaves(fresh["params"])):
        assert torch.equal(x, y)
    bad = _cpu_params(cfg)
    bad["head"]["b"] = torch.zeros(7, dtype=torch.int32)
    with pytest.raises(TypeError, match="cannot train"):
        init_state.from_params(bad)


def test_params_from_jax_refuses_other_shapes():
    jcfg, cfg = _cfgs()
    tree = _np(jax_init_vit_params(jax.random.PRNGKey(0), jcfg))
    got = _port(tree, cfg)
    for x, w in _leaf_pairs(got, tree):
        assert x.dtype == torch.float32 and torch.equal(
            x, torch.from_numpy(np.array(w)))
    with pytest.raises(ValueError, match="cfg wants 3 layers"):
        _port(tree, dataclasses.replace(cfg, n_layers=3))
    with pytest.raises(ValueError, match="/patch has shape"):
        _port(tree, dataclasses.replace(cfg, channels=1))
    with pytest.raises(ValueError, match="/pos has shape"):
        _port(tree, dataclasses.replace(cfg, image_size=20))
    with pytest.raises(ValueError, match="/blocks/0/w1 has shape"):
        _port(tree, dataclasses.replace(cfg, d_ff=128))
    with pytest.raises(ValueError, match="/head/[wb] has shape"):
        _port(tree, dataclasses.replace(cfg, n_classes=10))
    lm = dict(tree, embed=np.zeros((8, 32), np.float32))
    with pytest.raises(ValueError, match="holds"):
        _port(lm, cfg)
