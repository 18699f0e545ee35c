"""The port's Vision Transformer over a rank mesh against the JAX package's,
on the CPU.

Mirrors the mesh cases of ``tests/test_vit.py``: three steps over
``make_mesh_nd(8)``, a (dp 2, sp 2, tp 2) mesh, against JAX's sharded
step, with ``w1`` split over tp; remat with a mesh against plain; the zigzag
layouts refused; and the encoder LM (``TransformerConfig(causal=False)``)
over the contiguous ring and Ulysses against JAX's dense ``forward``. The
port's mesh is ``make_mesh_nd(8, devices=["cpu"] * 8)``: its tp reductions
run kernel 6's plain version, its dp axis one pass over every row.
JAX's side runs on conftest's virtual CPU devices, at
``tests/test_vit.py``'s size.

Tolerances, float32: the sharded losses rel 2e-4 (``tests/test_vit.py:88``,
JAX's sharded step against one device) and atol = rtol = 1e-5 where both
sides reduce in a known order (summation order alone); the parameters
after three AdamW steps atol 1e-4, rtol 1e-5 (``tests/test_torch_vit.py``
gives the reason); the encoder logits atol = rtol = 2e-4
(``tests/test_vit.py``'s); remat with a mesh against plain the same bits.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import ViTConfig as JaxViTConfig  # noqa: E402
from mpi_tpu.models import forward as jax_forward  # noqa: E402
from mpi_tpu.models import init_params as jax_init  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import (  # noqa: E402
    make_vit_train_step as jax_make_vit_train_step)
from mpi_tpu_torch.models import (TransformerConfig, ViTConfig,  # noqa
                                  forward, forward_vit, init_vit_params,
                                  make_mesh_nd, make_vit_train_step,
                                  params_from_jax, rank_state,
                                  vit_params_from_jax)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

tensor_parallel = importlib.import_module(
    "mpi_tpu_torch.parallel.tensor_parallel")

SHARDED_REL = 2e-4
LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
ENCODER = dict(atol=2e-4, rtol=2e-4)
MODEL = dict(image_size=16, patch_size=4, channels=3, n_classes=7,
             d_model=32, n_heads=4, n_layers=2, d_ff=64)
STEPS = 3


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


def _mesh():
    return make_mesh_nd(8, devices=["cpu"] * 8)


def _steps(cfg, params, mesh, steps=STEPS, lr=1e-3, batch=None):
    """``steps`` AdamW steps from ``params`` (taken as they are): (state,
    losses)."""
    init_state, step = make_vit_train_step(cfg, mesh=mesh, learning_rate=lr)
    state = init_state.from_params(params)
    batch = tuple(torch.from_numpy(a) for a in batch or _images())
    return state, [float(step(state, batch)[1]) for _ in range(steps)]


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's three AdamW steps over make_mesh_nd(8): (initial parameters,
    losses, parameters after them, w1's distinct shards)."""
    cfg = JaxViTConfig(**MODEL)
    init_state, step = jax_make_vit_train_step(cfg, mesh=jax_make_mesh_nd(8))
    state = init_state(jax.random.PRNGKey(0))
    params0 = _np(state["params"])
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, _images())
        losses.append(float(loss))
    w1 = state["params"]["blocks"][0]["w1"]
    shards = len({s.index for s in w1.addressable_shards})
    return params0, losses, _np(state["params"]), shards


def test_sharded_steps_match_jax(jax_sharded):
    """Three steps over (dp 2, sp 2, tp 2) against JAX's sharded step from
    the same parameters: losses within tests/test_vit.py's rel 2e-4 (and
    1e-5), every parameter within PARAMS; tp reaches the blocks (w1's
    spec names it; rank_state gives tp rank 1 its half of d_ff, as JAX's 2
    distinct shards)."""
    params0, want_losses, want_params, shards = jax_sharded
    cfg = ViTConfig(**MODEL)
    mesh = _mesh()
    assert tuple(mesh.shape.values()) == (2, 2, 2)
    state, losses = _steps(cfg, vit_params_from_jax(params0, cfg, "cpu"),
                           mesh)
    for got, want in zip(losses, want_losses):
        assert got == pytest.approx(want, rel=SHARDED_REL)
    _close(torch.tensor(losses), want_losses, LOSS)
    assert losses[-1] < losses[0]
    got_params = tree_leaves(state["params"])
    assert len(got_params) == len(jax.tree.leaves(want_params))
    for blk, want_blk in zip(state["params"]["blocks"],
                             want_params["blocks"]):
        for k in blk:
            for x, w in zip(tree_leaves(blk[k]), jax.tree.leaves(want_blk[k])):
                _close(x, w, PARAMS)
    for k in ("patch", "pos"):
        _close(state["params"][k], want_params[k], PARAMS)
    specs = state["specs"]
    assert state["mesh"] is mesh
    assert specs["blocks"][0]["w1"] == (None, "tp")
    assert specs["blocks"][0]["wq"] == (None, "tp", None)
    assert specs["patch"] == () and specs["head"] == {"w": (), "b": ()}
    assert shards == 2
    held = rank_state(state, 0, 1)["params"]["blocks"][0]
    w1 = state["params"]["blocks"][0]["w1"]
    assert tuple(held["w1"].shape) == (32, 32)
    assert torch.equal(held["w1"], w1[:, 32:])


def _count_kernel_6(monkeypatch):
    """Count kernel 6's calls (its plain version here) by the tp
    operators: a list whose one entry the calls raise."""
    calls = [0]
    sound = tensor_parallel.ring_allreduce

    def counted(*args, **kw):
        calls[0] += 1
        return sound(*args, **kw)

    monkeypatch.setattr(tensor_parallel, "ring_allreduce", counted)
    return calls


def test_sharded_steps_match_one_device(monkeypatch):
    """The mesh's steps against the port's own one-device steps, and the
    faulty control (every tp reduction keeps rank 0's partial) outside
    the same tolerance; kernel 6 (its plain version here) runs 4 times a
    layer a step: the reduces after wo and w2, and the copies' backward
    before q/k/v and w1 (the patch projection needs the first's
    gradient)."""
    cfg = ViTConfig(**MODEL)

    def fresh():
        return init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")

    _, one = _steps(cfg, fresh(), None)
    calls = _count_kernel_6(monkeypatch)
    _, sharded = _steps(cfg, fresh(), _mesh())
    assert calls[0] == STEPS * 4 * MODEL["n_layers"]
    _close(torch.tensor(sharded), one, LOSS)
    monkeypatch.setattr(tensor_parallel, "ring_allreduce",
                        lambda contribs, ring, op="sum":
                        contribs[:1].expand_as(contribs))
    _, control = _steps(cfg, fresh(), _mesh())
    assert all(abs(c - o) > SHARDED_REL * abs(o)
               for c, o in zip(control, one)), (control, one)


def test_zigzag_rejected_for_encoder():
    """Only the zigzag layouts are causal-only; the ring layer raises with
    its own message when an encoder asks for them."""
    cfg = ViTConfig(**MODEL)
    params = init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    imgs = torch.from_numpy(_images(2)[0])
    for impl in ("zigzag", "zigzag_flash"):
        with pytest.raises(ValueError, match="zigzag"):
            forward_vit(params, imgs,
                        dataclasses.replace(cfg, attention_impl=impl),
                        _mesh())


def test_tp_must_divide_d_ff_not_a_vocabulary():
    """The encoder has no token embedding: tp need not divide its
    vocab=1, but must divide the heads and d_ff."""
    cfg = ViTConfig(**MODEL)
    tp4 = RankMesh(["cpu"] * 4, ("dp", "sp", "tp"), (1, 1, 4))
    params = init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    imgs = torch.from_numpy(_images(2)[0])
    assert forward_vit(params, imgs, cfg, tp4).shape == (2, 7)
    with pytest.raises(ValueError, match=r"tp=4 must divide d_ff=6 \(w1"):
        make_vit_train_step(dataclasses.replace(cfg, d_ff=6), mesh=tp4)
    with pytest.raises(ValueError, match="tp=4 must divide n_heads=2"):
        make_vit_train_step(dataclasses.replace(cfg, n_heads=2), mesh=tp4)


def test_remat_with_mesh_matches_no_remat(monkeypatch):
    """remat with a mesh: the same logits and losses, bit for bit, and
    it trains; kernel 6 runs 5 times a layer a step: the recompute runs
    the reduce after wo again, but stops (torch's non-reentrant
    checkpoint stops once the backward's saved tensors are rebuilt) before
    the reduce after w2, which saves nothing."""
    cfg = ViTConfig(**MODEL)
    rcfg = dataclasses.replace(cfg, remat=True)
    mesh = _mesh()
    params = init_vit_params(cfg, torch.Generator().manual_seed(4), "cpu")
    imgs, labels = _images(4, seed=9)
    x = torch.from_numpy(imgs)
    assert torch.equal(forward_vit(params, x, rcfg, mesh),
                       forward_vit(params, x, cfg, mesh))
    calls = _count_kernel_6(monkeypatch)
    rstate, rlosses = _steps(rcfg, init_vit_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), mesh, 2, 1e-2,
        (imgs, labels))
    assert calls[0] == 2 * 5 * MODEL["n_layers"]
    state, losses = _steps(cfg, init_vit_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), mesh, 2, 1e-2,
        (imgs, labels))
    assert rlosses == losses and rlosses[1] < rlosses[0]
    for a, b in zip(tree_leaves(rstate["params"]),
                    tree_leaves(state["params"])):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def encoder():
    """The encoder LM (causal=False) of tests/test_vit.py: the JAX tree as
    numpy arrays, the tokens, and JAX's dense logits."""
    base = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=16, causal=False)
    tree = jax_init(jax.random.PRNGKey(0), JaxConfig(**base))
    toks = np.random.default_rng(0).integers(0, 32, (4, 16)).astype(np.int32)
    want = np.asarray(jax_forward(tree, toks, JaxConfig(**base)))
    return base, _np(tree), toks, want


@pytest.mark.parametrize("impl", ["ulysses", "ring", "ulysses_flash",
                                  "ring_flash"])
def test_encoder_sequence_parallel_matches_jax_dense(encoder, impl):
    """causal=False flows through the contiguous ring and Ulysses over
    the mesh's sp axis: the port's encoder logits match JAX's dense
    forward; the causal model's do not."""
    base, tree, toks, want = encoder
    cfg = TransformerConfig(**base, attention_impl=impl)
    params = params_from_jax(tree, cfg, device="cpu")
    mesh = _mesh()
    got = forward(params, torch.from_numpy(toks), cfg, mesh)
    _close(got, want, ENCODER)
    causal = forward(params, torch.from_numpy(toks),
                     dataclasses.replace(cfg, causal=True), mesh)
    assert not np.allclose(causal.numpy(), want, **ENCODER)


def test_encoder_zigzag_rejected(encoder):
    base, tree, toks, _ = encoder
    cfg = TransformerConfig(**base, attention_impl="zigzag")
    params = params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="zigzag"):
        forward(params, torch.from_numpy(toks), cfg, _mesh())
