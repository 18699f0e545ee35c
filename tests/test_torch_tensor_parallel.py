"""The port's tensor-parallel training against the JAX package's, on the
CPU.

The JAX side runs ``make_train_step(cfg, mesh=..., zero1=..., fsdp=...)``
on conftest's 8 virtual CPU devices, where GSPMD inserts the tp reductions
that ``param_specs`` implies; the port runs ``make_train_step`` on a
``RankMesh`` of 8 ranks on ``"cpu"``, where the reductions are explicit
(``parallel/tensor_parallel.py``, kernel 6's plain version), from the same
initial parameters (the JAX tree through ``params_from_jax``) and the same
numpy tokens. Three meshes with tp above 1: (dp 1, sp 1, tp 8), (2, 1, 4)
and ``make_mesh_nd(8)``, (2, 2, 2). The config (d_model 64, d_ff 128,
vocab 64; MHA 8 heads, GQA 16 heads over 8 kv heads) divides by tp 8
everywhere, and no two leaves share a shape (ZeRO-1 matches a moment to
the first parameter of its shape, and the two packages walk the tree in
other orders).

Tolerances are ``tests/test_torch_train.py``'s, float32 and from summation
order (the tp partials are summed in kernel 6's ring order, JAX's in
XLA's): losses atol = rtol = 1e-5, parameters after three AdamW steps atol
1e-4, rtol 1e-5, gradients atol 1e-5, rtol 1e-4.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.models.transformer import loss_fn as jax_loss_fn  # noqa: E402
from mpi_tpu.models.transformer import (  # noqa: E402
    token_xent as jax_token_xent)
from mpi_tpu_torch.models import (TransformerConfig, loss_fn,  # noqa: E402
                                  make_mesh_nd, make_train_step,
                                  params_from_jax, token_xent)
from mpi_tpu_torch.models.transformer import (full_params,  # noqa: E402
                                              rank_state)
from mpi_tpu_torch.ops.ring_collectives import (  # noqa: E402
    ring_allreduce_plain)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.parallel.mesh import axis_ring  # noqa: E402
from mpi_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    tp_copy, tp_reduce, tp_ring, vocab_parallel_embed, vocab_parallel_xent)
from mpi_tpu_torch.parallel.zero import tree_leaves  # noqa: E402

tensor_parallel = importlib.import_module(
    "mpi_tpu_torch.parallel.tensor_parallel")

LOSS = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
PARAMS = dict(atol=1e-4, rtol=1e-5)
MODEL = dict(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
             max_seq=17)
VARIANTS = {"mha": {}, "gqa": {"n_heads": 16, "n_kv_heads": 8}}
MESHES = {"tp8": (1, 1, 8), "dp2_tp4": (2, 1, 4), "nd8": (2, 2, 2)}
AXES = ("dp", "sp", "tp")
MODES = {"dp": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}
STEPS = 3
# On dense attention: every (mesh, mode) with MHA, GQA's head slices on
# every mesh (plain dp) and under zero1; then the nd8 mesh's sp axis with
# ring attention (fold chunks), MHA plain dp and GQA fsdp. Each case is
# one JAX compile of a sharded step (3-5 s).
CASES = ([(m, "mha", mode, "dense") for m in MESHES for mode in MODES]
         + [(m, "gqa", "dp", "dense") for m in MESHES]
         + [("dp2_tp4", "gqa", "zero1", "dense"),
            ("nd8", "mha", "dp", "ring"), ("nd8", "gqa", "fsdp", "ring")])


def _kw(variant, impl="dense"):
    return {**MODEL, **VARIANTS[variant], "attention_impl": impl}


def _jax_mesh(name):
    if name == "nd8":
        return jax_make_mesh_nd(8, devices=jax.devices()[:8])
    return Mesh(np.asarray(jax.devices()[:8]).reshape(MESHES[name]), AXES)


def _port_mesh(name):
    if name == "nd8":
        return make_mesh_nd(8, devices=["cpu"] * 8)
    return RankMesh(["cpu"] * 8, AXES, MESHES[name])


def _tokens():
    return np.random.default_rng(11).integers(
        0, MODEL["vocab"], (8, MODEL["max_seq"])).astype(np.int32)


def _walk(port_tree, jax_tree):
    """(port leaf, JAX leaf) pairs, matched by key."""
    if isinstance(port_tree, dict):
        return [pair for k in port_tree
                for pair in _walk(port_tree[k], jax_tree[k])]
    if isinstance(port_tree, list):
        return [pair for p, j in zip(port_tree, jax_tree)
                for pair in _walk(p, j)]
    return [(port_tree, jax_tree)]


@pytest.fixture(scope="module")
def jax_runs():
    """A cache (mesh, variant, mode, impl) -> (initial params, the losses
    of three steps, the parameters after them, the shape of device 0's
    shard of each first moment and of each parameter), filled on first
    use from JAX's make_train_step."""
    cache = {}

    def get(mesh_name, variant, mode, impl="dense"):
        key = (mesh_name, variant, mode, impl)
        if key not in cache:
            mesh = _jax_mesh(mesh_name)
            batch = jax.device_put(jnp.asarray(_tokens()),
                                   NamedSharding(mesh, P("dp", None)))
            init_state, step = jax_make_train_step(
                JaxConfig(**_kw(variant, impl)), mesh=mesh, **MODES[mode])
            state = init_state(jax.random.PRNGKey(4))
            params0 = jax.tree.map(np.asarray, state["params"])
            losses = []
            for _ in range(STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))

            def shard_shape(x):
                return tuple(x.addressable_shards[0].data.shape)

            cache[key] = (params0, losses,
                          jax.tree.map(np.asarray, state["params"]),
                          jax.tree.map(shard_shape, state["opt"][0].mu),
                          jax.tree.map(shard_shape, state["params"]))
        return cache[key]

    return get


def _port_run(params0, mesh_name, variant, mode, impl="dense"):
    cfg = TransformerConfig(**_kw(variant, impl))
    init_state, step = make_train_step(cfg, mesh=_port_mesh(mesh_name),
                                       **MODES[mode])
    state = init_state.from_params(params_from_jax(params0, cfg,
                                                   device="cpu"))
    tok = torch.from_numpy(_tokens())
    losses = [float(step(state, tok)[1]) for _ in range(STEPS)]
    return state, losses


# --------------------------------------------------------------------------
# The operators
# --------------------------------------------------------------------------

def _ring(n):
    return axis_ring(RankMesh(["cpu"] * n, ("tp",)), "tp")


@pytest.mark.parametrize("shape", [(4, 3, 5), (4, 6), (8, 2, 3, 7)])
def test_reduce_forward_and_backward_are_plain_sums(shape):
    """tp_reduce: forward the sum of the partials (kernel 6's ring order,
    so to rounding), backward the upstream gradient for every partial."""
    n = shape[0]
    rng = np.random.default_rng(1)
    partials = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_(True)
    out = tp_reduce(partials, _ring(n))
    torch.testing.assert_close(out, partials.detach().sum(0), atol=1e-6,
                               rtol=1e-6)
    up = torch.from_numpy(rng.standard_normal(shape[1:]).astype(np.float32))
    (grad,) = torch.autograd.grad(out, partials, up)
    assert torch.equal(grad, up.expand(shape))


@pytest.mark.parametrize("shape", [(4, 3, 5), (8, 2, 3)])
def test_copy_forward_and_backward_are_plain_sums(shape):
    """tp_copy: forward the input for every rank, backward the sum of the
    ranks' gradient partials."""
    n = shape[0]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape[1:]).astype(
        np.float32)).requires_grad_(True)
    xs = tp_copy(x, _ring(n))
    assert xs.shape == shape and all(torch.equal(xs[r], x.detach())
                                     for r in range(n))
    up = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    (grad,) = torch.autograd.grad(xs, x, up)
    torch.testing.assert_close(grad, up.sum(0), atol=1e-6, rtol=1e-6)


def test_without_a_tp_axis_nothing_reduces():
    x = torch.arange(6.0).reshape(2, 3)
    assert tp_ring(None) is None
    assert tp_ring(RankMesh(["cpu"] * 4, ("dp", "tp"), (4, 1))) is None
    assert tp_copy(x, None).shape == (1, 2, 3)
    assert torch.equal(tp_reduce(x[None], None), x)


def test_vocab_parallel_embed_and_xent_match_the_whole_vocab():
    """The vocab-split lookup equals a whole-table lookup bit for bit (one
    rank is nonzero per token), and the vocab-parallel cross-entropy (the
    max on kernel 6's max, the sums on its sum) equals token_xent over the
    gathered logits, gradient too."""
    rng = np.random.default_rng(3)
    n, v, d = 4, 32, 5
    ring = _ring(n)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, v, (3, 7)))
    assert torch.equal(vocab_parallel_embed(table, tokens, ring),
                       table[tokens])
    logits = torch.from_numpy(rng.standard_normal((3, 7, v)).astype(
        np.float32) * 4).requires_grad_(True)
    parts = logits.unflatten(-1, (n, -1)).permute(2, 0, 1, 3)
    got = vocab_parallel_xent(parts, tokens, ring)
    want = token_xent(logits, tokens)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    g_got, = torch.autograd.grad(got, logits)
    g_want, = torch.autograd.grad(want, logits)
    torch.testing.assert_close(g_got, g_want, atol=1e-7, rtol=1e-5)


def test_token_xent_matches_jax():
    """token_xent's single-device form against the JAX package's."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 64)).astype(np.float32) * 3
    targets = rng.integers(0, 64, (2, 9)).astype(np.int32)
    want = float(jax_token_xent(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(token_xent(torch.from_numpy(logits),
                           torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, **LOSS)


def test_every_copy_kernel_6_writes_is_the_same(monkeypatch):
    """Every all-reduce of a tp step on the (2, 1, 4) mesh, fsdp: each
    rank's copy of the result holds the same bits (one fold order); the
    operators read copy 0. 4 layers-worth of launches a dp rank: 2 a block
    forward and 2 backward, the embedding, the logits' copy, the max and
    the sums."""
    seen = []

    def checked(contribs, mesh, op="sum"):
        out = ring_allreduce_plain(contribs, op)
        seen.append(all(torch.equal(out[0], out[r])
                        for r in range(1, out.shape[0])))
        return out

    monkeypatch.setattr(tensor_parallel, "ring_allreduce", checked)
    cfg = TransformerConfig(**_kw("mha"))
    init_state, step = make_train_step(cfg, mesh=_port_mesh("dp2_tp4"),
                                       fsdp=True)
    state = init_state(torch.Generator().manual_seed(0), "cpu")
    step(state, torch.from_numpy(_tokens()))
    assert len(seen) == 2 * (4 * MODEL["n_layers"] + 4) and all(seen)


# --------------------------------------------------------------------------
# Steps against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name,variant,mode,impl", CASES)
def test_three_steps_match_jax(jax_runs, mesh_name, variant, mode, impl):
    """Losses of three steps and the full parameters after them against
    JAX's step with the same mesh, flags and attention."""
    params0, want_losses, want_params, _, _ = jax_runs(mesh_name, variant,
                                                       mode, impl)
    state, losses = _port_run(params0, mesh_name, variant, mode, impl)
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    for got, want in _walk(full_params(state), want_params):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, **PARAMS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_replicated_leaves_get_the_jax_gradient(jax_runs, variant):
    """Every tp rank reads the norms and the position table: their
    gradient over the tp-8 mesh is JAX's (to float32 rounding), not tp
    times it, and so is every sharded leaf's."""
    params0 = jax_runs("tp8", variant, "dp")[0]
    jcfg = JaxConfig(**_kw(variant))
    tok = _tokens()
    _, want = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=2)(
        jax.tree.map(jnp.asarray, params0), jnp.asarray(tok), jcfg)
    cfg = TransformerConfig(**_kw(variant))
    params = params_from_jax(params0, cfg, device="cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss_fn(params, torch.from_numpy(tok), cfg, _port_mesh("tp8")).backward()
    pairs = _walk(params, jax.tree.map(np.asarray, want))
    replicated = [(x, w) for x, w in pairs if x.dim() == 1 or x.shape[0]
                  == MODEL["max_seq"]]
    assert len(replicated) == 2 + 4 * MODEL["n_layers"] + 1
    for x, w in pairs:
        np.testing.assert_allclose(x.grad.numpy(), w, **GRAD)
    for x, w in replicated:  # a tp-fold gradient would miss by 7 |g|
        assert np.abs(x.grad.numpy() - w).max() < 1e-3 * np.abs(w).max()


def test_rank_zero_partial_alone_misses_jax(jax_runs, monkeypatch):
    """The faulty control: every tp reduction keeps rank 0's partial
    alone (the embedding of the tokens outside rank 0's vocab range is
    lost with the rest). Every loss misses JAX's by more than LOSS."""
    def rank_zero(contribs, mesh, op="sum"):
        return contribs[:1].expand_as(contribs)

    monkeypatch.setattr(tensor_parallel, "ring_allreduce", rank_zero)
    params0, want, _, _, _ = jax_runs("tp8", "mha", "dp")
    _, losses = _port_run(params0, "tp8", "mha", "dp")
    gaps = [abs(g - w) - (LOSS["atol"] + LOSS["rtol"] * abs(w))
            for g, w in zip(losses, want)]
    assert min(gaps) > 0, (losses, want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", ["dp2_tp4", "nd8"])
def test_rank_shards_have_jax_shapes(jax_runs, mesh_name, mode):
    """What each (dp, tp) coordinate holds, every first moment and (but
    under zero1, which keeps them whole) parameter, has the shape of JAX's
    shard on device 0 (the split is even, so every device's shard has that
    shape)."""
    params0, _, _, mu_shapes, param_shapes = jax_runs(mesh_name, "mha",
                                                      mode)
    state, _ = _port_run(params0, mesh_name, "mha", mode)
    mesh = _port_mesh(mesh_name)
    for r in range(mesh.shape["dp"]):
        for t in range(mesh.shape["tp"]):
            held = rank_state(state, r, t)
            assert set(held) == {"params", "exp_avg", "exp_avg_sq"}
            for what, want_tree in (("exp_avg", mu_shapes),
                                    ("params", param_shapes)):
                if what == "params" and mode == "zero1":
                    continue  # zero1 keeps the parameters whole
                for got, want in _walk(held[what], want_tree):
                    assert tuple(got.shape) == want, (what, r, t)


@pytest.mark.parametrize("kwargs,match", [
    ({"d_ff": 60}, "d_ff=60"), ({"vocab": 60}, "vocab=60"),
    ({"n_heads": 4, "n_kv_heads": 4}, "n_heads=4")])
def test_tp_must_divide_heads_ffn_and_vocab(kwargs, match):
    cfg = TransformerConfig(**{**MODEL, **kwargs})
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, mesh=_port_mesh("tp8"))
