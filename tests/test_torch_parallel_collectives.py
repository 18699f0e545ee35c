"""The port's ``parallel/collectives`` against ``mpi_tpu.parallel.
collectives``.

The JAX functions run inside ``shard_map`` on the 8 virtual CPU devices
that tests/conftest.py sets up, as tests/test_parallel_collectives.py runs
them; each rank's result is stacked on a new leading axis. The port's
functions take and return that stacked view over a mesh that names "cpu"
once per rank. Inputs are made with numpy from a seed.

Tolerances: the deterministic paths (tree, ring, reduce-scatter in the
canonical order), the gathers, shifts, broadcasts and prefix folds, and the
max/min reductions are bitwise: both compute the same ops in the same
order. The fast sum and product reduce in XLA's order in JAX and torch's
here, so they are held to 2 n u Σ|x_i| (sums) and 2 n u |Π x_i|
(products) with u = 2**-24 for float32: each differs from the exact result
by at most (n − 1) u of that magnitude, to first order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi_tpu.collectives_generic as jgen
from mpi_tpu.parallel import collectives as JC
from mpi_tpu.parallel import make_mesh as jax_mesh
from mpi_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
from mpi_tpu_torch import collectives_generic as tgen
from mpi_tpu_torch.parallel import collectives as TC
from mpi_tpu_torch.parallel import make_mesh, make_mesh_2d

N = 8
U = 2.0 ** -24
OPS = ("sum", "prod", "min", "max")


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N, "conftest must force 8 cpu devices"
    return jax_mesh(N)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=["cpu"] * N)


def per_rank(mesh, body, x, spec=P("rank")):
    """JAX's per-rank results of ``body`` on each rank's block of the
    stacked ``x``, stacked on a new leading axis."""
    fn = jax.jit(jax.shard_map(lambda v: body(v[0])[None], mesh=mesh,
                               in_specs=spec, out_specs=spec,
                               check_vma=False))
    return np.asarray(fn(jnp.asarray(x)))


def stacked(shape, op="sum", seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-50, 50, (N, *shape)).astype(dtype)
    if op == "prod":
        return rng.uniform(0.5, 1.5, (N, *shape)).astype(dtype)
    return rng.standard_normal((N, *shape)).astype(dtype)


def assert_bitwise(got, want):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def assert_within_order(got, want, x, op):
    """|got - want| within 2 n u of the sum of magnitudes (sum) or of the
    product's magnitude (prod)."""
    scale = np.abs(x).sum(0) if op == "sum" else np.abs(np.prod(x, 0))
    assert got.shape == want.shape
    assert (np.abs(got.numpy() - want) <= 2 * N * U * scale).all()


@pytest.mark.parametrize("op", OPS)
def test_allreduce_fast(jmesh, tmesh, op):
    x = stacked((6, 5), op, seed=1)
    want = per_rank(jmesh, lambda v: JC.allreduce(v, "rank", op=op), x)
    got = TC.allreduce(torch.from_numpy(x), tmesh, op)
    if op in ("min", "max"):
        assert_bitwise(got.contiguous(), want)
    else:
        assert_within_order(got, want, x, op)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_deterministic_tree_bitwise(jmesh, tmesh, op):
    x = stacked((257,), op, seed=2)
    want = per_rank(jmesh, lambda v: JC.allreduce(v, "rank", op=op,
                                                  deterministic=True), x)
    got = TC.allreduce(torch.from_numpy(x), tmesh, op, deterministic=True)
    assert_bitwise(got.contiguous(), want)
    direct = TC.tree_allreduce(torch.from_numpy(x), tmesh, op)
    assert_bitwise(direct.contiguous(), want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("size", [8 * 30, 8 * 30 + 5])
def test_allreduce_deterministic_ring_bitwise(monkeypatch, jmesh, tmesh,
                                              size, op):
    monkeypatch.setattr(jgen, "RING_MIN_BYTES", 1)
    monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    x = stacked((size,), op, seed=size)
    want = per_rank(jmesh, lambda v: JC.allreduce(v, "rank", op=op,
                                                  deterministic=True), x)
    got = TC.allreduce(torch.from_numpy(x), tmesh, op, deterministic=True)
    assert_bitwise(got, want)
    # the canonical ring, not the tree
    assert_bitwise(got[0], jgen.ring_combine(list(x), op))


@pytest.mark.parametrize("shape", [(16, 3), (5, 7)])
def test_ring_allreduce_bitwise(jmesh, tmesh, shape):
    x = stacked(shape, seed=3)
    want = per_rank(jmesh, lambda v: JC.ring_allreduce(v, "rank"), x)
    assert_bitwise(TC.ring_allreduce(torch.from_numpy(x), tmesh), want)


@pytest.mark.parametrize("op", OPS)
def test_ring_reduce_scatter_bitwise(jmesh, tmesh, op):
    x = stacked((2 * N, 3), op, seed=4)
    want = per_rank(jmesh, lambda v: JC.ring_reduce_scatter(v, "rank", op),
                    x)
    assert_bitwise(TC.ring_reduce_scatter(torch.from_numpy(x), tmesh, op),
                   want)


def test_reduce_scatter_fast_sum(jmesh, tmesh):
    x = stacked((2 * N, 3), seed=5)
    want = per_rank(jmesh, lambda v: JC.reduce_scatter(v, "rank"), x)
    got = TC.reduce_scatter(torch.from_numpy(x), tmesh)
    assert got.shape == (N, 2, 3)
    scale = np.abs(x).sum(0).reshape(N, 2, 3)
    assert (np.abs(got.numpy() - want) <= 2 * N * U * scale).all()


@pytest.mark.parametrize("op", ["prod", "min", "max"])
@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_fast_other_ops_bitwise(jmesh, tmesh, op, dim):
    shape = (2 * N, 3) if dim == 0 else (3, 2 * N)
    x = stacked(shape, op, seed=6)
    want = per_rank(jmesh, lambda v: JC.reduce_scatter(
        v, "rank", op=op, scatter_dimension=dim), x)
    got = TC.reduce_scatter(torch.from_numpy(x), tmesh, op,
                            scatter_dimension=dim)
    assert_bitwise(got.contiguous(), want)


def test_reduce_scatter_untiled(jmesh, tmesh):
    x = stacked((N, 4), seed=7)
    want = per_rank(jmesh, lambda v: JC.reduce_scatter(v, "rank",
                                                       tiled=False), x)
    got = TC.reduce_scatter(torch.from_numpy(x), tmesh, tiled=False)
    assert got.shape == want.shape == (N, 4)
    assert (np.abs(got.numpy() - want)
            <= 2 * N * U * np.abs(x).sum(0)).all()


@pytest.mark.parametrize("ring", [False, True])
def test_reduce_scatter_deterministic_bitwise(monkeypatch, jmesh, tmesh,
                                              ring):
    if ring:
        monkeypatch.setattr(jgen, "RING_MIN_BYTES", 1)
        monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    x = stacked((3 * N, 2), seed=8)
    want = per_rank(jmesh, lambda v: JC.reduce_scatter(
        v, "rank", deterministic=True), x)
    got = TC.reduce_scatter(torch.from_numpy(x), tmesh, deterministic=True)
    assert_bitwise(got.contiguous(), want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_hierarchical_allreduce(op, grid):
    jm = jax_mesh_2d(grid)
    tm = make_mesh_2d(grid, devices=["cpu"] * N)
    x = stacked((4, 3), op, seed=9)
    want = per_rank(jm, lambda v: JC.hierarchical_allreduce(v, op=op), x,
                    spec=P(("outer", "inner")))
    got = TC.hierarchical_allreduce(torch.from_numpy(x), tm, op)
    if op in ("min", "max"):
        assert_bitwise(got.contiguous(), want)
    else:
        assert_within_order(got, want, x, op)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_allgather_bitwise(jmesh, tmesh, axis, tiled, dtype):
    x = stacked((3, 5), seed=10, dtype=dtype)
    want = per_rank(jmesh, lambda v: JC.allgather(v, "rank", axis=axis,
                                                  tiled=tiled), x)
    got = TC.allgather(torch.from_numpy(x), tmesh, axis=axis, tiled=tiled)
    assert_bitwise(got.contiguous(), want)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_bcast_bitwise(jmesh, tmesh, root):
    x = stacked((5,), seed=11)
    want = per_rank(jmesh, lambda v: JC.bcast(v, root, "rank"), x)
    assert_bitwise(TC.bcast(torch.from_numpy(x), tmesh, root).contiguous(),
                   want)


@pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_alltoall_bitwise(jmesh, tmesh, split, concat):
    x = stacked((2 * N, N), seed=12)
    want = per_rank(jmesh, lambda v: JC.alltoall(v, "rank", split_axis=split,
                                                 concat_axis=concat), x)
    got = TC.alltoall(torch.from_numpy(x), tmesh, split, concat)
    assert_bitwise(got.contiguous(), want)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_prefix_reduce_bitwise(jmesh, tmesh, op, exclusive, dtype):
    x = stacked((4,), op, seed=13, dtype=dtype)
    want = per_rank(jmesh, lambda v: JC.prefix_reduce(
        v, "rank", op=op, exclusive=exclusive), x)
    got = TC.prefix_reduce(torch.from_numpy(x), tmesh, op, exclusive)
    assert_bitwise(got, want)


@pytest.mark.parametrize("shift", [1, 3, -1, 8])
def test_pshift_bitwise(jmesh, tmesh, shift):
    x = stacked((2, 3), seed=14)
    want = per_rank(jmesh, lambda v: JC.pshift(v, shift, "rank"), x)
    assert_bitwise(TC.pshift(torch.from_numpy(x), tmesh, shift), want)


def test_bad_op_raises(tmesh):
    x = torch.zeros(N, 4)
    for fn in (TC.allreduce, TC.tree_allreduce, TC.ring_allreduce,
               TC.reduce_scatter, TC.prefix_reduce):
        with pytest.raises(ValueError, match="unknown reduction op"):
            fn(x, tmesh, op="xor")


def test_block_count_must_match_the_mesh(tmesh):
    with pytest.raises(ValueError, match="one block per rank"):
        TC.allreduce(torch.zeros(N - 1, 4), tmesh)
