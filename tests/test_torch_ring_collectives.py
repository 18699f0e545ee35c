"""The port's ring collectives against the JAX package's, bit for bit.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs the Pallas ring kernels as tests/test_ring_collectives.py runs
them: in interpret mode, inside shard_map, on conftest's 8 virtual CPU
devices. The port runs its plain versions on the CPU over a mesh that names
"cpu" once per rank.

Tolerance 0: both replay the same ring, folding ``local ⊕ arriving`` in the
same order and rounding to the working dtype at every hop, so every rank's
output must be equal (NaN compared as equal to NaN). bfloat16 results are
compared after an exact cast to float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mpi_tpu.ops import ring_collectives as jrc
from mpi_tpu.parallel import p2p as jp2p
from mpi_tpu_torch.ops import ring_collectives as trc
from mpi_tpu_torch.parallel import make_mesh, sendrecv_sharded

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("rank",))


def _torch_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(DTYPES[dtype][0])


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(DTYPES[dtype][1])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _per_rank(body, n):
    """JAX's per-rank view: ``body`` on each device's shard, every rank's
    result stacked on a new leading axis."""
    return jax.shard_map(lambda v: body(v)[None], mesh=_jax_mesh(n),
                         in_specs=P("rank"), out_specs=P("rank"),
                         check_vma=False)


def _jax_allreduce(x, n, op):
    fn = _per_rank(lambda v: jrc.ring_allreduce(v[0], op=op, interpret=True),
                   n)
    return fn(x)


def _contribs(n, m, op, seed=0):
    rng = np.random.default_rng(seed)
    if op == "prod":  # keep the product of n factors in range
        return rng.uniform(0.5, 1.5, (n, m, 3)).astype(np.float32)
    return rng.standard_normal((n, m, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_allreduce_every_rank_matches_jax(n, op, dtype):
    x = _contribs(n, 2 * n, op, seed=n)
    want = _np(_jax_allreduce(_to_jax(x, dtype), n, op))
    got = trc.ring_allreduce(_to_torch(x, dtype), _torch_mesh(n), op)
    assert got.dtype == DTYPES[dtype][1] and got.shape == x.shape
    assert np.array_equal(_np(got), want)
    # Every rank holds the same reduction.
    assert all(np.array_equal(want[0], want[r]) for r in range(n))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_allreduce_sharded_padding_path_matches_jax(dtype):
    # m = 5 is no multiple of n = 4: both pad to 8 and trim; a chunk is
    # 2 rows of 3, 24 bytes in float32.
    x = _contribs(4, 5, "sum", seed=11)
    want = _np(jrc.ring_allreduce_sharded(_to_jax(x, dtype), _jax_mesh(4),
                                          interpret=True))
    got = trc.ring_allreduce_sharded(_to_torch(x, dtype), _torch_mesh(4))
    assert got.shape == (5, 3)
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("op", ["max", "min"])
def test_allreduce_propagates_nan_as_jax(op):
    x = _contribs(4, 8, op, seed=5)
    x[2, 3, 1] = np.nan
    want = _np(_jax_allreduce(_to_jax(x, "float32"), 4, op))
    got = _np(trc.ring_allreduce(_to_torch(x, "float32"), _torch_mesh(4),
                                 op))
    assert np.isnan(want[:, 3, 1]).all()
    assert np.array_equal(got, want, equal_nan=True)


def _message(excinfo):
    return str(excinfo.value).split(": ", 1)[1]


def test_leading_axis_mismatch_raises_as_jax():
    x = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="ring size") as jerr:
        jrc.ring_allreduce_sharded(jnp.asarray(x), _jax_mesh(4))
    for fn in (trc.ring_allreduce_sharded, trc.ring_allreduce):
        with pytest.raises(ValueError, match="ring size") as terr:
            fn(torch.from_numpy(x), _torch_mesh(4))
        assert _message(terr) == _message(jerr)


def test_indivisible_axis_raises_as_jax():
    x = np.zeros((4, 5), np.float32)
    with pytest.raises(ValueError, match="ring") as jerr:
        _jax_allreduce(jnp.asarray(x), 4, "sum")
    with pytest.raises(ValueError, match="ring") as terr:
        trc.ring_allreduce(torch.from_numpy(x), _torch_mesh(4))
    assert _message(terr) == _message(jerr)


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown ring op"):
        trc.ring_allreduce(torch.zeros(2, 2), _torch_mesh(2), "mean")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_allgather_every_rank_matches_jax(n, dtype):
    x = np.random.default_rng(n).standard_normal((3 * n, 2)).astype(
        np.float32)
    fn = _per_rank(lambda v: jrc.ring_allgather(v, interpret=True), n)
    want = _np(fn(_to_jax(x, dtype)))
    got = trc.ring_allgather(_to_torch(x, dtype), _torch_mesh(n))
    assert got.shape == (n, 3 * n, 2)
    assert np.array_equal(_np(got), want)
    sharded = trc.ring_allgather_sharded(_to_torch(x, dtype), _torch_mesh(n))
    assert np.array_equal(_np(sharded), _np(_to_torch(x, dtype)))


def test_slice_data_parallel_round_matches_jax():
    """The layer as a data-parallel round uses it: ranks all-reduce their
    flattened gradients (padded: 1001 values over 8 ranks), all-gather
    their parameter shards, and hand an activation on around the ring."""
    n = 8
    rng = np.random.default_rng(7)
    grads = rng.standard_normal((n, 1001)).astype(np.float32)
    shards = rng.standard_normal((n * 16, 4)).astype(np.float32)
    acts = rng.standard_normal((n * 2, 8, 16)).astype(np.float32)
    ring = [(r, (r + 1) % n) for r in range(n)]

    jmesh, tmesh = _jax_mesh(n), _torch_mesh(n)
    for dtype in sorted(DTYPES):
        want = [jrc.ring_allreduce_sharded(_to_jax(grads, dtype), jmesh,
                                           interpret=True),
                jrc.ring_allgather_sharded(_to_jax(shards, dtype), jmesh,
                                           interpret=True),
                jp2p.pallas_sendrecv_sharded(_to_jax(acts, dtype), jmesh,
                                             ring, interpret=True)]
        got = [trc.ring_allreduce_sharded(_to_torch(grads, dtype), tmesh),
               trc.ring_allgather_sharded(_to_torch(shards, dtype), tmesh),
               sendrecv_sharded(_to_torch(acts, dtype), tmesh, ring)]
        for w, g in zip(want, got):
            assert np.array_equal(_np(g), _np(w)), dtype
