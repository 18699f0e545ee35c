"""The port's static point-to-point exchange against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs as tests/test_p2p.py runs it (``pallas_sendrecv_sharded`` in
interpret mode, ``exchange_sharded`` and ``tagged_exchange`` as ppermute,
on conftest's 8 virtual CPU devices). The port runs on the CPU over a mesh
that names "cpu" once per rank. A permutation moves values unchanged, so
the comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_tpu.parallel import make_mesh as jax_make_mesh
from mpi_tpu.parallel import p2p as jp2p
from mpi_tpu_torch.parallel import (exchange, exchange_sharded, make_mesh,
                                    p2p, sendrecv, sendrecv_sharded,
                                    tagged_exchange)

N = 8
PATTERNS = {
    "ring": [(r, (r + 1) % N) for r in range(N)],
    "reverse_ring": [(r, (r - 1) % N) for r in range(N)],
    "partial": [(0, 4), (4, 0), (2, 3)],
    "self_pair": [(1, 1), (0, 5), (5, 0), (6, 7)],
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(N)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=["cpu"] * N)


def _blocks(seed, shape=(4,)):
    return np.random.default_rng(seed).standard_normal(
        (N, *shape)).astype(np.float32)


def _shard(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P("rank")))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_sendrecv_sharded_matches_pallas_sendrecv(jmesh, tmesh, pattern,
                                                  dtype):
    perm = PATTERNS[pattern]
    x = _blocks(3, (8, 128)).reshape(N * 8, 128)
    want = jp2p.pallas_sendrecv_sharded(
        _shard(jmesh, jnp.asarray(x).astype(DTYPES[dtype][0])), jmesh, perm,
        interpret=True)
    got = sendrecv_sharded(torch.from_numpy(x).to(DTYPES[dtype][1]), tmesh,
                           perm)
    assert got.shape == x.shape and got.dtype == DTYPES[dtype][1]
    assert np.array_equal(_np(got), _np(want))
    receivers = {d for _, d in perm}
    for d in set(range(N)) - receivers:
        assert not _np(got).reshape(N, 8, 128)[d].any()


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_exchange_sharded_matches_jax(jmesh, tmesh, pattern):
    perm = PATTERNS[pattern]
    x = _blocks(4, (2, 3)).reshape(N * 2, 3)
    want = jp2p.exchange_sharded(_shard(jmesh, x), jmesh, perm)
    got = exchange_sharded(torch.from_numpy(x), tmesh, perm)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_exchange_equals_sendrecv(tmesh, pattern):
    x = torch.from_numpy(_blocks(5, (6,)))
    assert torch.equal(exchange(x, PATTERNS[pattern]),
                       sendrecv(x, tmesh, PATTERNS[pattern]))


def test_tagged_exchange_matches_jax(jmesh):
    xa, xb = _blocks(6), _blocks(7)
    sends = {7: [(0, 1)], 11: [(1, 0), (0, 2)]}

    def body(a, b):
        out = jp2p.tagged_exchange({7: a, 11: b}, sends)
        return out[7], out[11]

    fn = jax.jit(jax.shard_map(body, mesh=jmesh,
                               in_specs=(P("rank"), P("rank")),
                               out_specs=(P("rank"), P("rank")),
                               check_vma=False))
    wa, wb = fn(_shard(jmesh, xa), _shard(jmesh, xb))
    got = tagged_exchange({7: torch.from_numpy(xa),
                           11: torch.from_numpy(xb)}, sends)
    assert sorted(got) == [7, 11]
    assert np.array_equal(got[7].numpy(), np.asarray(wa))
    assert np.array_equal(got[11].numpy(), np.asarray(wb))
    assert not got[7][2].any()  # tag 7 sent nothing to rank 2


def test_tag_set_mismatch():
    with pytest.raises(ValueError, match="tag mismatch"):
        tagged_exchange({1: torch.zeros(N, 2)}, {2: [(0, 1)]})


@pytest.mark.parametrize("perm,match", [
    ([(0, 1), (0, 2)], "sends twice"),
    ([(0, 1), (2, 1)], "receives twice"),
    ([(0, 9)], "out of range"),
])
def test_pattern_errors(tmesh, perm, match):
    x = torch.zeros(N * 2, 3)
    with pytest.raises(ValueError, match=match):
        p2p._check_pattern(perm, n=N)
    with pytest.raises(ValueError, match=match):
        sendrecv_sharded(x, tmesh, perm)
    with pytest.raises(ValueError, match=match):
        exchange_sharded(x, tmesh, perm)
    with pytest.raises(ValueError, match=match):
        jp2p._check_pattern(perm, n=N)


def test_complete_permutation_matches_jax():
    for perm in PATTERNS.values():
        assert p2p._complete_permutation(perm, N) == \
            jp2p._complete_permutation(tuple(perm), N)
