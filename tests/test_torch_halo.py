"""The port's halo exchange and Jacobi sweeps (``parallel/halo.py``)
against the JAX package's, on the CPU.

Every case of ``tests/test_halo.py``: the JAX side runs
``halo_exchange`` / ``jacobi_step_1d`` / ``jacobi_step_2d`` inside
``shard_map`` over conftest's 8 virtual CPU devices; the port runs them on
the stacked blocks of a ``RankMesh`` of 8 ranks on ``"cpu"`` (kernel 7's
plain version). The same numpy inputs go to both, and to a dense sweep of
the whole array in numpy. Tolerance 0: a halo is a copy, and both
packages and the dense sweep add the same float32 neighbours in the same
order (``(lo + hi) * 0.5``; ``N + S + W + E`` then ``* 0.25``), so every
result is compared bit for bit, over 50 sweeps too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.parallel import halo as jhalo  # noqa: E402
from mpi_tpu_torch.parallel import (RankMesh, halo_exchange,  # noqa: E402
                                    jacobi_step_1d, jacobi_step_2d,
                                    make_mesh)

N = 8


def _jax_run(fn, x, spec, mesh=None):
    mesh = mesh or Mesh(np.asarray(jax.devices()[:N]), ("rank",))
    body = jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                         check_vma=False)
    return np.asarray(jax.jit(body)(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, spec))))


def _mesh():
    return make_mesh(devices=["cpu"] * N)


def _grid_mesh(rows, cols):
    return RankMesh(["cpu"] * N, ("row", "col"), (rows, cols))


def _to_blocks(u, rows, cols):
    """The (rows·cols, bi, bj) stacked blocks of a 2-D grid, rank (i, j)
    at index i·cols + j."""
    bi, bj = u.shape[0] // rows, u.shape[1] // cols
    return u.reshape(rows, bi, cols, bj).transpose(0, 2, 1, 3).reshape(
        rows * cols, bi, bj)


def _from_blocks(b, rows, cols):
    n, bi, bj = b.shape
    return b.reshape(rows, cols, bi, bj).transpose(0, 2, 1, 3).reshape(
        rows * bi, cols * bj)


def _dense_1d(u, sweeps, boundary=0.0, periodic=False):
    for _ in range(sweeps):
        p = np.pad(u, 1, mode="wrap") if periodic else np.pad(
            u, 1, constant_values=np.float32(boundary))
        u = ((p[:-2] + p[2:]) * np.float32(0.5)).astype(np.float32)
    return u


def _dense_2d(u, sweeps, boundary=0.0, periodic=False):
    for _ in range(sweeps):
        p = np.pad(u, 1, mode="wrap") if periodic else np.pad(
            u, 1, constant_values=np.float32(boundary))
        u = ((p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
             * np.float32(0.25)).astype(np.float32)
    return u


class TestHaloExchange:
    def test_periodic_matches_jax_and_roll(self):
        x = np.arange(N * 4, dtype=np.float32)
        want = _jax_run(lambda b: jhalo.halo_exchange(b, width=2,
                                                      periodic=True),
                        x, P("rank")).reshape(N, -1)
        got = halo_exchange(torch.from_numpy(x).reshape(N, 4), _mesh(),
                            width=2, periodic=True).numpy()
        np.testing.assert_array_equal(got, want)
        xs = x.reshape(N, 4)
        for i in range(N):
            np.testing.assert_array_equal(got[i][:2], xs[(i - 1) % N][-2:])
            np.testing.assert_array_equal(got[i][2:6], xs[i])
            np.testing.assert_array_equal(got[i][6:], xs[(i + 1) % N][:2])

    def test_nonperiodic_fill_matches_jax(self):
        x = np.ones(N * 2, np.float32)
        want = _jax_run(lambda b: jhalo.halo_exchange(b, width=1,
                                                      fill_value=7.0),
                        x, P("rank")).reshape(N, -1)
        got = halo_exchange(torch.from_numpy(x).reshape(N, 2), _mesh(),
                            fill_value=7.0).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0][0] == 7.0 and got[-1][-1] == 7.0
        assert (got[1:, 0] == 1.0).all() and (got[:-1, -1] == 1.0).all()

    def test_2d_blocks_halo_on_dim0_matches_jax(self):
        x = np.arange(N * 3 * 5, dtype=np.float32).reshape(N * 3, 5)
        want = _jax_run(lambda b: jhalo.halo_exchange(b, width=1,
                                                      periodic=True),
                        x, P("rank")).reshape(N, 5, 5)
        got = halo_exchange(torch.from_numpy(x).reshape(N, 3, 5), _mesh(),
                            periodic=True).numpy()
        np.testing.assert_array_equal(got, want)

    def test_halo_on_dim1_strided_edge_matches_jax(self):
        """A block sharded on its dimension 1: the edges are strided
        columns, made contiguous before the kernel-7 launch."""
        x = np.random.default_rng(3).standard_normal(
            (5, N * 3)).astype(np.float32)
        want = _jax_run(lambda b: jhalo.halo_exchange(b, width=2, dim=1,
                                                      fill_value=-2.5),
                        x, P(None, "rank"))
        blocks = torch.from_numpy(x).reshape(5, N, 3).permute(1, 0, 2)
        got = halo_exchange(blocks, _mesh(), width=2, dim=1,
                            fill_value=-2.5)
        assert got.shape == (N, 5, 7)
        np.testing.assert_array_equal(
            got.permute(1, 0, 2).reshape(5, -1).numpy(), want)

    @pytest.mark.parametrize("width,match", [(3, "smaller than halo"),
                                             (0, "must be >= 1")])
    def test_bad_width_rejected(self, width, match):
        x = np.ones(N * 2, np.float32)
        with pytest.raises(ValueError, match=match):
            _jax_run(lambda b: jhalo.halo_exchange(b, width=width), x,
                     P("rank"))
        with pytest.raises(ValueError, match=match):
            halo_exchange(torch.from_numpy(x).reshape(N, 2), _mesh(),
                          width=width)


class TestJacobi:
    @pytest.mark.parametrize("sweeps,periodic,boundary", [
        (5, False, 0.0), (50, False, 0.0), (50, True, 0.0),
        (10, False, 1.5)])
    def test_1d_sweeps_match_jax_and_dense(self, sweeps, periodic,
                                           boundary):
        u0 = np.random.default_rng(0).standard_normal(N * 8).astype(
            np.float32)

        def body(b):
            return lax.fori_loop(0, sweeps, lambda _, v: jhalo.jacobi_step_1d(
                v, periodic=periodic, boundary=boundary), b)

        want = _jax_run(body, u0, P("rank"))
        got = torch.from_numpy(u0).reshape(N, 8)
        for _ in range(sweeps):
            got = jacobi_step_1d(got, _mesh(), periodic=periodic,
                                 boundary=boundary)
        got = got.reshape(-1).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _dense_1d(u0, sweeps, boundary,
                                                     periodic))

    @pytest.mark.parametrize("shape,sweeps,periodic,boundary", [
        ((4, 2), 3, False, 1.5), ((4, 2), 50, False, 0.0),
        ((2, 4), 50, True, 0.0), ((2, 4), 50, False, 0.0)])
    def test_2d_sweeps_match_jax_and_dense(self, shape, sweeps, periodic,
                                           boundary):
        """5-point sweeps over a rows × cols grid of ranks (both spatial
        dimensions sharded; (2, 4) is the card's smoke layout)."""
        rows, cols = shape
        u0 = np.random.default_rng(2).standard_normal(
            (rows * 4, cols * 6)).astype(np.float32)
        mesh2 = Mesh(np.array(jax.devices()[:N]).reshape(rows, cols),
                     ("row", "col"))

        def body(b):
            return lax.fori_loop(0, sweeps, lambda _, v: jhalo.jacobi_step_2d(
                v, periodic=periodic, boundary=boundary), b)

        want = _jax_run(body, u0, P("row", "col"), mesh2)
        got = torch.from_numpy(_to_blocks(u0, rows, cols))
        for _ in range(sweeps):
            got = jacobi_step_2d(got, _grid_mesh(rows, cols),
                                 periodic=periodic, boundary=boundary)
        got = _from_blocks(got.numpy(), rows, cols)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _dense_2d(u0, sweeps, boundary,
                                                     periodic))

    def test_periodic_jacobi_conserves_mean(self):
        u0 = np.random.default_rng(1).standard_normal(N * 4).astype(
            np.float32)
        got = torch.from_numpy(u0).reshape(N, 4)
        for _ in range(10):
            got = jacobi_step_1d(got, _mesh(), periodic=True)
        np.testing.assert_allclose(float(got.sum()), u0.sum(), rtol=1e-4)
