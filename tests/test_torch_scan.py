"""The port's linear scans against the JAX package's, on the CPU.

``linear_scan`` (a Hillis-Steele doubling scan in plain PyTorch) against
``mpi_tpu.parallel.linear_scan`` (``lax.associative_scan``), and
``sharded_linear_scan`` over the stacked chunks of an ``sp`` rank mesh
against JAX's ``sharded_linear_scan`` under ``shard_map`` on
``make_mesh(n, axis="sp")``, for n = 1, 3, 4 and 8 (``tests/test_ssm.py``'s
cases plus a rank count that is no power of two), float32 and complex64;
rank 0's chunk bitwise the local scan; the hops' count and their reverse
hops in the backward; the gradient against ``jax.grad`` of JAX's sharded
scan. Inputs come from numpy with a seed, coefficients with |a| < 1 as the
LRU's lam.

Tolerances are ``tests/test_ssm.py``'s for a scan against the local scan:
atol = rtol = 2e-5 for float32, 3e-5 for complex64 (the two scans combine
in different trees, so the last bits differ). Gradients: atol = rtol =
1e-4 (a sum of up to s products of such values).
"""

import importlib
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.parallel import linear_scan as jax_linear_scan  # noqa: E402
from mpi_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from mpi_tpu.parallel import (  # noqa: E402
    sharded_linear_scan as jax_sharded_linear_scan)
from mpi_tpu_torch.parallel import (RankMesh, linear_scan,  # noqa: E402
                                    make_mesh, sharded_linear_scan)

p2p = importlib.import_module("mpi_tpu_torch.parallel.p2p")

TOL = {np.float32: dict(atol=2e-5, rtol=2e-5),
       np.complex64: dict(atol=3e-5, rtol=3e-5)}
GRAD = dict(atol=1e-4, rtol=1e-4)
# Jitted: eager dispatch of the associative scan took seconds a case.
_jax_local = jax.jit(jax_linear_scan, static_argnames="axis")


def _coeffs(shape, dtype, seed):
    """(a, b): |a| in [0.5, 0.99), b standard normal, as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.99, shape)
    b = rng.standard_normal(shape)
    if dtype == np.complex64:
        a = a * np.exp(1j * rng.uniform(0, 3, shape))
        b = b + 1j * rng.standard_normal(shape)
    return a.astype(dtype), b.astype(dtype)


def _stack(x, n, dim):
    """Global (…, s, …) with the sequence at ``dim`` → stacked (n, …,
    s / n, …): rank r's chunk at index r."""
    return torch.stack(torch.tensor_split(x, n, dim=dim))


def _unstack(x, dim):
    return torch.cat(list(x), dim=dim)


def _jax_sharded(a, b, n, axis):
    mesh = jax_make_mesh(n, axis="sp")
    spec = [None] * a.ndim
    spec[axis] = "sp"
    spec = P(*spec)
    body = jax.shard_map(
        lambda av, bv: jax_sharded_linear_scan(av, bv, "sp", axis=axis),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False)
    return jax.jit(body)(jnp.asarray(a), jnp.asarray(b))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("shape,axis", [((3, 128, 5), 1), ((2, 12), 1),
                                        ((257, 4), 0), ((1,), 0)])
def test_linear_scan_matches_jax(dtype, shape, axis):
    a, b = _coeffs(shape, dtype, seed=23)
    want = _jax_local(jnp.asarray(a), jnp.asarray(b), axis=axis)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=axis)
    assert got.dtype == torch.from_numpy(b).dtype
    _close(got, want, dtype)


def test_linear_scan_broadcasts_a():
    """The LRU passes its (h,) lam: broadcast against (b, s, h)."""
    a, b = _coeffs((2, 33, 6), np.complex64, seed=3)
    lam = a[0, 0]
    want = _jax_local(jnp.broadcast_to(jnp.asarray(lam), b.shape),
                      jnp.asarray(b), axis=1)
    got = linear_scan(torch.from_numpy(lam), torch.from_numpy(b), dim=1)
    _close(got, want, np.complex64)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_sharded_scan_matches_jax(dtype, n):
    a, b = _coeffs((3, n * 16, 5), dtype, seed=29 + n)
    want = _jax_sharded(a, b, n, axis=1)
    mesh = make_mesh(n, axis="sp", devices=["cpu"] * n)
    got = sharded_linear_scan(_stack(torch.from_numpy(a), n, 1),
                              _stack(torch.from_numpy(b), n, 1), mesh,
                              dim=1)
    assert got.shape == (n, 3, 16, 5)
    _close(_unstack(got, 1), want, dtype)
    # ... and the whole sequence's local scan.
    whole = linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    _close(_unstack(got, 1), whole.numpy(), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_sharded_scan_along_the_first_chunk_dimension(dtype):
    """``dim`` 0 (JAX's default ``axis``) and a negative ``dim``."""
    n = 4
    a, b = _coeffs((n * 8, 3), dtype, seed=5)
    want = _jax_sharded(a, b, n, axis=0)
    mesh = make_mesh(n, axis="sp", devices=["cpu"] * n)
    for dim in (0, -2):
        got = sharded_linear_scan(_stack(torch.from_numpy(a), n, 0),
                                  _stack(torch.from_numpy(b), n, 0), mesh,
                                  dim=dim)
        _close(_unstack(got, 0), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_rank_zero_chunk_is_the_local_scan_bitwise(dtype, n):
    a, b = _coeffs((2, n * 16, 5), dtype, seed=41)
    sa = _stack(torch.from_numpy(a), n, 1)
    sb = _stack(torch.from_numpy(b), n, 1)
    got = sharded_linear_scan(sa, sb, make_mesh(
        n, axis="sp", devices=["cpu"] * n), dim=1)
    local = linear_scan(sa[0].contiguous(), sb[0].contiguous(), dim=1)
    assert torch.equal(got[0], local)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_hops_a_scan(monkeypatch, n):
    """2·⌈log2 n⌉ + 1 hops forward (two a round, rank r to r + d, and the
    carry's by one rank), none at n = 1; the backward runs the reverse of
    each hop that reaches the output."""
    shifts = []
    real = p2p.ring_hop

    def counted(x, mesh, shift=1):
        shifts.append(shift)
        return real(x, mesh, shift)

    monkeypatch.setattr(p2p, "ring_hop", counted)
    a, b = _coeffs((2, n * 4, 3), np.complex64, seed=7)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = sharded_linear_scan(_stack(ta, n, 1), _stack(tb, n, 1),
                              make_mesh(n, axis="sp", devices=["cpu"] * n),
                              dim=1)
    rounds = [2 ** k for k in range(math.ceil(math.log2(n)))]
    want = [] if n == 1 else [d for d in rounds for _ in (0, 1)] + [1]
    assert shifts == want
    shifts.clear()
    out.real.sum().backward()
    # The last round's a-summary reaches no output, so its hop gets no
    # gradient: every other hop is reversed once.
    back = [-d for d in want]
    if rounds:
        back.remove(-rounds[-1])
    assert sorted(shifts) == sorted(back)


def _grad_case(dtype, n, seed):
    """(torch grads, JAX grads) of ``sum(w · x)`` (its real part) over the
    sharded scan's output ``x``, with respect to the real inputs that make
    ``a`` and ``b``."""
    shape = (2, n * 8, 3)
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(0.5, 0.99, shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32)]
    if dtype == np.complex64:
        parts += [rng.uniform(0, 3, shape).astype(np.float32),
                  rng.standard_normal(shape).astype(np.float32)]
    w = rng.standard_normal(shape).astype(np.float32)

    def make(xp, ps, polar, cplx):
        if dtype == np.complex64:
            return polar(ps[0], ps[2]), cplx(ps[1], ps[3])
        return ps[0], ps[1]

    def jax_loss(*ps):
        a, b = make(jnp, ps, lambda r, t: r * jnp.exp(1j * t),
                    lambda re, im: re + 1j * im)
        spec = P(None, "sp")
        body = jax.shard_map(
            lambda av, bv: jax_sharded_linear_scan(av, bv, "sp", axis=1),
            mesh=jax_make_mesh(n, axis="sp"), in_specs=(spec, spec),
            out_specs=spec, check_vma=False)
        return jnp.sum(jnp.real(body(a, b)) * w)

    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(len(parts)))))(
        *map(jnp.asarray, parts))
    ts = [torch.from_numpy(p).requires_grad_() for p in parts]
    a, b = make(torch, ts, torch.polar, torch.complex)
    x = sharded_linear_scan(_stack(a, n, 1), _stack(b, n, 1),
                            make_mesh(n, axis="sp", devices=["cpu"] * n),
                            dim=1)
    x = _unstack(x, 1)
    (x.real if x.is_complex() else x).mul(torch.from_numpy(w)).sum() \
        .backward()
    return [t.grad for t in ts], want


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("n", [3, 4])
def test_sharded_scan_gradient_matches_jax(dtype, n):
    got, want = _grad_case(dtype, n, seed=53 + n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


def test_sharded_scan_refusals():
    a, b = _coeffs((4, 8, 3), np.float32, seed=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="one chunk per 'sp' rank"):
        sharded_linear_scan(ta, tb, make_mesh(3, axis="sp",
                                              devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="has no 'sp' axis"):
        sharded_linear_scan(ta, tb, make_mesh(4, axis="dp",
                                              devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="out of range"):
        sharded_linear_scan(ta, tb, make_mesh(4, axis="sp",
                                              devices=["cpu"] * 4), dim=2)
    with pytest.raises(TypeError, match="takes a RankMesh"):
        sharded_linear_scan(ta, tb, jax_make_mesh(4, axis="sp"))
    with pytest.raises(NotImplementedError, match="several devices"):
        sharded_linear_scan(ta, tb, RankMesh(["cpu", "meta"] * 2, ("sp",)))
