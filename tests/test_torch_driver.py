"""The port's cuda driver against the JAX package's XLA driver.

Both run reference-style programs with one thread per rank. The JAX driver
runs as ``XlaNetwork(n, devices=[cpu] * n)``: its ranks share a device, so
it has no mesh and folds every collective on the host in the canonical
order of ``collectives_generic``. The port's driver runs as
``CudaNetwork(n, device="cpu")``, its ranks' tensors on the CPU, which
takes the same routes as on the card with each kernel's plain version.
Inputs are made with numpy from a seed; the JAX driver gets them as numpy
arrays (ml_dtypes' bfloat16 for bf16), the port as torch tensors.

Tolerance 0 (bitwise) everywhere: both fold the same payloads in the same
order, and each elementwise op rounds to the dtype in both (numpy and
ml_dtypes' bfloat16 as torch does). bf16 results are compared after an
exact cast to float32.
"""

import math
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mpi_tpu
import mpi_tpu.collectives_generic as jgen
from mpi_tpu import api as japi
from mpi_tpu.backends import xla
import mpi_tpu_torch as M
from mpi_tpu_torch import api as tapi
from mpi_tpu_torch import collectives_generic as tgen
from mpi_tpu_torch.backends import cuda
from mpi_tpu_torch.backends.cuda import CudaNetwork, run_spmd
from mpi_tpu_torch.examples import bounce, helloworld
from mpi_tpu_torch.ops import ring_collectives

OPS = ("sum", "prod", "min", "max")
DTYPES = ("float32", "bfloat16", "int32", "float64")


@pytest.fixture(autouse=True)
def fresh_registries():
    japi._reset_for_testing()
    tapi._reset_for_testing()
    yield
    japi._reset_for_testing()
    tapi._reset_for_testing()


def run_port(body, n):
    """``body(rank)`` on each of n port ranks, on the CPU, between init
    and finalize."""
    def main():
        M.init()
        try:
            return body(M.rank())
        finally:
            M.finalize()

    return run_spmd(main, n=n, device="cpu")


def run_jax(body, n):
    """``body(rank)`` on each of n ranks of the JAX driver, every rank on
    one CPU device (the host fold in the canonical order)."""
    net = xla.XlaNetwork(n, devices=[jax.devices("cpu")[0]] * n)

    def main():
        mpi_tpu.init()
        try:
            return body(mpi_tpu.rank())
        finally:
            mpi_tpu.finalize()

    return xla.run_spmd(main, net=net)


def inputs(n, shape, dtype, op, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        hi = 3 if op == "prod" else 1000
        return [rng.integers(-hi, hi, shape).astype(np.int32)
                for _ in range(n)]
    if op == "prod":  # keep the product of n factors in range
        return [rng.uniform(0.5, 1.5, shape) for _ in range(n)]
    return [rng.standard_normal(shape) for _ in range(n)]


def as_numpy(x, dtype):
    """The JAX driver's payload."""
    if dtype == "bfloat16":
        return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return np.asarray(x).astype(dtype)


def as_tensor(x, dtype):
    """The port's payload: the same values (bf16 rounded from float32 to
    nearest even, as ml_dtypes rounds)."""
    t = torch.from_numpy(np.asarray(x))
    if dtype == "bfloat16":
        return t.float().to(torch.bfloat16)
    return t.to(getattr(torch, dtype))


def bits(x):
    """Exact bytes of a result; bf16 as float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def assert_same(got, want):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    assert g.tobytes() == w.tobytes()


# --------------------------------------------------------------------------
# Lifecycle
# --------------------------------------------------------------------------

class TestLifecycle:
    def test_rank_size_device_binding(self):
        def body(r):
            return r, M.size(), M.registered().device()

        out = run_port(body, 4)
        assert [o[0] for o in out] == [0, 1, 2, 3]
        assert all(o[1] == 4 and o[2] == torch.device("cpu") for o in out)

    def test_unbound_thread_rejected(self):
        net = CudaNetwork(n=4, device="cpu")
        with pytest.raises(M.MpiError, match="no rank binding"):
            net.rank()

    def test_too_many_ranks(self):
        with pytest.raises(M.MpiError, match="need"):
            CudaNetwork(n=3, devices=["cpu"])
        assert CudaNetwork(n=3, devices=["cpu"], oversubscribe=True).size() \
            == 3

    def test_rank_error_propagates(self):
        def body(r):
            if r == 3:
                raise RuntimeError("boom on 3")
            M.barrier()

        with pytest.raises(RuntimeError, match="boom on 3"):
            run_port(body, 4)

    def test_run_spmd_twice_same_process(self):
        assert run_port(lambda r: r, 2) == [0, 1]
        assert run_port(lambda r: r, 2) == [0, 1]  # facade released

    def test_calls_before_init_raise(self):
        with pytest.raises(M.NotInitializedError):
            M.rank()


# --------------------------------------------------------------------------
# Point to point
# --------------------------------------------------------------------------

class TestPointToPoint:
    def test_ring_exchange(self):
        n = 5

        def body(r):
            return M.sendrecv(torch.full((4,), float(r)), dest=(r + 1) % n,
                              source=(r - 1) % n, tag=7)

        for r, got in enumerate(run_port(body, n)):
            assert torch.equal(got, torch.full((4,), float((r - 1) % n)))

    def test_self_send(self):
        def body(r):
            t = threading.Thread(target=M.send, args=(f"me{r}", r, 3),
                                 daemon=True)
            t.start()
            got = M.receive(r, tag=3)
            t.join(timeout=5)
            return got

        assert run_port(body, 3) == ["me0", "me1", "me2"]

    def test_tensor_lands_on_the_destination_device_as_a_copy(self):
        sent = torch.arange(8.0)

        def body(r):
            if r == 0:
                M.send(sent, dest=2, tag=1)
                return None
            if r == 2:
                got = M.receive(0, tag=1)
                return got, M.registered().device(2)
            return None

        got, dev = run_port(body, 3)[2]
        assert got.device == dev and torch.equal(got, sent)
        assert got.data_ptr() != sent.data_ptr()

    @pytest.mark.parametrize("kind", ["tensor", "ndarray", "dict"])
    def test_value_semantics_no_aliasing(self, kind):
        make = {"tensor": lambda: torch.zeros(4),
                "ndarray": lambda: np.zeros(4),
                "dict": lambda: {"v": [0, 0]}}[kind]

        def mutate(p):
            if kind == "dict":
                p["v"][0] = 999
            else:
                p[:] = 999

        def body(r):
            if r == 0:
                payload = make()
                M.send(payload, dest=1, tag=2)
                mutate(payload)  # after send returns
                M.barrier()
                return None
            got = M.receive(0, tag=2)
            M.barrier()
            return got

        got = run_port(body, 2)[1]
        assert (got == make()) if kind == "dict" else \
            bool((torch.as_tensor(got) == 0).all())

    def test_receive_into_out(self):
        def body(r):
            if r == 0:
                M.send(torch.arange(3.0), 1, 4)
                M.send(np.arange(3.0), 1, 5)
                return None
            t_out, a_out = torch.empty(3), np.empty(3)
            got_t = M.receive(0, 4, out=t_out)
            got_a = M.receive(0, 5, out=a_out)
            return got_t is t_out and got_a is a_out, t_out, a_out

        same, t_out, a_out = run_port(body, 2)[1]
        assert same and torch.equal(t_out, torch.arange(3.0))
        assert np.array_equal(a_out, np.arange(3.0))

    def test_tag_misuse_detected(self):
        def body(r):
            hit = None
            if r == 0:
                t = threading.Thread(target=M.send, args=(b"a", 1, 9),
                                     daemon=True)
                t.start()
                time.sleep(0.2)
                try:
                    M.send(b"b", 1, 9)
                except M.TagError as exc:
                    hit = exc
                M.send(b"go", 1, 99)
                t.join(timeout=5)
            elif r == 1:
                assert M.receive(0, 99) == b"go"
                assert M.receive(0, 9) == b"a"
            return hit is not None

        assert run_port(body, 2)[0] is True

    def test_iprobe_sees_a_parked_sender(self):
        def body(r):
            if r == 0:
                M.send(b"x", 1, 6)
                return None
            deadline = time.monotonic() + 10
            while not M.iprobe(0, 6):
                assert time.monotonic() < deadline
                time.sleep(0.001)
            return M.receive(0, 6)

        assert run_port(body, 2)[1] == b"x"

    def test_thread_started_in_a_rank_inherits_its_binding(self):
        def body(r):
            seen = []
            t = threading.Thread(target=lambda: seen.append(M.rank()))
            t.start()
            t.join(timeout=5)
            return seen

        assert run_port(body, 3) == [[0], [1], [2]]

    def test_both_drivers_leave_thread_start_as_they_found_it(self):
        start = threading.Thread.start
        run_jax(lambda r: r, 2)
        run_port(lambda r: r, 2)
        assert threading.Thread.start is start
        run_port(lambda r: r, 2)
        run_jax(lambda r: r, 2)
        assert threading.Thread.start is start


# --------------------------------------------------------------------------
# Collectives against the JAX driver
# --------------------------------------------------------------------------

def both(body_jax, body_port, n):
    return run_jax(body_jax, n), run_port(body_port, n)


def jax_allreduce(xs, dtype, op, n):
    """The JAX driver's allreduce of ``xs``. It refuses ml_dtypes'
    bfloat16 (numpy kind 'V') as non-numeric, so for bf16 this is the fold
    its host path runs, ``collectives_generic.canonical_combine``, once per
    rank."""
    if dtype == "bfloat16":
        return [jgen.canonical_combine([as_numpy(x, dtype) for x in xs], op)
                ] * n
    return run_jax(lambda r: mpi_tpu.allreduce(as_numpy(xs[r], dtype), op),
                   n)


def test_jax_driver_refuses_bf16_allreduce():
    """Why jax_allreduce folds bf16 itself: a difference of the reference
    that the port does not copy (ROADMAP.md Queue 3)."""
    with pytest.raises(japi.MpiError, match="numeric"):
        run_jax(lambda r: mpi_tpu.allreduce(as_numpy(np.ones(2), "bfloat16")),
                2)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", range(2, 9))
def test_allreduce_tree_bitwise(n, dtype, op):
    xs = inputs(n, (33, 5), dtype, op, seed=100 * n)
    want = jax_allreduce(xs, dtype, op, n)
    got = run_port(lambda r: M.allreduce(as_tensor(xs[r], dtype), op), n)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        assert_same(g, w)
    # every rank its own tensor, none of them an input
    assert len({g.data_ptr() for g in got}) == n


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", ["divisible", "indivisible"])
@pytest.mark.parametrize("n", [3, 4, 8])
def test_allreduce_ring_bitwise(monkeypatch, n, size, dtype, op):
    """RING_MIN_BYTES lowered in both packages: the JAX driver folds with
    ring_combine, the port with kernel 6's entry (its plain version)."""
    monkeypatch.setattr(jgen, "RING_MIN_BYTES", 1)
    monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    calls = []
    real = cuda.ring_allreduce_ranks
    monkeypatch.setattr(cuda, "ring_allreduce_ranks",
                        lambda ts, o: calls.append(o) or real(ts, o))
    m = n * 40 if size == "divisible" else n * 40 + 1
    xs = inputs(n, (m,), dtype, op, seed=7 * n + m)
    want = jax_allreduce(xs, dtype, op, n)
    got = run_port(lambda r: M.allreduce(as_tensor(xs[r], dtype), op), n)
    assert calls == [op]
    for g, w in zip(got, want):
        assert_same(g, w)
    assert_same(got[0], jgen.ring_combine([as_numpy(x, dtype) for x in xs],
                                          op))


def test_ring_and_tree_orders_differ_here():
    """The ring test above would pass with the tree if both orders gave the
    same bits: they do not on its float32 sum data."""
    xs = [as_numpy(x, "float32") for x in inputs(8, (321,), "float32",
                                                 "sum", seed=7 * 8 + 321)]
    assert jgen.ring_combine(xs, "sum").tobytes() != \
        jgen.tree_combine(xs, "sum").tobytes()


def test_ring_route_keeps_other_dtypes_on_the_tree(monkeypatch):
    monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    monkeypatch.setattr(cuda, "ring_allreduce_ranks",
                        lambda ts, o: pytest.fail("int32 took kernel 6"))
    xs = inputs(4, (12,), "int32", "sum", seed=3)
    got = run_port(lambda r: M.allreduce(as_tensor(xs[r], "int32")), 4)
    want = np.sum(xs, axis=0, dtype=np.int32)
    assert all(np.array_equal(g.numpy(), want) for g in got)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_scalars_and_host_arrays(op):
    n = 5
    want, got = both(
        lambda r: (mpi_tpu.allreduce(float(r + 1), op),
                   mpi_tpu.allreduce(np.full(3, r + 1, np.float32), op)),
        lambda r: (M.allreduce(float(r + 1), op),
                   M.allreduce(np.full(3, r + 1, np.float32), op)), n)
    for (gs, ga), (ws, wa) in zip(got, want):
        assert type(gs) is type(ws) and gs == ws
        assert_same(ga, wa)
    total = {"sum": 15.0, "prod": float(math.factorial(5)), "min": 1.0,
             "max": 5.0}[op]
    assert got[0][0] == total


def test_allreduce_zero_dim_tensor():
    got = run_port(lambda r: M.allreduce(torch.tensor(float(r))), 4)
    assert all(g.shape == () and float(g) == 6.0 for g in got)


def test_reduce_root_only():
    xs = inputs(6, (7,), "float32", "sum", seed=5)
    want, got = both(
        lambda r: mpi_tpu.reduce(as_numpy(xs[r], "float32"), root=4),
        lambda r: M.reduce(as_tensor(xs[r], "float32"), root=4), 6)
    for r in range(6):
        if r == 4:
            assert_same(got[r], want[r])
        else:
            assert got[r] is None and want[r] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n", range(2, 9))
def test_reduce_scatter_bitwise(n, dtype):
    xs = inputs(n, (3 * n, 2), dtype, "sum", seed=11 * n)
    want, got = both(
        lambda r: mpi_tpu.reduce_scatter(as_numpy(xs[r], dtype)),
        lambda r: M.reduce_scatter(as_tensor(xs[r], dtype)), n)
    for g, w in zip(got, want):
        assert g.shape == (3, 2)
        assert_same(g, w)
    assert len({g.data_ptr() for g in got}) == n


@pytest.mark.parametrize("n", [3, 4, 8])
def test_reduce_scatter_ring_bitwise(monkeypatch, n):
    monkeypatch.setattr(jgen, "RING_MIN_BYTES", 1)
    monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    xs = inputs(n, (5 * n, 3), "float32", "sum", seed=13 * n)
    want, got = both(
        lambda r: mpi_tpu.reduce_scatter(as_numpy(xs[r], "float32")),
        lambda r: M.reduce_scatter(as_tensor(xs[r], "float32")), n)
    for g, w in zip(got, want):
        assert_same(g, w)


def test_reduce_scatter_indivisible_raises_everywhere():
    def body(r):
        try:
            M.reduce_scatter(torch.ones(5))
        except M.MpiError as exc:
            return str(exc)
        return None

    out = run_port(body, 4)
    assert all(o and "must divide" in o for o in out)


def test_bcast_gather_scatter_alltoall_objects():
    n = 6

    def body(mod):
        def run(r):
            b = mod.bcast({"cfg": 42} if r == 2 else None, root=2)
            g = mod.gather(f"g{r}", root=1)
            s = mod.scatter([f"s->{i}" for i in range(n)] if r == 0
                            else None, root=0)
            a2a = mod.alltoall([f"{r}->{d}" for d in range(n)])
            ag = mod.allgather(r * 2)
            return b, g, s, a2a, ag
        return run

    want, got = both(body(mpi_tpu), body(M), n)
    assert got == want
    assert got[3][0] == {"cfg": 42} and got[1][1] == [f"g{i}"
                                                       for i in range(n)]


def test_bcast_gather_scatter_alltoall_tensors():
    n = 4
    xs = inputs(n, (n, 3), "float32", "sum", seed=17)

    def body(r):
        x = as_tensor(xs[r], "float32")
        b = M.bcast(x, root=3)
        g = M.gather(x, root=1)
        s = M.scatter(list(as_tensor(np.stack(xs), "float32")) if r == 0
                      else None, root=0)
        a2a = M.alltoall(list(x.unbind(0)))
        ag = M.allgather(x)
        return b, g, s, a2a, ag

    got = run_port(body, n)
    for r, (b, g, s, a2a, ag) in enumerate(got):
        assert np.array_equal(b.numpy(), xs[3].astype(np.float32))
        assert (g is None) == (r != 1)
        if g is not None:
            assert all(np.array_equal(t.numpy(), x.astype(np.float32))
                       for t, x in zip(g, xs))
        assert np.array_equal(s.numpy(), xs[r].astype(np.float32))
        assert all(np.array_equal(a2a[src].numpy(),
                                  xs[src][r].astype(np.float32))
                   for src in range(n))
        assert all(np.array_equal(t.numpy(), x.astype(np.float32))
                   for t, x in zip(ag, xs))
    # scatter hands out copies; allgather's entries may alias
    assert len({got[r][2].data_ptr() for r in range(n)}) == n


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_scan_exscan_bitwise(dtype, op):
    n = 7
    xs = inputs(n, (9,), dtype, op, seed=19)
    want, got = both(
        lambda r: (mpi_tpu.scan(as_numpy(xs[r], dtype), op),
                   mpi_tpu.exscan(as_numpy(xs[r], dtype), op)),
        lambda r: (M.scan(as_tensor(xs[r], dtype), op),
                   M.exscan(as_tensor(xs[r], dtype), op)), n)
    for r, ((gi, ge), (wi, we)) in enumerate(zip(got, want)):
        assert_same(gi, wi)
        if r == 0:
            assert ge is None and we is None
        else:
            assert_same(ge, we)


def test_scan_scalars_keep_types():
    want, got = both(lambda r: mpi_tpu.scan(1.5),
                     lambda r: M.scan(1.5), 4)
    assert got == want and isinstance(got[0], float)


def test_mixed_payload_shape_raises_everywhere():
    def body(r):
        try:
            M.allreduce(torch.ones(4 if r == 2 else 3))
        except M.MpiError as exc:
            return str(exc)
        return None

    assert all(o and "mismatch" in o for o in run_port(body, 4))


def test_tensor_and_host_payloads_mixed_raise_everywhere():
    def body(r):
        try:
            M.allreduce(torch.ones(3) if r else np.ones(3))
        except M.MpiError as exc:
            return str(exc)
        return None

    assert all(o and "mismatch" in o for o in run_port(body, 3))


def test_list_payload_matches_jax_driver():
    want, got = both(lambda r: mpi_tpu.allreduce([1.0, float(r)]),
                     lambda r: M.allreduce([1.0, float(r)]), 4)
    for g, w in zip(got, want):
        assert_same(g, w)


def test_string_payload_raises_everywhere():
    def body(r):
        try:
            M.allreduce("nope")
        except M.MpiError as exc:
            return str(exc)
        return None

    assert all(o and "numeric" in o for o in run_port(body, 2))


def test_callable_op_folds_in_rank_order():
    """A non-commutative user op, folded in the tree's rank order."""
    n = 6
    xs = inputs(n, (5,), "float32", "sum", seed=23)
    want, got = both(
        lambda r: mpi_tpu.allreduce(as_numpy(xs[r], "float32"),
                                    op=lambda a, b: a * 0.5 + b),
        lambda r: M.allreduce(as_tensor(xs[r], "float32"),
                              op=lambda a, b: a * 0.5 + b), n)
    for g, w in zip(got, want):
        assert_same(g, w)


def test_unknown_op_raises_on_every_rank():
    def body(r):
        with pytest.raises(M.MpiError, match="unknown reduction op"):
            M.allreduce(torch.ones(2), op="xor")
        return True

    assert run_port(body, 3) == [True] * 3


# --------------------------------------------------------------------------
# Communicator group engines
# --------------------------------------------------------------------------

GROUP = (4, 1, 3)  # member order, not rank order: member i is rank GROUP[i]


def group_collectives(registered, payload):
    """``body(rank)`` running every collective of GROUP's engine on its
    members; the ranks outside GROUP take no part and return None."""
    def body(r):
        if r not in GROUP:
            return None
        eng = registered().group_collectives(GROUP, 7)
        x = payload(r)
        out = {"allreduce": eng.allreduce(x, "sum"),
               "reduce": eng.reduce(x, root=1, op="min"),
               "reduce_scatter": eng.reduce_scatter(x, "prod"),
               "scan": eng.scan(x, "max"),
               "exscan": eng.exscan(x, "sum"),
               "bcast": eng.bcast(x, root=2),
               "gather": eng.gather(x, root=0),
               "allgather": eng.allgather(x),
               "scatter": eng.scatter(
                   [x + i for i in range(len(GROUP))]
                   if GROUP.index(r) == 0 else None, root=0),
               "alltoall": eng.alltoall([x * i for i in range(len(GROUP))])}
        registered().release_group_collectives(GROUP, 7)
        return out

    return body


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_group_engine_matches_jax_driver(dtype):
    """A communicator group's engine folds its members' payloads in member
    order, bitwise as the JAX driver's group engine does."""
    n = 6
    xs = inputs(n, (6, 2), dtype, "prod", seed=29)
    want, got = both(
        group_collectives(japi.registered, lambda r: as_numpy(xs[r], dtype)),
        group_collectives(M.registered, lambda r: as_tensor(xs[r], dtype)), n)
    for r in range(n):
        if r not in GROUP:
            assert want[r] is None and got[r] is None
            continue
        for key, w in want[r].items():
            g = got[r][key]
            if w is None:
                assert g is None, key
            elif isinstance(w, list):
                assert len(g) == len(w), key
                for gi, wi in zip(g, w):
                    assert_same(gi, wi)
            else:
                assert_same(g, w)


def test_group_engine_is_shared_and_released():
    """One engine per (context, members), shared by the members' threads;
    a release is idempotent and the next call makes a fresh engine."""
    def body(r):
        net = M.registered()
        eng = net.group_collectives((0, 2), 5)
        M.barrier()
        same = net.group_collectives([0, 2], 5) is eng
        M.barrier()
        if r == 0:
            net.release_group_collectives((0, 2), 5)
            net.release_group_collectives((0, 2), 5)
        M.barrier()
        return same, net.group_collectives((0, 2), 5) is not eng

    assert run_port(body, 3) == [(True, True)] * 3


def test_rank_error_breaks_a_group_collective():
    """A member blocked in a group collective fails fast when its partner
    dies: the driver breaks the groups' barriers too, and the root cause is
    raised."""
    def body(r):
        eng = M.registered().group_collectives((0, 1), 3)
        M.barrier()
        if r == 1:
            raise RuntimeError("boom on 1")
        return eng.allreduce(torch.ones(2))

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom on 1"):
        run_port(body, 2)
    assert time.monotonic() - t0 < 5.0


# --------------------------------------------------------------------------
# The examples
# --------------------------------------------------------------------------

def test_helloworld_four_ranks(capsys):
    out = M.run_main(helloworld.main, ["--mpi-ranks", "4",
                                       "--mpi-device", "cpu"])
    assert out == [[f"Hello to rank {r} from rank {s}" for s in range(4)]
                   for r in range(4)]
    assert capsys.readouterr().out.count("Hello to rank") == 16


def test_bounce_two_ranks_small():
    argv = ["--mpi-ranks", "2", "--mpi-device", "cpu", "--max-bytes", "1000"]
    out = M.run_main(lambda: bounce.main(argv), argv)
    res = out[0]
    assert out[1] is None
    assert res["sizes"] == [0, 1, 10, 100, 1000] and res["reps"] == 10
    assert len(res["bytes_us"]) == len(res["tensor_us"]) == 5
    assert all(t > 0 for t in res["bytes_us"] + res["tensor_us"])


def test_run_main_refuses_other_backends():
    with pytest.raises(M.MpiError, match="item 9"):
        M.run_main(lambda: None, ["--mpi-backend", "tcp"])


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 6 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8 * 1024, 8 * 1024 + 3])
def test_driver_ring_allreduce_is_one_kernel_6_launch(monkeypatch, cuda_dev,
                                                      dtype, m):
    monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    n = 8
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    xs = torch.randn(n, m, generator=gen, device=cuda_dev).to(dtype)
    before = ring_collectives.ring_allreduce.launches

    def body(r):
        out = [M.allreduce(xs[r].clone()) for _ in range(3)]
        torch.cuda.current_stream().synchronize()
        return out

    got = run_spmd(lambda: (M.init(), body(M.rank()), M.finalize())[1], n=n)
    assert ring_collectives.ring_allreduce.launches - before == 3
    pad = (-m) % n
    stack = torch.cat([xs, xs.new_zeros(n, pad)], dim=1)
    want = ring_collectives.ring_allreduce_plain(stack)[0, :m]
    for outs in got:
        for g in outs:
            assert g.device.type == "cuda"
            assert torch.equal(g.view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                               want.view(torch.int16 if dtype ==
                                         torch.bfloat16 else torch.int32))


@pytest.mark.cuda
def test_driver_tree_allreduce_is_tree_combine(cuda_dev):
    n = 8
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    xs = torch.randn(n, 4097, generator=gen, device=cuda_dev)
    before = ring_collectives.ring_allreduce.launches

    def main():
        M.init()
        out = M.allreduce(xs[M.rank()].clone())
        torch.cuda.current_stream().synchronize()
        M.finalize()
        return out

    got = run_spmd(main, n=n)
    assert ring_collectives.ring_allreduce.launches == before
    want = tgen.tree_combine(list(xs.unbind(0)), "sum")
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tree", "ring"])
def test_driver_orders_the_ranks_streams(monkeypatch, cuda_dev, route):
    """Every rank works on a stream of its own, and nothing waits for the
    device on the host until the results are read back. In round i rank
    i writes its payload behind a long spin on its stream: the leader may
    fold only after that write (its stream waits on every rank's), and a
    rank may read its result only after the fold (its stream waits on the
    leader's). A tensor sent behind such a spin is read only after it was
    written. Each rank frees its payload and result on its own stream."""
    if route == "ring":
        monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
    n, m, spin = 4, 1 << 16, 50_000_000  # tens of ms of spinning

    def main():
        M.init()
        try:
            r = M.rank()
            got = []
            with torch.cuda.stream(torch.cuda.Stream()):
                for i in range(n):
                    x = torch.empty(m, device=cuda_dev)
                    if r == i:
                        torch.cuda._sleep(spin)
                    x.fill_(float(r + 1 + 10 * i))
                    y = M.allreduce(x)
                    got.append(y + 0)
                    del x, y
                if r == 0:
                    x = torch.empty(m, device=cuda_dev)
                    torch.cuda._sleep(spin)
                    x.fill_(42.0)
                    M.send(x, 1, tag=9)
                    del x
                elif r == 1:
                    y = M.receive(0, tag=9)
                    got.append(y + 0)
                    del y
                # .cpu() waits for this rank's stream alone.
                return [g.cpu() for g in got]
        finally:
            M.finalize()

    before = ring_collectives.ring_allreduce.launches
    out = run_spmd(main, n=n)
    assert ring_collectives.ring_allreduce.launches - before == \
        (n if route == "ring" else 0)
    for r, got in enumerate(out):
        want = [n * (n + 1) / 2 + 10 * i * n for i in range(n)]
        want += [42.0] if r == 1 else []
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, torch.full((m,), w)), (r, w)


def run_layout(monkeypatch, devs):
    """Every collective and a ring of sendrecv over ranks on ``devs``;
    each result must lie on its rank's device, equal to the canonical fold
    computed on rank 0's device, and the ring route must launch kernel 6
    once where ``devs`` are CUDA devices."""
    n = len(devs)
    net = CudaNetwork(n=n, devices=devs)
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(n, 4 * n, 3, generator=gen)
    lead = devs[0]
    want_tree = tgen.tree_combine(list(xs.to(lead).unbind(0)), "sum")
    want_ring = ring_collectives.ring_allreduce_plain(
        xs.to(lead).reshape(n, -1))[0].reshape(xs.shape[1:])
    want_scan = [xs[0]]
    for x in xs[1:]:
        want_scan.append(want_scan[-1] + x)

    def main():
        M.init()
        try:
            r = M.rank()
            mine = xs[r].to(devs[r])
            got = {"tree": M.allreduce(mine),
                   "scatter": M.reduce_scatter(mine),
                   "bcast": M.bcast(mine, root=n - 1),
                   "allgather": M.allgather(mine),
                   "scan": M.scan(mine),
                   "recv": M.sendrecv(mine, dest=(r + 1) % n,
                                      source=(r - 1) % n, tag=3)}
            M.barrier()
            if r == 0:
                monkeypatch.setattr(tgen, "RING_MIN_BYTES", 1)
            M.barrier()
            got["ring"] = M.allreduce(mine)
            return got
        finally:
            M.finalize()

    before = ring_collectives.ring_allreduce.launches
    out = run_spmd(main, net=net)
    launched = ring_collectives.ring_allreduce.launches - before
    assert launched == (1 if lead.type == "cuda" else 0)
    m = 4
    for r, got in enumerate(out):
        for key in ("tree", "ring", "scatter", "bcast", "recv", "scan"):
            assert got[key].device == devs[r], key
        assert torch.equal(got["tree"].cpu(), want_tree.cpu())
        assert torch.equal(got["ring"].cpu(), want_ring.cpu())
        assert torch.equal(got["scatter"].cpu(),
                           want_tree[r * m:(r + 1) * m].cpu())
        assert torch.equal(got["bcast"].cpu(), xs[n - 1])
        assert torch.equal(got["recv"].cpu(), xs[(r - 1) % n])
        assert torch.equal(got["scan"].cpu(), want_scan[r])
        assert all(t.device == devs[r] and torch.equal(t.cpu(), xs[s])
                   for s, t in enumerate(got["allgather"]))


def test_every_collective_on_one_layout(monkeypatch):
    run_layout(monkeypatch, [torch.device("cpu")] * 8)


@pytest.mark.cuda
def test_driver_over_distinct_devices(monkeypatch):
    """Ranks round-robin over several cards: the leader stages the payloads
    on rank 0's card, runs the same routes there, and each rank gets its
    result on its own card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    k = torch.cuda.device_count()
    run_layout(monkeypatch, [torch.device("cuda", r % k)
                             for r in range(2 * k)])
