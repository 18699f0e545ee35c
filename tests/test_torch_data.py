"""The port's data stream (``mpi_tpu_torch/data.py``) against the JAX
package's (``mpi_tpu/data.py``), on the CPU.

Every source gives JAX's batches bit for bit: ``SyntheticLM``,
``from_token_array`` shuffled and sequential over several epochs (the epoch
wrap and the two-epoch permutation cache included), and ``from_token_file``
over uint8, uint16 and uint32 files. The port's native gather (its own copy
of ``native/dataloader.cpp``, built with g++) equals its numpy version for
every dtype it takes; int64 takes numpy; a gather that cannot be built
raises. ``ShardedLoader`` resumes at ``start_step``, gives the same stream
with and without prefetch, raises its source's errors, needs CUDA unless
given a device, and refuses a mesh whose dp does not divide the batch or
whose ranks are on several devices.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from mpi_tpu.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from mpi_tpu.data import from_token_array as jax_from_token_array  # noqa
from mpi_tpu.data import from_token_file as jax_from_token_file  # noqa
from mpi_tpu_torch import data  # noqa: E402
from mpi_tpu_torch import native  # noqa: E402
from mpi_tpu_torch.data import (ShardedLoader, SyntheticLM,  # noqa: E402
                                from_token_array, from_token_file)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402


def _same_stream(port, jax_src, steps):
    for s in steps:
        got, want = port(s), jax_src(s)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"step {s}")


@pytest.mark.parametrize("vocab, batch, seq, seed", [
    (100, 4, 8, 3), (8192, 2, 17, 0), (7, 1, 5, 12345)])
def test_synthetic_matches_jax(vocab, batch, seq, seed):
    _same_stream(SyntheticLM(vocab, batch, seq, seed),
                 JaxSyntheticLM(vocab, batch, seq, seed), range(12))


# 997 tokens in windows of 8: 124 windows, 123 to an epoch of batch 3, so
# the batches wrap around the window count and the epochs shift.
@pytest.mark.parametrize("shuffle_seed", [None, 0, 7])
@pytest.mark.parametrize("dtype", ["int32", "uint16", "int64"])
def test_token_array_matches_jax_over_three_epochs(dtype, shuffle_seed):
    tokens = np.random.default_rng(4).integers(0, 1000, 997).astype(dtype)
    port = from_token_array(tokens, 3, 8, shuffle_seed=shuffle_seed)
    jax_src = jax_from_token_array(tokens, 3, 8, shuffle_seed=shuffle_seed)
    _same_stream(port, jax_src, range(130))        # 3+ epochs of 41 steps
    _same_stream(port, jax_src, [250, 3, 129, 0])  # back and forth


@pytest.mark.parametrize("shuffle_seed", [None, 9])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "uint32"])
def test_token_file_matches_jax(tmp_path, dtype, shuffle_seed):
    hi = min(np.iinfo(dtype).max, 50_000)
    corpus = np.random.default_rng(0).integers(0, hi, 1000, dtype=dtype)
    path = tmp_path / "corpus.bin"
    corpus.tofile(path)
    port = from_token_file(path, 4, 50, dtype=dtype,
                           shuffle_seed=shuffle_seed)
    jax_src = jax_from_token_file(path, 4, 50, dtype=dtype,
                                  shuffle_seed=shuffle_seed)
    _same_stream(port, jax_src, range(16))  # 5 steps an epoch
    if shuffle_seed is None:
        np.testing.assert_array_equal(port(0).reshape(-1), corpus[:200])


@pytest.mark.parametrize("batch, seq", [(16, 7), (16, 4099)])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "uint32"])
def test_native_gather_matches_plain(dtype, batch, seq):
    """Both the inline and the threaded native path (batch * seq at least
    2^16) against the numpy gather."""
    rng = np.random.default_rng(5)
    hi = min(np.iinfo(dtype).max, 50_000)
    tokens = rng.integers(0, hi, (batch + 7) * seq, dtype=dtype)
    picks = rng.permutation(batch + 7)[:batch]
    got = data._gather_windows(tokens, picks, seq)
    want = data._gather_windows_plain(tokens, picks, seq)
    assert got.dtype == np.int32 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got, want)
    assert native.library_path().exists()


def test_int64_takes_numpy_and_native_dtypes_never_fall_back(monkeypatch):
    def no_library():
        raise RuntimeError("no native gather")

    monkeypatch.setattr(native, "dataloader", no_library)
    tokens = np.arange(60, dtype=np.int64)  # no native path
    got = data._gather_windows(tokens, np.asarray([2, 0]), 10)
    np.testing.assert_array_equal(got[0], np.arange(20, 30))
    np.testing.assert_array_equal(got[1], np.arange(0, 10))
    with pytest.raises(RuntimeError, match="no native gather"):
        data._gather_windows(tokens.astype(np.uint16), np.asarray([2, 0]),
                             10)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "dataloader-missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.dataloader()
    src = from_token_array(np.arange(64, dtype=np.uint16), 2, 8)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        src(0)


def test_corpus_errors_match_jax(tmp_path):
    for make in (from_token_array, jax_from_token_array):
        with pytest.raises(ValueError, match="shorter than one sequence"):
            make(np.arange(4), batch=1, seq=8)
        with pytest.raises(ValueError, match="fewer than one batch of 3"):
            make(np.arange(16), batch=3, seq=8)
    path = tmp_path / "empty.bin"
    path.write_bytes(b"")
    for make in (from_token_file, jax_from_token_file):
        with pytest.raises(ValueError, match="empty"):
            make(path, batch=1, seq=4)


def _host(batches):
    out = []
    for b in batches:
        assert b.device.type == "cpu" and b.dtype == torch.int32
        out.append(b.numpy().copy())
    return out


def test_loader_resumes_at_start_step():
    src = SyntheticLM(64, batch=2, seq=4)
    fresh = _host(itertools.islice(
        iter(ShardedLoader(src, prefetch=2, device="cpu")), 5))
    resumed = _host(itertools.islice(
        iter(ShardedLoader(src, start_step=3, prefetch=2, device="cpu")), 2))
    np.testing.assert_array_equal(resumed[0], fresh[3])
    np.testing.assert_array_equal(resumed[1], fresh[4])
    want = JaxSyntheticLM(64, 2, 4)
    for s, b in enumerate(fresh):
        np.testing.assert_array_equal(b, want(s))


def test_loader_no_prefetch_matches_prefetch():
    src = from_token_array(np.arange(640, dtype=np.uint16), 2, 4,
                           shuffle_seed=9)
    a = _host(itertools.islice(
        iter(ShardedLoader(src, prefetch=0, device="cpu")), 6))
    b = _host(itertools.islice(
        iter(ShardedLoader(src, prefetch=3, device="cpu")), 6))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_propagates_source_errors(prefetch):
    def bad(step):
        raise RuntimeError("corpus exploded")

    with pytest.raises(RuntimeError, match="corpus exploded"):
        next(iter(ShardedLoader(bad, prefetch=prefetch, device="cpu")))


def test_loader_stops_its_thread_when_closed():
    before = set(threading.enumerate())
    it = iter(ShardedLoader(SyntheticLM(64, 2, 4), prefetch=2,
                            device="cpu"))
    next(it)
    mine = [t for t in threading.enumerate()
            if t not in before and t.name == "mpi-torch-data-prefetch"]
    assert len(mine) == 1
    it.close()
    mine[0].join(5)
    assert not mine[0].is_alive()


def test_loader_on_a_dp_mesh_places_the_global_batch():
    mesh = RankMesh(["cpu"] * 4, ("dp", "sp", "tp"), (2, 1, 2))
    loader = ShardedLoader(SyntheticLM(64, batch=4, seq=16), mesh=mesh)
    batch = loader.batch_at(0)
    assert batch.shape == (4, 16) and batch.device.type == "cpu"
    np.testing.assert_array_equal(batch.numpy(), JaxSyntheticLM(64, 4, 16)(0))


def test_loader_refuses_a_dp_that_does_not_divide_the_batch():
    mesh = RankMesh(["cpu"] * 4, ("dp",))
    loader = ShardedLoader(SyntheticLM(64, batch=6, seq=4), mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        loader.batch_at(0)
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        next(iter(loader))


def test_loader_refuses_a_mesh_over_several_devices():
    mesh = RankMesh(["cpu", "cuda"], ("dp",))
    with pytest.raises(NotImplementedError, match="several devices"):
        ShardedLoader(SyntheticLM(64, batch=2, seq=4), mesh=mesh)


def test_loader_needs_cuda_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedLoader(SyntheticLM(64, batch=2, seq=4))


def test_two_iterator_perm_cache_race_is_deterministic():
    """tests/test_data.py's race on the port's source: four threads that
    share one source, at and behind epoch boundaries, hammer its two-epoch
    permutation cache; every batch equals the serially drawn one and
    JAX's."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 100, size=4 * 3 * 5 * 4, dtype=np.int32)
    src = from_token_array(tokens, batch=3, seq=4, shuffle_seed=5)
    ref_src = jax_from_token_array(tokens, batch=3, seq=4, shuffle_seed=5)
    steps = list(range(24))
    ref = {s: ref_src(s).copy() for s in steps}

    errors: list = []
    start = threading.Barrier(4)

    def worker(order):
        try:
            start.wait(5)
            for _ in range(50):
                for s in order:
                    if not np.array_equal(src(s), ref[s]):
                        errors.append(f"step {s}: raced batch != serial")
                        return
        except Exception as exc:  # noqa: BLE001 - surface in main thread
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(o,))
               for o in (steps, steps[::-1], steps[1::2], steps[0::2])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errors, errors[:3]
