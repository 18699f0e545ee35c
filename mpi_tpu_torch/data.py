"""Deterministic, prefetching token stream for the port's trainers.

Counterpart of ``mpi_tpu/data.py``. Batches are a pure function of the step
(a checkpoint resume replays the exact stream: it pairs with
:mod:`mpi_tpu_torch.utils.checkpoint`), built on the host by a prefetch
thread while the device runs the previous step, and placed on the device
the trainer runs on.

Sources give the JAX package's batches bit for bit: :class:`SyntheticLM`
(a seeded token stream) and :func:`from_token_array` /
:func:`from_token_file` over a flat corpus, whose per-step gather runs in
the port's copy of the native gather (``native/dataloader.cpp``) for the
dtypes it takes and in numpy for the others.

:class:`ShardedLoader` places each global batch on one device: the CUDA
device by default, or the device a :class:`~mpi_tpu_torch.parallel.RankMesh`'s
ranks share. The dp ranks of such a mesh share that device and the dp step
splits the rows among them itself, so there is no per-rank placement. The
JAX loader's multi-process slicing (each process keeps its share of the
rows) waits for the port's ``distributed.py``.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from .parallel.mesh import RankMesh
from .utils.platform import resolve_device

__all__ = ["SyntheticLM", "from_token_array", "from_token_file",
           "ShardedLoader"]

# dtypes the native gather kernel understands (widened to int32)
_NATIVE_GATHER_DTYPES = {
    np.dtype(np.uint8): 1,
    np.dtype(np.uint16): 2,
    np.dtype(np.int32): 4,
    np.dtype(np.uint32): 4,
}


def _gather_windows_plain(tokens: np.ndarray, picks: np.ndarray,
                          seq: int) -> np.ndarray:
    """The plain version of :func:`_gather_windows`: a numpy stack of the
    picked windows, widened to int32."""
    return np.stack(
        [tokens[w * seq:(w + 1) * seq] for w in picks]).astype(np.int32)


def _gather_windows(tokens: np.ndarray, picks: np.ndarray,
                    seq: int) -> np.ndarray:
    """(batch, seq) int32 batch from window indices ``picks``.

    A contiguous corpus of a dtype in ``_NATIVE_GATHER_DTYPES`` goes
    through the native gather+widen (``native/dataloader.cpp``): one call
    that releases the interpreter lock, threaded for large batches, so batch
    assembly overlaps the device's work under the prefetch thread. Other
    dtypes take the numpy gather, which gives the same output. A native
    library that cannot be built raises."""
    batch = len(picks)
    dt = tokens.dtype
    if dt not in _NATIVE_GATHER_DTYPES or not tokens.flags.c_contiguous \
            or not batch:
        return _gather_windows_plain(tokens, picks, seq)
    from .native import dataloader

    lib = dataloader()
    out = np.empty((batch, seq), dtype=np.int32)
    idx = np.ascontiguousarray(picks, dtype=np.int64)
    # Threads only pay off when the copy dwarfs thread create/join
    # (~tens of µs): gate on output size, not just core count.
    ncpu = os.cpu_count() or 1
    nthreads = min(4, ncpu) if batch * seq >= (1 << 16) else 1
    rc = lib.dl_gather(
        tokens.ctypes.data_as(ctypes.c_void_p), tokens.size,
        _NATIVE_GATHER_DTYPES[dt],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        batch, seq, out.ctypes.data_as(ctypes.c_void_p), nthreads)
    if rc != 0:  # the sources pick valid windows only
        raise ValueError(f"mpi_tpu_torch: native gather refused windows "
                         f"{idx.tolist()} of {seq} tokens from a corpus of "
                         f"{tokens.size} (rc {rc})")
    return out


class SyntheticLM:
    """Deterministic synthetic token source: ``sample(step) -> (B, S)``
    int32, a pure function of (seed, step) — the stream is identical
    across restarts and prefetch depths, and equal to the JAX package's."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def __call__(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        return rng.integers(0, self.vocab, (self.batch, self.seq),
                            dtype=np.int32)


def from_token_array(tokens: np.ndarray, batch: int, seq: int,
                     shuffle_seed: Optional[int] = 0
                     ) -> Callable[[int], np.ndarray]:
    """Batch source over a flat token array (e.g. np.memmap of a corpus).

    Step ``t`` yields ``batch`` windows of ``seq`` tokens. With
    ``shuffle_seed`` the window order is a seeded permutation per epoch
    (deterministic, resumable); ``None`` reads sequentially."""
    tokens = np.asarray(tokens)
    n_windows = len(tokens) // seq
    if n_windows < 1:
        raise ValueError(
            f"mpi_tpu_torch: corpus of {len(tokens)} tokens is shorter than "
            f"one sequence ({seq})")
    if n_windows < batch:
        raise ValueError(
            f"mpi_tpu_torch: corpus has {n_windows} windows of {seq} tokens "
            f"— fewer than one batch of {batch}")
    windows_per_epoch = n_windows // batch * batch
    perm_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
    perm_lock = threading.Lock()

    def _order(epoch: int) -> np.ndarray:
        if shuffle_seed is None:
            return np.arange(n_windows)
        # One O(n_windows) permutation per *epoch*, not per step — at
        # memmap-corpus scale the per-step cost must stay O(batch). The
        # two most-recently-*used* epochs are kept (not one) so iterators
        # straddling an epoch boundary — or a lagging iterator sharing
        # the source — don't thrash the permutation; the lock keeps
        # concurrent callers coherent.
        with perm_lock:
            if epoch in perm_cache:
                perm_cache.move_to_end(epoch)
            else:
                rng = np.random.default_rng(
                    np.random.SeedSequence([shuffle_seed, epoch]))
                perm_cache[epoch] = rng.permutation(n_windows)
                while len(perm_cache) > 2:
                    perm_cache.popitem(last=False)
            return perm_cache[epoch]

    def sample(step: int) -> np.ndarray:
        idx0 = step * batch
        epoch, offset = divmod(idx0, windows_per_epoch)
        order = _order(epoch)
        picks = order[(offset + np.arange(batch)) % n_windows]
        return _gather_windows(tokens, picks, seq)

    return sample


def from_token_file(path: Union[str, os.PathLike], batch: int, seq: int,
                    dtype: Any = np.uint16,
                    shuffle_seed: Optional[int] = 0
                    ) -> Callable[[int], np.ndarray]:
    """Batch source over a raw binary token file (the flat-corpus
    format: tokens back to back, no header). The file is memory-mapped
    read-only, so corpora far larger than RAM stream through the page
    cache, and each step reads only its own windows. ``dtype`` is the
    on-disk token width (``uint16`` for vocabularies < 64K, the common LM
    corpus format)."""
    mm = np.memmap(os.fspath(path), dtype=np.dtype(dtype), mode="r")
    if mm.size == 0:
        raise ValueError(f"mpi_tpu_torch: token file {os.fspath(path)!r} is "
                         f"empty")
    return from_token_array(mm, batch, seq, shuffle_seed=shuffle_seed)


class ShardedLoader:
    """Iterate device-resident batches of ``source`` with prefetch.

    ``source(step) -> (B, S)`` is the *global* batch (int32 numpy). It is
    placed on ``device`` (default: the CUDA device, raising without one),
    or, given ``mesh`` (a :class:`RankMesh`), on the device the mesh's
    ranks share, after checking that its ``dp`` axis divides the rows: the
    dp step splits them over its ranks. A mesh over several distinct
    devices raises ``NotImplementedError``, as the port's collectives do.

    Resumable: construct with ``start_step`` (e.g. the restored checkpoint
    step) and the stream continues exactly where it left off. With
    ``prefetch`` above 0 a thread builds up to that many batches ahead on
    the host, into pinned memory when the device is a GPU; the consumer
    copies each with ``non_blocking=True`` on its current stream. Every
    batch gets a pinned buffer of its own, which the caching host allocator
    reuses only after the copy that reads it has finished. An error in the
    source is raised by the iterator.
    """

    def __init__(self, source: Callable[[int], np.ndarray],
                 mesh: Optional[RankMesh] = None, start_step: int = 0,
                 prefetch: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.source = source
        self.mesh = mesh
        self.start_step = start_step
        self.prefetch = max(0, prefetch)
        if mesh is not None:
            if not isinstance(mesh, RankMesh):
                raise TypeError(f"mpi_tpu_torch: ShardedLoader takes a "
                                f"RankMesh; got {type(mesh).__name__}")
            distinct = sorted({str(d) for d in mesh.devices})
            if len(distinct) > 1:
                raise NotImplementedError(
                    f"mpi_tpu_torch: ShardedLoader over a mesh of several "
                    f"devices {distinct} is not ported: the mesh's ranks "
                    f"share one device")
            if device is not None and \
                    torch.device(device).type != mesh.devices[0].type:
                raise ValueError(f"mpi_tpu_torch: ShardedLoader got device "
                                 f"{device} and a mesh on "
                                 f"{mesh.devices[0]}")
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"

    # -- single-batch path ----------------------------------------------------

    def _host(self, step: int) -> torch.Tensor:
        """Step ``step``'s global batch on the host (pinned for a GPU)."""
        host = np.asarray(self.source(step))
        dp = 1 if self.mesh is None else self.mesh.shape.get("dp", 1)
        if host.shape[0] % dp:
            raise ValueError(f"mpi_tpu_torch: global batch {host.shape[0]} "
                             f"not divisible by dp={dp}")
        batch = torch.from_numpy(host)
        if self._pin:
            pinned = torch.empty(batch.shape, dtype=batch.dtype,
                                 pin_memory=True)
            batch = pinned.copy_(batch)
        return batch

    def _place(self, batch: torch.Tensor) -> torch.Tensor:
        return batch.to(self.device, non_blocking=self._pin)

    def batch_at(self, step: int) -> torch.Tensor:
        """The device-placed batch for ``step`` (pure, thread-safe)."""
        return self._place(self._host(step))

    # -- prefetching iterator -------------------------------------------------

    def __iter__(self) -> Iterator[torch.Tensor]:
        if self.prefetch == 0:
            step = self.start_step
            while True:
                yield self.batch_at(step)
                step += 1
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer() -> None:
            step = self.start_step

            def put(entry) -> bool:
                # Bounded put that stays responsive to stop().
                while not stop.is_set():
                    try:
                        q.put(entry, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False

            while not stop.is_set():
                try:
                    item = self._host(step)
                except BaseException as exc:  # noqa: BLE001 - to the consumer
                    put(("error", exc))
                    return
                put(("ok", item))
                step += 1

        t = threading.Thread(target=producer, daemon=True,
                             name="mpi-torch-data-prefetch")
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise item
                # The copy is enqueued on the consumer's current stream, so
                # it is ordered before the step that reads the batch.
                yield self._place(item)
        finally:
            stop.set()
