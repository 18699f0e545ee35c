"""Cuda driver: ranks as threads over CUDA devices.

Counterpart of ``mpi_tpu/backends/xla.py``. The reference maps rank → OS
process and moves bytes over TCP (network.go); the JAX package's XLA driver
maps rank → device on a mesh inside one process; this driver maps **rank →
CUDA device**, one thread per rank:

* ``init``/``finalize``: a barrier of the rank threads (the reference's
  socket handshake, network.go:122-351, collapses to it in one process);
* ``send``/``receive``: the reference's blocking tagged rendezvous
  (mpi.go:122-159) between rank threads, a tensor copied to the destination
  rank's device on the way, so the receiver never aliases the sender;
* collectives: every rank hands its payload to a session, one leader
  thread computes all ranks' results, and each rank takes its own.

Ranks may share a device: N ranks on fewer devices map round-robin, as
``XlaNetwork(oversubscribe=True)`` maps them, and that is how 8 ranks live
on one H100 and how the tests put them on ``"cpu"``. Where ranks share a
device the JAX driver has no mesh and always folds in the canonical order
of ``collectives_generic`` (``xla.py:392-402``). So does this driver, on
every layout: an all-reduce of tensors folds them in the binomial-tree
order on the device (``collectives_generic.tree_combine``), or, when
``ring_eligible`` says so and the dtype is float32 or bfloat16, in the ring
order with one launch of kernel 6 on the ranks' own buffers
(``ops.ring_collectives.ring_allreduce_ranks``). Both give the JAX and TCP
drivers' bits. The kernels run every rank on one device: with ranks on
several devices the leader stages the payloads on rank 0's device, runs the
same route and copies each result back to its rank's device (the NVLink
peer path will replace the staging).

Payloads that are not tensors (numpy arrays, scalars, objects) take the JAX
driver's host paths: numpy folds in the same canonical order, and object
hand-offs.

Streams: a rank produces its tensors on its current stream, and the leader
computes on its own. Before the leader starts, its stream waits for every
other rank's stream; before a rank takes its result, its stream waits for
the leader's, and the results are marked as used on it
(``record_stream``). Nothing on the path waits for the device on the host.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import OrderedDict
from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from ..api import MpiError
from ..collectives_generic import (canonical_combine, check_op, combine,
                                   ring_eligible, tree_combine)
from ..ops.ring_collectives import ALLREDUCE_DTYPES, ring_allreduce_ranks
from ..parallel.mesh import _device, mesh_devices
from ..utils.platform import resolve_device
from .rendezvous import ReceiveCancelled, Rendezvous

if TYPE_CHECKING:
    from ..collectives_generic import OpLike

__all__ = ["CudaNetwork", "run_spmd", "drive_rank_threads"]

# --------------------------------------------------------------------------
# Rank-binding inheritance (xla.py:60-105).
#
# A rank is a per-thread binding, so threads that user code starts (and the
# facade's own sendrecv helper) would come up unbound. While any run_spmd
# is active, Thread.start is wrapped so a thread started by a bound thread
# inherits its binding, CUDA device included. The wrapper restores
# whatever Thread.start it found, so drivers of both packages may run one
# after the other in one process.
# --------------------------------------------------------------------------

_patch_lock = threading.Lock()
_active_networks: List["CudaNetwork"] = []
_found_start: Optional[Callable[[threading.Thread], None]] = None


def _patched_start(self: threading.Thread) -> None:
    # Runs in the *parent* thread: snapshot its bindings for the child.
    bindings = [(net, net._tls.rank) for net in list(_active_networks)
                if getattr(net._tls, "rank", None) is not None]
    if bindings and not getattr(self, "_mpi_torch_rank_bound", False):
        orig_run = self.run

        def run_bound() -> None:
            for net, r in bindings:
                net.bind_rank(r)
            orig_run()

        self.run = run_bound
        self._mpi_torch_rank_bound = True
    _found_start(self)


def _activate_inheritance(net: "CudaNetwork") -> None:
    global _found_start
    with _patch_lock:
        if not _active_networks:
            _found_start = threading.Thread.start
            threading.Thread.start = _patched_start
        _active_networks.append(net)


def _deactivate_inheritance(net: "CudaNetwork") -> None:
    with _patch_lock:
        if net in _active_networks:
            _active_networks.remove(net)
        if not _active_networks and threading.Thread.start is _patched_start:
            threading.Thread.start = _found_start


Stream = Optional[torch.cuda.Stream]


def _current_stream(device: torch.device) -> Stream:
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def _record_on(result: Any, stream: torch.cuda.Stream) -> None:
    """Mark the CUDA tensors of ``result`` (a tensor or a list of them) as
    used on ``stream``, so the allocator does not reuse their memory while
    that stream may still read them."""
    items = result if isinstance(result, (list, tuple)) else [result]
    for t in items:
        if isinstance(t, torch.Tensor) and t.device == stream.device:
            t.record_stream(stream)


class _CollectiveSession:
    """Rank-thread synchronization for the driver's collectives
    (``xla.py:108``).

    Every rank contributes its payload and its current stream, a barrier
    fires, the leader (one arbitrary barrier winner) computes every rank's
    result once on its own stream, and a second barrier releases everyone
    to take theirs. Reusable across sequential collectives; all ranks must
    call collectives in the same order, the MPI rule."""

    def __init__(self, n: int, device: torch.device):
        self._n = n
        self._device = device  # where the leader computes
        self._barrier = threading.Barrier(n)
        self._slots: List[Any] = [None] * n
        self._streams: List[Stream] = [None] * n
        self._results: List[Any] = [None] * n
        self._error: Optional[BaseException] = None
        self._lead_stream: Stream = None

    def _wait(self) -> int:
        try:
            return self._barrier.wait()
        except threading.BrokenBarrierError as exc:
            raise MpiError("mpi_tpu_torch: collective aborted (another rank "
                           "failed)") from exc

    def run(self, rank: int, value: Any,
            leader: Callable[[List[Any]], List[Any]],
            stream: Stream = None) -> Any:
        self._slots[rank] = value
        self._streams[rank] = stream
        if self._wait() == 0:
            try:
                lead = self._lead_stream = _current_stream(self._device)
                if lead is not None:
                    for s in {s for s in self._streams if s is not None}:
                        if s != lead:
                            lead.wait_stream(s)
                self._results = leader(list(self._slots))
                self._error = None
            except BaseException as exc:  # noqa: BLE001 - raised on all ranks
                self._error = exc
        self._wait()
        if self._error is not None:
            raise MpiError(
                f"mpi_tpu_torch: collective failed on leader: {self._error}"
            ) from self._error
        result = self._results[rank]
        # Each rank drops the session's references to its payload and
        # result, so a finished collective pins no memory (no other thread
        # touches this index until the next collective's first barrier).
        self._results[rank] = self._slots[rank] = None
        lead = self._lead_stream
        if stream is not None and lead is not None and stream != lead:
            stream.wait_stream(lead)
            _record_on(result, stream)
        return result


def _to(payload: Any, device: torch.device) -> Any:
    """A tensor on ``device`` (itself when it lies there); anything else as
    it is."""
    return payload.to(device) if isinstance(payload, torch.Tensor) \
        else payload


class _MeshCollectives:
    """The collectives of one ordered list of rank devices (``xla.py:171``):
    the world (one engine per driver) or a communicator group (one per
    ``(context, members)``, :meth:`CudaNetwork.group_collectives`).
    ``rank_of`` maps the calling thread to its rank within this engine.

    Tensors of one shape and dtype take the device path: the reductions on
    the leader's device (rank 0's), the gather family as hand-offs that
    move each tensor to its receiver's device. Numpy arrays, scalars,
    objects and ragged payloads take the JAX driver's host paths."""

    def __init__(self, net: "CudaNetwork", devices: List[torch.device],
                 rank_of: Callable[[], int]):
        self._net = net
        self._devices = list(devices)
        self._n = len(self._devices)
        self._lead = self._devices[0]
        self._rank_of = rank_of
        self._coll = _CollectiveSession(self._n, self._lead)

    def _myrank(self) -> int:
        return self._rank_of()

    def _run(self, data: Any, leader: Callable[[List[Any]], List[Any]]
             ) -> Any:
        me = self._myrank()
        return self._coll.run(me, data, leader,
                              _current_stream(self._devices[me]))

    def _check_rank(self, r: int) -> None:
        if not 0 <= r < self._n:
            raise MpiError(
                f"mpi_tpu_torch: rank {r} out of range [0, {self._n})")

    @staticmethod
    def _validate_payloads(slots: List[Any]) -> None:
        """Cross-rank shape and dtype agreement, on the device and host
        paths alike. The JAX driver's float64 guard (``xla.py:221-227``)
        has no counterpart: the port reduces 8-byte payloads as they are."""
        shape, dtype = slots[0].shape, slots[0].dtype
        for i, s in enumerate(slots):
            if s.shape != shape or s.dtype != dtype:
                raise MpiError(
                    f"mpi_tpu_torch: collective payload mismatch: rank 0 has "
                    f"{tuple(shape)}/{dtype}, rank {i} has "
                    f"{tuple(s.shape)}/{s.dtype}")

    def _tensor_slots(self, slots: List[Any]) -> Optional[List[torch.Tensor]]:
        """The payloads staged on the leader's device when they are tensors
        (raising unless every one is, of one shape and dtype); None when
        none is a tensor."""
        if not any(isinstance(s, torch.Tensor) for s in slots):
            return None
        if not all(isinstance(s, torch.Tensor) for s in slots):
            raise MpiError(
                "mpi_tpu_torch: collective payload mismatch: some ranks "
                "passed tensors and some did not")
        self._validate_payloads(slots)
        return [s.to(self._lead).contiguous() for s in slots]

    def _home(self, per: List[Any]) -> List[Any]:
        """Each rank's result moved to its own device."""
        return [_to(p, d) for p, d in zip(per, self._devices)]

    def _reduce_tensors(self, tensors: List[torch.Tensor], op: "OpLike"
                        ) -> List[torch.Tensor]:
        """The reduction in the canonical order, one entry per rank: every
        rank's own buffer from one launch of kernel 6 for a ring-eligible
        payload of a dtype it takes (float32, bf16), else the one
        binomial-tree total on the device in every entry (exact for the
        integer and bool payloads that kernel 6 does not take)."""
        x = tensors[0]
        if x.dtype in ALLREDUCE_DTYPES and ring_eligible(
                x.numel() * x.element_size(), x.dtype, self._n, op):
            return ring_allreduce_ranks(tensors, op)
        return [tree_combine(tensors, op)] * self._n

    def allreduce(self, data: Any, op: "OpLike" = "sum") -> Any:
        """Combine ``data`` over the ranks in the canonical order; each rank
        gets its own result. Host payloads must be numeric (anything
        ``np.asarray`` maps to a numeric dtype); a non-numeric payload
        raises on every rank."""
        check_op(op)

        def leader(slots: List[Any]) -> List[Any]:
            tensors = self._tensor_slots(slots)
            if tensors is not None:
                # A tensor that a payload or an earlier rank holds (the tree's
                # one total; a payload itself when n == 1 or a callable op
                # returns one) is copied, so each rank owns its result.
                held = {id(t) for t in tensors}
                per = []
                for p in self._reduce_tensors(tensors, op):
                    per.append(p.clone() if id(p) in held else p)
                    held.add(id(p))
                return self._home(per)
            np_slots = [np.asarray(s) for s in slots]
            if np_slots[0].dtype.kind not in "fiubc":
                raise MpiError(
                    f"mpi_tpu_torch: allreduce requires numeric payloads, "
                    f"got dtype {np_slots[0].dtype}")
            self._validate_payloads(np_slots)
            total = canonical_combine(np_slots, op)
            per = [total.copy() for _ in range(self._n)]
            if np_slots[0].ndim == 0:
                per = [p[()] for p in per]
            return per

        return self._run(data, leader)

    def barrier(self) -> None:
        self._run(None, lambda slots: [None] * self._n)

    def bcast(self, data: Any, root: int = 0) -> Any:
        """Root's tensor reaches every rank on that rank's device; ranks
        that share root's device get root's tensor itself (results may
        alias across ranks: treat them as read-only, as with
        ``allgather``). Objects are deep-copied per rank."""
        self._check_rank(root)

        def leader(slots: List[Any]) -> List[Any]:
            payload = slots[root]
            if isinstance(payload, torch.Tensor):
                return [payload.to(d) for d in self._devices]
            return [payload if i == root else copy.deepcopy(payload)
                    for i in range(self._n)]

        return self._run(data, leader)

    def gather(self, data: Any, root: int = 0) -> Optional[List[Any]]:
        """Root gets every rank's payload, tensors moved to its device."""
        self._check_rank(root)

        def leader(slots: List[Any]) -> List[Any]:
            gathered = [_to(s, self._devices[root]) for s in slots]
            return [gathered if i == root else None for i in range(self._n)]

        return self._run(data, leader)

    def allgather(self, data: Any) -> List[Any]:
        """Every rank gets every rank's payload, tensors moved to its own
        device; entries may alias between ranks (a fresh list per rank)."""

        def leader(slots: List[Any]) -> List[Any]:
            return [[_to(s, d) for s in slots] for d in self._devices]

        return self._run(data, leader)

    def scatter(self, data: Optional[List[Any]], root: int = 0) -> Any:
        """Rank i gets item i of root's list; a tensor item as its own copy
        on rank i's device."""
        self._check_rank(root)

        def leader(slots: List[Any]) -> List[Any]:
            items = slots[root]
            if items is None or len(items) != self._n:
                raise MpiError(
                    f"mpi_tpu_torch: scatter root needs a list of exactly "
                    f"{self._n} payloads")
            return [x.to(d, copy=True) if isinstance(x, torch.Tensor) else x
                    for x, d in zip(items, self._devices)]

        return self._run(data, leader)

    def alltoall(self, data: List[Any]) -> List[Any]:
        """Item j of each rank's list goes to rank j, tensors moved to its
        device; each rank gets its list ordered by source."""
        if len(data) != self._n:
            raise MpiError(
                f"mpi_tpu_torch: alltoall needs exactly {self._n} payloads, "
                f"got {len(data)}")

        def leader(slots: List[List[Any]]) -> List[List[Any]]:
            return [[_to(slots[src][dst], d) for src in range(self._n)]
                    for dst, d in enumerate(self._devices)]

        return self._run(data, leader)

    def reduce(self, data: Any, root: int = 0,
               op: "OpLike" = "sum") -> Optional[Any]:
        self._check_rank(root)
        result = self.allreduce(data, op=op)
        return result if self._myrank() == root else None

    def reduce_scatter(self, data: Any, op: "OpLike" = "sum") -> Any:
        """Reduce over the ranks in the canonical order and keep this rank's
        block of the leading axis, which splits into ``size`` equal blocks;
        each rank gets its own tensor."""
        check_op(op)

        def leader(slots: List[Any]) -> List[Any]:
            tensors = self._tensor_slots(slots)
            if tensors is None:
                payloads: List[Any] = [np.asarray(s) for s in slots]
                self._validate_payloads(payloads)
            else:
                payloads = tensors
            shape = tuple(payloads[0].shape)
            if len(shape) < 1 or shape[0] % self._n:
                raise MpiError(
                    f"mpi_tpu_torch: reduce_scatter payload leading axis "
                    f"{shape or 'scalar'} must divide into {self._n} equal "
                    f"blocks")
            m = shape[0] // self._n
            if tensors is not None:
                full = self._reduce_tensors(tensors, op)
                return self._home([full[i][i * m:(i + 1) * m].clone()
                                   for i in range(self._n)])
            total = canonical_combine(payloads, op)
            return [total[i * m:(i + 1) * m].copy() for i in range(self._n)]

        return self._run(data, leader)

    def scan(self, data: Any, op: "OpLike" = "sum") -> Any:
        """Inclusive prefix reduction in rank order (MPI_Scan), one running
        left fold: the order is the cross-backend contract."""
        return self._prefix(data, op, exclusive=False)

    def exscan(self, data: Any, op: "OpLike" = "sum") -> Optional[Any]:
        """Exclusive prefix reduction; rank 0 gets None (MPI_Exscan)."""
        return self._prefix(data, op, exclusive=True)

    def _prefix(self, data: Any, op: "OpLike", exclusive: bool) -> Any:
        check_op(op)

        def leader(slots: List[Any]) -> List[Any]:
            tensors = self._tensor_slots(slots)
            items = tensors if tensors is not None else list(slots)
            # One running left fold gives every rank's prefix in n - 1
            # combines; rank 0's inclusive result is its own payload.
            prefixes: List[Any] = []
            acc = items[0]
            for it in items[1:]:
                prefixes.append(acc)
                acc = combine(acc, it, op)
            per = [None] + prefixes if exclusive else prefixes + [acc]
            return self._home(per)

        return self._run(data, leader)


class CudaNetwork:
    """Backend implementing the :class:`mpi_tpu_torch.api.Interface` SPI
    with one thread per rank over CUDA devices (``xla.py:644``).

    ``devices`` lists each rank's device; by default every visible CUDA
    device, one rank each, and raises when CUDA is absent. ``device`` puts
    all ``n`` ranks on one device (``device="cpu"`` runs the plain paths,
    as the tests do). With ``oversubscribe``, ``n`` ranks on fewer devices
    map round-robin. Hand user code to :func:`run_spmd`."""

    def __init__(self, n: Optional[int] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None,
                 oversubscribe: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if devices is None:
            if device is not None:
                devices = [device] * (1 if n is None else n)
            else:
                resolve_device(None)  # raises without CUDA
                devices = mesh_devices()
                if n is not None:
                    devices = devices[:n]
        devices = [_device(d) for d in devices]
        if n is not None and len(devices) < n:
            if oversubscribe and devices:
                # Reference parity: N ranks on fewer cores is always legal
                # (gompirun spawns N processes regardless of CPU count).
                devices = [devices[r % len(devices)] for r in range(n)]
            else:
                raise MpiError(
                    f"mpi_tpu_torch: need {n} devices for {n} ranks, have "
                    f"{len(devices)} (pass oversubscribe=True to share)")
        self._devices: List[torch.device] = devices
        self._n = len(self._devices)
        self._tls = threading.local()
        self._init_barrier = threading.Barrier(self._n)
        # One rendezvous per ordered (src, dst) pair, created lazily.
        self._pairs: Dict[Tuple[int, int], Rendezvous] = {}
        self._pairs_lock = threading.Lock()
        self._world_coll = _MeshCollectives(self, self._devices,
                                            self._myrank)
        self._group_colls: "OrderedDict[Tuple, _MeshCollectives]" = \
            OrderedDict()

    # -- rank binding --------------------------------------------------------

    def bind_rank(self, rank: int) -> None:
        """Associate the calling thread with ``rank`` and make the rank's
        CUDA device the thread's current one (run_spmd does this)."""
        if not 0 <= rank < self._n:
            raise MpiError(
                f"mpi_tpu_torch: rank {rank} out of range [0, {self._n})")
        self._tls.rank = rank
        if self._devices[rank].type == "cuda":
            torch.cuda.set_device(self._devices[rank])

    def _myrank(self) -> int:
        r = getattr(self._tls, "rank", None)
        if r is None:
            if self._n == 1:
                return 0
            raise MpiError(
                "mpi_tpu_torch: calling thread has no rank binding — run "
                "your program under mpi_tpu_torch.backends.cuda.run_spmd")
        return r

    def device(self, rank: Optional[int] = None) -> torch.device:
        """The device of ``rank`` (default: the calling thread's)."""
        return self._devices[self._myrank() if rank is None else rank]

    # -- Interface ------------------------------------------------------------

    def init(self) -> None:
        """Barrier across all rank threads (the bootstrap, network.go:
        122-159, collapses to it in one process)."""
        self._myrank()  # validates binding
        if self._n > 1:
            try:
                self._init_barrier.wait(timeout=60.0)
            except threading.BrokenBarrierError as exc:
                raise MpiError("mpi_tpu_torch: init barrier broken (a rank "
                               "failed to start)") from exc

    def finalize(self) -> None:
        """Nothing to tear down: the rank threads share one process, and
        the facade counts the ranks' init/finalize calls itself."""

    def rank(self) -> int:
        return self._myrank()

    def size(self) -> int:
        return self._n

    # -- point-to-point -------------------------------------------------------

    def _pair(self, src: int, dst: int) -> Rendezvous:
        key = (src, dst)
        with self._pairs_lock:
            rv = self._pairs.get(key)
            if rv is None:
                rv = Rendezvous(send_peer=dst, recv_peer=src)
                self._pairs[key] = rv
            return rv

    def send(self, data: Any, dest: int, tag: int) -> None:
        """Blocking rendezvous send. A tensor is copied to the destination
        rank's device (a clone on the same device: the place of the JAX
        driver's ``DevicePipe``, ``p2p.py:231``) on the sender's current
        stream, and the receiver's stream waits for that stream. numpy
        arrays are copied and other objects deep-copied: the receiver never
        aliases the sender's memory (the reference's gob round trip)."""
        me = self._myrank()
        self._check_rank(dest)
        if isinstance(data, torch.Tensor):
            moved = data.to(self._devices[dest], copy=True)
            payload: Any = _InFlight(moved, _current_stream(moved.device))
        elif isinstance(data, np.ndarray):
            payload = data.copy()
        elif isinstance(data, (bytes, str, int, float, bool, complex,
                               type(None))):
            payload = data  # immutable
        else:
            payload = copy.deepcopy(data)
        self._pair(me, dest).send(tag, payload)

    def receive(self, source: int, tag: int,
                out: Optional[Any] = None) -> Any:
        """Blocking receive. ``out``, a tensor or ndarray of the payload's
        shape and dtype, is filled and returned in place of the payload."""
        me = self._myrank()
        self._check_rank(source)
        payload = self._pair(source, me).receive(tag)
        if isinstance(payload, _InFlight):
            payload = payload.take()
        if isinstance(out, torch.Tensor) and isinstance(payload, torch.Tensor) \
                and out.shape == payload.shape and out.dtype == payload.dtype:
            out.copy_(payload)
            return out
        if isinstance(out, np.ndarray) and isinstance(payload, np.ndarray) \
                and out.shape == payload.shape and out.dtype == payload.dtype:
            out[...] = payload
            return out
        return payload

    def cancel_receive(self, source: int, tag: int) -> bool:
        me = self._myrank()
        self._check_rank(source)
        exc = ReceiveCancelled(
            f"mpi_tpu_torch: receive(source={source}, tag={tag}) cancelled")
        return self._pair(source, me).cancel(tag, exc)

    def iprobe(self, source: int, tag: int) -> bool:
        """Non-consuming MPI_Iprobe: True when the sender is parked at this
        pair's rendezvous with ``tag``."""
        me = self._myrank()
        self._check_rank(source)
        return self._pair(source, me).probe(tag)

    def _check_rank(self, r: int) -> None:
        if not 0 <= r < self._n:
            raise MpiError(
                f"mpi_tpu_torch: peer rank {r} out of range [0, {self._n})")

    # -- collectives (world engine; see _MeshCollectives) --------------------

    def allreduce(self, data: Any, op: "OpLike" = "sum") -> Any:
        return self._world_coll.allreduce(data, op=op)

    def barrier(self) -> None:
        return self._world_coll.barrier()

    def bcast(self, data: Any, root: int = 0) -> Any:
        return self._world_coll.bcast(data, root=root)

    def gather(self, data: Any, root: int = 0) -> Optional[List[Any]]:
        return self._world_coll.gather(data, root=root)

    def allgather(self, data: Any) -> List[Any]:
        return self._world_coll.allgather(data)

    def scatter(self, data: Optional[List[Any]], root: int = 0) -> Any:
        return self._world_coll.scatter(data, root=root)

    def alltoall(self, data: List[Any]) -> List[Any]:
        return self._world_coll.alltoall(data)

    def reduce(self, data: Any, root: int = 0,
               op: "OpLike" = "sum") -> Optional[Any]:
        return self._world_coll.reduce(data, root=root, op=op)

    def reduce_scatter(self, data: Any, op: "OpLike" = "sum") -> Any:
        return self._world_coll.reduce_scatter(data, op=op)

    def scan(self, data: Any, op: "OpLike" = "sum") -> Any:
        return self._world_coll.scan(data, op=op)

    def exscan(self, data: Any, op: "OpLike" = "sum") -> Optional[Any]:
        return self._world_coll.exscan(data, op=op)

    # -- communicator group engines ------------------------------------------

    _GROUP_ENGINE_CACHE = 128

    def group_collectives(self, members, ctx: int) -> _MeshCollectives:
        """The collective engine of a communicator group: the members'
        devices in member order, one shared engine per ``(ctx, members)``
        (it holds the members' session barrier)."""
        key = (int(ctx), tuple(int(m) for m in members))
        with self._pairs_lock:
            eng = self._group_colls.get(key)
            if eng is not None:
                self._group_colls.move_to_end(key)
                return eng
            for m in key[1]:
                self._check_rank(m)
            members_t = key[1]
            eng = _MeshCollectives(
                self, [self._devices[m] for m in members_t],
                lambda mt=members_t: mt.index(self._myrank()))
            self._group_colls[key] = eng
            # LRU backstop for leaked communicators; safe unless more than
            # _GROUP_ENGINE_CACHE groups are mid-collective at once.
            while len(self._group_colls) > self._GROUP_ENGINE_CACHE:
                self._group_colls.popitem(last=False)
        return eng

    def release_group_collectives(self, members, ctx: int) -> None:
        """Drop the group engine for ``(ctx, members)``. Idempotent; must
        not race a collective in flight on that group."""
        key = (int(ctx), tuple(int(m) for m in members))
        with self._pairs_lock:
            self._group_colls.pop(key, None)

    def abort_collectives(self) -> None:
        """Break every collective barrier (world and groups) so rank threads
        blocked in a collective fail fast when a sibling dies."""
        self._world_coll._coll._barrier.abort()
        with self._pairs_lock:
            engines = list(self._group_colls.values())
        for e in engines:
            e._coll._barrier.abort()


class _InFlight:
    """A sent tensor and the stream its copy was issued on."""

    __slots__ = ("tensor", "stream")

    def __init__(self, tensor: torch.Tensor, stream: Stream):
        self.tensor = tensor
        self.stream = stream

    def take(self) -> torch.Tensor:
        """The tensor, ordered after its copy on the receiver's stream."""
        t = self.tensor
        if self.stream is not None:
            mine = torch.cuda.current_stream(t.device)
            if mine != self.stream:
                mine.wait_stream(self.stream)
                t.record_stream(mine)
        return t


def drive_rank_threads(fn: Callable[[], Any], net: CudaNetwork
                       ) -> List[Any]:
    """The thread-per-rank driver (``xla.py:969``): register ``net`` with
    the facade, spawn one thread per rank bound to it, join with a bounded
    grace period once any rank errors (breaking every barrier so blocked
    siblings fail fast), release the facade, and re-raise the root-cause
    error (broken-barrier collateral only if nothing else failed)."""
    from .. import api

    nranks = net.size()
    api.register(net)
    results: List[Any] = [None] * nranks
    errors: List[Optional[BaseException]] = [None] * nranks
    _activate_inheritance(net)

    def runner(r: int) -> None:
        net.bind_rank(r)
        try:
            results[r] = fn()
        except BaseException as exc:  # noqa: BLE001 - aggregated below
            errors[r] = exc
            net._init_barrier.abort()
            net.abort_collectives()

    threads = [threading.Thread(target=runner, args=(r,),
                                name=f"mpi-rank-{r}", daemon=True)
               for r in range(nranks)]
    for t in threads:
        t.start()
    # Once a rank has failed, give the others a bounded grace period: a
    # failed partner can leave a rank parked in a rendezvous for good.
    try:
        deadline: Optional[float] = None
        while True:
            alive = [t for t in threads if t.is_alive()]
            if not alive:
                break
            if any(e is not None for e in errors):
                if deadline is None:
                    deadline = time.monotonic() + 10.0
                elif time.monotonic() > deadline:
                    break
            for t in alive:
                t.join(timeout=0.1)
    finally:
        _deactivate_inheritance(net)
        api._release_backend(net)
    secondary = None
    for e in errors:
        if e is None:
            continue
        if isinstance(e, MpiError) and \
                isinstance(e.__cause__, threading.BrokenBarrierError):
            secondary = secondary or e
            continue
        raise e
    if secondary is not None:
        raise secondary
    return results


def run_spmd(fn: Callable[[], Any], n: Optional[int] = None,
             net: Optional[CudaNetwork] = None,
             device: Optional[Union[str, torch.device]] = None) -> List[Any]:
    """Run ``fn`` SPMD, one thread per rank bound to its device: the
    in-process ``gompirun N prog`` (gompirun.go:28-93). ``fn`` is
    reference-style code: ``init()``, branch on ``rank()``, communicate,
    ``finalize()``. Returns the per-rank return values; the first rank
    exception is re-raised after all threads stop.

    Without ``net``, ``n`` ranks share the visible CUDA devices round-robin
    (every one of them when ``n`` is None), or all lie on ``device``; with
    no CUDA and no ``device`` it raises."""
    return drive_rank_threads(
        fn, net or CudaNetwork(n=n, oversubscribe=True, device=device))
