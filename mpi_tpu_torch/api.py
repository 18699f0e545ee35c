"""The port's MPI facade: module-level calls over one registered backend.

Counterpart of the part of ``mpi_tpu/api.py`` that the device driver and
the two examples use (``mpi_tpu/api.py:107-221, :238-296, :388-870``):
``init``/``finalize``/``rank``/``size``, blocking tagged rendezvous
``send``/``receive`` (the reference's mpi.go:93-159), ``iprobe``,
``sendrecv``, ``wtime``, and the collectives. The registry holds one
backend, here :class:`mpi_tpu_torch.backends.cuda.CudaNetwork`.

Semantics are the reference's: every call blocks; ``send`` returns once the
destination accepted the message; concurrent sends need distinct ``{dest,
tag}`` pairs and concurrent receives distinct ``{source, tag}`` pairs.

Left out of this copy: error handlers, ``Request``/``isend``/``irecv`` and
persistent requests, ``pack``/``unpack``, the observe and trace hooks, and
the generic send/receive collectives: the cuda driver implements every
collective itself, and a backend without one raises :class:`MpiError`
naming the missing method.
"""

from __future__ import annotations

import threading
import time
from typing import (TYPE_CHECKING, Any, List, Optional, Protocol,
                    runtime_checkable)

if TYPE_CHECKING:
    from .collectives_generic import OpLike

__all__ = ["Interface", "register", "registered", "init", "finalize",
           "rank", "size", "send", "receive", "sendrecv", "iprobe",
           "reduce", "allreduce", "reduce_scatter", "bcast", "allgather",
           "gather", "scatter", "alltoall", "scan", "exscan", "barrier",
           "MpiError", "TagError", "NotInitializedError", "wtime"]


class MpiError(RuntimeError):
    """Base class for all of the port's MPI errors."""


class TagError(MpiError):
    """A live ``{peer, tag}`` pair was used by a second concurrent call
    (the reference declares ``TagExists``, mpi.go:174-182)."""

    def __init__(self, tag: int, peer: int, direction: str = "send"):
        self.tag = tag
        self.peer = peer
        self.direction = direction
        super().__init__(
            f"mpi_tpu_torch: tag {tag} already live for concurrent "
            f"{direction} with peer {peer}; {{peer, tag}} pairs must be "
            f"unique among in-flight operations")


class NotInitializedError(MpiError):
    """An operation was called before ``init()`` / after ``finalize()``."""


@runtime_checkable
class Interface(Protocol):
    """Backend SPI, the six operations of ``mpi.Interface``
    (mpi.go:163-170). Collectives are backend methods of the same names;
    the facade calls them where they exist."""

    def init(self) -> None: ...
    def finalize(self) -> None: ...
    def rank(self) -> int: ...
    def size(self) -> int: ...
    def send(self, data: Any, dest: int, tag: int) -> None: ...
    def receive(self, source: int, tag: int,
                out: Optional[Any] = None) -> Any: ...


_lock = threading.Lock()
_backend: Optional[Interface] = None
_registered_explicitly = False
# Reference-counted: every rank thread calls init()/finalize() once, and one
# rank finishing early must not tear the facade down under its siblings.
_init_count = 0


def register(impl: Interface) -> None:
    """Swap in a backend (``mpi.Register``, mpi.go:61-67): at most once,
    and only before ``init``."""
    global _backend, _registered_explicitly
    with _lock:
        if _registered_explicitly:
            raise MpiError(
                "mpi_tpu_torch: register called twice (mpi.go:63-65 "
                "contract)")
        if _init_count > 0:
            raise MpiError("mpi_tpu_torch: register called after init")
        _backend = impl
        _registered_explicitly = True


def registered() -> Interface:
    """The active backend. The port has no default driver (the JAX
    package's is TCP): run the program under ``run_spmd`` or
    ``run_main``, which register one."""
    with _lock:
        if _backend is None:
            raise MpiError(
                "mpi_tpu_torch: no backend registered; run the program "
                "under mpi_tpu_torch.run_main or "
                "mpi_tpu_torch.backends.cuda.run_spmd")
        return _backend


def _release_backend(impl: Interface) -> None:
    """Deregister ``impl`` if it is the active backend, so a second
    ``run_spmd`` in the same process can register again."""
    global _backend, _registered_explicitly, _init_count
    with _lock:
        if _backend is impl:
            _backend = None
            _registered_explicitly = False
            _init_count = 0


def _reset_for_testing() -> None:
    """Clear the registry (test hook)."""
    global _backend, _registered_explicitly, _init_count
    with _lock:
        _backend = None
        _registered_explicitly = False
        _init_count = 0


def _require_init() -> Interface:
    if _init_count <= 0:
        raise NotInitializedError(
            "mpi_tpu_torch: call init() first (mpi.go:26-30)")
    return registered()


def init() -> None:
    """Initialize the network (mpi.go:96-98); blocks until every rank has
    arrived."""
    global _init_count
    impl = registered()
    impl.init()
    with _lock:
        _init_count += 1


def finalize() -> None:
    """Tear down (mpi.go:102-104). Delegates on every call: the rank-thread
    driver counts its ranks itself."""
    global _init_count
    impl = registered()
    with _lock:
        _init_count = max(0, _init_count - 1)
    impl.finalize()


def rank() -> int:
    """This rank, in [0, size) (mpi.go:112-114)."""
    return _require_init().rank()


def size() -> int:
    """The number of ranks (mpi.go:117-119)."""
    return _require_init().size()


def wtime() -> float:
    """Elapsed wall-clock seconds from an arbitrary fixed origin
    (MPI_Wtime): monotonic; take differences on one rank."""
    return time.perf_counter()


def send(data: Any, dest: int, tag: int) -> None:
    """Blocking rendezvous send (mpi.go:126-128): returns once rank
    ``dest`` has accepted the message."""
    impl = _require_init()
    _check_peer(dest, impl)
    _check_tag(tag)
    impl.send(data, dest, tag)


def receive(source: int, tag: int, out: Optional[Any] = None) -> Any:
    """Blocking receive (mpi.go:157-159). ``out``, a tensor or ndarray of
    the payload's shape and dtype, is filled and returned instead."""
    impl = _require_init()
    _check_peer(source, impl)
    _check_tag(tag)
    return impl.receive(source, tag, out=out)


def iprobe(source: int, tag: int) -> bool:
    """Non-consuming probe (MPI_Iprobe): True when a message from
    ``source`` with ``tag`` is waiting; never blocks."""
    impl = _require_init()
    _check_peer(source, impl)
    _check_tag(tag)
    probe = getattr(impl, "iprobe", None)
    if probe is None:
        raise MpiError(f"mpi_tpu_torch: backend {type(impl).__name__} does "
                       f"not support iprobe")
    return bool(probe(source, tag))


def exchange(impl: Interface, data: Any, dest: int, source: int, tag: int,
             out: Optional[Any] = None) -> Any:
    """Concurrent send + receive against ``impl`` (the receive on a helper
    thread), deadlock-free where send-then-receive would rendezvous-lock."""
    result: List[Any] = [None]
    err: List[Optional[BaseException]] = [None]

    def _recv() -> None:
        try:
            result[0] = impl.receive(source, tag, out=out)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            err[0] = exc

    t = threading.Thread(target=_recv, name="mpi-sendrecv", daemon=True)
    t.start()
    try:
        impl.send(data, dest, tag)
    except BaseException:
        # Do not orphan the posted receive: it would hold its {source, tag}
        # claim and could take a message meant for a later call.
        cancel = getattr(impl, "cancel_receive", None)
        if cancel is not None:
            cancel(source, tag)
        t.join(timeout=30.0)
        raise
    t.join()
    if err[0] is not None:
        raise err[0]
    return result[0]


def sendrecv(data: Any, dest: int, source: int, tag: int,
             out: Optional[Any] = None) -> Any:
    """Send to ``dest`` and receive from ``source`` concurrently, the
    idiom of the reference's examples (helloworld.go:53-81)."""
    impl = _require_init()
    _check_peer(dest, impl)
    _check_peer(source, impl)
    _check_tag(tag)
    return exchange(impl, data, dest, source, tag, out=out)


def _check_peer(peer: int, impl: Interface) -> None:
    n = impl.size()
    if not 0 <= peer < n:
        raise MpiError(
            f"mpi_tpu_torch: peer rank {peer} out of range [0, {n})")


def _check_tag(tag: int) -> None:
    """User traffic owns the non-negative tags; the JAX package reserves the
    negative half for sub-communicators, and the port keeps the rule."""
    if tag < 0:
        raise MpiError(
            f"mpi_tpu_torch: tag {tag} is negative; the negative tag space "
            f"is reserved for sub-communicator contexts")


# --------------------------------------------------------------------------
# Collectives: the backend's own method of the same name.
# --------------------------------------------------------------------------

def _collective(name: str, *args: Any, **kwargs: Any) -> Any:
    impl = _require_init()
    native = getattr(impl, name, None)
    if native is None:
        raise MpiError(
            f"mpi_tpu_torch: backend {type(impl).__name__} has no {name}(); "
            f"the port has no generic send/receive collectives")
    return native(*args, **kwargs)


def allreduce(data: Any, op: "OpLike" = "sum") -> Any:
    """Combine ``data`` across all ranks with ``op`` ("sum", "prod", "min",
    "max", or an associative callable ``op(a, b)`` folded in rank order);
    every rank gets the result."""
    return _collective("allreduce", data, op=op)


def reduce(data: Any, root: int = 0, op: "OpLike" = "sum") -> Optional[Any]:
    """Combine across ranks; the result on ``root``, None elsewhere."""
    return _collective("reduce", data, root=root, op=op)


def reduce_scatter(data: Any, op: "OpLike" = "sum") -> Any:
    """Combine across ranks; rank i keeps block i of the leading axis,
    which must divide into ``size`` equal blocks."""
    return _collective("reduce_scatter", data, op=op)


def bcast(data: Any, root: int = 0) -> Any:
    """Broadcast ``root``'s payload to every rank."""
    return _collective("bcast", data, root=root)


def allgather(data: Any) -> List[Any]:
    """Every rank's payload to every rank, ordered by rank."""
    return _collective("allgather", data)


def gather(data: Any, root: int = 0) -> Optional[List[Any]]:
    """Payloads to ``root`` (ordered by rank; None elsewhere)."""
    return _collective("gather", data, root=root)


def scatter(data: Optional[List[Any]], root: int = 0) -> Any:
    """Scatter ``root``'s list of per-rank payloads; returns this rank's."""
    return _collective("scatter", data, root=root)


def alltoall(data: List[Any]) -> List[Any]:
    """Element j of this rank's list goes to rank j; returns what arrived,
    ordered by source rank."""
    return _collective("alltoall", data)


def scan(data: Any, op: "OpLike" = "sum") -> Any:
    """Inclusive prefix reduction in rank order (MPI_Scan)."""
    return _collective("scan", data, op=op)


def exscan(data: Any, op: "OpLike" = "sum") -> Optional[Any]:
    """Exclusive prefix reduction; rank 0 gets None (MPI_Exscan)."""
    return _collective("exscan", data, op=op)


def barrier() -> None:
    """Block until every rank has entered the barrier."""
    return _collective("barrier")
