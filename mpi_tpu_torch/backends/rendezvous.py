"""Rendezvous primitives for the cuda driver's rank threads.

A copy of ``mpi_tpu/backends/rendezvous.py`` (only the imports differ), so
the port's in-process rank threads keep the JAX package's tag bookkeeping
and first-arrival-creates handoff (the reference's network.go:371-446,
449-497) and its misuse detection.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..api import MpiError, TagError

__all__ = ["Cancel", "DeadlineError", "ReceiveCancelled", "TagManager",
           "Rendezvous"]


class ReceiveCancelled(MpiError):
    """A pending receive was cancelled via ``cancel_receive`` (used by
    :func:`mpi_tpu_torch.api.exchange` to clean up after a failed send)."""


class DeadlineError(MpiError):
    """A blocking operation exceeded the ``--mpi-optimeout`` deadline.

    MPI class ``ERR_PENDING``: the operation did not complete — the peer
    is presumed dead or wedged. After a deadline expires the ``{peer,
    tag}`` channel is indeterminate (a late ack/payload may still arrive
    and be mis-matched to a later claim of the same tag); callers should
    treat the peer as failed rather than retry on the same tag."""

    def __init__(self, op: str, timeout: float):
        super().__init__(
            f"mpi_tpu: {op} exceeded the {timeout:g}s operation deadline "
            f"(--mpi-optimeout); peer presumed dead or wedged "
            f"(MPI_ERR_PENDING)")


class Cancel:
    """Cancellation token routed into a tag slot. Carries the claim
    generation it targets so a token that loses a race with real data
    cannot poison a *later* claim of the same tag."""

    def __init__(self, gen: int, exc: BaseException):
        self.gen = gen
        self.exc = exc


class TagManager:
    """Per-direction, per-peer tag → slot map with misuse detection.

    Rebuild of ``tagManager`` (network.go:449-497): a duplicate live tag is
    an error (the reference panics, network.go:469); early arrivals for
    unregistered tags are buffered; cancellation is generation-tagged."""

    def __init__(self, direction: str, peer: int):
        self._direction = direction
        self._peer = peer
        self._lock = threading.Lock()
        self._slots: Dict[int, queue.Queue] = {}
        self._claimed: set = set()
        self._gen: Dict[int, int] = {}
        self._dead: Optional[BaseException] = None

    def claim(self, tag: int) -> Tuple[queue.Queue, int]:
        """Register a live caller-side use of ``tag`` (send or receive).
        Returns the slot and this claim's generation.

        A poisoned direction still honors already-buffered traffic for
        the tag: a payload routed before the death is deliverable, and a
        routed per-tag failure (e.g. the ChecksumError for the exact
        frame that killed the conn) is more attributable than the
        generic poison — wait() drains the slot either way."""
        with self._lock:
            if self._dead is not None:
                q = self._slots.get(tag)
                if q is None or q.empty():
                    raise self._dead
            if tag in self._claimed:
                raise TagError(tag, self._peer, self._direction)
            self._claimed.add(tag)
            gen = self._gen.get(tag, 0) + 1
            self._gen[tag] = gen
            return self._slots.setdefault(tag, queue.Queue()), gen

    def cancel(self, tag: int, exc: BaseException) -> bool:
        """Best-effort cancel of the live claim on ``tag``.

        MPI's contract: a successful cancel means NO part of the
        message was received — so a claim whose sender's data frame
        has already been routed into the slot is NOT cancellable
        (ADVICE.md round 5): return False and let ``wait()`` deliver
        the payload. (The token-vs-payload race that remains —
        payload routed after this check — is resolved by the waiter:
        a delivered payload wins over a stale token, and
        ``api.Request.wait`` clears ``cancelled`` when data arrives.)"""
        with self._lock:
            if tag not in self._claimed:
                return False
            q = self._slots.setdefault(tag, queue.Queue())
            with q.mutex:
                if any(not isinstance(item, (Cancel, BaseException))
                       for item in q.queue):
                    return False  # message (partly) received already
            gen = self._gen.get(tag, 0)
        q.put(Cancel(gen, exc))
        return True

    def release(self, tag: int) -> None:
        with self._lock:
            self._claimed.discard(tag)
            q = self._slots.get(tag)
            if q is not None and q.empty():
                del self._slots[tag]

    def has_message(self, tag: int) -> bool:
        """Non-consuming probe: a real payload (not a cancellation
        token) is buffered for ``tag`` — on this transport a message is
        'available' exactly when the sender's frame has already arrived.
        A poisoned direction (peer died) or a buffered routed failure
        RAISES instead of returning False: the matching receive would
        raise immediately, and a blocking probe polling a dead link
        would otherwise spin forever."""
        with self._lock:
            dead = self._dead
            q = self._slots.get(tag)
        if q is not None:
            with q.mutex:
                items = list(q.queue)
            if any(not isinstance(item, (Cancel, BaseException))
                   for item in items):
                return True
            for item in items:
                if isinstance(item, BaseException):
                    raise item
        if dead is not None:
            raise dead
        return False

    def route(self, tag: int, item: Any) -> None:
        """Deliver an inbound item to the tag's slot (creating it if the
        matching call hasn't arrived yet)."""
        with self._lock:
            q = self._slots.setdefault(tag, queue.Queue())
        q.put(item)

    def poison(self, exc: BaseException) -> None:
        """Fail all pending and future operations on this direction.

        First poison wins: a second reader dying of the cross-close
        fallout must not overwrite the original (more attributable)
        cause of death."""
        with self._lock:
            if self._dead is None:
                self._dead = exc
            else:
                exc = self._dead
            slots = list(self._slots.values())
        for q in slots:
            q.put(exc)

    def wait(self, slot: queue.Queue, gen: int,
             timeout: Optional[float] = None,
             op: str = "operation") -> Any:
        """Block on ``slot`` for data, handling cancellation tokens and
        routed exceptions. Returns the payload.

        With ``timeout`` (seconds — the ``--mpi-optimeout`` plumbing) a
        slot that stays empty past the deadline raises
        :class:`DeadlineError` instead of blocking forever; ``op`` names
        the operation in the error message."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                if deadline is None:
                    item = slot.get()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # Deadline lapsed — but an already-delivered item
                        # (payload behind a just-drained stale Cancel,
                        # or timeout=0) must still win over the error.
                        item = slot.get_nowait()
                    else:
                        item = slot.get(timeout=remaining)
            except queue.Empty:
                raise DeadlineError(op, timeout) from None
            if isinstance(item, Cancel):
                if item.gen == gen:
                    raise item.exc
                continue  # stale token from an earlier claim — drop
            if isinstance(item, BaseException):
                raise item
            return item


class Rendezvous:
    """Blocking first-arrival-creates handoff between one sender side and
    one receiver side, keyed by tag (network.go:371-446).

    Used for every rank pair of the in-process cuda driver. A second arrival from the *same* side
    while an entry is live is the misuse the reference panics on
    (network.go:417,435) — here it raises :class:`TagError`."""

    _SENDER, _RECEIVER = "send", "receive"

    class _Entry:
        __slots__ = ("creator", "q", "done", "sender_engaged")

        def __init__(self, creator: str):
            self.creator = creator
            self.q: queue.Queue = queue.Queue(maxsize=1)
            self.done = threading.Event()
            self.sender_engaged = False

    def __init__(self, send_peer: int, recv_peer: int):
        # Peer ranks reported in TagError messages: a duplicate send names
        # the destination, a duplicate receive names the source.
        self._send_peer = send_peer
        self._recv_peer = recv_peer
        self._lock = threading.Lock()
        self._entries: Dict[int, "Rendezvous._Entry"] = {}

    def _entry(self, tag: int, side: str) -> "Rendezvous._Entry":
        with self._lock:
            ent = self._entries.get(tag)
            if ent is None:
                ent = Rendezvous._Entry(side)
                self._entries[tag] = ent
            elif ent.creator == side:
                peer = self._send_peer if side == self._SENDER else self._recv_peer
                raise TagError(tag, peer, side)
            if side == self._SENDER:
                # Marked under the lock, *before* the sender's q.put runs,
                # so cancel() can never retire an entry a sender is about
                # to fill (which would wedge the sender forever).
                ent.sender_engaged = True
            return ent

    def cancel(self, tag: int, exc: BaseException) -> bool:
        """Best-effort cancel of a parked receive: only succeeds while no
        sender has engaged the entry."""
        with self._lock:
            ent = self._entries.get(tag)
            if ent is None:
                return False
            if ent.creator != self._RECEIVER or ent.sender_engaged:
                return False
            self._entries.pop(tag)
        try:
            ent.q.put_nowait(Cancel(0, exc))
            return True
        except queue.Full:  # pragma: no cover - sender_engaged excludes this
            return False

    def probe(self, tag: int) -> bool:
        """Non-consuming probe: True when a sender has arrived and is
        parked at the rendezvous for ``tag`` (its payload is immediately
        receivable)."""
        with self._lock:
            ent = self._entries.get(tag)
            return ent is not None and ent.creator == self._SENDER

    def send(self, tag: int, payload: Any,
             timeout: Optional[float] = None, op: str = "send") -> None:
        ent = self._entry(tag, self._SENDER)
        try:
            if timeout is None:
                ent.q.put(payload)
            else:
                # The maxsize-1 queue can already hold the payload of a
                # sender whose receiver deadlined mid-engagement; the
                # put must be bounded too or the deadline is defeated.
                ent.q.put(payload, timeout=timeout)
        except queue.Full:
            raise DeadlineError(op, timeout) from None
        # Rendezvous: return only after the receiver took it. With
        # ``timeout`` (--mpi-optimeout parity with the remote path) a
        # receiver that never shows raises DeadlineError; the parked
        # payload then leaves the tag indeterminate, as documented for
        # the remote deadline.
        if not ent.done.wait(timeout):
            raise DeadlineError(op, timeout)

    def receive(self, tag: int,
                timeout: Optional[float] = None, op: str = "receive") -> Any:
        ent = self._entry(tag, self._RECEIVER)
        try:
            payload = (ent.q.get() if timeout is None
                       else ent.q.get(timeout=timeout))
        except queue.Empty:
            # Retire the still-unengaged entry so a later sender parks
            # on a fresh rendezvous instead of filling this corpse; a
            # sender that engaged in the race keeps the entry (its own
            # deadline bounds it).
            with self._lock:
                if self._entries.get(tag) is ent and not ent.sender_engaged:
                    self._entries.pop(tag)
            raise DeadlineError(op, timeout) from None
        if isinstance(payload, Cancel):
            raise payload.exc
        # The receiver retires the entry *before* signalling the sender:
        # popping under the lock here closes a race where a second legal
        # use of the same tag could observe the drained entry and deadlock.
        with self._lock:
            self._entries.pop(tag, None)
        ent.done.set()
        return payload
