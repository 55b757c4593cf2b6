"""Transport abstraction for the coded cluster runtime (DESIGN.md §7).

A transport moves typed messages (messages.py) between named endpoints
("master", "worker/3").  The interface is PURE asynchronous message passing
— send with a delay, receive what has arrived, peek at the next arrival
time — so the same master/scheduler code runs unchanged over the socket
backend (socket_transport.py), where "delay" is real network+compute time
and ``next_delivery`` is a bounded blocking poll.  The backend-shared
contract suite (tests/test_transport_contract.py) pins both to the same
semantics.

``InProcessTransport`` is the simulation backend: a per-endpoint heap of
(deliver_at, seq, msg).  It owns no clock; the EventScheduler advances
simulated time TO the transport's next delivery — the transport is the
event queue.
"""
from __future__ import annotations

import abc
import heapq
import itertools
import math
from typing import Any, Iterable


class Transport(abc.ABC):
    """Typed-message channel between named endpoints.

    ``real`` distinguishes the two time regimes the contract supports:
    simulated backends deliver on an externally-advanced clock (the
    scheduler moves time TO ``next_delivery``), while real backends
    (cluster/socket_transport.py) stamp arrivals with the wall clock and
    ``next_delivery`` is a bounded blocking poll — None means "nothing yet",
    not "nothing ever".
    """

    real: bool = False

    @abc.abstractmethod
    def send(self, dst: str, msg: Any, at: float, delay: float = 0.0
             ) -> None:
        """Schedule ``msg`` for delivery to ``dst`` at time ``at + delay``.

        ``delay == math.inf`` is legal and means the message is lost (dead
        worker): it never becomes visible to ``recv``/``next_delivery``.
        """

    @abc.abstractmethod
    def recv(self, dst: str, now: float) -> list[tuple[float, Any]]:
        """Pop every (deliver_time, msg) for ``dst`` due by ``now``,
        in delivery order."""

    @abc.abstractmethod
    def next_delivery(self, dst: str) -> float | None:
        """Earliest pending delivery time for ``dst`` (None = queue empty)."""


class InProcessTransport(Transport):
    def __init__(self):
        self._queues: dict[str, list[tuple[float, int, Any]]] = {}
        self._seq = itertools.count()   # FIFO tiebreak for equal times

    def send(self, dst: str, msg: Any, at: float, delay: float = 0.0) -> None:
        deliver_at = at + delay
        if math.isinf(deliver_at):
            return                      # lost in the void: dead worker
        heapq.heappush(self._queues.setdefault(dst, []),
                       (deliver_at, next(self._seq), msg))

    def recv(self, dst: str, now: float) -> list[tuple[float, Any]]:
        q = self._queues.get(dst, [])
        out = []
        while q and q[0][0] <= now:
            t, _, msg = heapq.heappop(q)
            out.append((t, msg))
        return out

    def next_delivery(self, dst: str) -> float | None:
        q = self._queues.get(dst)
        return q[0][0] if q else None

    # simulation-only introspection (not part of the Transport contract):
    def pending(self, dst: str) -> Iterable[tuple[float, Any]]:
        """(deliver_at, msg) for every undelivered message, unordered."""
        return [(t, msg) for t, _, msg in self._queues.get(dst, [])]
