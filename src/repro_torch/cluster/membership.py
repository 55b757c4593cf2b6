"""Elastic cluster membership: epoch-numbered worker sets (DESIGN.md §13).

The fixed-N runtime froze the fleet at provision time: a dead worker could
only be speculatively excluded round by round, and a new worker could never
join mid-run.  This module makes membership a first-class mutable object:

  * ``MembershipView`` — an immutable (epoch, members) snapshot.  Every
    round derives its dispatch set, decode matrix, and DecodePlan from ONE
    view taken at the round fence, so a mid-round transition can never mix
    two fleets inside a single round (the epoch fence).
  * ``ClusterMembership`` — the epoch state machine.  JOIN admits a worker
    from the pre-provisioned SPARE pool (extra Lagrange evaluation points
    encoded up front — see below); LEAVE permanently retires a worker the
    failure detector declared dead, instead of re-excluding it every round.
    Each transition bumps the epoch and is logged for the flight recorder.

Spare evaluation points & bit-identity: a ``CodingScheme(N, K, T)`` uses
CONSECUTIVE evaluation points (alphas = K+T+1 .. K+T+N), so the scheme for
N + spares extends the point set without moving the first N points — the
first N columns of the encode matrix, hence shares 0..N-1 and every decode
over survivors drawn from them, are bit-identical to the fixed-N scheme's.
A joiner simply picks up a spare share of the SAME degree-(K+T-1) masked
polynomial: any T shares of it remain jointly uniform, so T-privacy is
unchanged (DESIGN.md §13).

The monitor (runtime/resilience.py HeartbeatMonitor) stays the liveness
authority; ClusterMembership owns WHO is in the fleet and drives
``add_worker``/``remove_worker`` on it as workers join and leave.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """Immutable epoch snapshot: the fleet as one round sees it."""
    epoch: int
    members: tuple[int, ...]        # sorted active worker slots

    def __contains__(self, worker: int) -> bool:
        return int(worker) in self.members

    def __len__(self) -> int:
        return len(self.members)


@dataclasses.dataclass(frozen=True)
class Transition:
    """One membership change, as logged for the flight recorder."""
    epoch: int                      # epoch AFTER the transition
    kind: str                       # "join" | "leave"
    worker: int
    round: int                      # fence round the transition landed at
    at: float                       # scheduler clock at the transition


class ClusterMembership:
    """Epoch state machine over a worker-slot set, with a spare pool.

    ``initial`` seeds epoch 0; ``spares`` are slot ids whose coded shares
    were provisioned up front (extra evaluation points) but which carry no
    live worker yet.  A spare becomes a member via ``admit`` — either as a
    scheduled JOIN (``schedule_join``/``due_joins``) or as the permanent
    replacement pulled by ``leave``.
    """

    def __init__(self, initial: Iterable[int],
                 monitor=None, spares: Iterable[int] = ()):
        self._members: set[int] = {int(w) for w in initial}
        self._spares: list[int] = sorted(int(w) for w in spares)
        assert not (self._members & set(self._spares)), (
            "spare slots must be disjoint from the initial members")
        self.monitor = monitor
        self.epoch = 0
        self.transitions: list[Transition] = []
        self._pending: list[tuple[int, int]] = []   # (slot, at_round)
        self._left: set[int] = set()

    # -- snapshots ------------------------------------------------------

    def view(self) -> MembershipView:
        """The epoch fence: one immutable snapshot per round."""
        return MembershipView(self.epoch, tuple(sorted(self._members)))

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, worker: int) -> bool:
        return int(worker) in self._members

    @property
    def spares(self) -> tuple[int, ...]:
        return tuple(self._spares)

    # -- scheduled joins ------------------------------------------------

    def schedule_join(self, worker: int, at_round: int) -> None:
        """Register a JOIN request (late HELLO): ``worker`` wants to enter
        the fleet at the first round fence with t >= at_round.  Idempotent
        per slot; a slot that already left may rejoin (resilient restore)."""
        worker = int(worker)
        if worker in self._members:
            return
        if any(w == worker for w, _ in self._pending):
            return
        self._pending.append((worker, int(at_round)))

    def due_joins(self, t: int) -> list[int]:
        """Pending joiners whose at_round has arrived, in request order."""
        return [w for w, r in self._pending if r <= t]

    def take_spare(self) -> int | None:
        """Pop the lowest pre-provisioned spare slot (None = pool dry)."""
        return self._spares.pop(0) if self._spares else None

    # -- transitions (each bumps the epoch) -----------------------------

    def admit(self, worker: int, round: int, now: float = 0.0
              ) -> MembershipView:
        """JOIN: move a slot into the member set; new epoch.

        The slot's coded share already exists (spare evaluation point), so
        admission is pure bookkeeping plus telling the monitor a fresh
        worker now answers for the slot.
        """
        worker = int(worker)
        assert worker not in self._members, f"worker {worker} already member"
        self._members.add(worker)
        self._spares = [s for s in self._spares if s != worker]
        self._pending = [(w, r) for w, r in self._pending if w != worker]
        self._left.discard(worker)
        self.epoch += 1
        if self.monitor is not None:
            self.monitor.add_worker(worker, now=now)
        self.transitions.append(
            Transition(self.epoch, "join", worker, int(round), float(now)))
        return self.view()

    def leave(self, worker: int, round: int, now: float = 0.0
              ) -> MembershipView:
        """LEAVE: permanently retire a slot the detector declared dead; new
        epoch.  The slot is never dispatched again (no per-round
        re-exclusion); its monitor entry is removed with it.  The caller
        decides whether a spare replaces it (``take_spare`` + ``admit``)."""
        worker = int(worker)
        assert worker in self._members, f"worker {worker} not a member"
        self._members.discard(worker)
        self._left.add(worker)
        self.epoch += 1
        if self.monitor is not None:
            self.monitor.remove_worker(worker)
        self.transitions.append(
            Transition(self.epoch, "leave", worker, int(round), float(now)))
        return self.view()

    @property
    def departed(self) -> frozenset[int]:
        return frozenset(self._left)
