"""Event-loop scheduler: round dispatch + first-T collect on either clock.

The scheduler owns the clock — simulated or wall, behind one ``Clock``
abstraction.  One round (DESIGN.md §7):

  1. DISPATCH  at clock t0: send an EncodeShare to every worker in the
     dispatch set.  With a ``latency`` model the scheduler also ENACTS the
     workers (the in-process simulation): each alive worker acks with a
     Heartbeat after a small network delay and sends its WorkerResult after
     its sampled latency (latency.py); dead workers (latency = inf) send
     nothing.  With ``latency=None`` the transport is real
     (socket_transport.py) and actual worker processes produce the replies.
  2. COLLECT   pop master deliveries in time order, advancing the clock to
     each arrival, until ``threshold`` results of THIS round are in (late
     results of earlier rounds still update the heartbeat monitor — a late
     reply proves the worker is alive, just slow).  On a wall clock
     "advancing" is a no-op: time already passed; the loop instead blocks
     on the transport's bounded poll until the round deadline.
  3. DECODE    the moment the threshold-th result lands the master decodes;
     the clock at that instant is the round's wait-for-fastest-T completion
     time.  ``t_all`` (when the LAST dispatched response would have landed)
     is what a wait-for-all master — or an MPC baseline that cannot treat
     stragglers as erasures — would have paid for the same round.  On a
     real transport that counterfactual is unobservable unless
     ``collect_all=True`` keeps the loop open until every dispatched worker
     responds (the straggler benchmark does exactly this).

The scheduler moves messages and time only; the gradient numerics stay in
core/protocol (see runner.py).

``run_mpc_round`` generalizes the single dispatch/collect phase to the
multi-phase rounds the BGW MPC baseline needs (DESIGN.md §7): dispatch ->
local multiply -> all-to-all reshare BARRIER (repeated once per degree
reduction) -> combine -> collect the first 2T+1 final shares.  The reshare
barrier is the structural difference the paper's comparison hinges on: a
recipient needs sub-shares from ALL N workers before it can combine, so
every reshare phase is gated on the slowest worker — stragglers cannot be
treated as erasures the way the coded decode treats them.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import time as _time
from typing import Any

import numpy as np

from repro_torch.cluster.latency import LatencyModel
from repro_torch.cluster.messages import (
    MASTER,
    CombineResult,
    EncodeShare,
    Heartbeat,
    Join,
    SubShare,
    WorkerResult,
    worker_endpoint,
)
from repro_torch.cluster.transport import InProcessTransport, Transport
from repro_torch.obs.trace import NULL_RECORDER


class ClusterDecodeError(RuntimeError):
    """Fewer than ``threshold`` results arrived within the round timeout —
    the coded decode is infeasible and recovery (checkpoint restore +
    worker reprovision) must take over."""


# ---------------------------------------------------------------------------
# Clock abstraction: simulated time is SET, wall time only OBSERVED
# ---------------------------------------------------------------------------

class Clock(abc.ABC):
    """``real`` mirrors Transport.real: a simulated clock is advanced by the
    scheduler to the transport's next delivery; a wall clock cannot be
    advanced at all — ``advance_to`` is a no-op and waiting happens inside
    the transport's bounded poll."""

    real: bool

    @abc.abstractmethod
    def now(self) -> float: ...

    @abc.abstractmethod
    def advance_to(self, t: float) -> None: ...


class SimClock(Clock):
    real = False

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, t)


class WallClock(Clock):
    real = True

    def now(self) -> float:
        return _time.monotonic()

    def advance_to(self, t: float) -> None:
        pass                        # wall time advances itself


@dataclasses.dataclass
class RoundTrace:
    """Everything the master observed about one round's timing."""
    round: int
    t_start: float
    dispatched: np.ndarray          # workers the share was sent to
    responders: np.ndarray          # arrival order (may exceed threshold on
                                    # ties at the decode instant)
    arrivals: dict[int, float]      # worker -> absolute arrival time
    latencies: dict[int, float]     # worker -> sampled/reported latency
                                    # (inf = dead)
    t_first_R: float                # clock at the threshold-th arrival
    t_all: float                    # when the slowest dispatched response
                                    # lands (inf if any worker is dead, or
                                    # unobservable on a real transport)
    payloads: dict[int, Any] = dataclasses.field(default_factory=dict)
                                    # worker -> WorkerResult payload (real
                                    # transports carry serialized arrays;
                                    # the simulation carries None)
    # master-side pipeline components (DESIGN.md §9), recorded NEXT TO the
    # wait so the benches can attribute where each round's time went:
    encode_s: float = 0.0           # encode time on the critical path
                                    # BEFORE dispatch (sim: the pre_s
                                    # charge; real: runner-measured wall)
    decode_s: float = 0.0           # decode+step time on the critical path
                                    # AFTER the threshold-th arrival (sim:
                                    # the post_s charge; real: measured)
    t_ready: float = math.nan       # clock when the updated weights were
                                    # ready (t_first_R + post charges; on a
                                    # real transport set by the runner
                                    # after the actual update)
    # wire accounting (real transports only; zeros on the simulation): the
    # delta of the transport's wire_totals() across this round's dispatch +
    # collect — bytes/frames enqueued to and decoded from ALL peers while
    # the round ran, so coalescing/packing wins show up per round
    tx_bytes: int = 0
    rx_bytes: int = 0
    tx_frames: int = 0
    rx_frames: int = 0
    # worker-shipped observability spans (DESIGN.md §11): worker ->
    # [name, start, end] triples on THAT worker's monotonic clock, present
    # only when the master asked for tracing and the peer speaks wire v2
    worker_traces: dict[int, Any] = dataclasses.field(default_factory=dict)

    @property
    def coded_wait_s(self) -> float:
        return self.t_first_R - self.t_start

    @property
    def all_wait_s(self) -> float:
        return self.t_all - self.t_start

    @property
    def critical_path_s(self) -> float:
        """Master-observed round cost: encode + wait-for-threshold + decode
        — the quantity pipelining shrinks (the wait is irreducible)."""
        return self.encode_s + self.coded_wait_s + self.decode_s


@dataclasses.dataclass
class MPCRoundTrace:
    """Everything the master observed about one multi-phase MPC round."""
    round: int
    t_start: float
    dispatched: np.ndarray
    responders: np.ndarray          # arrival order of final shares
    arrivals: dict[int, float]      # worker -> final-share arrival time
    latencies: dict[int, float]     # worker -> reported final-phase latency
    t_done: float                   # clock at the (2T+1)-th final share
                                    # (inf = starved round)
    t_all: float                    # when the LAST final share lands
                                    # (inf if any worker dead/stalled)
    barriers: list[float] = dataclasses.field(default_factory=list)
                                    # simulated reshare-barrier exit times
                                    # (unobservable master-side on a real
                                    # transport: empty)
    payloads: dict[int, Any] = dataclasses.field(default_factory=dict)
    worker_traces: dict[int, Any] = dataclasses.field(default_factory=dict)
                                    # worker-clock span triples incl. the
                                    # BGW barrier phases (wire v2 + tracing)

    @property
    def mpc_wait_s(self) -> float:
        return self.t_done - self.t_start

    @property
    def all_wait_s(self) -> float:
        return self.t_all - self.t_start


class EventScheduler:
    def __init__(self, n_workers, latency: LatencyModel | None = None,
                 transport: Transport | None = None,
                 heartbeat_delay_s: float = 1e-3,
                 master_overhead_s: float = 0.0,
                 recorder=None):
        # ``n_workers`` is an int (fixed fleet, the historical contract) or
        # a cluster.membership.ClusterMembership — then the fleet is ELASTIC
        # and every default worker set is read off the live membership at
        # dispatch time (the runner fences on a view() snapshot per round).
        if isinstance(n_workers, (int, np.integer)):
            self.membership = None
            self._n = int(n_workers)
        else:
            self.membership = n_workers
            self._n = None
        # JOIN (and any future control traffic) arrives on the same master
        # inbox as results; the collect loop stashes it here instead of
        # dropping it, and the runner drains the stash at each round fence.
        self.control_inbox: list[tuple[float, Any]] = []
        self.latency = latency
        self.transport = transport or InProcessTransport()
        self.heartbeat_delay_s = heartbeat_delay_s
        self.master_overhead_s = master_overhead_s
        # flight recorder (DESIGN.md §11): the default NullRecorder makes
        # every span call a constant no-op, so tracing costs nothing off
        self.obs = recorder if recorder is not None else NULL_RECORDER
        if self.transport.real:
            assert latency is None, (
                "a real transport's workers produce their own latencies; "
                "injected latency models are simulation-only")
            self.time: Clock = WallClock()
        else:
            assert latency is not None, (
                "the in-process simulation needs a latency model to enact "
                "its workers")
            self.time = SimClock()

    def bind_membership(self, membership) -> None:
        """Switch an int-constructed scheduler onto a live membership (the
        runner builds its ClusterMembership after the scheduler, because
        the membership needs the monitor and the monitor needs this
        scheduler's clock)."""
        self.membership = membership
        self._n = None

    @property
    def n(self) -> int:
        """Current fleet size (elastic: tracks the live membership)."""
        return self._n if self.membership is None else len(self.membership)

    def default_workers(self) -> np.ndarray:
        """The default dispatch set: all slots (fixed) or the current
        members (elastic).  Elastic callers normally pass an explicit set
        derived from their round's epoch snapshot instead."""
        if self.membership is None:
            return np.arange(self._n)
        return np.asarray(self.membership.view().members, dtype=np.int64)

    @property
    def clock(self) -> float:
        return self.time.now()

    def _deliver_to_master(self, now: float, round: int, monitor,
                           dispatched: set[int],
                           arrivals: dict[int, float],
                           latencies: dict[int, float],
                           responders: list[int],
                           payloads: dict[int, Any],
                           result_type: type = WorkerResult,
                           on_result=None,
                           worker_traces: dict[int, Any] | None = None
                           ) -> None:
        for at, msg in self.transport.recv(MASTER, now):
            if isinstance(msg, Heartbeat):
                if monitor is not None:
                    monitor.heartbeat(msg.worker, now=at)
            elif isinstance(msg, Join):
                # elastic membership: a late worker's JOIN rides the same
                # master inbox as results; stash it for the runner's next
                # round fence (dropping it would strand the joiner forever)
                self.control_inbox.append((at, msg))
            elif isinstance(msg, (WorkerResult, CombineResult)):
                if monitor is not None:
                    # late results of past rounds still count as liveness +
                    # latency evidence; only THIS round's feed the decode.
                    monitor.heartbeat(msg.worker, latency_s=msg.compute_s,
                                      now=at)
                # decode accepts only workers dispatched THIS attempt: after
                # a checkpoint restore, a stale result for the same round
                # number from the aborted attempt (or from a worker the
                # replay excluded) must not enter the responder trace.  The
                # result TYPE is part of the filter: a stale coded
                # WorkerResult can never enter an MPC round's trace.
                if (isinstance(msg, result_type) and msg.round == round
                        and msg.worker in dispatched
                        and msg.worker not in arrivals):
                    arrivals[msg.worker] = at
                    latencies[msg.worker] = msg.compute_s
                    responders.append(msg.worker)
                    payloads[msg.worker] = msg.payload
                    if (worker_traces is not None
                            and getattr(msg, "trace", None) is not None):
                        worker_traces[msg.worker] = msg.trace
                    if on_result is not None:
                        # streaming decode: fold this share into the
                        # reconstruction NOW, while later shares are still
                        # in flight (DESIGN.md §9)
                        on_result(msg.worker, msg.payload)

    def _presumed_dead(self, missing, monitor) -> bool:
        """True when the failure detector has declared EVERY missing worker
        dead (HeartbeatMonitor.is_dead: explicitly mark_failed, or
        heartbeat-silent beyond the monitor's finite timeout).  The collect
        loop's only legitimate way to stop waiting for absent workers on a
        real transport."""
        if monitor is None or not missing:
            return False
        now = self.time.now()
        return all(monitor.is_dead(w, now=now) for w in missing)

    def _collect(self, round: int, threshold: int, dispatched: set[int],
                 monitor, deadline: float, collect_all: bool,
                 result_type: type, on_result=None,
                 worker_traces: dict[int, Any] | None = None
                 ) -> tuple[dict[int, float],
                            dict[int, float], list[int],
                            dict[int, Any]]:
        """The master's event loop: pop deliveries in time order until
        ``threshold`` results of ``result_type`` for THIS round are in (and,
        under ``collect_all``, every dispatched worker has responded), or
        the deadline passes.  On a real transport the collect-ALL extension
        additionally ends when the heartbeat monitor declares every
        still-missing worker dead — a dead worker's silence would otherwise
        spin a deadline-less collect-all forever.  The dead-exit fires only
        AFTER the threshold is met: the decode wait itself is bounded by the
        deadline alone, so a heartbeat timeout shorter than a slow-but-
        healthy round (e.g. jit warmup) can never abandon a decodable round
        early."""
        arrivals: dict[int, float] = {}
        latencies: dict[int, float] = {}
        responders: list[int] = []
        payloads: dict[int, Any] = {}
        real = self.transport.real
        while (len(responders) < threshold
               or (collect_all and len(arrivals) < len(dispatched))):
            nxt = self.transport.next_delivery(MASTER)
            if nxt is None:
                if not real:
                    break              # sim queue drained: nothing will come
                if self.time.now() >= deadline:
                    break              # wall clock ran out: starved
                if (len(responders) >= threshold
                        and self._presumed_dead(
                            dispatched - arrivals.keys(), monitor)):
                    break              # decode done + all absentees dead:
                                       # wait-for-all is unobservable
                continue               # nothing YET: poll again
            if nxt > deadline:
                break
            self.time.advance_to(nxt)
            self._deliver_to_master(self.time.now(), round, monitor,
                                    dispatched, arrivals, latencies,
                                    responders, payloads, result_type,
                                    on_result, worker_traces)
        return arrivals, latencies, responders, payloads

    @staticmethod
    def _check_exitable(real: bool, collect_all: bool, timeout_s: float,
                        monitor) -> None:
        """A real-transport collect-all with no deadline AND no failure
        detector can never conclude a dead worker's response isn't coming —
        refuse up front instead of spinning forever."""
        if (real and collect_all and math.isinf(timeout_s)
                and (monitor is None or math.isinf(monitor.timeout_s))):
            raise ValueError(
                "collect_all on a real transport with timeout_s=inf needs a "
                "heartbeat monitor with a finite timeout: a dead worker's "
                "silence would spin the collect loop forever")

    def _send_round(self, round: int, workers: np.ndarray, t0: float,
                    payloads: dict[int, Any] | None
                    ) -> dict[int, float]:
        """Dispatch the EncodeShares; in simulation also enact the workers.

        Returns the sampled latencies (empty on a real transport — there the
        latencies are whatever the worker processes actually take)."""
        sampled: dict[int, float] = {}
        for w in workers:
            w = int(w)
            payload = None if payloads is None else payloads.get(w)
            if self.latency is None:
                # real transport: the worker process acks + replies itself
                self.transport.send(worker_endpoint(w),
                                    EncodeShare(round, w, payload), at=t0)
                continue
            # the (simulated) worker consumes its previous share when the
            # next one is dispatched — without this drain the per-worker
            # inboxes grow one EncodeShare per round forever.  The CURRENT
            # round's share stays queued and inspectable until then.
            self.transport.recv(worker_endpoint(w), t0)
            self.transport.send(worker_endpoint(w),
                                EncodeShare(round, w, payload), at=t0)
            lat = self.latency.sample(round, w)
            sampled[w] = lat
            if math.isfinite(lat):
                self.transport.send(MASTER, Heartbeat(w, t0), at=t0,
                                    delay=self.heartbeat_delay_s)
            # inf delay = the transport drops it: a dead worker's silence
            self.transport.send(MASTER, WorkerResult(round, w, lat),
                                at=t0, delay=lat)
        return sampled

    def dispatch_round(self, round: int, threshold: int,
                       workers: np.ndarray | None = None,
                       monitor=None,
                       timeout_s: float = math.inf,
                       payloads: dict[int, Any] | None = None,
                       collect_all: bool = False,
                       pre_s: float = 0.0, post_s: float = 0.0,
                       on_result=None) -> RoundTrace:
        """Run one round's event loop; returns the observed RoundTrace.

        Does NOT raise when fewer than ``threshold`` results arrive — the
        trace reports ``t_first_R = inf`` and the caller (runner.py) decides
        between failing and recovering.  ``payloads[w]`` rides in worker w's
        EncodeShare (real transports carry the serialized weight share).
        ``collect_all`` keeps collecting past the decode instant until every
        dispatched worker has responded (or the deadline passes) — the only
        way a real transport can observe the wait-for-all counterfactual.

        ``pre_s``/``post_s`` model master-side encode/decode time on a
        SIMULATED clock (DESIGN.md §9): pre_s advances the clock before
        dispatch (encode on the critical path), post_s after the decode
        instant.  On a wall clock both are no-ops — real master time passes
        by itself and the runner records the measured components on the
        trace.  ``on_result(worker, payload)`` fires at each accepted
        arrival of THIS round, in arrival order — the streaming decoder's
        fold point.
        """
        workers = (self.default_workers() if workers is None
                   else np.asarray(workers))
        real = self.transport.real
        self._check_exitable(real, collect_all, timeout_s, monitor)
        if pre_s:
            self.time.advance_to(self.time.now() + pre_s)
        wire0 = (self.transport.wire_totals()
                 if hasattr(self.transport, "wire_totals") else None)
        t0 = self.time.now()
        with self.obs.span("dispatch", round=round, workers=len(workers)):
            sampled = self._send_round(round, workers, t0, payloads)

        dispatched = {int(w) for w in workers}
        deadline = t0 + timeout_s
        worker_traces: dict[int, Any] = {}
        with self.obs.span("collect", round=round):
            arrivals, latencies, responders, round_payloads = self._collect(
                round, threshold, dispatched, monitor, deadline,
                collect_all=collect_all, result_type=WorkerResult,
                on_result=on_result, worker_traces=worker_traces)
        if self.obs.enabled:
            # per-worker flight lanes in the MASTER clock domain: dispatch
            # instant -> result arrival.  This is the cross-worker surface a
            # straggler shows up on (worker-shipped spans ride their own
            # clocks and are never compared across processes, §11).
            for w, at in sorted(arrivals.items()):
                self.obs.add_span("flight", t0, at, track=f"worker/{w}",
                                  round=round, worker=w,
                                  compute_s=latencies.get(w))

        got_R = len(responders) >= threshold
        # the decode instant is the threshold-th ARRIVAL, which (under
        # collect_all) the clock may have moved past by loop exit.
        t_first_R = arrivals[responders[threshold - 1]] if got_R else math.inf
        if real:
            t_all = (max(arrivals.values())
                     if arrivals and len(arrivals) == len(dispatched)
                     else math.inf)
        else:
            t_all = t0 + max(sampled.values(), default=0.0)
        t_ready = math.inf
        if got_R:
            self.time.advance_to(self.time.now() + self.master_overhead_s
                                 + post_s)
            t_ready = (self.time.now() if not real
                       else math.nan)     # real: runner stamps after update
        elif not real:
            self._park_starved(t0, deadline, t_all, monitor)
        wire_d = {}
        if wire0 is not None:
            wire1 = self.transport.wire_totals()
            wire_d = {k: wire1[k] - wire0[k] for k in wire0}
        return RoundTrace(
            round=round, t_start=t0, dispatched=workers,
            responders=np.asarray(responders, dtype=np.int64),
            arrivals=arrivals, latencies=latencies,
            t_first_R=t_first_R, t_all=t_all, payloads=round_payloads,
            encode_s=pre_s, decode_s=post_s, t_ready=t_ready,
            worker_traces=worker_traces, **wire_d)

    # ------------------------------------------------------------------
    # Multi-phase MPC rounds (DESIGN.md §7: "MPC on the cluster runtime")
    # ------------------------------------------------------------------

    def run_mpc_round(self, round: int, collect_threshold: int,
                      phase_models: list[LatencyModel] | None = None,
                      workers: np.ndarray | None = None,
                      monitor=None,
                      timeout_s: float = math.inf,
                      payloads: dict[int, Any] | None = None
                      ) -> MPCRoundTrace:
        """One BGW iteration's message flow: dispatch -> (local multiply ->
        all-to-all reshare barrier -> combine) x n_reductions -> collect the
        first ``collect_threshold`` (= 2T+1) final shares.

        In simulation ``phase_models`` (length n_reductions + 1: one per
        reshare phase plus the final send) enacts the workers: phase j's
        sample covers worker w's compute+network for that phase, its
        SubShares reach every peer at ``start + lat``, and NO worker enters
        phase j+1 before the slowest finishes phase j — sub-shares from all
        N workers are needed to combine, so the barrier exit is
        ``max_w(start_w + lat_w)``.  A dead worker (inf) makes the barrier
        — and the whole round — never complete: BGW cannot treat stragglers
        as erasures.  On a real transport (``latency=None``) the worker
        processes run the phases themselves (launch/cpml_worker.py, MPC
        serve mode) and the reshare traffic relays through the master's
        transport; only dispatch + final collect are enacted here.
        """
        workers = (self.default_workers() if workers is None
                   else np.asarray(workers))
        t0 = self.time.now()
        dispatched = {int(w) for w in workers}
        barriers: list[float] = []
        with self.obs.span("dispatch", round=round, workers=len(workers)):
            if self.latency is None:                  # real worker processes
                assert phase_models is None, (
                    "a real transport's workers pace their own phases")
                for w in workers:
                    w = int(w)
                    payload = None if payloads is None else payloads.get(w)
                    self.transport.send(worker_endpoint(w),
                                        EncodeShare(round, w, payload),
                                        at=t0)
                sampled: dict[int, float] = {}
            else:
                assert phase_models, (
                    "the in-process simulation needs one latency model per "
                    "reshare phase plus the final send")
                sampled = self._enact_mpc_phases(round, workers, t0,
                                                 phase_models, barriers,
                                                 payloads)
        if self.obs.enabled and barriers:
            # simulated reshare barriers become spans: the wait-for-ALL
            # structure the showdown hinges on, visible per phase.  (On a
            # real transport the master cannot observe the barriers — the
            # workers ship their own barrier spans over the wire instead.)
            prev = t0
            for j, b in enumerate(barriers):
                if math.isfinite(b):
                    self.obs.add_span("barrier", prev, b, round=round,
                                      phase=j)
                    prev = b

        deadline = t0 + timeout_s
        worker_traces: dict[int, Any] = {}
        with self.obs.span("collect", round=round):
            arrivals, latencies, responders, round_payloads = self._collect(
                round, collect_threshold, dispatched, monitor, deadline,
                collect_all=False, result_type=CombineResult,
                worker_traces=worker_traces)
        if self.obs.enabled:
            for w, at in sorted(arrivals.items()):
                self.obs.add_span("flight", t0, at, track=f"worker/{w}",
                                  round=round, worker=w,
                                  compute_s=latencies.get(w))

        got = len(responders) >= collect_threshold
        t_done = (arrivals[responders[collect_threshold - 1]] if got
                  else math.inf)
        if self.transport.real:
            t_all = (max(arrivals.values())
                     if arrivals and len(arrivals) == len(dispatched)
                     else math.inf)
        else:
            t_all = max(sampled.values(), default=math.inf)
        if got:
            self.time.advance_to(self.time.now() + self.master_overhead_s)
        elif not self.transport.real:
            self._park_starved(t0, deadline, t_all, monitor)
        return MPCRoundTrace(
            round=round, t_start=t0, dispatched=workers,
            responders=np.asarray(responders, dtype=np.int64),
            arrivals=arrivals, latencies=latencies,
            t_done=t_done, t_all=t_all, barriers=barriers,
            payloads=round_payloads, worker_traces=worker_traces)

    def _enact_mpc_phases(self, round: int, workers: np.ndarray, t0: float,
                          phase_models: list[LatencyModel],
                          barriers: list[float],
                          payloads: dict[int, Any] | None
                          ) -> dict[int, float]:
        """Simulate the workers through dispatch, every reshare barrier, and
        the final send; returns each worker's final-share landing time."""
        idx = [int(w) for w in workers]
        for w in idx:
            # drain the previous round's share (bounded inboxes), then
            # dispatch; alive workers ack with a heartbeat.  sample() is
            # order-independent, so re-reading phase 0's draw is free.
            payload = None if payloads is None else payloads.get(w)
            self.transport.recv(worker_endpoint(w), t0)
            self.transport.send(worker_endpoint(w),
                                EncodeShare(round, w, payload), at=t0)
            if math.isfinite(phase_models[0].sample(round, w)):
                self.transport.send(MASTER, Heartbeat(w, t0), at=t0,
                                    delay=self.heartbeat_delay_s)
        start = {w: t0 for w in idx}
        for j, model in enumerate(phase_models[:-1]):
            done = {}
            for w in idx:
                lat = model.sample(round, w)
                done[w] = start[w] + lat
                for v in idx:       # all-to-all: sub-share to every peer
                    self.transport.send(worker_endpoint(v),
                                        SubShare(round, j, w, v),
                                        at=start[w], delay=lat)
            barrier = max(done.values())
            barriers.append(barrier)
            for v in idx:           # sub-shares are consumed at the barrier
                self.transport.recv(
                    worker_endpoint(v),
                    barrier if math.isfinite(barrier) else math.inf)
            start = {w: barrier for w in idx}
        sampled = {}
        final = phase_models[-1]
        for w in idx:
            lat = final.sample(round, w)
            sampled[w] = start[w] + lat
            self.transport.send(MASTER, CombineResult(round, w, lat),
                                at=start[w], delay=lat)
        return sampled

    def _park_starved(self, t0: float, deadline: float, t_all: float,
                      monitor) -> None:
        """Starved round in simulation: park the clock at the moment the
        master gave up waiting, so downstream heartbeat-timeout/recovery
        logic sees the time the wait actually consumed.

        With a finite deadline that is min(deadline, t_all).  With an
        infinite deadline the master's patience is unbounded and only a
        failure detector can end the wait: park at the instant the
        monitor's (finite) heartbeat timeout declares this round's silent
        workers dead.  With neither bound the wait is unsimulatable — the
        clock stays at the last delivery (pinned in tests; callers that
        want recovery semantics must supply a finite timeout or monitor).
        """
        give_up = min(deadline, t_all)
        if (not math.isfinite(give_up) and monitor is not None
                and math.isfinite(monitor.timeout_s)):
            give_up = t0 + monitor.timeout_s
        if math.isfinite(give_up):
            self.time.advance_to(give_up)
