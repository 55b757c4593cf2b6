"""Typed master<->worker(<->worker) messages + endpoint naming (DESIGN.md §7).

Every in-flight unit of the cluster protocol is one of these frozen
dataclasses.  Payloads are deliberately ``Any``: the in-process simulation
carries lightweight references (the numeric work stays on-device in
core/protocol — see runner.py), while the multi-process socket transport
carries serialized arrays (wire.py) through the SAME message types —
EncodeShare ships the round's weight share W̃_i, WorkerResult ships the
worker's (d, c) field evaluation.

The MPC baseline (cluster/mpc_runner.py) adds worker<->worker traffic:
SubShare is one worker's degree-T re-share of its product share addressed
to one peer (the all-to-all round of BGW degree reduction), CombineResult
is the worker's post-barrier final share back to the master.  Keeping them
distinct from WorkerResult means the coded collect loop can never mistake
MPC traffic for CPML results.
"""
from __future__ import annotations

import dataclasses
from typing import Any

MASTER = "master"

# Control "rounds" for real worker processes (launch/cpml_worker.py): a
# provisioning EncodeShare carries the worker's coded dataset share + static
# round context before round 0; a shutdown EncodeShare ends the serve loop.
# Real rounds are >= 0, so neither can collide with training traffic.
PROVISION_ROUND = -1
SHUTDOWN_ROUND = -2


def worker_endpoint(worker: int) -> str:
    return f"worker/{worker}"


# The canonical per-(worker, round) dispatch payload the scheduler ships in
# one EncodeShare (runner.step_round): the round's weight share, this
# round's batch rows, and — when pipelining — the NEXT round's rows so the
# worker can pre-slice.  Wire v2 coalesces exactly this dict into a single
# compact ROUND frame (wire.py); any other payload shape (provisioning,
# shutdown, tests) rides the generic encoding unchanged.
ROUND_PAYLOAD_KEYS = ("w_share", "batch", "next_batch")


@dataclasses.dataclass(frozen=True)
class EncodeShare:
    """Master -> worker: round t's coded weight share (+ optional batch)."""
    round: int
    worker: int
    payload: Any = None          # weight-share ref / serialized W̃_i


@dataclasses.dataclass(frozen=True)
class WorkerResult:
    """Worker -> master: the worker's polynomial evaluation f(X̃_i, W̃_i).

    ``trace`` is the optional piggy-backed worker-side span list (DESIGN.md
    §11): ``[name, start, end]`` triples on the WORKER's monotonic clock
    (recv/compute/serialize/send phases).  It rides a v2-only wire frame —
    a v1 peer's serialization simply omits it, the same negotiation shape
    as HELLO2 — and is None unless the master asked for tracing at
    provisioning.
    """
    round: int
    worker: int
    compute_s: float             # simulated compute+network time this round
    payload: Any = None          # result ref / serialized (d, c) field array
    trace: Any = None            # worker-clock span triples (v2 wire only)


@dataclasses.dataclass(frozen=True)
class SubShare:
    """Worker src -> worker dst: one degree-T re-share of src's degree-2T
    product share, for BGW degree reduction ``phase`` of round ``round``.

    The all-to-all exchange of these is the wait-for-all barrier MPC pays
    per multiplication: every recipient needs ALL N sub-shares before it can
    Lagrange-combine, so one straggler stalls everyone (DESIGN.md §7).
    """
    round: int
    phase: int                   # which degree reduction of this round
    src: int
    dst: int
    payload: Any = None          # sub-share ref / serialized field array


@dataclasses.dataclass(frozen=True)
class CombineResult:
    """Worker -> master: the worker's final degree-2T gradient share, sent
    after the last reshare barrier of round ``round`` (the master
    reconstructs from the first 2T+1 of these)."""
    round: int
    worker: int
    compute_s: float             # worker-side compute time this round
    payload: Any = None          # result ref / serialized (d,) field array
    trace: Any = None            # worker-clock span triples incl. barrier
                                 # phases (v2 wire only, like WorkerResult)


@dataclasses.dataclass(frozen=True)
class Query:
    """Client -> master: one prediction request for the serving plane
    (cluster/serve.py).

    ``sent_at`` is the client-clock submission time — the open-loop load
    generator stamps the arrival schedule here, and every served latency
    (queue wait + batching + dispatch + decode) is measured from it.
    """
    qid: int
    client: str
    sent_at: float               # client submission time (latency epoch)
    x: Any = None                # (rows, d) feature block / serialized array


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Master -> client: the decoded logits answering one Query.

    Decoded at the first `deg_f*(K+T-1)+1` responders of the query's coded
    flush — exact Lagrange interpolation, so ``y`` is bit-identical to the
    uncoded plaintext evaluation regardless of WHICH workers responded.
    """
    qid: int
    client: str
    y: Any = None                # (rows, c) real logits
    latency_s: float = 0.0       # sent_at -> decode completion


@dataclasses.dataclass(frozen=True)
class Join:
    """Worker -> master: a late worker asks to enter the fleet (elastic
    membership, DESIGN.md §13).

    Sent right after the transport HELLO by a worker started with
    ``--join-at-round``: ``worker`` is the spare slot it answers for,
    ``at_round`` the first round fence it wants to be dispatched from.  The
    master stashes the request and admits the worker at the fence —
    provisioning its pre-encoded spare share, bumping the membership epoch,
    and broadcasting the new Epoch.  Wire v2 only: a v1 fleet has no JOIN
    frame and keeps fixed-fleet semantics bit-identically.
    """
    worker: int
    at_round: int
    sent_at: float = 0.0             # worker-clock request time


@dataclasses.dataclass(frozen=True)
class Epoch:
    """Master -> workers: the membership epoch changed (join/leave).

    Informational fan-out so workers can stamp their spans/metrics with the
    fleet generation they computed under; the master's own round math never
    depends on a worker having seen it (the epoch fence lives master-side).
    Wire v2 only — the master skips v1 peers, whose byte stream stays
    bit-identical to the fixed-fleet protocol.
    """
    epoch: int
    members: Any = None              # tuple of active slots (int32-able)
    round: int = 0                   # fence round the transition landed at


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """Worker -> master liveness ack, sent on receipt of an EncodeShare.

    Dead workers never ack; the HeartbeatMonitor's timeout turns silence
    into exclusion from the next round's dispatch set.
    """
    worker: int
    sent_at: float               # simulated send time
