"""ClusterRunner: coded training driven by the cluster runtime, on torch.

Mirrors ``repro/cluster/runner.py``.  The scheduler
moves messages and time; all gradient numerics run through the round and
update hooks that ``engine.train``/``train_reference`` use, with the
decode matrix and responder order observed from the runtime.  In the
in-process simulation the whole round is ``engine.round_fn`` on the
master (one ``coded_grad`` launch for all N workers on the card); over
the socket transport real worker processes (launch/cpml_worker.py)
evaluate f(X̃_i, W̃_i) and their deserialized payloads feed
``engine.update_fn``.  Either way a run is bit-identical to
``engine.train_reference`` replaying the same responder trace with the
same draws.

Differences from the reference:

  * randomness comes from a draws object (core/protocol/draws.py): the
    reference's ``jax.random.split(key)`` into setup and loop keys becomes
    ``draws.dataset_masks`` / ``draws.round(t, ...)`` / ``draws.batch(t,
    ...)``.  ``TorchDraws(0, device)`` by default;
  * every device tensor (dataset shares, weights, the prefetched mask
    shares) lives on the runner's device; what goes on the wire is numpy;
  * the prefetch thread launches ``modmatmul`` on the consumer's CUDA
    stream and records an event on it that the consumer waits on before
    it reads the context;
  * ``close()`` (called by ``shutdown_workers``) stops the master
    group's executors.

``masters > 1`` builds a ``MasterGroup`` (cluster/master_group.py): S
logical masters each own a contiguous d-slice of the dataset encode at
setup and, on the socket path, of each round's weight encode (whole or
split) and streaming decode; bit-identical to one master, since every draw
is made at full shape.  ``wait_stats()["masters"]`` holds the group's
per-master seconds (an encode on the card from CUDA events, on the CPU
and every fold in per-thread CPU seconds) and critical path.

``engine="alcc"`` swaps in ``protocol/alcc_engine``: real-valued Lagrange
coding with Gaussian masks and a least-squares decode.  Weight shares and
results are float32 (wire v2 frames), the decode hooks take the responder
ORDER (rows picked by the decode's conditioning), and every decode's
condition number, error budget and fallback flag go to
``wait_stats()["alcc"]``, the ``cpml_alcc_*`` metrics and ``alcc_decode``
trace instants.  A simulated ALCC run is bit-identical to
``alcc_engine.train_reference`` on the same device; a socket run agrees
within the decode error budget.  Pipelining, spares and joins are
exact-engine only and refused (``ValueError``).

Resilience (runtime/resilience.py): results and acks feed a
HeartbeatMonitor on the scheduler's clock; dead workers drop out of
dispatch, and known stragglers are speculatively excluded while the fast
set strictly exceeds the recovery threshold.  ``run_resilient``
checkpoints the weights (checkpoint/manager.py) and, on a starved round,
restores, revives or respawns the dead workers and replays; round t's
draws depend on t alone (draws.py), so a replay re-derives the same
masks and batches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time as _time
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.cluster.latency import LatencyModel
from repro_torch.cluster.master_group import MasterGroup
from repro_torch.cluster.membership import ClusterMembership, MembershipView
from repro_torch.cluster.messages import (
    MASTER,
    PROVISION_ROUND,
    SHUTDOWN_ROUND,
    EncodeShare,
    Epoch,
    Heartbeat,
    Join,
    worker_endpoint,
)
from repro_torch.cluster.pipeline import (PIPELINE_MODES, RoundContext,
                                          RoundPrefetcher)
from repro_torch.cluster.scheduler import (ClusterDecodeError, EventScheduler,
                                           RoundTrace)
from repro_torch.cluster.transport import Transport
from repro_torch.cluster.wire import WIRE_V2
from repro_torch.core.protocol import alcc_engine, decode
from repro_torch.core.protocol import engine as _eng
from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.core.protocol.draws import TorchALCCDraws, TorchDraws
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.resilience import HeartbeatMonitor, ResilientLoop


def wait_summary(a) -> dict[str, float]:
    """mean/p50/p95/total of a wait-time series; an empty series gives a
    well-formed all-zero summary (no NaN from a mean over nothing)."""
    a = np.asarray(a, dtype=float)
    if a.size == 0:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "total": 0.0}
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)), "total": float(a.sum())}


def await_worker_acks(transport: Transport, clock_fn, expect,
                      monitor, timeout_s: float,
                      control: list | None = None) -> None:
    """Block until every worker in ``expect`` (an int n for workers
    0..n-1, or a set of slots) has acked provisioning with a Heartbeat.
    ``control`` collects JOIN frames drained off the master inbox here.

    No round is dispatched until the last ack, so an early acker is silent
    for the rest of the barrier by the master's doing: every acked worker
    is stamped live at the barrier's end, or with a heartbeat timeout
    shorter than the acks' spread the first fence would retire it."""
    expect = (set(range(expect)) if isinstance(expect, int)
              else {int(w) for w in expect})
    deadline = clock_fn() + timeout_s
    acked: set[int] = set()
    while not expect <= acked:
        nxt = transport.next_delivery(MASTER)
        if nxt is None:
            if clock_fn() >= deadline:
                raise TimeoutError(
                    f"workers never acked provisioning: "
                    f"{sorted(expect - acked)}")
            continue
        for at, msg in transport.recv(MASTER, nxt):
            if isinstance(msg, Heartbeat):
                if monitor is not None:
                    monitor.heartbeat(msg.worker, now=at)
                acked.add(msg.worker)
            elif isinstance(msg, Join) and control is not None:
                control.append((at, msg))
    if monitor is not None:
        now = clock_fn()
        for w in acked:
            monitor.heartbeat(w, now=now)


@dataclasses.dataclass
class RoundRecord:
    """Per-round outcome: a thin view over the scheduler's RoundTrace plus
    what the runner decided (decode order, replay/pipeline flags)."""
    round: int
    trace: RoundTrace            # the single timing source for this round
    survivors: np.ndarray        # decode order used (first `threshold`)
    replayed: bool = False       # True when re-run after a restore
    prefetched: bool = False     # W-independent half built ahead of time
    streamed: bool = False       # decode was the incremental fold (hit)

    @property
    def n_responders(self) -> int:
        return len(self.trace.responders)

    @property
    def dispatched(self) -> np.ndarray:
        return self.trace.dispatched

    @property
    def coded_wait_s(self) -> float:         # wait-for-fastest-T
        return self.trace.coded_wait_s

    @property
    def all_wait_s(self) -> float:           # wait-for-all (inf = dead)
        return self.trace.all_wait_s

    @property
    def encode_s(self) -> float:
        return self.trace.encode_s

    @property
    def decode_s(self) -> float:
        return self.trace.decode_s

    @property
    def tx_bytes(self) -> int:
        return self.trace.tx_bytes

    @property
    def rx_bytes(self) -> int:
        return self.trace.rx_bytes

    @property
    def tx_frames(self) -> int:
        return self.trace.tx_frames

    @property
    def rx_frames(self) -> int:
        return self.trace.rx_frames

    @property
    def critical_path_s(self) -> float:
        return self.trace.critical_path_s


class ClusterRunner:
    """Drives ``iters`` protocol rounds through the event scheduler.

    ``latency`` given: in-process simulation, the whole round computed on
    the master with the observed responder order.  ``latency=None`` and a
    real transport: worker processes compute, the runner encodes and ships
    each round's weight shares, decodes the first ``threshold`` payloads
    and the wall clock replaces the simulated one; ``provision()`` runs
    once before the rounds.

    ``pipeline``: ``"off"`` (sequential), ``"prefetch"`` (a thread builds
    round t+1's draws, mask shares, batch and decode plan while round t is
    in flight), ``"streaming"`` (the host folds each result into the
    decode as it arrives), ``"full"`` (both).  Every mode is bit-identical
    to ``"off"``.  In simulation the overlap is modeled by scaling
    ``encode_cost_s``/``decode_cost_s`` as the reference does.

    ``x``, ``y`` are numpy arrays or tensors; they go to ``device``
    (``None`` means CUDA, ``repro_torch.device.resolve``).  ``engine``:
    ``"exact"`` (``cfg`` a CPMLConfig) or ``"alcc"`` (an ALCCConfig; see
    the module docstring).
    """

    def __init__(self, cfg, x, y,
                 latency: LatencyModel | None = None, *,
                 draws=None,
                 device: str | torch.device | None = None,
                 eta: float | None = None,
                 transport: Transport | None = None,
                 round_timeout_s: float = math.inf,
                 heartbeat_timeout_s: float = math.inf,
                 straggler_factor: float = 3.0,
                 master_overhead_s: float = 0.0,
                 exclude_stragglers: bool = True,
                 collect_all: bool = False,
                 pipeline: str = "off",
                 encode_cost_s: float = 0.0,
                 decode_cost_s: float = 0.0,
                 recorder=None,
                 metrics: MetricsRegistry | None = None,
                 spares: int = 0,
                 masters: int = 1,
                 join_schedule: dict[int, int] | None = None,
                 engine: str = "exact"):
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"pipeline={pipeline!r} not in {PIPELINE_MODES}")
        if engine not in ("exact", "alcc"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "alcc":
            # the float engine keeps the round loop, not the exact-only
            # machinery: pipelining splits a field matmul, and the sharded
            # master and spare points rely on bit-identical re-encode
            if pipeline != "off":
                raise ValueError("pipeline modes are exact-engine only")
            if masters != 1 or spares or join_schedule:
                raise ValueError("sharded masters / elastic membership are "
                                 "exact-engine only")
        self.engine_name = engine
        self.eng = alcc_engine if engine == "alcc" else _eng
        self.device = _device.resolve(device)
        if draws is None:
            draws = (TorchALCCDraws if engine == "alcc"
                     else TorchDraws)(0, self.device)
        self.draws = draws
        # Elastic membership: ``spares`` extra Lagrange evaluation points
        # are encoded up front; the points are consecutive, so shares
        # 0..N-1 and every decode over them equal the fixed-N scheme's.
        self.base_n = cfg.N
        if spares:
            cfg = dataclasses.replace(cfg, N=cfg.N + spares)
        self.cfg = cfg
        self.elastic = spares > 0 or bool(join_schedule)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        # Sharded master group: S > 1 splits the master's dataset encode
        # and, on the socket path, each round's encode and streaming decode
        # over contiguous d-slices (bit-identical: randomness at full
        # shape).  In simulation the round runs on the device as one
        # engine round, where the group has nothing to shard.
        self.masters = int(masters)
        self.master_group = (MasterGroup(cfg, self.masters)
                             if self.masters > 1 else None)
        kw = ({} if self.master_group is None else
              {"dataset_encoder": self.master_group.encode_dataset})
        self.state = self.eng.setup(cfg, x, y, draws=self.draws, **kw)
        self.eta = (self.eng.lipschitz_eta(self.state.xq_real)
                    if eta is None else float(eta))
        if engine == "alcc":
            # every least-squares decode appends its conditioning info here
            self.alcc_info: list[dict] | None = []
            self._round = alcc_engine.round_fn(cfg, self.state, self.eta,
                                               self.draws,
                                               info_sink=self.alcc_info)
            self._update = alcc_engine.update_fn(cfg, self.state, self.eta,
                                                 info_sink=self.alcc_info)
        else:
            self.alcc_info = None
            self._round = _eng.round_fn(cfg, self.state, self.eta,
                                        self.draws)
            self._update = _eng.update_fn(cfg, self.state, self.eta)
        self._round_split = self.eng.round_fn_split(cfg, self.state, self.eta)
        self._update_parts = self.eng.update_from_parts_fn(cfg, self.state,
                                                           self.eta)
        # the stream every launch of this run goes to, the prefetch
        # thread's included (pipeline.py)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.pipeline = pipeline
        self.encode_cost_s = encode_cost_s
        self.decode_cost_s = decode_cost_s
        self._w_shape = (x.shape[1], cfg.c)       # internal w2 shape
        self._prefetcher: RoundPrefetcher | None = None
        self._last_order: np.ndarray | None = None    # prediction source
        self.latency = latency
        self.round_timeout_s = round_timeout_s
        self.exclude_stragglers = exclude_stragglers
        self.collect_all = collect_all
        self.scheduler = EventScheduler(cfg.N, latency, transport,
                                        master_overhead_s=master_overhead_s,
                                        recorder=recorder)
        self.obs = self.scheduler.obs
        self.obs.bind_clock(self.scheduler.time.now)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._init_metrics()
        if self.distributed and math.isinf(round_timeout_s):
            # a real cluster must be able to give up on silence
            self.round_timeout_s = 300.0
        self.monitor = HeartbeatMonitor(self.base_n,
                                        timeout_s=heartbeat_timeout_s,
                                        straggler_factor=straggler_factor,
                                        now=self.scheduler.clock)
        self.membership = ClusterMembership(
            range(self.base_n), monitor=self.monitor,
            spares=range(self.base_n, cfg.N))
        self.scheduler.bind_membership(self.membership)
        for w, at_round in (join_schedule or {}).items():
            self.membership.schedule_join(w, at_round)
        self.w2 = self.eng._w_internal(cfg, self.state.w)
        self.records: dict[int, RoundRecord] = {}
        self.traces: dict[int, RoundTrace] = {}
        self.restarts = 0

    @property
    def distributed(self) -> bool:
        """True when real worker processes compute (socket transport)."""
        return self.latency is None

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def _init_metrics(self) -> None:
        m = self.metrics
        self._m_rounds = m.counter(
            "cpml_rounds_total", "completed training rounds")
        self._m_starved = m.counter(
            "cpml_starved_rounds_total",
            "rounds with fewer than threshold responses in the timeout")
        self._m_excluded = m.counter(
            "cpml_straggler_exclusions_total",
            "worker-rounds speculatively excluded from dispatch")
        self._m_marked_dead = m.counter(
            "cpml_heartbeat_misses_total",
            "workers marked dead after round-timeout silence")
        self._m_prefetch = m.counter(
            "cpml_prefetch_hits_total",
            "rounds served from a prefetched W-independent context")
        self._m_folds = m.counter(
            "cpml_stream_folds_total", "eager streaming-decoder folds")
        self._m_streamed = m.counter(
            "cpml_streamed_rounds_total",
            "rounds decoded by the incremental fold (prediction hits)")
        self._m_tx = m.counter(
            "cpml_wire_tx_bytes_total", "wire bytes enqueued during rounds")
        self._m_rx = m.counter(
            "cpml_wire_rx_bytes_total", "wire bytes received during rounds")
        self._m_wait = m.histogram(
            "cpml_round_wait_seconds",
            "dispatch to threshold-th arrival, per round")
        self._m_cp = m.histogram(
            "cpml_round_critical_path_seconds",
            "encode + wait + decode, per round")
        self._m_alive = m.gauge(
            "cpml_workers_alive", "dispatchable workers at last round")
        self._m_epoch = m.gauge(
            "cpml_epoch", "membership epoch at the last round fence")
        self._m_members = m.gauge(
            "cpml_members_alive", "member slots at the last round fence")
        self._m_joins = m.counter(
            "cpml_member_joins_total", "workers admitted mid-run")
        self._m_leaves = m.counter(
            "cpml_member_leaves_total", "members permanently retired")
        # the reference's name, so one dashboard reads both packages; here
        # it is the worker's warm-up round (kernel load, CUDA init)
        self._m_warm = m.gauge(
            "cpml_xla_warm_compile_seconds",
            "max worker-reported warm-up wall before its provisioning ack "
            "(needs tracing + v2 wire)")
        if self.engine_name == "alcc":
            self._m_alcc_cond = m.gauge(
                "cpml_alcc_decode_cond",
                "condition number of the last round's least-squares decode")
            self._m_alcc_budget = m.gauge(
                "cpml_alcc_error_budget",
                "a-priori absolute decode-error bound of the last round "
                "(cond * eps32 * max|evaluation|)")
            self._m_alcc_fallback = m.counter(
                "cpml_alcc_decode_fallbacks_total",
                "rounds decoded by the overdetermined all-responder "
                "fallback (square system over cond_max)")

    def _observe_round(self, t: int, trace: RoundTrace,
                       rec: RoundRecord) -> None:
        """Emit the round's derived spans and update the metrics, from the
        same RoundTrace fields ``wait_stats`` aggregates."""
        obs = self.obs
        if obs.enabled:
            if trace.encode_s > 0:
                obs.add_span("encode", trace.t_start - trace.encode_s,
                             trace.t_start, round=t)
            obs.add_span("wait", trace.t_start, trace.t_first_R, round=t,
                         responders=rec.n_responders)
            t_ready = trace.t_ready
            if math.isfinite(t_ready) and trace.decode_s > 0:
                obs.add_span("decode", t_ready - trace.decode_s, t_ready,
                             round=t, streamed=rec.streamed)
            for w, spans in trace.worker_traces.items():
                obs.add_process_spans(f"worker{int(w)}", spans, round=t)
        self._m_rounds.inc()
        if self.alcc_info:
            # the decode that just ran appended its conditioning info
            info = self.alcc_info[-1]
            self._m_alcc_cond.set(float(info["cond"]))
            self._m_alcc_budget.set(float(info["abs_err_budget"]))
            if info["fallback"]:
                self._m_alcc_fallback.inc()
            self.obs.instant("alcc_decode", round=t,
                             cond=float(info["cond"]),
                             err_budget=float(info["abs_err_budget"]),
                             fallback=bool(info["fallback"]))
        if rec.prefetched:
            self._m_prefetch.inc()
        if rec.streamed:
            self._m_streamed.inc()
        self._m_tx.inc(trace.tx_bytes)
        self._m_rx.inc(trace.rx_bytes)
        self._m_wait.observe(trace.coded_wait_s)
        self._m_cp.observe(trace.critical_path_s)
        self._m_alive.set(len(self._alive(self.scheduler.clock)))
        for spans in trace.worker_traces.values():
            for item in spans:
                if item and item[0] == "warm_compile" and len(item) == 3:
                    self._m_warm.set(max(self._m_warm.value,
                                         float(item[2]) - float(item[1])))

    # ------------------------------------------------------------------
    # Pipeline plumbing
    # ------------------------------------------------------------------

    @property
    def prefetching(self) -> bool:
        return self.pipeline in ("prefetch", "full")

    @property
    def streaming(self) -> bool:
        return self.pipeline in ("streaming", "full")

    def _predicted_order(self) -> np.ndarray | None:
        """Next round's responder order forecast: last round's arrivals.
        Read racily by the prefetch thread; a stale forecast costs a
        fallback decode, never a wrong one."""
        return self._last_order

    def _batch(self, t: int) -> torch.Tensor:
        """Round t's coded sub-batch indices, int64 on the runner's device."""
        return torch.as_tensor(
            self.draws.batch(t, self.state.mk, self.cfg.batch_rows),
            dtype=torch.int64, device=self.device)

    def _build_ctx(self, t: int, iters: int) -> RoundContext:
        """Round t's W-independent context (runs on the prefetch thread).

        Its launches go to the runner's stream, and ``ready`` is an event
        recorded there after the last of them: the consumer waits on it
        before it reads the context (``_take_ctx``)."""
        cfg = self.cfg
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with stream:
            u, mask_shares = _eng.round_mask_context(cfg, self.draws, t,
                                                       self._w_shape)
            bidx = next_np = None
            if cfg.batch_rows is not None:
                bidx = self._batch(t)
                if self.distributed and t + 1 < iters:
                    # round t+1's indices ride in round t's dispatch so the
                    # workers pre-slice their coded sub-batch while idle
                    next_np = self._batch(t + 1).cpu().numpy().astype(
                        np.int32)
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(self._stream)
        plan = (decode.prefix_decode_plan(cfg, self._predicted_order())
                if self.streaming else None)
        return RoundContext(t=t, kq=u, mask_shares=mask_shares,
                            batch_idx=bidx, plan=plan, next_batch=next_np,
                            epoch=self.membership.epoch, ready=ready)

    def _take_ctx(self, t: int) -> RoundContext | None:
        if self._prefetcher is None:
            return None
        ctx = self._prefetcher.get(t)
        if ctx.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ctx.ready)
        return ctx

    def _pipeline_scope(self, iters: int):
        """Context manager owning the prefetch thread for one training run."""
        if not self.prefetching:
            return contextlib.nullcontext()
        self._prefetcher = RoundPrefetcher(
            lambda t: self._build_ctx(t, iters), start=0, stop=iters,
            recorder=self.obs)

        @contextlib.contextmanager
        def scope():
            try:
                yield
            finally:
                self._prefetcher.close()
                self._prefetcher = None

        return scope()

    def _sim_charges(self) -> tuple[float, float]:
        """(pre_s, post_s) master-side charges for the SimClock, scaled by
        what the active pipeline mode hides."""
        cfg = self.cfg
        pre = self.encode_cost_s
        if self.prefetching:
            pre *= cfg.K / (cfg.K + cfg.T)    # mask rows precomputed
        post = self.decode_cost_s
        if self.streaming:
            post /= cfg.threshold             # one fold left after arrival
        return pre, post

    # ------------------------------------------------------------------
    # Distributed-mode provisioning
    # ------------------------------------------------------------------

    def provision(self, workers=None, timeout_s: float = 60.0) -> None:
        """Ship each worker its coded dataset share and the static round
        context as an EncodeShare with ``round == PROVISION_ROUND``; wait
        until every one of them acked with a Heartbeat (sent after its
        warm-up round).  ``workers=None`` provisions the current members."""
        if not self.distributed:
            raise RuntimeError("provision() is for real transports only")
        if workers is None:
            workers = list(self.membership.view().members)
        workers = [int(w) for w in workers]
        wall0 = _time.perf_counter()
        with self.obs.span("provision", workers=len(workers)):
            tr = self.scheduler.transport
            x_shares = self.state.x_shares.cpu().numpy()
            cbar = self.eng.poly_coeffs(self.cfg)
            cfg_kw = {"N": self.cfg.N, "K": self.cfg.K, "T": self.cfg.T,
                      "r": self.cfg.r, "c": self.cfg.c,
                      "batch_rows": self.cfg.batch_rows}
            if self.engine_name == "alcc":
                cfg_kw["sigma"] = self.cfg.sigma
            else:
                cfg_kw.update(lx=self.cfg.lx, lw=self.cfg.lw, lc=self.cfg.lc,
                              p=self.cfg.p)
            now = self.scheduler.clock
            for w in workers:
                payload = {"cfg": cfg_kw, "x_share": x_shares[w],
                           "cbar": cbar, "trace": bool(self.obs.enabled)}
                if self.engine_name == "alcc":
                    # the worker picks its float round off this marker
                    payload["protocol"] = "alcc"
                tr.send(worker_endpoint(w),
                        EncodeShare(PROVISION_ROUND, w, payload), at=now)
            await_worker_acks(tr, lambda: self.scheduler.clock, set(workers),
                              self.monitor, timeout_s,
                              control=self.scheduler.control_inbox)
        self.metrics.gauge(
            "cpml_provision_seconds",
            "wall seconds from provisioning dispatch to the last worker "
            "ack (includes the workers' warm-up)").set(
                _time.perf_counter() - wall0)

    def shutdown_workers(self) -> None:
        """Ask every live member's process to exit its serve loop."""
        if not self.distributed:
            raise RuntimeError("shutdown_workers() is for real transports")
        now = self.scheduler.clock
        for w in self.membership.view().members:
            self.scheduler.transport.send(
                worker_endpoint(w), EncodeShare(SHUTDOWN_ROUND, w), at=now)
        self.close()

    def close(self) -> None:
        """Stop the master group's executors (nothing to stop with one
        master); ``wait_stats`` still reads the group's seconds after."""
        if self.master_group is not None:
            self.master_group.close()

    # ------------------------------------------------------------------
    # Elastic membership: the per-round epoch fence
    # ------------------------------------------------------------------

    def _broadcast_epoch(self, view: MembershipView, t: int) -> None:
        """Fan the new epoch out to the live v2 members (informational)."""
        if not self.distributed:
            return
        tr = self.scheduler.transport
        peer_version = getattr(tr, "peer_version", None)
        now = self.scheduler.clock
        for w in view.members:
            ep = worker_endpoint(w)
            if peer_version is not None and peer_version(ep) < WIRE_V2:
                continue
            tr.send(ep, Epoch(view.epoch, view.members, t), at=now)

    def _admit(self, worker: int, t: int) -> None:
        """Admit one slot at the fence; distributed mode provisions the
        joiner's pre-encoded spare share and waits for its ack first."""
        if self.distributed:
            t0 = self.scheduler.clock
            self.provision(workers=[worker], timeout_s=60.0)
            self.monitor.credit_stall(self.scheduler.clock - t0,
                                      now=self.scheduler.clock)
        now = self.scheduler.clock
        self.membership.admit(worker, t, now=now)
        self._m_joins.inc()
        self.obs.instant("member_join", round=t, worker=int(worker),
                         epoch=self.membership.epoch)

    def _membership_fence(self, t: int) -> MembershipView:
        """Apply every due membership transition, then snapshot: round t's
        dispatch set, decode matrix and plan all derive from this view."""
        if self.elastic:
            now = self.scheduler.clock
            for _, msg in self.scheduler.control_inbox:
                self.membership.schedule_join(msg.worker, msg.at_round)
            self.scheduler.control_inbox.clear()
            span = None
            pre_epoch = self.membership.epoch
            for w in list(self.membership.view().members):
                if w in self.monitor.workers and self.monitor.is_dead(
                        w, now=now):
                    if span is None:
                        span = self.obs.begin("membership_transition",
                                              round=t)
                    self.membership.leave(w, t, now=now)
                    self._m_leaves.inc()
                    self.obs.instant("member_leave", round=t, worker=int(w),
                                     epoch=self.membership.epoch)
                    if not self.distributed:
                        spare = self.membership.take_spare()
                        if spare is not None:
                            self._admit(spare, t)
            for w in self.membership.due_joins(t):
                if span is None:
                    span = self.obs.begin("membership_transition", round=t)
                self._admit(w, t)
            view = self.membership.view()
            if view.epoch != pre_epoch:
                self._broadcast_epoch(view, t)
            if span is not None:
                self.obs.end(span)
        else:
            view = self.membership.view()
        self._m_epoch.set(view.epoch)
        self._m_members.set(len(view))
        return view

    # ------------------------------------------------------------------
    # Dispatch-set policy
    # ------------------------------------------------------------------

    def _alive(self, now: float) -> np.ndarray:
        return np.array(
            [i for i in self.monitor.workers
             if not self.monitor.is_dead(i, now=now)],
            dtype=np.int64)

    def dispatch_set(self, view: MembershipView | None = None) -> np.ndarray:
        """Monitor-alive members, minus known stragglers while the fast set
        strictly exceeds the recovery threshold."""
        now = self.scheduler.clock
        alive = self._alive(now)
        if view is not None:
            alive = np.asarray([w for w in alive if w in view],
                               dtype=np.int64)
        if self.exclude_stragglers:
            fast = self.monitor.survivors(now=now)
            if view is not None:
                fast = np.asarray([w for w in fast if w in view],
                                  dtype=np.int64)
            if len(fast) > self.cfg.threshold:
                self._m_excluded.inc(len(alive) - len(fast))
                return fast
        return alive

    # ------------------------------------------------------------------
    # One round
    # ------------------------------------------------------------------

    def step_round(self, t: int, iters: int, replayed: bool = False
                   ) -> RoundTrace:
        """One traced protocol round (the ``round`` span brackets it); a
        starved round leaves an instant and a counter bump, then raises."""
        rspan = self.obs.begin("round", round=t, replayed=replayed)
        try:
            trace = self._step_round_inner(t, iters, replayed)
            self._observe_round(t, trace, self.records[t])
            return trace
        except ClusterDecodeError:
            self.obs.instant("starved", round=t)
            self._m_starved.inc()
            raise
        finally:
            self.obs.end(rspan)

    def _step_round_inner(self, t: int, iters: int, replayed: bool = False
                          ) -> RoundTrace:
        cfg = self.cfg
        view = self._membership_fence(t)
        workers = self.dispatch_set(view)
        if len(workers) < cfg.threshold:
            raise ClusterDecodeError(
                f"round {t}: only {len(workers)} dispatchable workers < "
                f"recovery threshold {cfg.threshold}")
        ctx = self._take_ctx(t)
        if ctx is not None and ctx.epoch != view.epoch:
            # only the plan referenced the older fleet; draws and batch are
            # functions of t alone
            ctx.plan = None
            ctx.epoch = view.epoch
            self.obs.instant("prefetch_epoch_invalidated", round=t,
                             epoch=view.epoch)
        pred_subset = None
        if self.streaming:
            if ctx is not None and ctx.plan is not None:
                pred_subset = ctx.plan.subset
            elif ctx is None:
                pred = self._predicted_order()
                if pred is not None and len(pred) >= cfg.threshold:
                    pred_subset = frozenset(
                        int(w) for w in pred[: cfg.threshold])
        if ctx is not None:
            bidx = ctx.batch_idx
        else:
            bidx = self._batch(t) if cfg.batch_rows is not None else None
        payloads = None
        enc_t0 = _time.perf_counter()
        if self.distributed:
            # this round's weight shares, one to each worker, as numpy:
            # (N, d, c, r) int32, or (N, d, c) float32 under ALCC; sharded
            # masters each encode their own contiguous d-slice
            if self.master_group is not None:
                w_shares = (self.master_group.encode_round_shares_split(
                                ctx.kq, ctx.mask_shares, self.w2)
                            if ctx is not None else
                            self.master_group.encode_round_shares(
                                self.draws, t, self.w2))
            elif ctx is not None:
                w_shares = _eng.encode_round_shares_split(
                    cfg, ctx.kq, ctx.mask_shares, self.w2).cpu().numpy()
            else:
                w_shares = self.eng.encode_round_shares(
                    cfg, self.draws, t, self.w2).cpu().numpy()
            batch_np = (None if bidx is None
                        else bidx.cpu().numpy().astype(np.int32))
            next_np = None if ctx is None else ctx.next_batch
            payloads = {int(w): {"w_share": w_shares[int(w)],
                                 "batch": batch_np,
                                 "next_batch": next_np}
                        for w in workers}
        encode_wall_s = _time.perf_counter() - enc_t0

        decoder = None
        on_result = None
        if self.streaming and self.distributed:
            plan = (ctx.plan if ctx is not None and ctx.plan is not None
                    else decode.prefix_decode_plan(
                        cfg, self._predicted_order()))
            decoder = (self.master_group.make_decoder(plan,
                                                      self._w_shape[0])
                       if self.master_group is not None
                       else decode.StreamingDecoder(cfg, plan))

            def on_result(w, payload, _d=decoder):
                self._m_folds.inc()
                self.obs.instant("fold", round=t, worker=int(w))
                _d.fold(w, payload)
        pre_s = post_s = 0.0
        if not self.distributed:
            pre_s, post_s = self._sim_charges()
        if self._prefetcher is not None:
            # let the producer build round t+1 during the collect wait
            self._prefetcher.release()
        trace = self.scheduler.dispatch_round(
            t, cfg.threshold, workers=workers, monitor=self.monitor,
            timeout_s=self.round_timeout_s, payloads=payloads,
            collect_all=self.collect_all, pre_s=pre_s, post_s=post_s,
            on_result=on_result)
        if not math.isfinite(trace.t_first_R):
            for w in workers:
                if int(w) not in trace.arrivals:
                    self.monitor.mark_failed(int(w))
                    self._m_marked_dead.inc()
            silent = sorted(int(w) for w in workers
                            if int(w) not in trace.arrivals)
            raise ClusterDecodeError(
                f"round {t}: {len(trace.responders)} responses < threshold "
                f"{cfg.threshold} within {self.round_timeout_s}s (no result "
                f"from workers {silent})")

        streamed = False
        alcc = self.engine_name == "alcc"
        dec_t0 = _time.perf_counter()
        if decoder is not None:
            order = np.asarray(trace.responders[: cfg.threshold],
                               dtype=np.int64)
        elif alcc:
            # the least-squares decode picks its own row count (the
            # ill-conditioned fallback reads ALL responders)
            _, order, _ = alcc_engine.survivor_round_info(cfg,
                                                          trace.responders)
        else:
            dmat, order = _eng.survivor_round(cfg, trace.responders)
            dmat_t = torch.as_tensor(dmat, dtype=torch.int32,
                                     device=self.device)
        if self.distributed:
            if decoder is not None:
                parts = decoder.finish(order)
                streamed = decoder.streamed
                self.w2 = self._update_parts(self.w2, parts, bidx)
            elif alcc:
                fastest = np.stack([np.asarray(trace.payloads[int(w)],
                                               dtype=np.float32)
                                    for w in order])
                self.w2 = self._update(self.w2, fastest, order, bidx)
            else:
                fastest = np.stack([np.asarray(trace.payloads[int(w)],
                                               dtype=np.int32)
                                    for w in order])
                self.w2 = self._update(
                    self.w2, torch.as_tensor(fastest, device=self.device),
                    dmat_t, bidx)
            if self.device.type == "cuda":    # honest decode_s
                torch.cuda.synchronize(self.device)
        elif alcc:
            self.w2 = self._round(t, self.w2, order, bidx)
        else:
            order_t = torch.as_tensor(order, dtype=torch.int64,
                                      device=self.device)
            if ctx is not None:
                self.w2 = self._round_split(ctx.kq, ctx.mask_shares, self.w2,
                                            dmat_t, order_t, bidx)
            else:
                self.w2 = self._round(t, self.w2, dmat_t, order_t, bidx)
        decode_wall_s = _time.perf_counter() - dec_t0
        if self.distributed:
            trace.encode_s = encode_wall_s
            trace.decode_s = decode_wall_s
            trace.t_ready = self.scheduler.clock
        else:
            # a simulated streaming decoder folds eagerly only on a subset
            # hit; on a miss charge the rest of the batch decode
            streamed = (self.streaming and pred_subset is not None
                        and frozenset(int(w) for w in order) == pred_subset)
            if self.streaming and not streamed:
                miss_extra = self.decode_cost_s - post_s
                if miss_extra > 0:
                    self.scheduler.time.advance_to(
                        self.scheduler.clock + miss_extra)
                    trace.decode_s = post_s + miss_extra
                    trace.t_ready = self.scheduler.clock
        self._last_order = np.asarray(trace.responders).copy()
        self.traces[t] = trace
        self.records[t] = RoundRecord(
            round=t, trace=trace, survivors=np.asarray(order).copy(),
            replayed=replayed, prefetched=ctx is not None, streamed=streamed)
        return trace

    # ------------------------------------------------------------------
    # Training drivers
    # ------------------------------------------------------------------

    def run(self, iters: int) -> torch.Tensor:
        """Plain run: any starved round raises ClusterDecodeError."""
        self._reset()
        with self._pipeline_scope(iters):
            for t in range(iters):
                self.step_round(t, iters)
        return self.eng._w_public(self.cfg, self.w2)

    def run_resilient(self, iters: int, ckpt_manager,
                      checkpoint_every: int = 5, max_retries: int = 3,
                      respawn: Callable[[int, int], None] | None = None
                      ) -> torch.Tensor:
        """Checkpointed run: a starved round restores the last checkpoint,
        reprovisions dead workers, and replays.

        ``respawn(worker, step)`` is the real transport's replacement hook:
        called for each dead slot after a restore, it starts a fresh worker
        process for that slot (the caller owns the processes); the runner
        then reprovisions the slot and waits for its ack before replaying.
        In simulation the latency model's ``revive`` plays that part and
        ``respawn`` is unused.
        """
        self._reset()
        replaying = {"flag": False}

        def step_fn(state, t):
            self.w2 = state["train"]["w2"].to(self.device)
            self.step_round(t, iters, replayed=replaying["flag"])
            return {"train": {"w2": self.w2}}

        def on_restore(step):
            replaying["flag"] = True
            t0 = self.scheduler.clock
            for i, ws in list(self.monitor.workers.items()):
                if not ws.alive:
                    if self.latency is not None:
                        self.latency.revive(i, at_round=step)
                    elif respawn is not None:
                        respawn(i, step)
                        self.provision(workers=[i], timeout_s=180.0)
                    self.monitor.revive(i, now=self.scheduler.clock)
            # the respawn and reprovision blocked dispatch: credit the
            # healthy fleet the stall so the replay's first fence does not
            # read their silence as death
            self.monitor.credit_stall(self.scheduler.clock - t0,
                                      now=self.scheduler.clock)

        loop = ResilientLoop(ckpt_manager, checkpoint_every=checkpoint_every,
                             max_retries=max_retries, on_restore=on_restore)
        state0 = {"train": {"w2": self.w2}}
        ckpt_manager.save(0, state0)
        ckpt_manager.wait()
        with self._pipeline_scope(iters):
            # a restore rewinds t; RoundPrefetcher.get resets its producer
            loop.run(state0, step_fn, start_step=0, num_steps=iters)
        self.restarts = loop.restarts
        return self.eng._w_public(self.cfg, self.w2)

    def _reset(self) -> None:
        self.w2 = self.eng._w_internal(self.cfg, self.state.w)
        self.records.clear()
        self.traces.clear()
        self._last_order = None
        if self.alcc_info is not None:
            self.alcc_info.clear()

    # ------------------------------------------------------------------
    # Trace export + stats
    # ------------------------------------------------------------------

    def survivor_fn(self) -> Callable[[int], np.ndarray]:
        """Responder trace -> survivor_fn for _eng.train/train_reference;
        replaying it with the same draws reproduces this run's weights
        bit for bit."""
        trace = {t: rec.survivors for t, rec in self.records.items()}
        return lambda t: trace[t]

    def wait_stats(self) -> dict[str, dict[str, float]]:
        """Per-round completion-time stats: coded first-T against
        wait-for-all, the master's encode/decode components, the critical
        path, wire bytes and the membership summary."""
        recs = sorted(self.records.values(), key=lambda r: r.round)
        coded = np.array([r.coded_wait_s for r in recs])
        allw = np.array([r.all_wait_s for r in recs])
        enc = np.array([r.encode_s for r in recs])
        dec = np.array([r.decode_s for r in recs])
        stats = {"coded_T": wait_summary(coded),
                 "wait_all": wait_summary(allw[np.isfinite(allw)]),
                 "encode": wait_summary(enc),
                 "decode": wait_summary(dec),
                 "critical_path": wait_summary(enc + coded + dec),
                 "wire_tx_bytes": wait_summary([r.tx_bytes for r in recs]),
                 "wire_rx_bytes": wait_summary([r.rx_bytes for r in recs]),
                 "wire_tx_frames": wait_summary([r.tx_frames for r in recs]),
                 "wire_rx_frames": wait_summary([r.rx_frames for r in recs]),
                 "rounds": {"n": float(len(recs)),
                            "dead_rounds": float(np.sum(~np.isfinite(allw))),
                            "prefetched": float(sum(r.prefetched
                                                    for r in recs)),
                            "streamed": float(sum(r.streamed
                                                  for r in recs))}}
        wire_totals = getattr(self.scheduler.transport, "wire_totals", None)
        if wire_totals is not None:
            stats["wire_totals"] = {k: float(v)
                                    for k, v in wire_totals().items()}
        trans = self.membership.transitions
        stats["membership"] = {
            "epoch": float(self.membership.epoch),
            "members": float(len(self.membership)),
            "spares_left": float(len(self.membership.spares)),
            "joins": float(sum(tr.kind == "join" for tr in trans)),
            "leaves": float(sum(tr.kind == "leave" for tr in trans)),
        }
        if self.master_group is not None:
            stats["masters"] = self.master_group.group_stats()
        if self.alcc_info:
            # the decode's conditioning and a-priori float error bound
            stats["alcc"] = {
                "cond": wait_summary([i["cond"] for i in self.alcc_info]),
                "abs_err_budget": wait_summary(
                    [i["abs_err_budget"] for i in self.alcc_info]),
                "fallbacks": {"n": float(sum(
                    1 for i in self.alcc_info if i["fallback"]))},
            }
        return stats
