"""Coded prediction serving plane on torch; mirrors ``repro/cluster/serve.py``.

The trained model W is quantized and Lagrange-encoded once (every one of
the K data slots carries the same W̄, plus T uniform masks), and each
worker keeps its share W̃_i for the deployment (``provision``).  Clients
submit Query batches that the master admits into a bounded FIFO, flushes
under the max-batch / max-wait ``BatchingPolicy``, encodes (rows padded
to ``max_batch``, split into K row blocks, fresh masks each flush) and
dispatches through the ``EventScheduler``; it decodes the logits at the
first 2(K+T-1)+1 arrivals.  Worker i computes the bilinear X̃_i·W̃_i, so
the decode is exact: bit-identical to the uncoded plaintext product.

Every field product runs on ``field.matmul``, which on the card is the
``modmatmul`` kernel: the provision encode, each flush's encode, the
in-process master's products X̃_i·W̃_i (one launch per responder, as each
worker process makes one), the decode and the oracle.  Over sockets the
decode is the host's ``StreamingDecoder``, as in the reference.

Differences from the reference: randomness comes from a draws object
(``draws.TorchServeDraws`` by default; the reference's ``jax.random`` key
becomes its ``weight_masks`` and ``flush_masks(t, ...)``), the weights and
every flush's tensors live on the server's device, and flushes are still
padded to ``max_batch`` (the masks' shape, so the bits, depend on it).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time as _time
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.cluster.latency import LatencyModel
from repro_torch.cluster.membership import ClusterMembership
from repro_torch.cluster.messages import (
    PROVISION_ROUND, SHUTDOWN_ROUND, EncodeShare, Prediction, Query,
    worker_endpoint)
from repro_torch.cluster.runner import await_worker_acks
from repro_torch.cluster.scheduler import (
    ClusterDecodeError, EventScheduler, RoundTrace)
from repro_torch.core import field, lagrange, quantize
from repro_torch.core.protocol import decode
from repro_torch.core.protocol.draws import TorchServeDraws
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.resilience import HeartbeatMonitor

SERVE_DEG_F = 2                  # worker fn X̃·W̃ is bilinear in the codes


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static parameters of one serving deployment.

    Duck-types the decode layer's config (``threshold`` / ``scheme`` /
    ``K`` / ``p``), so ``StreamingDecoder`` and the cached decode matrices
    serve it unchanged; its threshold is the bilinear worker's.
    """
    N: int                       # workers
    K: int                       # batch parallelization (row split)
    T: int                       # privacy threshold (colluding workers)
    lx: int = 2                  # query fractional bits
    lw: int = 4                  # weight fractional bits
    p: int = field.P
    max_batch: int = 32          # rows per coded flush (K | max_batch)
    max_wait_s: float = 0.05     # oldest-query deadline before a flush
    queue_cap: int = 64          # admitted-but-unflushed query bound

    def __post_init__(self):
        assert self.K >= 1 and self.T >= 0, (self.K, self.T)
        assert self.max_batch % self.K == 0, (
            f"K={self.K} must divide max_batch={self.max_batch} "
            f"(fixed-shape row blocks)")
        assert self.queue_cap >= 1
        assert math.isfinite(self.max_wait_s) and self.max_wait_s >= 0, (
            "the deadline trigger needs a finite max_wait_s")
        assert self.N >= self.threshold, (
            f"N={self.N} < serve threshold {self.threshold} "
            f"= 2(K+T-1)+1: no responder set could ever decode")

    @property
    def threshold(self) -> int:
        return lagrange.degree_threshold(self.K, self.T, SERVE_DEG_F)

    @property
    def rows_per_part(self) -> int:
        return self.max_batch // self.K

    @property
    def scheme(self) -> lagrange.CodingScheme:
        return lagrange.CodingScheme(self.N, self.K, self.T, self.p)


class BatchingPolicy:
    """Deadline-aware flush decision, separable from the server."""

    def __init__(self, max_batch: int, max_wait_s: float):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s

    def should_flush(self, pending_rows: int, oldest_age_s: float) -> bool:
        """Flush on max-batch OR max-wait, whichever fires first."""
        if pending_rows <= 0:
            return False
        return pending_rows >= self.max_batch \
            or oldest_age_s >= self.max_wait_s

    def deadline(self, oldest_admitted_at: float) -> float:
        """Absolute time the deadline trigger fires for the oldest query."""
        return oldest_admitted_at + self.max_wait_s


@dataclasses.dataclass
class _Pending:
    query: Query
    admitted_at: float           # master-clock admission instant
    sent_abs: float              # master-clock submission (latency epoch)
    rows: int


def open_loop_queries(n: int, rows: int, d: int, rate_qps: float,
                      seed: int = 0, clients: int = 4) -> list[Query]:
    """Open-loop load: ``n`` queries of ``rows`` random feature rows each,
    Poisson arrivals at ``rate_qps`` (``rate_qps <= 0`` = all at t=0).
    ``sent_at`` values are offsets from the run() epoch."""
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(1.0 / rate_qps, n) if rate_qps > 0
            else np.zeros(n))
    at = np.cumsum(gaps)
    return [Query(qid=i, client=f"client{i % clients}",
                  sent_at=float(at[i]),
                  x=rng.standard_normal((rows, d)).astype(np.float32))
            for i in range(n)]


class PredictionServer:
    """The master side of the serving plane.

    ``latency=<LatencyModel>``: event-driven simulation, the master
    evaluates the responders' shares itself in observed arrival order.
    ``transport=<SocketTransport>``: worker processes hold W̃_i
    (``provision()`` once), each flush ships X̃_i, and arriving shares fold
    into a ``StreamingDecoder``.  ``verify=True`` recomputes every flush
    through the uncoded plaintext oracle and counts mismatches.  ``w`` is
    the (d, classes) model; it goes to ``device`` (``None`` means CUDA).
    """

    def __init__(self, cfg: ServeConfig, w, *,
                 draws=None,
                 device: str | torch.device | None = None,
                 latency: LatencyModel | None = None,
                 transport=None,
                 round_timeout_s: float = math.inf,
                 heartbeat_timeout_s: float = math.inf,
                 straggler_factor: float = 3.0,
                 exclude_stragglers: bool = True,
                 collect_all: bool = False,
                 verify: bool = False,
                 recorder=None,
                 metrics: MetricsRegistry | None = None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.draws = (draws if draws is not None
                      else TorchServeDraws(0, self.device))
        w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        assert w.ndim == 2, f"model weights must be (d, classes), got {w.shape}"
        self.d, self.classes = int(w.shape[0]), int(w.shape[1])
        self.wq = quantize.quantize_data(w, cfg.lw, cfg.p)      # (d, c) field
        # provision-time encode: all K slots carry the SAME W̄ (the row
        # split parallelizes the query batch, not the model) + T masks,
        # drawn once and reused for every query
        parts = self.wq[None].expand(cfg.K, self.d, self.classes)
        masks = self.draws.weight_masks(cfg.T, (self.d, self.classes), cfg.p)
        self.w_shares = lagrange.encode(cfg.scheme, parts, masks, cfg.p)
        self.latency = latency
        self.collect_all = collect_all
        self.verify = verify
        self.exclude_stragglers = exclude_stragglers
        self.round_timeout_s = round_timeout_s
        self.scheduler = EventScheduler(cfg.N, latency, transport,
                                        recorder=recorder)
        self.obs = self.scheduler.obs
        self.obs.bind_clock(self.scheduler.time.now)
        if self.distributed and math.isinf(round_timeout_s):
            self.round_timeout_s = 300.0     # real silence must be detectable
        self.monitor = HeartbeatMonitor(cfg.N, timeout_s=heartbeat_timeout_s,
                                        straggler_factor=straggler_factor,
                                        now=self.scheduler.clock)
        # a fixed fleet (the model shares are provisioned once), read off
        # a membership view like training's
        self.membership = ClusterMembership(range(cfg.N),
                                            monitor=self.monitor)
        self.scheduler.bind_membership(self.membership)
        self.policy = BatchingPolicy(cfg.max_batch, cfg.max_wait_s)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._init_metrics()
        self._queue: collections.deque[_Pending] = collections.deque()
        self._queued_rows = 0
        self._epoch = 0.0                    # run()-start clock offset
        self._round = 0
        self._last_order: np.ndarray | None = None
        self.results: dict[int, Prediction] = {}
        self.rejected: list[int] = []
        self.traces: dict[int, RoundTrace] = {}
        self.lat_first: list[float] = []     # per query, first-threshold
        self.lat_all: list[float] = []       # per query, wait-for-all
        self.oracle_checked = 0
        self.oracle_mismatches = 0
        self._served_rows = 0
        self._t_first_query: float | None = None
        self._t_last_done: float | None = None

    @property
    def distributed(self) -> bool:
        return self.latency is None

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def _init_metrics(self) -> None:
        m = self.metrics
        self._m_queries = m.counter(
            "serve_queries_total", "queries admitted to the request queue")
        self._m_rejected = m.counter(
            "serve_rejected_total",
            "queries rejected at admission (queue full or oversized)")
        self._m_rounds = m.counter(
            "serve_rounds_total", "coded flushes dispatched")
        self._m_starved = m.counter(
            "serve_starved_rounds_total",
            "flushes with fewer than threshold responses in the timeout")
        self._m_depth = m.gauge(
            "serve_queue_depth", "admitted-but-unflushed queries")
        self._m_fill = m.gauge(
            "serve_batch_fill", "row fill fraction of the last coded flush")
        self._m_p99 = m.gauge(
            "serve_p99_s", "p99 first-threshold query latency so far")
        self._m_lat = m.histogram(
            "serve_latency_seconds",
            "query submission to decoded prediction, first-threshold policy")

    # ------------------------------------------------------------------
    # Distributed provisioning: W̃_i to each worker, once
    # ------------------------------------------------------------------

    def provision(self, timeout_s: float = 60.0) -> None:
        """Ship every worker its model share W̃_i and the flush shape; block
        until all ack (each runs one warm-up product first)."""
        if not self.distributed:
            raise RuntimeError("provision() is for real transports only")
        members = list(self.membership.view().members)
        w_shares = self.w_shares.cpu().numpy()
        with self.obs.span("provision", workers=len(members)):
            tr = self.scheduler.transport
            now = self.scheduler.clock
            for w in members:
                tr.send(worker_endpoint(w),
                        EncodeShare(PROVISION_ROUND, w,
                                    {"protocol": "serve",
                                     "w_share": w_shares[w],
                                     "p": self.cfg.p,
                                     "rows": self.cfg.rows_per_part,
                                     "trace": bool(self.obs.enabled)}),
                        at=now)
            await_worker_acks(tr, lambda: self.scheduler.clock, set(members),
                              self.monitor, timeout_s)

    def shutdown_workers(self) -> None:
        if not self.distributed:
            raise RuntimeError("shutdown_workers() is for real transports")
        now = self.scheduler.clock
        for w in self.membership.view().members:
            self.scheduler.transport.send(
                worker_endpoint(w), EncodeShare(SHUTDOWN_ROUND, w), at=now)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def submit(self, query: Query, now: float | None = None) -> bool:
        """Admit one query into the bounded queue.  False = rejected
        (queue at ``queue_cap``, or more rows than a flush can carry)."""
        now = self.scheduler.clock if now is None else now
        rows = int(np.asarray(query.x).shape[0])
        if rows > self.cfg.max_batch or rows <= 0 \
                or len(self._queue) >= self.cfg.queue_cap:
            self._m_rejected.inc()
            self.rejected.append(query.qid)
            return False
        self._queue.append(_Pending(query, admitted_at=now,
                                    sent_abs=self._epoch + query.sent_at,
                                    rows=rows))
        self._queued_rows += rows
        self._m_queries.inc()
        self._m_depth.set(len(self._queue))
        return True

    # ------------------------------------------------------------------
    # Dispatch-set policy (same shape as ClusterRunner)
    # ------------------------------------------------------------------

    def _alive(self, now: float) -> np.ndarray:
        return np.array(
            [i for i in self.monitor.workers
             if not self.monitor.is_dead(i, now=now)], dtype=np.int64)

    def dispatch_set(self) -> np.ndarray:
        now = self.scheduler.clock
        alive = self._alive(now)
        if self.exclude_stragglers:
            fast = self.monitor.survivors(now=now)
            # strictly more than threshold: leave slack for a silent death
            if len(fast) > self.cfg.threshold:
                return fast
        return alive

    # ------------------------------------------------------------------
    # Flush: pack -> encode -> dispatch -> threshold decode -> respond
    # ------------------------------------------------------------------

    def _take_flush(self) -> list[_Pending]:
        """Pop whole queries off the queue head while they fit the flush
        (FIFO; a query is never split across flushes)."""
        batch: list[_Pending] = []
        used = 0
        while self._queue and used + self._queue[0].rows <= self.cfg.max_batch:
            pend = self._queue.popleft()
            self._queued_rows -= pend.rows
            used += pend.rows
            batch.append(pend)
        return batch

    def _encode_flush(self, batch: list[_Pending], t: int
                      ) -> tuple[torch.Tensor, torch.Tensor,
                                 list[tuple[int, int]]]:
        """(N, b, d) query shares + the quantized padded batch + per-query
        row spans.  Rows are zero-padded to max_batch."""
        cfg = self.cfg
        x = np.zeros((cfg.max_batch, self.d), np.float32)
        spans: list[tuple[int, int]] = []
        row = 0
        for pend in batch:
            x[row: row + pend.rows] = np.asarray(pend.query.x, np.float32)
            spans.append((row, row + pend.rows))
            row += pend.rows
        xq = quantize.quantize_data(torch.as_tensor(x, device=self.device),
                                    cfg.lx, cfg.p)
        parts = xq.reshape(cfg.K, cfg.rows_per_part, self.d)
        masks = self.draws.flush_masks(t, cfg.T, (cfg.rows_per_part, self.d),
                                       cfg.p)             # fresh per flush
        shares = lagrange.encode(cfg.scheme, parts, masks, cfg.p)
        return shares, xq, spans

    def _decode_flush(self, trace: RoundTrace, shares: torch.Tensor,
                      decoder: decode.StreamingDecoder | None) -> np.ndarray:
        """(max_batch, classes) real logits from the first-threshold
        responders: exact mod-p interpolation, then dequantize."""
        cfg = self.cfg
        order = np.asarray(trace.responders[: cfg.threshold], dtype=np.int64)
        if decoder is not None:                    # socket: shares folded
            yq = torch.as_tensor(decoder.finish(order), device=self.device)
        else:                                      # sim: master evaluates
            res = torch.stack([field.matmul(shares[i], self.w_shares[i],
                                            cfg.p) for i in order.tolist()])
            yq = lagrange.decode(cfg.scheme, res, order, SERVE_DEG_F, cfg.p)
        self._last_order = np.asarray(trace.responders, dtype=np.int64)
        flat = yq.reshape(cfg.max_batch, self.classes)
        return quantize.dequantize(flat, cfg.lx + cfg.lw, cfg.p).cpu().numpy()

    def oracle_logits(self, x) -> np.ndarray:
        """Uncoded plaintext oracle: quantize -> one field matmul against
        W̄ -> dequantize.  The coded path must match it bit for bit."""
        xq = quantize.quantize_data(
            torch.as_tensor(np.asarray(x, np.float32), device=self.device),
            self.cfg.lx, self.cfg.p)
        return self._oracle_from_quantized(xq)

    def _oracle_from_quantized(self, xq: torch.Tensor) -> np.ndarray:
        yq = field.matmul(xq, self.wq, self.cfg.p)
        return quantize.dequantize(yq, self.cfg.lx + self.cfg.lw,
                                   self.cfg.p).cpu().numpy()

    def _flush(self, now: float) -> None:
        cfg = self.cfg
        batch = self._take_flush()
        if not batch:
            return
        t = self._round
        self._round += 1
        used = sum(p.rows for p in batch)
        span = self.obs.begin("serve_round", round=t, queries=len(batch),
                              rows=used)
        enc0 = _time.perf_counter()
        shares, xq, spans = self._encode_flush(batch, t)
        workers = self.dispatch_set()
        if len(workers) < cfg.threshold:
            self._m_starved.inc()
            self.obs.end(span, starved=True)
            raise ClusterDecodeError(
                f"flush {t}: only {len(workers)} live workers "
                f"< threshold {cfg.threshold}")
        payloads = decoder = on_result = None
        if self.distributed:
            shares_np = shares.cpu().numpy()
            payloads = {int(w): {"x_share": shares_np[int(w)]}
                        for w in workers}
            decoder = decode.StreamingDecoder(
                cfg, decode.prefix_decode_plan(cfg, self._last_order))

            def on_result(w, payload, _d=decoder):
                _d.fold(w, payload)
        enc_s = _time.perf_counter() - enc0
        trace = self.scheduler.dispatch_round(
            t, cfg.threshold, workers, monitor=self.monitor,
            timeout_s=self.round_timeout_s, payloads=payloads,
            collect_all=self.collect_all, on_result=on_result)
        if self.scheduler.time.real:
            trace.encode_s = enc_s    # measured wall encode (batch span)
        if not math.isfinite(trace.t_first_R):
            for w in workers:
                if int(w) not in trace.arrivals:
                    self.monitor.mark_failed(int(w))
            self._m_starved.inc()
            self.obs.end(span, starved=True)
            raise ClusterDecodeError(
                f"flush {t}: {len(trace.responders)} responses "
                f"< threshold {cfg.threshold} within "
                f"{self.round_timeout_s}s")
        dec0 = _time.perf_counter()
        logits = self._decode_flush(trace, shares, decoder)
        dec_s = _time.perf_counter() - dec0
        if self.verify:
            self.oracle_checked += 1
            if not np.array_equal(logits, self._oracle_from_quantized(xq)):
                self.oracle_mismatches += 1
        # the first-threshold decode instant: the threshold-th arrival plus
        # the measured decode, never the post-dispatch clock (under
        # collect_all that clock waited for every straggler)
        t_done = trace.t_first_R + (dec_s if self.scheduler.time.real
                                    else 0.0)
        if self.scheduler.time.real:
            trace.decode_s = dec_s
        self.traces[t] = trace
        self._respond(batch, spans, logits, trace, t_done, t)
        self.obs.end(span, responders=len(trace.responders))
        self._m_rounds.inc()
        self._m_fill.set(used / cfg.max_batch)
        self._m_depth.set(len(self._queue))
        if self.lat_first:
            self._m_p99.set(float(np.percentile(self.lat_first, 99)))

    def _respond(self, batch: list[_Pending], spans: list[tuple[int, int]],
                 logits: np.ndarray, trace: RoundTrace, t_done: float,
                 t: int) -> None:
        for pend, (r0, r1) in zip(batch, spans):
            q = pend.query
            lat = t_done - pend.sent_abs
            lat_all = (trace.t_all - pend.sent_abs
                       if math.isfinite(trace.t_all) else math.inf)
            self.results[q.qid] = Prediction(
                qid=q.qid, client=q.client, y=logits[r0:r1], latency_s=lat)
            self.lat_first.append(lat)
            self.lat_all.append(lat_all)
            self._m_lat.observe(lat)
            self._served_rows += pend.rows
            if self._t_first_query is None \
                    or pend.sent_abs < self._t_first_query:
                self._t_first_query = pend.sent_abs
            self._t_last_done = t_done
            if self.obs.enabled:
                track = f"query/{q.qid}"
                self.obs.add_span("queue", pend.admitted_at, trace.t_start,
                                  track=track, round=t)
                self.obs.add_span("batch", trace.t_start - trace.encode_s,
                                  trace.t_start, track=track, round=t)
                self.obs.add_span("dispatch", trace.t_start, trace.t_first_R,
                                  track=track, round=t,
                                  responders=len(trace.responders))
                self.obs.add_span("decode", trace.t_first_R, t_done,
                                  track=track, round=t)
        if self.obs.enabled:
            for w, wspans in trace.worker_traces.items():
                self.obs.add_process_spans(f"worker{int(w)}", wspans, round=t)

    # ------------------------------------------------------------------
    # Client loops
    # ------------------------------------------------------------------

    def run(self, queries: list[Query]) -> dict[int, Prediction]:
        """Open-loop service: admit each query at its ``sent_at`` offset,
        flush under the batching policy, drain the queue; returns every
        decoded Prediction by qid."""
        queries = sorted(queries, key=lambda q: q.sent_at)
        self._epoch = self.scheduler.clock
        i = 0
        while i < len(queries) or self._queue:
            now = self.scheduler.clock
            while i < len(queries) \
                    and self._epoch + queries[i].sent_at <= now:
                self.submit(queries[i], now=now)
                i += 1
            if self._queue and self.policy.should_flush(
                    self._queued_rows, now - self._queue[0].admitted_at):
                self._flush(now)
                continue
            nxt = math.inf
            if i < len(queries):
                nxt = self._epoch + queries[i].sent_at
            if self._queue:
                nxt = min(nxt, self.policy.deadline(
                    self._queue[0].admitted_at))
            if not math.isfinite(nxt):
                break
            if nxt <= now:
                # float-rounding guard: the oldest query's deadline landed
                # on `now` while its age still rounds below max_wait
                self._flush(now)
                continue
            if self.scheduler.time.real:
                _time.sleep(max(0.0, nxt - self.scheduler.clock))
            else:
                self.scheduler.time.advance_to(nxt)
        return self.results

    def run_closed_loop(self, queries: list[Query]) -> dict[int, Prediction]:
        """Closed-loop service: one query in flight at a time, each flushed
        immediately (the zero-queueing throughput ceiling)."""
        for q in queries:
            now = self.scheduler.clock
            if self.submit(dataclasses.replace(
                    q, sent_at=now - self._epoch), now=now):
                self._flush(now)
        return self.results

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------

    @staticmethod
    def _lat_summary(a: list[float]) -> dict[str, float]:
        fin = np.asarray([v for v in a if math.isfinite(v)], dtype=float)
        if fin.size == 0:
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                    "unobserved": len(a)}
        return {"n": int(fin.size), "mean": float(fin.mean()),
                "p50": float(np.percentile(fin, 50)),
                "p99": float(np.percentile(fin, 99)),
                "unobserved": len(a) - int(fin.size)}

    def stats(self) -> dict[str, Any]:
        """Served/rejected counts, queries/s, and p50/p99 latency under both
        wait policies: first-threshold (what this server does) and
        wait-for-all (the counterfactual, from the same traces' ``t_all``)."""
        served = len(self.results)
        elapsed = 0.0
        if served and self._t_last_done is not None \
                and self._t_first_query is not None:
            elapsed = max(self._t_last_done - self._t_first_query, 1e-12)
        return {
            "queries": served,
            "rejected": len(self.rejected),
            "rounds": self._round,
            "rows": self._served_rows,
            "elapsed_s": elapsed,
            "queries_per_s": served / elapsed if elapsed else 0.0,
            "rows_per_s": self._served_rows / elapsed if elapsed else 0.0,
            "latency_first": self._lat_summary(self.lat_first),
            "latency_all": self._lat_summary(self.lat_all),
            "oracle": {"checked": self.oracle_checked,
                       "bit_identical": self.oracle_mismatches == 0},
        }
