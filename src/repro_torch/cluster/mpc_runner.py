"""MPCClusterRunner: the BGW baseline run as a distributed protocol, on torch.

Mirrors ``repro/cluster/mpc_runner.py``.  The scheduler moves messages and
time (``EventScheduler.run_mpc_round``: dispatch -> one reshare barrier per
degree reduction -> collect the first 2T+1 final shares); all numerics run
through the per-phase hooks of core/mpc_baseline.py, the functions
``mpc_baseline.step`` composes, with reconstruction at the observed first
2T+1 arrivals (``reconstruct_at``: any 2T+1 correct shares of a degree-2T
sharing give the same field element).  So a run, simulated or over
sockets, is bit-identical to ``mpc_baseline.train`` with the same draws,
stragglers included.

BGW has no erasure tolerance: every degree reduction needs sub-shares from
all N workers, so each reshare phase waits for the slowest worker, and a
dead worker starves the round.

Differences from the reference:

  * randomness comes from a draws object (``TorchMPCDraws(0, device)`` by
    default); each round ships ``{"w_share", "kred"}`` where ``"kred"``
    holds the round's reshare seeds (int64), from which every worker draws
    its own reshare masks;
  * in simulation the N workers' phases run on the runner's device, two
    ``modmatmul`` launches per worker per round;
  * ``wait_stats`` adds the master's encode and reconstruct walls, the
    critical path (encode + wait + reconstruct) and wire bytes per round
    on a real transport.
"""
from __future__ import annotations

import math
import time as _time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.cluster.latency import LatencyModel, make_latency
from repro_torch.cluster.membership import ClusterMembership
from repro_torch.cluster.messages import (
    PROVISION_ROUND,
    SHUTDOWN_ROUND,
    EncodeShare,
    worker_endpoint,
)
from repro_torch.cluster.runner import await_worker_acks, wait_summary
from repro_torch.cluster.scheduler import (
    ClusterDecodeError,
    EventScheduler,
    MPCRoundTrace,
)
from repro_torch.cluster.transport import Transport
from repro_torch.core import mpc_baseline as mpc
from repro_torch.core.protocol.draws import TorchMPCDraws
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.resilience import HeartbeatMonitor


def mpc_phase_models(name: str, seed: int = 0, r: int = 1
                     ) -> list[LatencyModel]:
    """One latency model per BGW phase: r reshare rounds + the final send.
    Phase 0 reuses the coded run's (seed, round, worker) stream; each extra
    phase gets a disjointly seeded stream."""
    return [make_latency(name, seed=seed if j == 0 else seed + 7919 * j)
            for j in range(r + 1)]


class MPCClusterRunner:
    """Drives ``iters`` BGW iterations through the event scheduler.

    ``phase_latency`` given (r+1 models): in-process simulation, every
    worker's phases computed on the runner's device.  ``phase_latency=None``
    and a real transport: N worker processes (launch/cpml_worker.py, "mpc"
    mode) run the phases and reshare through the master's relay; the
    runner ships weight shares and reshare seeds and reconstructs from the
    first 2T+1 CombineResult payloads.  ``provision()`` runs once before
    the rounds.  ``x``, ``y`` go to ``device`` (``None`` means CUDA).
    """

    def __init__(self, cfg: mpc.MPCConfig, x, y,
                 phase_latency: list[LatencyModel] | None = None, *,
                 draws=None,
                 device: str | torch.device | None = None,
                 eta: float | None = None,
                 transport: Transport | None = None,
                 round_timeout_s: float = math.inf,
                 heartbeat_timeout_s: float = math.inf,
                 master_overhead_s: float = 0.0,
                 recorder=None,
                 metrics: MetricsRegistry | None = None):
        from repro_torch.core import protocol as cpml
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.draws = (draws if draws is not None
                      else TorchMPCDraws(0, self.device))
        self.collect_threshold = 2 * cfg.T + 1
        self.phase_latency = phase_latency
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        # a master whose workers compute needs no X̄ᵀ
        self.state = mpc.setup(cfg, x, y, self.draws,
                               transposed=not self.distributed)
        self.eta = (cpml.lipschitz_eta(self.state.xq_real)
                    if eta is None else float(eta))
        self.scheduler = EventScheduler(
            cfg.N, None if phase_latency is None else phase_latency[0],
            transport, master_overhead_s=master_overhead_s,
            recorder=recorder)
        self.obs = self.scheduler.obs
        self.obs.bind_clock(self.scheduler.time.now)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_rounds = self.metrics.counter(
            "mpc_rounds_total", "completed BGW iterations")
        self._m_wait = self.metrics.histogram(
            "mpc_round_wait_seconds",
            "dispatch to (2T+1)-th final share, per iteration")
        self.round_timeout_s = round_timeout_s
        if self.distributed and math.isinf(round_timeout_s):
            self.round_timeout_s = 300.0   # real silence must be detectable
        self.monitor = HeartbeatMonitor(cfg.N, timeout_s=heartbeat_timeout_s,
                                        now=self.scheduler.clock)
        # a fixed fleet: N is baked into every reshare polynomial, so there
        # are no spare points to join on and a leave is terminal
        self.membership = ClusterMembership(range(cfg.N),
                                            monitor=self.monitor)
        self.scheduler.bind_membership(self.membership)
        self.w = self.state.w
        self.traces: dict[int, MPCRoundTrace] = {}
        # per round on a real transport: (encode s, reconstruct s, wire
        # tx bytes, wire rx bytes)
        self.walls: dict[int, tuple[float, float, int, int]] = {}

    @property
    def distributed(self) -> bool:
        return self.phase_latency is None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Distributed-mode lifecycle
    # ------------------------------------------------------------------

    def provision(self, timeout_s: float = 60.0) -> None:
        """Ship each worker its whole-dataset Shamir share and the static
        context (the encode-everything-everywhere cost BGW pays)."""
        if not self.distributed:
            raise RuntimeError("provision() is for real transports only")
        tr = self.scheduler.transport
        cfg_kw = {"N": self.cfg.N, "T": self.cfg.T, "r": self.cfg.r,
                  "lx": self.cfg.lx, "lw": self.cfg.lw, "lc": self.cfg.lc,
                  "p": self.cfg.p}
        cbar = mpc.poly_coeffs(self.cfg)
        now = self.scheduler.clock
        members = list(self.membership.view().members)
        for w in members:
            tr.send(worker_endpoint(w),
                    EncodeShare(PROVISION_ROUND, w,
                                {"protocol": "mpc", "cfg": cfg_kw,
                                 "x_share": self.state.x_shares[w].cpu()
                                 .numpy(),
                                 "cbar": cbar,
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
    # One iteration
    # ------------------------------------------------------------------

    def step_round(self, t: int) -> MPCRoundTrace:
        rspan = self.obs.begin("mpc_round", round=t)
        try:
            return self._step_round_inner(t)
        except ClusterDecodeError:
            self.obs.instant("starved", round=t)
            raise
        finally:
            self.obs.end(rspan)

    def _step_round_inner(self, t: int) -> MPCRoundTrace:
        cfg = self.cfg
        payloads = None
        wire_totals = getattr(self.scheduler.transport, "wire_totals", None)
        wire0 = wire_totals() if self.distributed and wire_totals else None
        enc_t0 = _time.perf_counter()
        if self.distributed:
            # this iteration's weight shares and reshare seeds, one slice
            # to each worker, as numpy
            w_shares, seeds = mpc.encode_step(cfg, self.draws, t, self.w)
            w_shares = w_shares.cpu().numpy()                  # (N, d, r)
            kred = np.asarray(seeds, dtype=np.int64)
            payloads = {w: {"w_share": w_shares[w], "kred": kred}
                        for w in range(cfg.N)}
        encode_s = _time.perf_counter() - enc_t0
        trace = self.scheduler.run_mpc_round(
            t, self.collect_threshold, phase_models=self.phase_latency,
            monitor=self.monitor, timeout_s=self.round_timeout_s,
            payloads=payloads)
        if not math.isfinite(trace.t_done):
            raise ClusterDecodeError(
                f"MPC round {t}: {len(trace.responders)} final shares < "
                f"2T+1 = {self.collect_threshold} within "
                f"{self.round_timeout_s}s — BGW cannot ride through a "
                f"dead or stalled worker")
        dec_t0 = _time.perf_counter()
        order = np.asarray(trace.responders[: self.collect_threshold])
        if self.distributed:
            g = torch.as_tensor(np.stack(
                [np.asarray(trace.payloads[int(w)], dtype=np.int32)
                 for w in order]), device=self.device)
        else:
            g = mpc.all_g_shares(cfg, self.draws, t, self.w, self.state)[
                torch.as_tensor(order, dtype=torch.int64, device=self.device)]
        decoded = mpc.reconstruct_at(cfg, g, order)
        self.w = mpc.finish_update(cfg, self.w, decoded, self.state.xty,
                                   mpc.eta_over_m(self.eta, self.state.m))
        if self.distributed:
            self._sync()
            wire1 = wire_totals() if wire0 is not None else None
            self.walls[t] = (
                encode_s, _time.perf_counter() - dec_t0,
                0 if wire1 is None else wire1["tx_bytes"] - wire0["tx_bytes"],
                0 if wire1 is None else wire1["rx_bytes"] - wire0["rx_bytes"])
        self.traces[t] = trace
        if self.obs.enabled:
            self.obs.add_span("wait", trace.t_start, trace.t_done, round=t,
                              responders=len(trace.responders))
            for w, spans in trace.worker_traces.items():
                self.obs.add_process_spans(f"worker{int(w)}", spans, round=t)
        self._m_rounds.inc()
        self._m_wait.observe(trace.mpc_wait_s)
        return trace

    def run(self, iters: int) -> torch.Tensor:
        """No resilient variant: a starved round is terminal for BGW."""
        self.w = self.state.w
        self.traces.clear()
        self.walls.clear()
        for t in range(iters):
            self.step_round(t)
        return self.w

    # ------------------------------------------------------------------
    # Stats (the keys of runner.wait_stats where they apply)
    # ------------------------------------------------------------------

    def wait_stats(self) -> dict[str, dict[str, float]]:
        trs = sorted(self.traces.values(), key=lambda r: r.round)
        waits = np.array([r.mpc_wait_s for r in trs])
        allw = np.array([r.all_wait_s for r in trs])
        stats = {"mpc": wait_summary(waits),
                 "mpc_all": wait_summary(allw[np.isfinite(allw)]),
                 "rounds": {"n": float(len(trs))}}
        if self.walls:
            walls = np.array([self.walls[r.round] for r in trs], dtype=float)
            stats.update(
                encode=wait_summary(walls[:, 0]),
                decode=wait_summary(walls[:, 1]),
                critical_path=wait_summary(walls[:, 0] + waits + walls[:, 1]),
                wire_tx_bytes=wait_summary(walls[:, 2]),
                wire_rx_bytes=wait_summary(walls[:, 3]))
        wire_totals = getattr(self.scheduler.transport, "wire_totals", None)
        if wire_totals is not None:
            stats["wire_totals"] = {k: float(v)
                                    for k, v in wire_totals().items()}
        return stats
