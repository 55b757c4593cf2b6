"""ALCCMLPRunner: coded MLP training over the cluster runtime, on torch.

Mirrors ``repro/cluster/alcc_mlp.py``.  One gradient step of the two-layer
gelu MLP (``models/layers.gelu_mlp``) is two bilinear coded phases with
the nonlinear work on the master between them:

  round 2t   (phase A): workers compute X̃_i[batch] @ W̃1_i; any
             ``mlp_threshold`` responses decode to Z1_k = X̄_k[batch] @ W1;
  master:    gelu forward, softmax-CE backward through layer 2
             (``alcc_engine.mlp_middle``): the W2 gradient and δ1_k;
  round 2t+1 (phase B): δ1 is encoded like data (per part, fresh masks)
             and workers compute X̃_i[batch]ᵀ @ δ̃1_i; the decode's sum is
             the W1 gradient.

The runner drives the same EventScheduler as ClusterRunner: a latency
model simulates the fleet (each responder's product on the master's
device, the op its worker process runs), or a SocketTransport dispatches to
``cpml_worker`` processes provisioned with ``"protocol": "alcc_mlp"``.  A
simulated run replays bit for bit through ``train_reference`` below,
which runs the same ops; a socket run within the decode error budget
(1e-3 in the CLI).  Randomness comes from a draws object
(``TorchALCCDraws`` by default): step t's rounds are 2t and 2t+1.
"""
from __future__ import annotations

import math
import time as _time
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.cluster.latency import LatencyModel
from repro_torch.cluster.messages import (
    PROVISION_ROUND, SHUTDOWN_ROUND, EncodeShare, worker_endpoint)
from repro_torch.cluster.runner import await_worker_acks, wait_summary
from repro_torch.cluster.scheduler import ClusterDecodeError, EventScheduler
from repro_torch.cluster.transport import Transport
from repro_torch.core.protocol import alcc_engine
from repro_torch.core.protocol.draws import TorchALCCDraws
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.resilience import HeartbeatMonitor


def _decode_order(cfg: alcc_engine.ALCCConfig, responders) -> np.ndarray:
    """The responders a degree-2 decode reads: ``mlp_threshold`` of them on
    the square path, all of them on the ill-conditioned fallback."""
    sv = np.asarray(responders)
    _, info = cfg.scheme.decode_matrix(sv, 2)
    return np.asarray(sv[: info["rows"]], np.int64)


def _step_update(w1, w2, gw1, gw2, eta: float):
    return ((w1.to(torch.float64) - eta * gw1).to(torch.float32),
            w2 - eta * gw2)


class ALCCMLPRunner:
    """Drives ``iters`` two-phase MLP steps through the event scheduler.

    ``latency`` given: in-process simulation.  ``latency=None`` and a real
    ``transport``: the socket backend (``provision()`` first).  ``eta`` is
    both layers' step size; ``round_timeout_s`` is each phase's collect
    deadline on a real transport.  ``x``, ``y`` go to ``device`` (``None``
    means CUDA).
    """

    def __init__(self, cfg: alcc_engine.ALCCConfig, x, y, hidden: int,
                 latency: LatencyModel | None = None, *,
                 draws=None,
                 device: str | torch.device | None = None,
                 eta: float = 0.1,
                 transport: Transport | None = None,
                 round_timeout_s: float = math.inf,
                 heartbeat_timeout_s: float = math.inf,
                 metrics: MetricsRegistry | None = None,
                 recorder=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.draws = (draws if draws is not None
                      else TorchALCCDraws(0, self.device))
        self.hidden = int(hidden)
        self.eta = float(eta)
        self.threshold = cfg.mlp_threshold
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        self.state = alcc_engine.mlp_setup(cfg, x, y, hidden,
                                           draws=self.draws)
        self.w1 = self.state.w1
        self.w2 = self.state.w2
        self.scheduler = EventScheduler(cfg.N, latency, transport,
                                        recorder=recorder)
        self.obs = self.scheduler.obs
        self.obs.bind_clock(self.scheduler.time.now)
        self.latency = latency
        self.round_timeout_s = round_timeout_s
        if self.distributed and math.isinf(round_timeout_s):
            self.round_timeout_s = 300.0
        self.monitor = HeartbeatMonitor(cfg.N, timeout_s=heartbeat_timeout_s,
                                        now=self.scheduler.clock)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_steps = self.metrics.counter(
            "cpml_mlp_steps_total", "completed MLP training steps")
        self._m_cond = self.metrics.gauge(
            "cpml_alcc_decode_cond",
            "condition number of the last ALCC least-squares decode")
        self._m_budget = self.metrics.gauge(
            "cpml_alcc_error_budget",
            "a-priori absolute decode error bound of the last ALCC round")
        self._m_fallback = self.metrics.counter(
            "cpml_alcc_decode_fallbacks_total",
            "ALCC decodes that took the overdetermined fallback path")
        self.alcc_info: list[dict] = []
        self.survivors: dict[int, np.ndarray] = {}      # round id -> order
        self.history: list[dict[str, float]] = []
        self.traces: dict = {}
        self._phase_stats: list[dict[str, float]] = []

    @property
    def distributed(self) -> bool:
        return self.latency is None

    # ------------------------------------------------------------------
    # Socket provisioning
    # ------------------------------------------------------------------

    def provision(self, timeout_s: float = 60.0) -> None:
        """Ship each worker its float dataset share and the MLP mode; each
        acks after a warm-up of both phases' products."""
        if not self.distributed:
            raise RuntimeError("provision() is for real transports only")
        cfg = self.cfg
        wall0 = _time.perf_counter()
        with self.obs.span("provision", workers=cfg.N):
            tr = self.scheduler.transport
            cfg_kw = {"N": cfg.N, "K": cfg.K, "T": cfg.T, "r": cfg.r,
                      "c": cfg.c, "sigma": cfg.sigma,
                      "batch_rows": cfg.batch_rows}
            x_shares = self.state.x_shares.cpu().numpy()
            now = self.scheduler.clock
            for w in range(cfg.N):
                tr.send(worker_endpoint(w),
                        EncodeShare(PROVISION_ROUND, w, {
                            "protocol": "alcc_mlp", "cfg": cfg_kw,
                            "hidden": self.hidden, "x_share": x_shares[w],
                            "trace": bool(self.obs.enabled)}),
                        at=now)
            await_worker_acks(tr, lambda: self.scheduler.clock, cfg.N,
                              self.monitor, timeout_s)
        self.metrics.gauge(
            "cpml_provision_seconds",
            "wall seconds from provisioning dispatch to the last worker "
            "ack (includes the workers' warm-up)").set(
                _time.perf_counter() - wall0)

    def shutdown_workers(self) -> None:
        if not self.distributed:
            raise RuntimeError("shutdown_workers() is for real transports")
        now = self.scheduler.clock
        for w in range(self.cfg.N):
            self.scheduler.transport.send(
                worker_endpoint(w), EncodeShare(SHUTDOWN_ROUND, w), at=now)

    # ------------------------------------------------------------------
    # One coded phase = one scheduler round
    # ------------------------------------------------------------------

    def _coded_phase(self, rid: int, shares: torch.Tensor,
                     batch_idx: torch.Tensor | None, phase: int
                     ) -> tuple[torch.Tensor, np.ndarray]:
        """Dispatch round ``rid`` with per-worker ``shares``; return the
        float32 responses in decode order and the order."""
        cfg = self.cfg
        payloads = None
        enc_t0 = _time.perf_counter()
        if self.distributed:
            shares_np = shares.cpu().numpy()
            batch_np = (None if batch_idx is None
                        else batch_idx.cpu().numpy().astype(np.int32))
            payloads = {w: {"w_share": shares_np[w], "batch": batch_np,
                            "next_batch": None}
                        for w in range(cfg.N)}
        encode_s = _time.perf_counter() - enc_t0
        trace = self.scheduler.dispatch_round(
            rid, self.threshold, monitor=self.monitor,
            timeout_s=self.round_timeout_s, payloads=payloads)
        if not math.isfinite(trace.t_first_R):
            raise ClusterDecodeError(
                f"phase round {rid}: {len(trace.responders)} responses < "
                f"threshold {self.threshold}")
        order = _decode_order(cfg, trace.responders)
        if self.distributed:
            fastest = torch.as_tensor(
                np.stack([np.asarray(trace.payloads[int(w)], np.float32)
                          for w in order]), device=self.device)
        else:
            # what the responders' worker processes would return
            fastest = alcc_engine.mlp_responders_eval(
                phase, self.state.x_shares, shares, order, batch_idx)
        self._phase_stats.append({
            "wait_s": trace.t_first_R - trace.t_start,
            "encode_s": encode_s if self.distributed else 0.0})
        self.survivors[rid] = np.asarray(trace.responders).copy()
        self.traces[rid] = trace
        return fastest, order

    def _track(self, info: dict, rid: int) -> None:
        self.alcc_info.append(info)
        self._m_cond.set(float(info["cond"]))
        self._m_budget.set(float(info["abs_err_budget"]))
        if info["fallback"]:
            self._m_fallback.inc()
        self.obs.instant("alcc_decode", round=rid,
                         cond=float(info["cond"]),
                         err_budget=float(info["abs_err_budget"]),
                         fallback=bool(info["fallback"]))

    def _batch(self, t: int) -> torch.Tensor | None:
        return alcc_engine._batch(self.cfg, self.draws, t, self.state.mk,
                                  self.device)

    def step(self, t: int) -> None:
        """One MLP step: phase A, the master's middle, phase B, update."""
        cfg = self.cfg
        with self.obs.span("mlp_step", step=t):
            bidx = self._batch(t)
            w1_shares = alcc_engine.mlp_encode_forward(cfg, self.draws,
                                                       2 * t, self.w1)
            fast, order = self._coded_phase(2 * t, w1_shares, bidx, 0)
            z1_parts, info = alcc_engine.mlp_decode_forward(cfg, fast, order)
            self._track(info, 2 * t)
            gw2, dz1, loss, acc = alcc_engine.mlp_middle(
                cfg, self.state, z1_parts, bidx)
            d1_shares = alcc_engine.mlp_encode_backward(cfg, self.draws,
                                                        2 * t + 1, dz1)
            fast, order = self._coded_phase(2 * t + 1, d1_shares, bidx, 1)
            gw1, info = alcc_engine.mlp_decode_backward(cfg, fast, order)
            self._track(info, 2 * t + 1)
            self.w1, self.w2 = _step_update(self.w1, self.w2, gw1, gw2,
                                            self.eta)
            self.history.append({"step": t, "loss": loss, "acc": acc})
        self._m_steps.inc()

    def run(self, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Train for ``iters`` steps from the initial weights; returns
        (w1, w2)."""
        self.w1, self.w2 = self.state.w1, self.state.w2
        self.alcc_info.clear()
        self.survivors.clear()
        self.history.clear()
        self.traces.clear()
        self._phase_stats.clear()
        for t in range(iters):
            self.step(t)
        return self.w1, self.w2

    # ------------------------------------------------------------------
    # Verification + stats
    # ------------------------------------------------------------------

    def survivor_fn(self) -> Callable[[int], np.ndarray]:
        """Round id (2t / 2t+1) -> observed responders, for
        ``train_reference``."""
        trace = dict(self.survivors)
        return lambda rid: trace[rid]

    def wait_stats(self) -> dict[str, dict[str, float]]:
        stats = {
            "coded_T": wait_summary([p["wait_s"] for p in self._phase_stats]),
            "encode": wait_summary(
                [p["encode_s"] for p in self._phase_stats]),
            "alcc": {
                "cond": wait_summary([i["cond"] for i in self.alcc_info]),
                "abs_err_budget": wait_summary(
                    [i["abs_err_budget"] for i in self.alcc_info]),
                "fallbacks": {"n": float(sum(
                    1 for i in self.alcc_info if i["fallback"]))},
            },
            "rounds": {"n": float(len(self._phase_stats))},
        }
        wire_totals = getattr(self.scheduler.transport, "wire_totals", None)
        if wire_totals is not None:
            stats["wire_totals"] = {k: float(v)
                                    for k, v in wire_totals().items()}
        return stats

    def metrics_now(self) -> tuple[float, float]:
        """Full-data (loss, accuracy) of the current weights."""
        return alcc_engine.mlp_metrics(self.state, self.w1, self.w2)


def train_reference(cfg: alcc_engine.ALCCConfig, x, y, hidden: int,
                    iters: int, eta: float,
                    survivor_fn: Callable[[int], np.ndarray] | None = None,
                    *, draws=None, device: str | torch.device | None = None):
    """Schedulerless replay of the two-phase loop over the same ops.

    With a runner's ``survivor_fn()`` and draws, on its device, this
    reproduces a simulated run's weights bit for bit and a socket run's
    within the decode error budget.  Returns (w1, w2, history).
    """
    x, y, draws = alcc_engine._prepare(x, y, draws, device)
    state = alcc_engine.mlp_setup(cfg, x, y, hidden, draws=draws)
    w1, w2 = state.w1, state.w2
    everyone = np.arange(cfg.N)
    history = []
    for t in range(iters):
        bidx = alcc_engine._batch(cfg, draws, t, state.mk, x.device)
        orders = [_decode_order(cfg, everyone if survivor_fn is None
                                else survivor_fn(rid))
                  for rid in (2 * t, 2 * t + 1)]
        w1_shares = alcc_engine.mlp_encode_forward(cfg, draws, 2 * t, w1)
        fast = alcc_engine.mlp_responders_eval(0, state.x_shares, w1_shares,
                                               orders[0], bidx)
        z1_parts, _ = alcc_engine.mlp_decode_forward(cfg, fast, orders[0])
        gw2, dz1, loss, acc = alcc_engine.mlp_middle(cfg, state, z1_parts,
                                                     bidx)
        d1_shares = alcc_engine.mlp_encode_backward(cfg, draws, 2 * t + 1,
                                                    dz1)
        fast = alcc_engine.mlp_responders_eval(1, state.x_shares, d1_shares,
                                               orders[1], bidx)
        gw1, _ = alcc_engine.mlp_decode_backward(cfg, fast, orders[1])
        w1, w2 = _step_update(w1, w2, gw1, gw2, eta)
        history.append({"step": t, "loss": loss, "acc": acc})
    return w1, w2, history
