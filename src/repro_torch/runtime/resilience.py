"""Fault-tolerance runtime: heartbeats, straggler/failure injection, restart.

Three layers of defense for 1000+-node runs (DESIGN.md §5):

1. CODED tolerance (zero-cost recovery): the paper's own mechanism.  Layers
   built on Lagrange codes (core/protocol, core/coded_linear) decode from any
   `threshold` of N shards — the HeartbeatMonitor simply feeds the survivor
   set into the decode-matrix selection.  No recomputation, no restart.

2. CHECKPOINT/RESTART: `ResilientLoop` wraps the train step; any step failure
   restores the latest checkpoint and replays.  Checkpoints are elastic
   (restorable onto a different mesh), giving scale-down-and-continue.

3. STRAGGLER MITIGATION: monitor marks slow workers (simulated via injected
   latency here; wall-clock thresholds on real clusters); coded layers drop
   them from the survivor set, uncoded paths trigger an elastic re-shard.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    latency_ewma: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    """Tracks N workers; exposes survivor sets for coded-decode selection.

    Clock-agnostic: pass ``now`` everywhere to run on a simulated clock
    (cluster/scheduler.py drives one from simulated epoch 0); omit it for
    wall-clock operation on a real deployment.
    """

    def __init__(self, n_workers: int, timeout_s: float = 10.0,
                 straggler_factor: float = 3.0, now: float | None = None):
        now = time.time() if now is None else now
        self.workers = {i: WorkerState(now) for i in range(n_workers)}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor

    def add_worker(self, worker: int, now: float | None = None):
        """Elastic JOIN (cluster/membership.py): start tracking a fresh
        worker slot on a clean heartbeat/latency slate.  Idempotent — an
        existing slot is re-initialized, which is exactly revive()."""
        self.workers[worker] = WorkerState(time.time() if now is None else now)

    def remove_worker(self, worker: int):
        """Elastic LEAVE: stop tracking a permanently retired slot (the
        membership layer never dispatches it again, so keeping its state
        would only skew the straggler median)."""
        self.workers.pop(worker, None)

    def heartbeat(self, worker: int, latency_s: float | None = None,
                  now: float | None = None):
        """latency_s=None is a liveness-only ack (leaves the EWMA alone);
        pass a measured latency to update the straggler statistic.  A
        heartbeat from an unknown slot (a joiner's first ack racing its
        admission, or a retired slot's last in-flight reply) is liveness
        evidence for nobody and is dropped."""
        if worker not in self.workers:
            return
        w = self.workers[worker]
        w.last_heartbeat = time.time() if now is None else now
        if latency_s is not None:
            w.latency_ewma = 0.8 * w.latency_ewma + 0.2 * latency_s
        w.alive = True

    def mark_failed(self, worker: int):
        if worker in self.workers:       # a retired slot is already gone
            self.workers[worker].alive = False

    def is_dead(self, worker: int, now: float | None = None) -> bool:
        """The ONE liveness predicate: explicitly failed, or heartbeat-
        silent beyond the (finite) timeout.  Shared by survivors() and the
        scheduler's collect-all dead-exit (cluster/scheduler.py), so the
        failure detector can never drift between call sites."""
        now = time.time() if now is None else now
        w = self.workers[worker]
        return not w.alive or (now - w.last_heartbeat) > self.timeout_s

    def revive(self, worker: int, now: float | None = None):
        """Node replacement: fresh worker on a clean latency slate."""
        self.workers[worker] = WorkerState(time.time() if now is None else now)

    def credit_stall(self, stall_s: float, now: float | None = None):
        """Master-side blocking work (a joiner's provisioning barrier, a
        checkpoint-restore respawn) stops round dispatch — and with it the
        per-round acks that are this detector's heartbeat source.  Without
        credit, a barrier longer than ``timeout_s`` makes the whole healthy
        fleet look silent-dead.  Shift every worker that was live BEFORE
        the stall forward by its duration; a worker already past the
        timeout when the stall began stays dead."""
        now = time.time() if now is None else now
        before = now - stall_s
        for w in self.workers.values():
            if w.alive and (before - w.last_heartbeat) <= self.timeout_s:
                w.last_heartbeat = min(now, w.last_heartbeat + stall_s)

    def survivors(self, now: float | None = None) -> np.ndarray:
        """Alive + non-straggling workers, fastest first."""
        # compare against None: simulated-clock callers legitimately pass 0.0
        now = time.time() if now is None else now
        lat = [w.latency_ewma for w in self.workers.values() if w.alive]
        median = float(np.median(lat)) if lat else 0.0
        good = []
        for i, w in self.workers.items():
            if self.is_dead(i, now=now):
                continue
            if median > 0 and w.latency_ewma > self.straggler_factor * median:
                continue           # straggler: exclude from the fast set
            good.append((w.latency_ewma, i))
        return np.array([i for _, i in sorted(good)], dtype=np.int64)


class FailureInjector:
    """Deterministic chaos for tests: kill/slow workers on a schedule."""

    def __init__(self, seed: int = 0, fail_prob: float = 0.0,
                 straggle_prob: float = 0.0):
        self.rng = random.Random(seed)
        self.fail_prob = fail_prob
        self.straggle_prob = straggle_prob

    def step(self, monitor: HeartbeatMonitor):
        for i, w in monitor.workers.items():
            if not w.alive:
                continue
            if self.rng.random() < self.fail_prob:
                monitor.mark_failed(i)
            elif self.rng.random() < self.straggle_prob:
                monitor.heartbeat(i, latency_s=10.0)
            else:
                monitor.heartbeat(i, latency_s=1.0 + 0.1 * self.rng.random())


class ResilientLoop:
    """Checkpoint-every-k + restore-and-replay on step failure.

    ``max_retries`` bounds failures PER STEP, not over the whole run: a
    long healthy run must not accumulate isolated transient failures until
    restart 4 kills it, while a deterministic failure at one step (which a
    run-wide-but-resetting budget would replay forever whenever a
    checkpointed step succeeds in between) still trips after max_retries.
    ``restarts`` counts every restart over the loop's lifetime for
    observability.  ``on_restore(step)`` (optional) runs after each
    checkpoint restore, before replay — the hook where a cluster driver
    reprovisions dead workers (cluster/runner.py).
    """

    def __init__(self, ckpt_manager, checkpoint_every: int = 100,
                 max_retries: int = 3,
                 on_restore: Callable[[int], None] | None = None):
        self.ckpt = ckpt_manager
        self.every = checkpoint_every
        self.max_retries = max_retries
        self.restarts = 0
        self.on_restore = on_restore

    def run(self, state: dict[str, Any], step_fn: Callable[[dict, int], dict],
            start_step: int, num_steps: int,
            shardings: dict | None = None) -> dict[str, Any]:
        """step_fn(state, step) -> state; must raise on failure."""
        step = start_step
        failures: dict[int, int] = {}
        while step < start_step + num_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if self.every and step % self.every == 0:
                    self.ckpt.save(step, state)
            except Exception:
                self.restarts += 1
                failures[step] = failures.get(step, 0) + 1
                if failures[step] > self.max_retries:
                    raise
                restored = self.ckpt.restore(shardings=shardings)
                step = restored.pop("step")
                state = restored
                if self.on_restore is not None:
                    self.on_restore(step)
        self.ckpt.wait()
        return state
