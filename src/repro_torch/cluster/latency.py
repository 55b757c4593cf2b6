"""Per-worker latency models for the cluster simulation (DESIGN.md §7).

Every model maps (round, worker) -> simulated seconds of compute+network
time for that worker's response; ``math.inf`` means the response never
arrives (dead worker).  Two properties matter for the runtime:

  * SEEDED + ORDER-INDEPENDENT: ``sample(t, w)`` derives a private RNG
    stream from ``(seed, t, w)`` — the same call returns the same value
    regardless of call order or how many other samples were drawn.  This is
    what makes checkpoint-restore REPLAY deterministic (ResilientLoop
    re-runs rounds; the cluster must re-observe the same latencies).
  * HEAVY TAILS ON DEMAND: the paper's EC2 speedup comes from not waiting
    for the slow tail; the lognormal-tail and bursty-straggler models
    reproduce that tail so BENCH_cluster.json can measure the Fig. 5 effect.
"""
from __future__ import annotations

import abc
import math

import numpy as np


def _rng(seed: int, *ids: int) -> np.random.Generator:
    """Private RNG stream for one (round, worker) draw — order-independent."""
    return np.random.default_rng((int(seed),) + tuple(int(i) for i in ids))


class LatencyModel(abc.ABC):
    @abc.abstractmethod
    def sample(self, round: int, worker: int) -> float:
        """Simulated response latency in seconds; math.inf = never arrives."""

    def revive(self, worker: int, at_round: int) -> None:
        """Node replacement hook; a no-op unless the model kills workers."""


class DeterministicLatency(LatencyModel):
    """Fixed per-worker latency with a linear skew: worker i always takes
    ``base * (1 + skew * i)``.  The replayable no-noise baseline."""

    def __init__(self, base: float = 1.0, skew: float = 0.05):
        self.base = base
        self.skew = skew

    def sample(self, round: int, worker: int) -> float:
        return self.base * (1.0 + self.skew * worker)


class LognormalTailLatency(LatencyModel):
    """Lognormal body with an occasional multiplicative heavy tail.

    latency = base * LogNormal(0, sigma), multiplied by ``tail_scale`` with
    probability ``tail_prob`` — the classic EC2 straggler distribution
    (most responses tight around base, a few 10x outliers).
    """

    def __init__(self, seed: int = 0, base: float = 1.0, sigma: float = 0.3,
                 tail_prob: float = 0.05, tail_scale: float = 10.0):
        self.seed = seed
        self.base = base
        self.sigma = sigma
        self.tail_prob = tail_prob
        self.tail_scale = tail_scale

    def sample(self, round: int, worker: int) -> float:
        rng = _rng(self.seed, 0, round, worker)
        lat = self.base * math.exp(rng.normal(0.0, self.sigma))
        if rng.random() < self.tail_prob:
            lat *= self.tail_scale
        return lat


class BurstyStragglerLatency(LatencyModel):
    """Markov-style straggling: a worker that enters a burst stays slow for
    ``burst_len`` consecutive rounds (node paging / noisy neighbor), then
    recovers.  Burst membership is computed from scratch per (round, worker)
    — a burst covers round t iff one STARTED in (t - burst_len, t] — so
    sampling stays order-independent despite the temporal correlation.
    """

    def __init__(self, seed: int = 0, base: float = 1.0, sigma: float = 0.1,
                 burst_prob: float = 0.03, burst_len: int = 5,
                 slow_factor: float = 8.0):
        self.seed = seed
        self.base = base
        self.sigma = sigma
        self.burst_prob = burst_prob
        self.burst_len = burst_len
        self.slow_factor = slow_factor

    def _burst_starts(self, round: int, worker: int) -> bool:
        return _rng(self.seed, 1, round, worker).random() < self.burst_prob

    def in_burst(self, round: int, worker: int) -> bool:
        lo = max(0, round - self.burst_len + 1)
        return any(self._burst_starts(s, worker)
                   for s in range(lo, round + 1))

    def sample(self, round: int, worker: int) -> float:
        rng = _rng(self.seed, 2, round, worker)
        lat = self.base * math.exp(rng.normal(0.0, self.sigma))
        if self.in_burst(round, worker):
            lat *= self.slow_factor
        return lat


class SleepyStragglerLatency(LatencyModel):
    """Wraps another model and adds a fixed sleep to chosen workers —
    the simulation analog of cpml_worker's ``--sleep-s`` injection
    (``sleeps={worker: seconds}``), so sim and socket benchmarks inject
    the SAME deterministic straggler shape.
    """

    def __init__(self, inner: LatencyModel, sleeps: dict[int, float]):
        self.inner = inner
        self.sleeps = dict(sleeps)

    def sample(self, round: int, worker: int) -> float:
        return self.inner.sample(round, worker) + self.sleeps.get(worker, 0.0)

    def revive(self, worker: int, at_round: int) -> None:
        self.inner.revive(worker, at_round)


class DeadWorkerLatency(LatencyModel):
    """Wraps another model and kills chosen workers at chosen rounds.

    ``deaths={worker: round}``: the worker stops responding from that round
    on, until ``revive(worker, at_round)`` models its replacement node
    coming up — the worker is then alive again for rounds >= at_round
    (rounds in [death, revival) stay dead on replay, keeping restore-and-
    replay deterministic).
    """

    def __init__(self, inner: LatencyModel, deaths: dict[int, int]):
        self.inner = inner
        self.deaths = dict(deaths)
        self.revivals: dict[int, int] = {}

    def _dead(self, round: int, worker: int) -> bool:
        died = self.deaths.get(worker)
        if died is None or round < died:
            return False
        revived = self.revivals.get(worker)
        return revived is None or round < revived

    def sample(self, round: int, worker: int) -> float:
        if self._dead(round, worker):
            return math.inf
        return self.inner.sample(round, worker)

    def revive(self, worker: int, at_round: int) -> None:
        if worker in self.deaths:
            self.revivals[worker] = at_round


LATENCY_MODELS = ("deterministic", "lognormal", "bursty", "dead")


def make_latency(name: str, seed: int = 0, **kw) -> LatencyModel:
    """CLI/benchmark factory.  ``dead`` wraps lognormal with worker 0 dying
    at round 3 (override via ``deaths={worker: round}``)."""
    if name == "deterministic":
        return DeterministicLatency(**kw)
    if name == "lognormal":
        return LognormalTailLatency(seed=seed, **kw)
    if name == "bursty":
        return BurstyStragglerLatency(seed=seed, **kw)
    if name == "dead":
        deaths = kw.pop("deaths", {0: 3})
        return DeadWorkerLatency(LognormalTailLatency(seed=seed, **kw), deaths)
    raise ValueError(f"unknown latency model {name!r}; "
                     f"choose from {LATENCY_MODELS}")
