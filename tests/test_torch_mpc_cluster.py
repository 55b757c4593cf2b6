"""The port's BGW baseline on the cluster runtime
(repro_torch.cluster.mpc_runner), on the CPU.

In process: the port's MPCClusterRunner is bit-identical to the port's own
single-host ``mpc_baseline.train`` with the same ``TorchMPCDraws``, with a
straggler, under shuffled lognormal orders and at r = 2; every reshare
phase waits for the slowest worker; a dead worker starves the round.  Fed
the reference's draws (``JaxMPCDraws``), it has the reference runner's
responder orders and simulated times, and weights within W_ATOL_TRAIN.

Over sockets (``slow``, like tests/test_mpc_cluster.py): the port's master
drives the port's worker processes, one of them a real straggler.

``cpml_cluster --protocol mpc`` on the CPU: the reference's refusals in
its words, the bit-identity line in process and over sockets, and a dead
worker starving the run.
"""
import json
import contextlib
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster import MPCClusterRunner as JRunner  # noqa: E402
from repro.cluster import mpc_phase_models as j_phase_models  # noqa: E402
from repro.core import mpc_baseline as jm  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.cluster import latency as tlat  # noqa: E402
from repro_torch.cluster.messages import worker_endpoint  # noqa: E402
from repro_torch.cluster.mpc_runner import (MPCClusterRunner,  # noqa: E402
                                            mpc_phase_models)
from repro_torch.cluster.runner import ClusterRunner  # noqa: E402
from repro_torch.cluster.scheduler import ClusterDecodeError  # noqa: E402
from repro_torch.cluster.socket_transport import SocketTransport  # noqa: E402
from repro_torch.core import field  # noqa: E402
from repro_torch.core import mpc_baseline as tm  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.protocol.draws import TorchMPCDraws  # noqa: E402
from test_torch_mpc import JaxMPCDraws  # noqa: E402
from test_torch_protocol import W_ATOL_TRAIN  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def binary_data():
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=200, d=16)
    return np.array(x), np.array(y)


class OneSlow(tlat.DeterministicLatency):
    """Worker ``slow`` always takes ``slow_s``; everyone else ``base``."""

    def __init__(self, slow, slow_s, base=1.0):
        super().__init__(base=base, skew=0.01)
        self.slow = slow
        self.slow_s = slow_s

    def sample(self, round, worker):
        return self.slow_s if worker == self.slow else super().sample(
            round, worker)


def oracle(cfg, x, y, iters, runner, seed):
    w, _ = tm.train(cfg, x, y, iters, eta=runner.eta,
                    draws=TorchMPCDraws(seed), device="cpu")
    return w


def test_mpc_cluster_bit_identical_with_straggler(binary_data):
    """N=8 T=3, 10 rounds, one alive straggler: bit-identical to the
    oracle, and the straggler, never among the 2T+1 reconstructed, gates
    every reshare barrier."""
    x, y = binary_data
    cfg = tm.MPCConfig(N=8, T=3, r=1)
    slow = 7
    runner = MPCClusterRunner(cfg, x, y,
                              [OneSlow(slow, 6.0), OneSlow(slow, 6.0, 0.5)],
                              draws=TorchMPCDraws(7), device="cpu")
    w = runner.run(10)
    assert torch.equal(w, oracle(cfg, x, y, 10, runner, 7))
    for trace in runner.traces.values():
        assert slow not in list(map(int, trace.responders[: 2 * cfg.T + 1]))
        assert trace.barriers[0] - trace.t_start >= 6.0
        assert trace.mpc_wait_s >= 6.0 + 0.5


def test_mpc_cluster_bit_identical_lognormal_orders_shuffle(binary_data):
    x, y = binary_data
    cfg = tm.MPCConfig(N=8, T=3, r=1)
    runner = MPCClusterRunner(cfg, x, y,
                              mpc_phase_models("lognormal", seed=3, r=cfg.r),
                              draws=TorchMPCDraws(11), device="cpu")
    w = runner.run(12)
    orders = {tuple(t.responders[: 7]) for t in runner.traces.values()}
    assert len(orders) > 1, "latency model produced a constant order"
    assert torch.equal(w, oracle(cfg, x, y, 12, runner, 11))


def test_mpc_cluster_r2_has_one_barrier_per_reduction(binary_data):
    x, y = binary_data
    cfg = tm.MPCConfig(N=8, T=2, r=2, p=field.P30)
    runner = MPCClusterRunner(cfg, x, y,
                              mpc_phase_models("deterministic", r=cfg.r),
                              draws=TorchMPCDraws(5), device="cpu")
    w = runner.run(3)
    assert torch.equal(w, oracle(cfg, x, y, 3, runner, 5))
    for trace in runner.traces.values():
        assert len(trace.barriers) == cfg.r
        assert trace.barriers[0] < trace.barriers[1] <= trace.t_done


def test_mpc_cluster_dead_worker_starves_the_round(binary_data):
    """2T+1 = 3 of 8 could reconstruct, but nobody gets past the reshare
    barrier once worker 5 is dead."""
    x, y = binary_data
    cfg = tm.MPCConfig(N=8, T=1, r=1)
    models = [tlat.DeadWorkerLatency(tlat.DeterministicLatency(), {5: 2}),
              tlat.DeterministicLatency(base=0.5)]
    runner = MPCClusterRunner(cfg, x, y, models, draws=TorchMPCDraws(7),
                              device="cpu", round_timeout_s=60.0)
    with pytest.raises(ClusterDecodeError):
        runner.run(10)
    assert 0 in runner.traces and 1 in runner.traces
    assert 2 not in runner.traces


def test_mpc_waits_exceed_coded_waits_under_same_tail(binary_data):
    x, y = binary_data
    coded = ClusterRunner(tp.CPMLConfig(N=8, K=2, T=1, r=1), x, y,
                          tlat.LognormalTailLatency(seed=0, tail_prob=0.2,
                                                    tail_scale=10.0),
                          device="cpu")
    coded.run(10)
    bgw = MPCClusterRunner(tm.MPCConfig(N=8, T=1, r=1), x, y,
                           mpc_phase_models("lognormal", seed=0, r=1),
                           device="cpu")
    bgw.run(10)
    assert (bgw.wait_stats()["mpc"]["mean"]
            > coded.wait_stats()["coded_T"]["mean"])


def test_runner_matches_reference(binary_data):
    """Fed the reference's draws: the reference runner's responder orders,
    barriers and waits, round by round, and its weights within
    W_ATOL_TRAIN; the port's run is bit-identical to the port's train
    with the same draws."""
    x, y = binary_data
    cj = jm.MPCConfig(N=5, T=2, r=1)
    ct = tm.MPCConfig(N=5, T=2, r=1)
    key = jax.random.PRNGKey(7)
    iters = 4
    jrun = JRunner(cj, key, jnp.asarray(x), jnp.asarray(y),
                   j_phase_models("lognormal", seed=3, r=1))
    w_j = jrun.run(iters)
    draws = JaxMPCDraws(cj, key)
    trun = MPCClusterRunner(ct, x, y,
                            mpc_phase_models("lognormal", seed=3, r=1),
                            draws=draws, device="cpu")
    w_t = trun.run(iters)
    for t in range(iters):
        a, b = jrun.traces[t], trun.traces[t]
        assert np.array_equal(a.responders, b.responders), t
        assert (a.t_start, a.t_done, a.t_all) == (b.t_start, b.t_done,
                                                  b.t_all), t
        assert a.barriers == b.barriers, t
    assert jrun.wait_stats() == {k: v for k, v in trun.wait_stats().items()
                                 if k in ("mpc", "mpc_all", "rounds")}
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=W_ATOL_TRAIN)
    w_ref, _ = tm.train(ct, x, y, iters, eta=trun.eta, draws=draws,
                        device="cpu")
    assert torch.equal(w_t, w_ref)


def test_runner_refusals(binary_data):
    x, y = binary_data
    runner = MPCClusterRunner(tm.MPCConfig(N=5, T=1), x, y,
                              mpc_phase_models("deterministic"), device="cpu")
    assert runner.state.x_shares_t is not None
    for fn in (runner.provision, runner.shutdown_workers):
        with pytest.raises(RuntimeError, match="real transport"):
            fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MPCClusterRunner(tm.MPCConfig(N=5, T=1), x, y,
                             mpc_phase_models("deterministic"))


def test_collect_all_inf_timeout_without_detector_is_refused():
    """The reference's case of the same name, on the port's scheduler and
    transport (it imports them from the package, which in the port
    re-exports nothing, so torch_parity cannot re-run it)."""
    from repro_torch.cluster.scheduler import EventScheduler

    master = SocketTransport.master(poll_interval_s=0.02)
    try:
        sched = EventScheduler(2, latency=None, transport=master)
        with pytest.raises(ValueError, match="collect_all"):
            sched.dispatch_round(0, threshold=1, timeout_s=math.inf,
                                 collect_all=True)
    finally:
        master.close()


# -- over sockets: the port's master and the port's worker processes --

@contextlib.contextmanager
def port_cluster(n, sleep_s=None):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    tr = SocketTransport.master(poll_interval_s=0.02)
    procs = []
    try:
        for w in range(n):
            cmd = [sys.executable, "-m", "repro_torch.launch.cpml_worker",
                   "--device", "cpu", "--host", "127.0.0.1",
                   "--port", str(tr.port), "--worker", str(w)]
            if w in (sleep_s or {}):
                cmd += ["--sleep-s", str(sleep_s[w])]
            procs.append(subprocess.Popen(cmd, env=env,
                                          stdout=subprocess.DEVNULL))
        tr.wait_for_endpoints([worker_endpoint(w) for w in range(n)],
                              timeout_s=120.0)
        yield tr
    finally:
        tr.close()
        deadline = time.monotonic() + 30.0
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@pytest.mark.slow
@pytest.mark.parametrize("r", [1, 2])
def test_socket_mpc_bit_identical_with_straggler(binary_data, r):
    """N=8 over real TCP, worker 7 sleeping before every phase: the reshare
    traffic relays through the master, every barrier waits for the
    sleeper, and the weights are bit-identical to the port's train."""
    x, y = binary_data
    cfg = tm.MPCConfig(N=8, T=3 if r == 1 else 2, r=r)
    sleep = 0.1
    iters = 5
    with port_cluster(cfg.N, sleep_s={7: sleep}) as tr:
        runner = MPCClusterRunner(cfg, x, y, None, draws=TorchMPCDraws(7),
                                  device="cpu", transport=tr,
                                  round_timeout_s=120.0)
        runner.provision(timeout_s=120.0)
        w = runner.run(iters)
        runner.shutdown_workers()
    assert len(runner.traces) == iters
    assert torch.equal(w, oracle(cfg, x, y, iters, runner, 7))
    for trace in runner.traces.values():
        # the sleeper's sub-shares gate the first barrier
        assert trace.mpc_wait_s >= sleep
    stats = runner.wait_stats()
    # the relay: N (N-1) sub-shares of m elements a reduction, each way
    assert stats["wire_rx_bytes"]["mean"] > cfg.N * (cfg.N - 1) * 200 * 4 * r


# -- cpml_cluster --protocol mpc on the CPU --

SMALL = ["--device", "cpu", "--m", "200", "--d", "12", "--iters", "4"]


@pytest.mark.parametrize("flags,words", [
    (["--resilient"], "--resilient is meaningless for MPC"),
    (["--pipeline", "full"], "--pipeline applies to the coded protocol"),
    (["--classes", "3"], "binary task only"),
    (["--kill-worker", "1"], "--kill-worker is meaningless for MPC"),
    (["--masters", "2"], "coded-protocol features"),
    (["--spares", "1"], "coded-protocol features"),
    (["--join-at-round", "2"], "coded-protocol features"),
])
def test_cpml_cluster_mpc_refusals_are_the_references(flags, words, capsys):
    from repro_torch.launch import cpml_cluster
    assert cpml_cluster.main([*SMALL, "--protocol", "mpc", *flags]) == 2
    assert words in capsys.readouterr().err


def test_cpml_cluster_mpc_inprocess_cpu_smoke(tmp_path, capsys):
    from repro_torch.launch import cpml_cluster
    out = tmp_path / "m.json"
    assert cpml_cluster.main([*SMALL, "--protocol", "mpc", "--latency",
                              "lognormal", "--json-out", str(out)]) == 0
    assert "bit-identical to the single-host mpc_baseline oracle: True" \
        in capsys.readouterr().out
    got = json.loads(out.read_text())
    assert got["bit_identical"] is True and got["device"] == "cpu"
    assert {"config", "wait_stats", "acc_mpc"} <= set(got)
    assert got["config"]["protocol"] == "mpc"
    assert got["launches_run"]["modmatmul"] == 0       # plain version


def test_cpml_cluster_mpc_dead_worker_starves_the_run():
    from repro_torch.launch import cpml_cluster
    with pytest.raises(ClusterDecodeError):
        cpml_cluster.main([*SMALL, "--protocol", "mpc", "--latency", "dead"])


@pytest.mark.slow
def test_cpml_cluster_mpc_socket_cpu_smoke(tmp_path, capsys):
    """N=5, T=2 over sockets with a straggler: every worker reports the
    CPU, no kernel launch and every round; bit-identical to the oracle."""
    from repro_torch.launch import cpml_cluster
    out = tmp_path / "m.json"
    assert cpml_cluster.main([*SMALL, "--protocol", "mpc", "--transport",
                              "socket", "-N", "5", "-T", "2",
                              "--straggle-worker", "4", "--straggle-sleep",
                              "0.05", "--json-out", str(out)]) == 0
    assert "bit-identical to the single-host mpc_baseline oracle: True" \
        in capsys.readouterr().out
    got = json.loads(out.read_text())
    reports = {r["worker"]: r for r in got["worker_reports"]}
    assert sorted(reports) == list(range(5))
    for r in reports.values():
        assert r["device"] == "cpu" and r["rounds"] == 4
        assert set(r["launches"].values()) == {0}
    assert got["provision_wire"]["tx_bytes"] > 5 * 200 * 12 * 3
    assert got["wait_stats"]["wire_rx_bytes"]["mean"] > 0
