"""Socket clusters across the packages, on the CPU: real worker processes,
wire v2 frames over localhost TCP.

  (a) the reference's master (SocketTransport + ClusterRunner) drives the
      port's workers (``python -m repro_torch.launch.cpml_worker --device
      cpu``), one of them killed mid-run: weights bit-identical to the
      reference's train_reference over the observed trace; and pipelined,
      with mini-batches whose next indices ride ahead (``next_batch``);
  (b) the port's master drives the reference's workers: bit-identical to
      the port's train_reference;
  (c) the port's master drives the port's workers with a real straggler:
      first-T beats wait-all, bit-identical to the port's train_reference;
  (d) the reference's PredictionServer drives the port's workers in their
      "serve" mode, one of them killed: every prediction bit-identical to
      the reference's uncoded oracle;
  (e) the reference's ALCC masters (ClusterRunner(engine="alcc") and
      ALCCMLPRunner) drive the port's workers in their "alcc" and
      "alcc_mlp" modes: within the reference's ALCC_SOCKET_TOL of the
      reference's train_reference over the observed trace.

They spawn processes, so they are marked ``slow`` like
tests/test_socket_cluster.py.
"""
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

from repro.cluster import ClusterRunner as JRunner  # noqa: E402
from repro.cluster.messages import worker_endpoint  # noqa: E402
from repro.cluster.socket_transport import SocketTransport as JSocket  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.cluster.runner import ClusterRunner as TRunner  # noqa: E402
from repro_torch.cluster.socket_transport import SocketTransport as TSocket  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parents[1] / "src"
PORT_WORKER = ["-m", "repro_torch.launch.cpml_worker", "--device", "cpu"]
REF_WORKER = ["-m", "repro.launch.cpml_worker"]


@pytest.fixture(scope="module")
def binary_data():
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=256, d=20)
    return np.array(x), np.array(y)


@contextlib.contextmanager
def cluster(transport_cls, worker_cmd, n, die_at_round=None, sleep_s=None):
    """A master transport of ``transport_cls`` and ``n`` worker processes
    started with ``worker_cmd``; yields the transport once all connected."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    tr = transport_cls.master(poll_interval_s=0.02)
    procs = []
    try:
        for w in range(n):
            cmd = [sys.executable, *worker_cmd, "--host", "127.0.0.1",
                   "--port", str(tr.port), "--worker", str(w)]
            if w in (die_at_round or {}):
                cmd += ["--die-at-round", str(die_at_round[w])]
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


def check_killed(runner, killed, at_round, cfg):
    for t, rec in runner.records.items():
        if t >= at_round:
            assert killed not in set(map(int, rec.survivors))
    last = max(runner.records)
    assert runner.records[last].n_responders == cfg.threshold


@pytest.mark.parametrize("pipeline,batch_rows", [("off", None),
                                                 ("full", 16)])
def test_reference_master_drives_port_workers(binary_data, pipeline,
                                              batch_rows):
    """(a) The first slice's third check: torch workers under the JAX
    master, worker 5 killed at round 4."""
    x, y = binary_data
    cfg = jp.CPMLConfig(N=8, K=2, T=1, r=1, batch_rows=batch_rows)
    iters = 8
    key = jax.random.PRNGKey(7)
    with cluster(JSocket, PORT_WORKER, cfg.N, die_at_round={5: 4}) as tr:
        runner = JRunner(cfg, key, x, y, latency=None, transport=tr,
                         round_timeout_s=120.0, pipeline=pipeline)
        runner.provision(timeout_s=120.0)
        w = runner.run(iters)
        runner.shutdown_workers()
    check_killed(runner, 5, 4, cfg)
    if batch_rows is not None:
        assert runner.wait_stats()["rounds"]["prefetched"] == iters
    w_ref, _ = jp.train_reference(cfg, key, x, y, iters=iters,
                                  survivor_fn=runner.survivor_fn())
    assert (np.asarray(w) == np.asarray(w_ref)).all()


def test_port_master_drives_reference_workers(binary_data):
    """(b) The port's master, JAX workers, worker 2 killed at round 3."""
    x, y = binary_data
    cfg = tp.CPMLConfig(N=8, K=2, T=1, r=1)
    draws = tp.TorchDraws(11, "cpu")
    with cluster(TSocket, REF_WORKER, cfg.N, die_at_round={2: 3}) as tr:
        runner = TRunner(cfg, x, y, latency=None, transport=tr, draws=draws,
                         device="cpu", round_timeout_s=120.0,
                         pipeline="full")
        runner.provision(timeout_s=120.0)
        w = runner.run(6)
        runner.shutdown_workers()
    check_killed(runner, 2, 3, cfg)
    w_ref, _ = tp.train_reference(cfg, x, y, 6, eta=runner.eta,
                                  survivor_fn=runner.survivor_fn(),
                                  draws=draws, device="cpu")
    assert torch.equal(w, w_ref)


def test_port_master_drives_port_workers_with_straggler():
    """(c) The port end to end: a worker that really sleeps before each
    reply is the last arrival of every steady round, never decoded from,
    and waiting for it costs extra; multiclass with mini-batches."""
    x, y = jsyn.multiclass_mnist_like(jax.random.PRNGKey(42), m=256, d=20,
                                      c=3)
    x, y = np.array(x), np.array(y)
    cfg = tp.CPMLConfig(N=5, K=1, T=1, r=1, c=3, batch_rows=16)
    draws = tp.TorchDraws(3, "cpu")
    with cluster(TSocket, PORT_WORKER, cfg.N, sleep_s={2: 0.4}) as tr:
        runner = TRunner(cfg, x, y, latency=None, transport=tr, draws=draws,
                         device="cpu", round_timeout_s=120.0,
                         collect_all=True, pipeline="prefetch")
        runner.provision(timeout_s=120.0)
        w = runner.run(5)
        runner.shutdown_workers()
    stats = runner.wait_stats()
    assert math.isfinite(stats["wait_all"]["mean"])
    assert stats["coded_T"]["mean"] < stats["wait_all"]["mean"]
    for t, rec in runner.records.items():
        assert 2 not in set(map(int, rec.survivors))
        assert rec.all_wait_s > rec.coded_wait_s
        assert int(runner.traces[t].responders[-1]) == 2
    w_ref, _ = tp.train_reference(cfg, x, y, 5, eta=runner.eta,
                                  survivor_fn=runner.survivor_fn(),
                                  draws=draws, device="cpu")
    assert torch.equal(w, w_ref)


def test_reference_server_drives_port_serve_workers():
    from repro.cluster.serve import (PredictionServer, ServeConfig,
                                     open_loop_queries)
    cfg = ServeConfig(N=6, K=2, T=1, max_batch=8, max_wait_s=0.02)
    w = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (12, 5))
    qs = open_loop_queries(10, rows=4, d=12, rate_qps=100.0, seed=6)
    with cluster(JSocket, PORT_WORKER, cfg.N, die_at_round={4: 2}) as tr:
        srv = PredictionServer(cfg, w, jax.random.PRNGKey(2), transport=tr,
                               round_timeout_s=120.0, verify=True)
        srv.provision()
        srv.run(qs)
        srv.shutdown_workers()
    stats = srv.stats()
    assert stats["queries"] == 10 and stats["rounds"] >= 3
    assert stats["oracle"]["bit_identical"]
    for q in qs:
        assert np.array_equal(np.asarray(srv.results[q.qid].y),
                              srv.oracle_logits(q.x))
    assert 4 not in srv.traces[max(srv.traces)].responders


def test_reference_alcc_masters_drive_port_workers(binary_data):
    from repro.cluster import alcc_mlp as jmlp
    from repro.core.protocol import alcc_engine as je
    from repro.launch.cpml_cluster import ALCC_SOCKET_TOL
    x, y = binary_data
    cfg = je.ALCCConfig(N=8, K=2, T=1)
    key = jax.random.PRNGKey(7)
    with cluster(JSocket, PORT_WORKER, cfg.N) as tr:
        runner = JRunner(cfg, key, x, y, latency=None, transport=tr,
                         round_timeout_s=120.0, engine="alcc")
        runner.provision()
        w = runner.run(4)
        runner.shutdown_workers()
    w_ref, _ = je.train_reference(cfg, key, x, y, 4,
                                  survivor_fn=runner.survivor_fn())
    assert np.max(np.abs(np.asarray(w) - np.asarray(w_ref))) <= ALCC_SOCKET_TOL

    xm, ym = jsyn.multiclass_mnist_like(jax.random.PRNGKey(2), m=96, d=12,
                                        c=4)
    cm = je.ALCCConfig(N=8, K=2, T=1, c=4)
    with cluster(JSocket, PORT_WORKER, cm.N) as tr:
        mlp = jmlp.ALCCMLPRunner(cm, key, xm, ym, 8, latency=None,
                                 transport=tr, eta=0.1,
                                 round_timeout_s=120.0)
        mlp.provision()
        w1, w2 = mlp.run(3)
        mlp.shutdown_workers()
    w1r, w2r, _ = jmlp.train_reference(cm, key, xm, ym, 8, 3, 0.1,
                                       survivor_fn=mlp.survivor_fn())
    for a, b in ((w1, w1r), (w2, w2r)):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) <= ALCC_SOCKET_TOL
