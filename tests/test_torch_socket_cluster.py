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
      first-T beats wait-all, bit-identical to the port's train_reference.

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
