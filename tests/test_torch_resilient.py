"""The port's ``ClusterRunner.run_resilient`` on the CPU: checkpoint
restore, reprovision and replay after a starved round.

  * in process (tests/test_cluster.py's resilient case): two workers die
    in the same round, one more than the code tolerates; the run restores
    once, revives them and replays, bit-identical to the port's
    train_reference over the observed trace, with and without the
    pipeline; fed the reference's draws (``JaxDraws``) it restores where
    the reference's runner does, with its responder traces and weights
    within W_ATOL_TRAIN;
  * over sockets (tests/test_socket_cluster.py's resilient case, ``slow``):
    the ``respawn`` hook starts fresh port worker processes for the dead
    slots, the runner reprovisions them and the replay completes;
  * ``cpml_cluster --resilient`` on the CPU, in process and over sockets.
"""
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.cluster import ClusterRunner as JRunner  # noqa: E402
from repro.cluster import latency as jlat  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.cluster import latency as tlat  # noqa: E402
from repro_torch.cluster.runner import ClusterRunner  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from test_torch_protocol import W_ATOL_TRAIN, JaxDraws  # noqa: E402

BINARY = dict(N=8, K=2, T=1, r=1)          # threshold 7: one death absorbed


@pytest.fixture(scope="module")
def binary_data():
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=200, d=16)
    return np.array(x), np.array(y)


def two_dead(pkg):
    return pkg.DeadWorkerLatency(pkg.LognormalTailLatency(seed=5),
                                 deaths={0: 4, 1: 4})


def run_resilient(runner, iters, manager_cls=CheckpointManager, **kw):
    with tempfile.TemporaryDirectory() as d:
        return runner.run_resilient(iters, manager_cls(d, async_write=False),
                                    checkpoint_every=2, **kw)


@pytest.mark.parametrize("pipeline", ["off", "full"])
def test_cluster_resilient_recovers_from_worker_death(binary_data, pipeline):
    x, y = binary_data
    cfg = tp.CPMLConfig(**BINARY)
    draws = tp.TorchDraws(9)
    runner = ClusterRunner(cfg, x, y, two_dead(tlat), draws=draws,
                           device="cpu", round_timeout_s=60.0,
                           pipeline=pipeline)
    w = run_resilient(runner, 12)
    assert runner.restarts == 1
    assert sorted(runner.records) == list(range(12))
    assert w.shape == (x.shape[1],)
    assert runner.records[11].n_responders >= cfg.threshold
    assert any(r.replayed for r in runner.records.values())
    w_ref, _ = tp.train_reference(cfg, x, y, 12, eta=runner.eta,
                                  survivor_fn=runner.survivor_fn(),
                                  draws=draws, device="cpu")
    assert torch.equal(w, w_ref)


def test_resilient_matches_reference(binary_data):
    x, y = binary_data
    cj = jp.CPMLConfig(**BINARY)
    ct = tp.CPMLConfig(**BINARY)
    key = jax.random.PRNGKey(9)
    iters = 10
    jrun = JRunner(cj, key, jnp.asarray(x), jnp.asarray(y), two_dead(jlat),
                   round_timeout_s=60.0)
    w_j = run_resilient(jrun, iters, JManager)
    trun = ClusterRunner(ct, x, y, two_dead(tlat),
                         draws=JaxDraws(cj, key, iters), device="cpu",
                         round_timeout_s=60.0)
    w_t = run_resilient(trun, iters)
    assert trun.restarts == jrun.restarts == 1
    for t in range(iters):
        rj, rt = jrun.records[t], trun.records[t]
        assert np.array_equal(rj.survivors, rt.survivors), t
        assert rj.replayed == rt.replayed, t
        assert (rj.coded_wait_s, rj.all_wait_s) == (rt.coded_wait_s,
                                                    rt.all_wait_s), t
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=W_ATOL_TRAIN)


def test_resilient_gives_up_after_max_retries(binary_data):
    """A round that starves however often it is replayed (too few workers
    for good, revived or not) ends the run after max_retries restores."""
    x, y = binary_data
    cfg = tp.CPMLConfig(**BINARY)

    class NeverEnough(tlat.DeterministicLatency):
        def sample(self, round, worker):
            return float("inf") if worker < 2 else 1.0

        def revive(self, worker, at_round):
            pass

    runner = ClusterRunner(cfg, x, y, NeverEnough(), device="cpu",
                           round_timeout_s=30.0)
    from repro_torch.cluster.scheduler import ClusterDecodeError
    with pytest.raises(ClusterDecodeError):
        run_resilient(runner, 4, max_retries=2)


@pytest.mark.slow
def test_socket_resilient_restore_respawns_dead_workers(binary_data):
    """Two port worker processes die in round 4 (threshold 7 of 8): the
    starved round restores, ``respawn`` starts fresh processes for slots
    0 and 1, the runner reprovisions them over the wire, and the replay
    is bit-identical to the port's train_reference over the trace."""
    from repro_torch.cluster.messages import worker_endpoint
    from repro_torch.launch.cpml_cluster import (local_socket_cluster,
                                                 spawn_worker)

    x, y = binary_data
    cfg = tp.CPMLConfig(**BINARY)
    draws = tp.TorchDraws(7)
    reports: list = []
    with local_socket_cluster(cfg.N, die_at_round={0: 4, 1: 4},
                              device="cpu", reports=reports) as tr:
        runner = ClusterRunner(cfg, x, y, latency=None, transport=tr,
                               draws=draws, device="cpu",
                               round_timeout_s=6.0)
        runner.provision()

        def respawn(worker, step):
            tr.procs.append(spawn_worker(tr.port, worker, device="cpu",
                                         stdout=tr.worker_stdout))
            tr.wait_for_endpoints([worker_endpoint(worker)], timeout_s=60.0)

        w = run_resilient(runner, 10, respawn=respawn)
        runner.shutdown_workers()
    assert runner.restarts == 1
    assert sorted(runner.records) == list(range(10))
    assert runner.records[9].n_responders >= cfg.threshold
    # each dead slot has two reports: the crash and its replacement
    for slot in (0, 1):
        exits = sorted(r["exit"] for r in reports if r["worker"] == slot)
        assert len(exits) == 2 and exits[0] == "die_at_round 4"
    w_ref, _ = tp.train_reference(cfg, x, y, 10, eta=runner.eta,
                                  survivor_fn=runner.survivor_fn(),
                                  draws=draws, device="cpu")
    assert torch.equal(w, w_ref)


SMALL = ["--device", "cpu", "--m", "200", "--d", "12"]


def test_cpml_cluster_resilient_inprocess_cpu_smoke(tmp_path, capsys):
    from repro_torch.launch import cpml_cluster
    out = tmp_path / "r.json"
    assert cpml_cluster.main([*SMALL, "--iters", "8", "--latency", "dead",
                              "--resilient", "--checkpoint-every", "2",
                              "--json-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "resilient run: 1 restart(s)" in text
    assert "bit-identical to train_reference over the observed " \
           "responder trace: True" in text
    got = json.loads(out.read_text())
    assert got["restarts"] == 1 and got["bit_identical"] is True


@pytest.mark.slow
def test_cpml_cluster_resilient_socket_cpu_smoke(tmp_path):
    """Workers 0 and 1 crash at round 2 (threshold 7 of 8): one restart,
    two respawned worker processes, bit-identical to train_reference."""
    from repro_torch.launch import cpml_cluster
    out = tmp_path / "r.json"
    assert cpml_cluster.main([*SMALL, "--iters", "6", "--transport",
                              "socket", "--resilient", "--kill-worker", "0",
                              "1", "--kill-at-round", "2",
                              "--checkpoint-every", "2", "--round-timeout",
                              "5", "--json-out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["bit_identical"] is True and got["restarts"] == 1
    slots = [r["worker"] for r in got["worker_reports"]]
    assert sorted(slots) == [0, 0, 1, 1, 2, 3, 4, 5, 6, 7]
    for r in got["worker_reports"]:
        assert r["device"] == "cpu"
