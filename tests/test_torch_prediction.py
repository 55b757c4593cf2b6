"""The port's coded prediction serving plane (repro_torch.cluster.serve)
against the reference's, on the CPU.

The reference's randomness reaches the port through ``JaxServeDraws``,
which replays its keys: ``kmask, kflush = split(key)``, the model's masks
from ``kmask`` and flush t's from ``fold_in(kflush, t)``.  Serving is exact
field arithmetic, so everything is held bit for bit: the model's shares,
every flush's query shares, the decoded field values, the served logits,
and the responder traces and simulated latencies (the scheduler and
latency models are copies).

``tests/test_serve.py``'s cases that reach no JAX object (the batching
policy, config validation, the Query/Prediction frames) re-run against the
port through ``torch_parity``; its admission cases build a JAX model, so
they are re-stated here on the port's server.  A socket run of the port's
master and CPU worker processes, one of them killed, is bit-identical to
the oracle (``slow``, as the reference's).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.cluster import latency as jlat  # noqa: E402
from repro.cluster import serve as js  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import lagrange as jl  # noqa: E402
from repro_torch.cluster import latency as tlat  # noqa: E402
from repro_torch.cluster import serve as ts  # noqa: E402
from repro_torch.cluster.messages import Query  # noqa: E402
from repro_torch.core import field as tf  # noqa: E402
from repro_torch.core import lagrange as tl  # noqa: E402
from repro_torch.core.protocol.draws import TorchServeDraws  # noqa: E402
import torch_parity  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class JaxServeDraws:
    """The reference server's draws (jax.random, threefry) behind the
    port's seam."""

    def __init__(self, key):
        self.kmask, self.kflush = jax.random.split(key)

    def weight_masks(self, T, shape, p):
        return torch.from_numpy(np.array(
            jl.draw_masks(self.kmask, T, tuple(shape), p)))

    def flush_masks(self, t, T, shape, p):
        return torch.from_numpy(np.array(jl.draw_masks(
            jax.random.fold_in(self.kflush, t), T, tuple(shape), p)))


SERVE_CASES = torch_parity.reference_cases("test_serve")


def test_reference_case_list():
    assert {c.values[1] for c in SERVE_CASES} == {
        "test_policy_flushes_on_size", "test_policy_flushes_on_deadline",
        "test_policy_never_flushes_empty_queue", "test_config_validation",
        "test_query_roundtrip", "test_prediction_roundtrip"}


@pytest.mark.parametrize("module,name,params", SERVE_CASES)
def test_reference_case_against_port(module, name, params, request):
    torch_parity.run_case(module, name, params, request)


def tiny_cfg(**kw):
    return ts.ServeConfig(**{"N": 6, "K": 2, "T": 1, "max_batch": 8,
                             "max_wait_s": 0.02, **kw})


def tiny_server(cfg=None, d=12, classes=5, **kw):
    w = np.random.default_rng(1).normal(size=(d, classes)).astype(np.float32)
    kw.setdefault("latency", tlat.DeterministicLatency(base=1e-3, skew=0.1))
    return ts.PredictionServer(cfg or tiny_cfg(), 0.5 * w, verify=True,
                               draws=TorchServeDraws(2, "cpu"),
                               device="cpu", **kw)


def test_queue_full_and_oversized_queries_rejected():
    srv = tiny_server(tiny_cfg(queue_cap=3))
    qs = ts.open_loop_queries(5, rows=1, d=12, rate_qps=0.0)
    assert [srv.submit(q, now=0.0) for q in qs] == [True] * 3 + [False] * 2
    assert srv.rejected == [3, 4]
    assert int(srv.metrics.counter("serve_rejected_total").value) == 2
    srv = tiny_server()                        # max_batch = 8
    for qid, rows in ((0, 9), (1, 0)):
        assert not srv.submit(Query(qid=qid, client="c", sent_at=0.0,
                                    x=np.zeros((rows, 12), np.float32)),
                              now=0.0)
    assert srv.rejected == [0, 1]


def test_port_server_serves_the_oracle_and_keeps_its_shares():
    """The port's own draws: open loop, closed loop and a lone query under
    the deadline, every prediction bit-identical to the oracle, the model's
    shares untouched by serving."""
    srv = tiny_server()
    before = srv.w_shares.clone()
    for run, qs in (
            (srv.run, ts.open_loop_queries(12, rows=3, d=12, rate_qps=500.0,
                                           seed=9)),
            (srv.run_closed_loop, ts.open_loop_queries(3, rows=8, d=12,
                                                       rate_qps=0.0, seed=3)),
            (srv.run, ts.open_loop_queries(1, rows=2, d=12, rate_qps=0.0))):
        run(qs)
        for q in qs:
            assert np.array_equal(srv.results[q.qid].y,
                                  srv.oracle_logits(q.x))
            assert math.isfinite(srv.results[q.qid].latency_s)
    stats = srv.stats()
    assert stats["oracle"]["bit_identical"] and stats["queries"] == 12
    assert stats["oracle"]["checked"] == stats["rounds"] >= 6
    assert torch.equal(srv.w_shares, before)


CASES = {
    "open_deterministic": dict(cfg=dict(N=6, K=2, T=1, max_batch=8),
                               lat="deterministic", mode="open",
                               collect_all=False),
    "open_lognormal_T2_collect_all": dict(
        cfg=dict(N=9, K=2, T=2, max_batch=8), lat="lognormal", mode="open",
        collect_all=True),
    "closed_straggler": dict(cfg=dict(N=7, K=2, T=1, max_batch=6),
                             lat="straggler", mode="closed",
                             collect_all=False),
}


def _latency(pkg, name):
    if name == "deterministic":
        return pkg.DeterministicLatency(base=1e-3, skew=0.1)
    if name == "straggler":
        return pkg.SleepyStragglerLatency(
            pkg.DeterministicLatency(base=1e-3, skew=0.1), {5: 0.5})
    return pkg.LognormalTailLatency(seed=3, base=0.01, tail_prob=0.3,
                                    tail_scale=10.0)


def _record_encodes(srv):
    """Keep every flush's query shares as the server encodes them."""
    seen = []
    inner = srv._encode_flush

    def encode(batch, t):
        out = inner(batch, t)
        seen.append(np.asarray(out[0]))
        return out

    srv._encode_flush = encode
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_port_server_bit_equal_to_reference(case):
    spec = CASES[case]
    cj, ct = js.ServeConfig(**spec["cfg"]), ts.ServeConfig(**spec["cfg"])
    d, classes = 12, 5
    w = np.array(0.5 * jax.random.normal(jax.random.PRNGKey(1), (d, classes)))
    key = jax.random.PRNGKey(2)
    kw = dict(verify=True, collect_all=spec["collect_all"])
    jsrv = js.PredictionServer(cj, w, key, latency=_latency(jlat, spec["lat"]),
                               **kw)
    tsrv = ts.PredictionServer(ct, w, draws=JaxServeDraws(key), device="cpu",
                               latency=_latency(tlat, spec["lat"]), **kw)
    assert np.array_equal(tsrv.w_shares.numpy(), jsrv.w_shares)
    enc_j, enc_t = _record_encodes(jsrv), _record_encodes(tsrv)
    if spec["mode"] == "open":
        make = lambda pkg: pkg.open_loop_queries(                # noqa: E731
            14, rows=3, d=d, rate_qps=400.0, seed=9)
        jsrv.run(make(js))
        tsrv.run(make(ts))
    else:
        make = lambda pkg: pkg.open_loop_queries(                # noqa: E731
            4, rows=ct.max_batch, d=d, rate_qps=0.0, seed=3)
        jsrv.run_closed_loop(make(js))
        tsrv.run_closed_loop(make(ts))
    assert len(enc_t) == len(enc_j) == tsrv.stats()["rounds"] >= 3
    for a, b in zip(enc_t, enc_j):
        assert np.array_equal(a, b)
    assert sorted(tsrv.results) == sorted(jsrv.results)
    for qid, pred in jsrv.results.items():
        assert np.array_equal(tsrv.results[qid].y, np.asarray(pred.y))
        assert tsrv.results[qid].latency_s == pred.latency_s
    for t, trace in jsrv.traces.items():
        assert list(tsrv.traces[t].responders) == list(trace.responders)
        # the decoded field values of the flush, from its shares
        order = np.asarray(trace.responders[: ct.threshold])
        res_j = np.stack([np.asarray(jf.matmul(enc_j[t][i], jsrv.w_shares[i],
                                               cj.p)) for i in order])
        want = np.asarray(jl.decode(cj.scheme, res_j, order, 2, cj.p))
        res_t = torch.stack([tf.matmul(torch.from_numpy(enc_t[t][i]),
                                       tsrv.w_shares[i], ct.p)
                             for i in order])
        got = tl.decode(ct.scheme, res_t, order, 2, ct.p)
        assert np.array_equal(got.numpy(), want)
    sj, st = jsrv.stats(), tsrv.stats()
    for k in ("queries", "rejected", "rounds", "rows", "latency_first",
              "latency_all", "oracle"):
        assert st[k] == sj[k], k


# -- over sockets: the port's master and CPU worker processes --

def _serve_cli(args, tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cpml_serve",
         "--device", "cpu", "-N", "6", "-K", "2", "-T", "1", "--d", "12",
         "--classes", "5", "--max-batch", "8", *args,
         "--json-out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout, json.loads(out.read_text())


@pytest.mark.slow
def test_socket_serving_bit_identical_with_worker_killed(tmp_path):
    """N=6 CPU worker processes serving open-loop queries, worker 4 killed
    at flush 2 (N drops to the threshold 5): every flush bit-identical to
    the oracle, the dead worker in no later decode, every other worker on
    the CPU with a result for each flush it answered."""
    out, res = _serve_cli(["--transport", "socket", "--queries", "10",
                           "--rate", "100", "--kill-worker", "4",
                           "--kill-at-round", "2"], tmp_path)
    stats = res["stats"]
    assert stats["queries"] == 10 and stats["rounds"] >= 3
    assert stats["oracle"]["bit_identical"]
    assert stats["oracle"]["checked"] == stats["rounds"]
    assert "bit-identical to the uncoded plaintext oracle: True" in out
    for t, resp in res["responders"].items():
        if int(t) >= 2:
            assert 4 not in resp[:5]
    reports = {r["worker"]: r for r in res["worker_reports"]}
    assert sorted(reports) == list(range(6))
    assert reports[4]["exit"] == "die_at_round 2"
    for w in (0, 1, 2, 3, 5):
        assert reports[w]["device"] == "cpu" and reports[w]["rounds"] >= 3
        assert set(reports[w]["launches"].values()) == {0}


def test_cluster_package_exports_resolve_lazily():
    """``repro_torch.cluster`` exports every one of the reference's names,
    resolving each on first use: a worker process that imports the socket
    transport does not load the runner."""
    import repro.cluster as jc
    import repro_torch.cluster as tc
    assert set(jc.__all__) <= set(tc.__all__)
    assert {"MasterGroup", "ShardedStreamingDecoder"} <= set(tc.__all__)
    assert tc.PredictionServer is ts.PredictionServer
    assert all(getattr(tc, name) is not None for name in tc.__all__)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.cluster.socket_transport\n"
         "print('repro_torch.cluster.runner' in sys.modules)"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.stdout.split() == ["False"], res.stderr
