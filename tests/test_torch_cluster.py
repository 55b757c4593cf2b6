"""The port's in-process ClusterRunner against the reference's, on the CPU.

Both runners get the same configuration, data, latency model and seed; the
port draws the reference's randomness through ``JaxDraws``.  For every
latency model and pipeline mode tested, binary and multiclass with
mini-batch, and with a spare and a join:

  * the responder traces and the simulated times of every round are equal
    (the scheduler, latency models and membership are copies), the waits
    to float64 rounding where the reference's own timing is racy;
  * the decoded parts are bit-equal: each round's field parts, computed by
    both packages from the reference runner's weights before that round
    and the observed decode order;
  * the final weights agree within W_ATOL_TRAIN (float32 summation order);
  * the port's run is bit-identical to the port's own train_reference
    over its responder trace.

With a group of S masters (``masters=S``) the same holds, and the weights
equal the one-master run's bit for bit.  Also: the port's StreamingDecoder
and prefix_decode_plan against the reference's on hits, misses and
near-miss variants (bit-equal), and the port's refusals.
"""
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster import ClusterRunner as JRunner  # noqa: E402
from repro.cluster import latency as jlat  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.protocol import compute as jcompute  # noqa: E402
from repro.core.protocol import decode as jdecode  # noqa: E402
from repro.core.protocol import encode as jencode  # noqa: E402
from repro.core.protocol import engine as je  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cluster import latency as tlat  # noqa: E402
from repro_torch.cluster.runner import ClusterRunner as TRunner  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.protocol import alcc_engine  # noqa: E402
from repro_torch.core.protocol import decode as tdecode  # noqa: E402
from repro_torch.core.protocol import engine as te  # noqa: E402
from test_torch_protocol import W_ATOL_TRAIN, JaxDraws  # noqa: E402

KEY_SEED = 7
ITERS = 6


def dataset(c, m=200, d=16):
    key = jax.random.PRNGKey(42)
    if c == 1:
        x, y = jsyn.mnist_like(key, m=m, d=d, margin=12.0)
    else:
        x, y = jsyn.multiclass_mnist_like(key, m=m, d=d, c=c)
    return np.array(x), np.array(y)


def latency(pkg, name, seed=3):
    """The same latency model from each package; ``dead`` kills worker 0
    at round 3 (make_latency's default)."""
    if name == "lognormal":
        return pkg.LognormalTailLatency(seed=seed, tail_prob=0.3,
                                        tail_scale=25.0)
    if name == "steady_then_dead":        # worker 2 dies at round 3
        return pkg.DeadWorkerLatency(
            pkg.DeterministicLatency(base=1.0, skew=0.1), deaths={2: 3})
    return pkg.make_latency(name, seed=seed)


def record_run(runner, iters):
    """``runner.run(iters)``, keeping the internal weights before each
    round (the teacher inputs of the parts check)."""
    runner._reset()
    before = []
    with runner._pipeline_scope(iters):
        for t in range(iters):
            before.append(np.array(runner.w2))
            runner.step_round(t, iters)
    return before


def round_times(trace):
    return (trace.t_start, trace.t_first_R, trace.encode_s, trace.decode_s,
            trace.t_ready)


def assert_parts_bit_equal(cj, ct, jrun, trun, draws, before, iters):
    """Each round's decoded field parts, both packages, from the reference
    runner's weights before that round and the observed decode order."""
    cbar = je.poly_coeffs(cj)
    for t, w2 in enumerate(before):
        dmat, order = je.survivor_round(cj, jrun.records[t].survivors)
        bidx = (None if cj.batch_rows is None
                else je.draw_batch(cj, jrun.kloop, iters, jrun.state.mk, t))
        shares = jencode.encode_weights(cj, je.round_key(jrun.kloop, t),
                                        jnp.asarray(w2))
        xb = (jrun.state.x_shares if bidx is None
              else jnp.take(jrun.state.x_shares, bidx, axis=1))
        results = jcompute.all_worker_results(cj, jnp.asarray(cbar), xb,
                                              shares)
        want = jdecode.decode_parts(cj, jnp.take(results, order, axis=0),
                                    jnp.asarray(dmat))
        bidx_t = (None if bidx is None
                  else torch.from_numpy(np.array(bidx)).long())
        got = te.round_parts(
            ct, trun.state, te.encode_round_shares(ct, draws, t,
                                                   torch.from_numpy(w2)),
            torch.from_numpy(np.array(dmat)), torch.from_numpy(order).long(),
            bidx_t)
        assert np.array_equal(got.numpy(), np.asarray(want)), f"round {t}"


def run_both(cfg_kw, lat_name, pipeline="off", iters=ITERS, c=1, **kw):
    cj = jp.CPMLConfig(**cfg_kw)
    ct = convert.config_from_reference(
        {f: getattr(cj, f) for f in cj.__dataclass_fields__})
    x, y = dataset(c)
    key = jax.random.PRNGKey(KEY_SEED)
    common = dict(pipeline=pipeline, encode_cost_s=0.2, decode_cost_s=0.1,
                  **kw)
    jrun = JRunner(cj, key, jnp.asarray(x), jnp.asarray(y),
                   latency(jlat, lat_name), **common)
    draws = JaxDraws(jrun.cfg, key, iters)
    trun = TRunner(ct, x, y, latency(tlat, lat_name), draws=draws,
                   device="cpu", **common)
    jbefore = record_run(jrun, iters)
    record_run(trun, iters)
    w_j = je._w_public(jrun.cfg, jrun.w2)
    w_t = te._w_public(trun.cfg, trun.w2)

    # responder traces and simulated times, round by round
    assert sorted(jrun.records) == sorted(trun.records) == list(range(iters))
    for t in range(iters):
        rj, rt = jrun.records[t], trun.records[t]
        assert np.array_equal(rj.survivors, rt.survivors), t
        assert np.array_equal(rj.trace.responders, rt.trace.responders), t
        assert np.array_equal(rj.dispatched, rt.dispatched), t
        assert rj.prefetched == rt.prefetched
        if pipeline != "full":
            assert (rj.coded_wait_s, rj.all_wait_s) == \
                (rt.coded_wait_s, rt.all_wait_s), t
            assert round_times(rj.trace) == round_times(rt.trace), t
            assert rj.streamed == rt.streamed
        else:
            # with both prefetch and streaming the decode plan is built on
            # the prefetch thread from a racily read prediction (in both
            # packages), so whether a simulated round streamed, and so the
            # decode time charged and every later round's start, may differ
            # run to run; a wait is then the same latency less another
            # start, equal to float64 rounding
            assert rj.coded_wait_s == pytest.approx(rt.coded_wait_s,
                                                    rel=0, abs=1e-9), t
            assert rj.all_wait_s == pytest.approx(rt.all_wait_s, rel=0,
                                                  abs=1e-9), t
    stats_j, stats_t = jrun.wait_stats(), trun.wait_stats()
    assert stats_j["membership"] == stats_t["membership"]
    # a master group's seconds are each package's own CPU time
    gj, gt = stats_j.pop("masters", None), stats_t.pop("masters", None)
    assert (gj and gj["size"]) == (gt and gt["size"])
    if pipeline != "full":
        assert stats_j == stats_t

    assert_parts_bit_equal(jrun.cfg, trun.cfg, jrun, trun, draws, jbefore,
                           iters)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=W_ATOL_TRAIN)
    # the port against its own replay: bit-identical
    w_ref, _ = tp.train_reference(trun.cfg, x, y, iters, eta=trun.eta,
                                  survivor_fn=trun.survivor_fn(),
                                  draws=draws, device="cpu")
    assert torch.equal(w_t, w_ref)
    return jrun, trun


BINARY = dict(N=8, K=2, T=1, r=1)


@pytest.mark.parametrize("pipeline", ["off", "prefetch", "streaming", "full"])
@pytest.mark.parametrize("lat", ["deterministic", "lognormal", "bursty",
                                 "dead"])
def test_runner_matches_reference(lat, pipeline):
    kw = {"round_timeout_s": 60.0} if lat == "dead" else {}
    jrun, trun = run_both(BINARY, lat, pipeline, **kw)
    if lat == "dead":
        # worker 0 died at round 3: first-T rode through, wait-all did not
        assert all(0 not in set(map(int, trun.records[t].survivors))
                   for t in range(3, ITERS))
        assert math.isinf(trun.records[ITERS - 1].all_wait_s)


@pytest.mark.parametrize("masters,pipeline,c,extra", [
    (2, "off", 1, {}),
    (3, "full", 3, {}),
    (2, "off", 1, {"spares": 1, "join_schedule": {8: 3}}),
])
def test_runner_matches_reference_sharded_masters(masters, pipeline, c,
                                                  extra):
    """A group of S masters on both packages (in process the group encodes
    the dataset; with a spare, the spare-extended config's): the same
    traces, bit-equal parts, and the port's weights bit-identical to the
    port's one-master run of the same flags and to its replay."""
    cfg_kw = dict(BINARY, c=c, batch_rows=16 if c > 1 else None)
    _, trun = run_both(cfg_kw, "lognormal", pipeline, c=c, masters=masters,
                       **extra)
    _, one = run_both(cfg_kw, "lognormal", pipeline, c=c, **extra)
    assert torch.equal(trun.w2, one.w2)
    assert torch.equal(trun.state.x_shares, one.state.x_shares)
    g = trun.wait_stats()["masters"]
    assert g["size"] == masters and g["critical_path_s"] > 0


@pytest.mark.parametrize("pipeline", ["off", "full"])
def test_runner_matches_reference_multiclass_minibatch(pipeline):
    run_both(dict(N=8, K=2, T=1, r=1, c=3, batch_rows=16), "lognormal",
             pipeline, c=3)


def test_runner_matches_reference_spare_replaces_dead_member():
    """Worker 2 dies at round 3; the failure detector retires it and the
    spare slot 8 joins in its place."""
    _, trun = run_both(BINARY, "steady_then_dead", "off", spares=1,
                       heartbeat_timeout_s=4.0, round_timeout_s=60.0,
                       iters=8)
    kinds = [(tr.kind, tr.worker) for tr in trun.membership.transitions]
    assert ("leave", 2) in kinds and ("join", 8) in kinds
    assert trun.cfg.N == 9


@pytest.mark.parametrize("pipeline", ["off", "full"])
def test_runner_matches_reference_scheduled_join(pipeline):
    _, trun = run_both(BINARY, "lognormal", pipeline, spares=1,
                       join_schedule={8: 3})
    for t, rec in trun.records.items():
        assert (8 in set(map(int, rec.dispatched))) == (t >= 3)


def test_runner_traced_run_equals_untraced():
    """The flight recorder changes nothing: a traced port run gives the same
    weights, and its trace exports as valid Chrome trace-event JSON."""
    from repro_torch.obs import export
    from repro_torch.obs.trace import Recorder

    x, y = dataset(1)
    ct = tp.CPMLConfig(**BINARY)
    runs = []
    for rec in (None, Recorder()):
        r = TRunner(ct, x, y, latency(tlat, "lognormal"), device="cpu",
                    recorder=rec, pipeline="full")
        runs.append((r, r.run(4)))
    assert torch.equal(runs[0][1], runs[1][1])
    obj = export.to_chrome_trace(runs[1][0].obs)
    assert export.validate_chrome_trace(obj) == []
    assert runs[1][0].metrics.counter("cpml_rounds_total").value == 4


def test_runner_refusals():
    x, y = dataset(1, m=40, d=4)
    ct = tp.CPMLConfig(**BINARY)
    lat = latency(tlat, "deterministic")
    # the ALCC engine refuses what the reference's does
    # (tests/test_alcc.py::test_cluster_runner_alcc_rejects_elastic_and_pipeline)
    ca = alcc_engine.ALCCConfig(N=8, K=2, T=1)
    with pytest.raises(ValueError, match="exact-engine only"):
        TRunner(ca, x, y, lat, device="cpu", engine="alcc", pipeline="full")
    with pytest.raises(ValueError, match="exact-engine only"):
        TRunner(ca, x, y, lat, device="cpu", engine="alcc", masters=2)
    with pytest.raises(ValueError, match="unknown engine"):
        TRunner(ct, x, y, lat, device="cpu", engine="sideways")
    with pytest.raises(ValueError):
        TRunner(ct, x, y, lat, device="cpu", pipeline="sideways")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TRunner(ct, x, y, lat)


def test_provisioning_barrier_keeps_early_ackers_live():
    """Acks spread over 1 s against a 0.5 s heartbeat timeout: the worker
    that acked first was silent for the rest of the barrier only because
    no round was dispatched, so every acked worker is live when it ends
    (the first fence of an elastic run would otherwise retire it)."""
    from repro_torch.cluster.messages import Heartbeat
    from repro_torch.cluster.runner import await_worker_acks
    from repro_torch.runtime.resilience import HeartbeatMonitor

    class AckTransport:
        def __init__(self, acks):
            self.acks = list(acks)              # (arrival time, worker)
            self.now = 0.0

        def next_delivery(self, dst):
            return self.acks[0][0] if self.acks else None

        def recv(self, dst, now):
            self.now = now
            out = [(t, Heartbeat(w, t)) for t, w in self.acks if t <= now]
            self.acks = [a for a in self.acks if a[0] > now]
            return out

    tr = AckTransport([(0.0, 0), (0.4, 1), (1.0, 2)])
    mon = HeartbeatMonitor(3, timeout_s=0.5, now=0.0)
    await_worker_acks(tr, lambda: tr.now, 3, mon, timeout_s=10.0)
    assert tr.now == 1.0
    assert [mon.is_dead(w, now=1.0) for w in range(3)] == [False] * 3
    assert mon.is_dead(0, now=1.6)              # silence after it counts


# -- the streaming decode against the reference's --

def test_streaming_decoder_bit_equal_hits_misses_near_misses():
    """All P(5, 4) arrival orders at N=5, K=1, T=1 (threshold 4): with a
    plan of the same subset (a hit), of another subset (a miss), of a
    near-miss variant (one predicted responder late, the next one in), and
    with no plan, both packages return the same parts and the same
    ``streamed`` flag, equal to the port's batch decode."""
    cj = jp.CPMLConfig(N=5, K=1, T=1, r=1)
    ct = tp.CPMLConfig(N=5, K=1, T=1, r=1)
    R = ct.threshold
    H = np.random.default_rng(0).integers(0, ct.p, (ct.N, 6, 2)).astype(
        np.int32)
    hits = 0
    for perm in itertools.permutations(range(ct.N), R):
        order = np.asarray(perm)
        rest = [w for w in range(ct.N) if w not in perm]
        batch = tdecode.decode_parts(
            ct, torch.from_numpy(H[order]),
            tdecode.make_decode_matrix(ct, order)).numpy()
        predictions = {
            "hit": np.asarray(sorted(perm)),
            "miss": np.asarray([w for w in range(ct.N) if w != perm[0]]),
            "near_miss": np.asarray(list(perm[1:]) + rest + [perm[0]]),
            "none": None,
        }
        for kind, pred in predictions.items():
            pj = jdecode.prefix_decode_plan(cj, pred)
            pt = tdecode.prefix_decode_plan(ct, pred)
            assert (pj is None) == (pt is None)
            if pt is not None:
                assert pj.subset == pt.subset
                assert pj.cols.keys() == pt.cols.keys()
                for w in pt.cols:
                    assert np.array_equal(pj.cols[w], pt.cols[w])
            sj, st = jdecode.StreamingDecoder(cj, pj), \
                tdecode.StreamingDecoder(ct, pt)
            for w in order:
                sj.fold(w, H[w])
                st.fold(w, H[w])
            got, want = st.finish(order), sj.finish(order)
            assert np.array_equal(got, want) and np.array_equal(got, batch)
            assert st.streamed == sj.streamed == (kind == "hit")
            hits += st.streamed
    assert hits == 120


def test_prefix_plan_warms_every_near_miss_variant():
    """The one-displacement variants the plan pre-solves are the
    reference's, with the same decode matrices."""
    ct = tp.CPMLConfig(N=8, K=2, T=1, r=1)
    cj = jp.CPMLConfig(N=8, K=2, T=1, r=1)
    pred = np.asarray([3, 1, 7, 0, 5, 2, 6, 4])
    tdecode._cached_decode_matrix.cache_clear()
    tdecode.prefix_decode_plan(ct, pred)
    R = ct.threshold
    prefix = tuple(int(w) for w in pred[:R])
    variants = [prefix[:i] + prefix[i + 1:] + (int(pred[R]),)
                for i in range(R)]
    assert tdecode._cached_decode_matrix.cache_info().currsize == R + 1
    for v in [prefix, *variants]:
        assert np.array_equal(
            tdecode._cached_decode_matrix(ct.scheme, v),
            np.asarray(jdecode._cached_decode_matrix(cj.scheme, v)))
    assert tdecode.prefix_decode_plan(ct, None) is None
    assert tdecode.prefix_decode_plan(ct, pred[: R - 1]) is None


@pytest.mark.parametrize("c,r", [(1, 1), (3, 2)])
def test_split_encode_bit_equal_to_reference_and_to_one_shot(c, r):
    """round_mask_context + encode_round_shares_split: the reference's
    split halves, and the port's one-shot encode, bit for bit."""
    cj = jp.CPMLConfig(N=16, K=2, T=2, r=r, c=c)
    ct = convert.config_from_reference(
        {f: getattr(cj, f) for f in cj.__dataclass_fields__})
    key = jax.random.PRNGKey(3)
    draws = JaxDraws(cj, key, 4)
    w2 = (np.random.default_rng(c).normal(size=(9, c)) * 0.3).astype(
        np.float32)
    t = 2
    kq, masks_j = je.round_mask_context(cj, je.round_key(draws.kloop, t),
                                        (9, c))
    want = je.encode_round_shares_split(cj, kq, masks_j, jnp.asarray(w2))
    u, masks_t = te.round_mask_context(ct, draws, t, (9, c))
    assert np.array_equal(masks_t.numpy(), np.asarray(masks_j))
    got = te.encode_round_shares_split(ct, u, masks_t, torch.from_numpy(w2))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, te.encode_round_shares(ct, draws, t,
                                                   torch.from_numpy(w2)))
