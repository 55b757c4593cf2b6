"""The port's sharded master group (cluster/master_group.py) against the
reference's (repro/cluster/master_group.py) on the CPU, case for case with
``tests/test_master_group.py``: the shard placement, the dataset encode,
the weight encode whole and split, the T = 0 encode, the streaming decode
on a plan hit and its fallback on a miss, the group's stats and the
encode for both primes, bit-equal to the reference's group (whose encode
is host int64 numpy; the port's is the field encode on each d-slice) and
to the port's single-master ``encode``/``engine`` path for group sizes 1
to 4.
The reference's randomness reaches the port through the draws seam:
``KeyDraws`` hands the port the masks the reference's group draws from its
key, ``JaxDraws`` (tests/test_torch_protocol.py) the uniforms and masks of
round t.

Then the runner with S masters over local sockets (port worker processes
on the CPU, N = 8), each run bit-identical to the same run with one master
and to the port's train_reference over its responder trace, and the
elastic kill-and-join run of ``tests/test_socket_cluster.py`` on a group
of two.  The runner in process with S masters is held against the
reference's runner in ``tests/test_torch_cluster.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster import master_group as jmg  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import lagrange as jl  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.protocol import decode as jdecode  # noqa: E402
from repro.core.protocol import encode as jencode  # noqa: E402
from repro.core.protocol import engine as je  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cluster import master_group as tmg  # noqa: E402
from repro_torch.cluster.runner import ClusterRunner  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.protocol import decode as tdecode  # noqa: E402
from repro_torch.core.protocol import encode as tencode  # noqa: E402
from repro_torch.core.protocol import engine as te  # noqa: E402
from repro_torch.launch.cpml_cluster import local_socket_cluster  # noqa: E402
from test_torch_protocol import JaxDraws  # noqa: E402

SIZES = [1, 2, 3, 4]
D = 22


class KeyDraws:
    """The dataset masks the reference's ``encode_dataset(cfg, key, x)``
    draws from ``key`` itself, behind the port's seam."""

    def __init__(self, key):
        self.key = key

    def dataset_masks(self, T, mk, d, p):
        return torch.from_numpy(np.array(jl.draw_masks(self.key, T, (mk, d),
                                                       p)))


def configs(**kw):
    cj = jp.CPMLConfig(**kw)
    return cj, convert.config_from_reference(dataclasses.asdict(cj))


@pytest.fixture(scope="module")
def cfgs():
    return configs(N=8, K=2, T=1, r=1, c=3)


@pytest.fixture(scope="module")
def data():
    x, y = jsyn.multiclass_mnist_like(jax.random.PRNGKey(0), m=96, d=D, c=3)
    return np.array(x), np.array(y)


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and (a == b).all()


# -- shard placement --

@pytest.mark.parametrize("d,size", [(24, 2), (24, 3), (22, 2), (22, 3),
                                    (7, 4), (5, 1), (16, 4)])
def test_d_shard_slices_are_the_references_and_balanced(cfgs, d, size):
    cj, ct = cfgs
    slices = tmg.d_shard_slices(ct, d, size)
    assert slices == jmg.d_shard_slices(cj, d, size)
    assert len(slices) == min(size, d)
    covered = np.concatenate([np.arange(s.start, s.stop) for s in slices])
    assert (covered == np.arange(d)).all()
    widths = [s.stop - s.start for s in slices]
    assert max(widths) - min(widths) <= 1


def test_d_shard_slices_clamp_degenerate_sizes(cfgs):
    cj, ct = cfgs
    assert tmg.d_shard_slices(ct, 6, 0) == [slice(0, 6)]
    assert len(tmg.d_shard_slices(ct, 3, 10)) == 3
    for d, size in ((6, 0), (3, 10), (1, 4)):
        assert tmg.d_shard_slices(ct, d, size) == jmg.d_shard_slices(cj, d,
                                                                    size)
    with pytest.raises(ValueError):
        tmg.MasterGroup(ct, 0)


# -- encode surfaces --

@pytest.mark.parametrize("size", SIZES)
def test_encode_dataset_bit_identical(cfgs, data, size):
    cj, ct = cfgs
    x, _ = data
    key = jax.random.PRNGKey(11)
    ref_shares, ref_ctx = jencode.encode_dataset(cj, key, jnp.asarray(x))
    with jmg.MasterGroup(cj, size) as jg:
        j_shares, _ = jg.encode_dataset(cj, key, jnp.asarray(x))
    one, one_ctx = tencode.encode_dataset(ct, KeyDraws(key),
                                          torch.as_tensor(x))
    with tmg.MasterGroup(ct, size) as tg:
        shares, ctx = tg.encode_dataset(ct, KeyDraws(key), torch.as_tensor(x))
    assert shares.dtype == torch.int32
    assert same(shares, ref_shares) and same(shares, j_shares)
    assert same(shares, one)
    assert same(ctx["xq"], ref_ctx["xq"]) and same(ctx["xq"], one_ctx["xq"])
    assert ctx["m_padded"] == int(ref_ctx["m_padded"]) == one_ctx["m_padded"]


def round_inputs(cj, seed):
    draws = JaxDraws(cj, jax.random.PRNGKey(seed), iters=4)
    w2 = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                    (D, cj.c)))
    return draws, w2


@pytest.mark.parametrize("size", SIZES)
def test_encode_round_shares_bit_identical(cfgs, size):
    cj, ct = cfgs
    draws, w2 = round_inputs(cj, 5)
    t = 2
    key = je.round_key(draws.kloop, t)
    ref = je.encode_round_shares(cj, key, jnp.asarray(w2))
    with jmg.MasterGroup(cj, size) as jg:
        jout = jg.encode_round_shares(key, jnp.asarray(w2))
    one = te.encode_round_shares(ct, draws, t, torch.as_tensor(w2))
    with tmg.MasterGroup(ct, size) as tg:
        out = tg.encode_round_shares(draws, t, torch.as_tensor(w2))
    assert isinstance(out, np.ndarray) and out.dtype == np.int32
    assert out.shape == (ct.N, D, ct.c, ct.r)
    assert same(out, ref) and same(out, jout) and same(out, one)


@pytest.mark.parametrize("size", SIZES)
def test_encode_round_shares_split_bit_identical(cfgs, size):
    """The pipelined half-encode: group split == engine split == whole."""
    cj, ct = cfgs
    draws, w2 = round_inputs(cj, 9)
    t = 1
    key = je.round_key(draws.kloop, t)
    kq, jmask = je.round_mask_context(cj, key, (D, cj.c))
    ref = je.encode_round_shares_split(cj, kq, jmask, jnp.asarray(w2))
    u, mask_shares = te.round_mask_context(ct, draws, t, (D, ct.c))
    one = te.encode_round_shares_split(ct, u, mask_shares, torch.as_tensor(w2))
    whole = te.encode_round_shares(ct, draws, t, torch.as_tensor(w2))
    with tmg.MasterGroup(ct, size) as tg:
        out = tg.encode_round_shares_split(u, mask_shares,
                                           torch.as_tensor(w2))
    assert same(one, whole)
    assert same(out, ref) and same(out, one)


def test_t0_no_mask_encode_bit_identical(data):
    """T = 0 drops the mask rows: the data-only branch of the stack."""
    cj0, ct0 = configs(N=8, K=2, T=0, r=1)
    x, _ = data
    key = jax.random.PRNGKey(3)
    ref, _ = jencode.encode_dataset(cj0, key, jnp.asarray(x))
    draws, w2 = round_inputs(cj0, 4)
    w2 = w2[:, :1]
    ref_w = je.encode_round_shares(cj0, je.round_key(draws.kloop, 0),
                                   jnp.asarray(w2))
    with tmg.MasterGroup(ct0, 2) as tg:
        out, _ = tg.encode_dataset(ct0, KeyDraws(key), torch.as_tensor(x))
        out_w = tg.encode_round_shares(draws, 0, torch.as_tensor(w2))
    assert same(out, ref) and same(out_w, ref_w)


# -- sharded streaming decode --

def _fake_results(ct, d, seed=0):
    rng = np.random.default_rng(seed)
    return {w: rng.integers(0, ct.p, size=(d, ct.c)).astype(np.int32)
            for w in range(ct.N)}


@pytest.mark.parametrize("size", SIZES)
def test_sharded_decoder_streams_on_plan_hit(cfgs, size):
    cj, ct = cfgs
    results = _fake_results(ct, D)
    order = np.arange(ct.N)
    plan = tdecode.prefix_decode_plan(ct, order)
    jplan = jdecode.prefix_decode_plan(cj, order)
    one = tdecode.StreamingDecoder(ct, plan)
    with jmg.MasterGroup(cj, size) as jg, tmg.MasterGroup(ct, size) as tg:
        jdec = jg.make_decoder(jplan, D)
        dec = tg.make_decoder(plan, D)
        assert isinstance(dec, tmg.ShardedStreamingDecoder)
        for w in order[: ct.threshold]:
            for x in (one, jdec, dec):
                x.fold(w, results[w])
        parts = dec.finish(order)
        assert dec.streamed and one.streamed is False
        ref_one = one.finish(order)
        assert one.streamed
        assert parts.shape == (ct.K, D, ct.c)
        assert same(parts, jdec.finish(order)) and same(parts, ref_one)
    stacked = np.stack([results[w] for w in order[: ct.threshold]])
    dmat = tdecode.make_decode_matrix(ct, order)
    batch = tdecode.decode_parts(ct, torch.as_tensor(stacked), dmat)
    assert same(parts, batch)


@pytest.mark.parametrize("size", [2, 3])
def test_sharded_decoder_fallback_on_plan_miss_matches_batch(cfgs, size):
    """Arrivals off the predicted subset: every shard falls back to the
    batch decode over the observed order, still bit-identical."""
    cj, ct = cfgs
    results = _fake_results(ct, D, seed=1)
    plan = tdecode.prefix_decode_plan(ct, np.arange(ct.N))
    jplan = jdecode.prefix_decode_plan(cj, np.arange(cj.N))
    observed = np.array([7, 6, 5, 4, 3, 2, 1, 0])[: ct.threshold]
    with jmg.MasterGroup(cj, size) as jg, tmg.MasterGroup(ct, size) as tg:
        jdec, dec = jg.make_decoder(jplan, D), tg.make_decoder(plan, D)
        for w in observed:
            jdec.fold(w, results[w])
            dec.fold(w, results[w])
        parts = dec.finish(observed)
        assert not dec.streamed
        assert same(parts, jdec.finish(observed))
    stacked = np.stack([results[w] for w in observed])
    dmat = tdecode.make_decode_matrix(ct, observed)
    assert same(parts, tdecode.decode_parts(ct, torch.as_tensor(stacked),
                                            dmat))


def test_group_stats_track_per_master_walls(cfgs, data):
    cj, ct = cfgs
    x, _ = data
    with tmg.MasterGroup(ct, 2) as tg:
        tg.encode_dataset(ct, KeyDraws(jax.random.PRNGKey(0)),
                          torch.as_tensor(x))
        plan = tdecode.prefix_decode_plan(ct, np.arange(ct.N))
        dec = tg.make_decoder(plan, D)
        results = _fake_results(ct, D)
        for w in range(ct.threshold):
            dec.fold(w, results[w])
        dec.finish(np.arange(ct.N))
        stats = tg.group_stats()
    assert set(stats) == {"size", "per_master", "encode_total_s",
                          "decode_total_s", "critical_path_s"}
    assert stats["size"] == 2 and len(stats["per_master"]) == 2
    assert stats["encode_total_s"] > 0 and stats["decode_total_s"] > 0
    assert stats["critical_path_s"] <= (stats["encode_total_s"]
                                        + stats["decode_total_s"])
    assert stats["critical_path_s"] >= max(
        w["encode_s"] + w["decode_s"] for w in stats["per_master"]) * 0.999


def test_host_encode_matches_the_field_encode_for_both_primes(data):
    """The group's per-slice field encode against the reference's host
    int64 encode (its group's ``_host_encode_rows``) and its device encode
    for the 24-bit P and the 30-bit P30: the overflow discipline."""
    x, _ = data
    for p in (jf.P, jf.P30):
        cj, ct = configs(N=8, K=2, T=1, r=1, p=p)
        key = jax.random.PRNGKey(2)
        ref, _ = jencode.encode_dataset(cj, key, jnp.asarray(x))
        with jmg.MasterGroup(cj, 3) as jg:
            host, _ = jg.encode_dataset(cj, key, jnp.asarray(x))
        with tmg.MasterGroup(ct, 3) as tg:
            out, _ = tg.encode_dataset(ct, KeyDraws(key), torch.as_tensor(x))
        assert same(out, ref) and same(out, host)


# -- the runner --

def replay(runner, x, y, iters):
    """The port's train_reference over the runner's (spare-extended)
    config and its observed responder trace, with the runner's draws."""
    w, _ = te.train_reference(runner.cfg, x, y, iters, eta=runner.eta,
                              survivor_fn=runner.survivor_fn(),
                              draws=runner.draws, device="cpu")
    return w


def check_group(runner, size, decode=True):
    g = runner.wait_stats()["masters"]
    assert g["size"] == size and len(g["per_master"]) == size
    assert g["critical_path_s"] > 0
    assert all(m["encode_s"] > 0 for m in g["per_master"])
    if decode:
        assert all(m["decode_s"] > 0 for m in g["per_master"])


# Over sockets: the slack fleet (N = 8, K = 2, T = 1, threshold 7) of port
# worker processes on the CPU.  Worker 7 sleeps before each reply, so it is
# the last arrival of every round and each round decodes workers 0-6 in
# every run: a group run is held to the one-master run bit for bit.
SOCKET_ITERS = 6
STRAGGLE_S = 0.2


def socket_run(x, y, masters, iters=SOCKET_ITERS, pipeline="full",
               die_at_round=None, join_at_round=None, sleep_s=None, **kw):
    cfg = tp.CPMLConfig(N=8, K=2, T=1, r=1)
    with local_socket_cluster(cfg.N, die_at_round=die_at_round,
                              sleep_s=sleep_s or {7: STRAGGLE_S},
                              join_at_round=join_at_round,
                              device="cpu") as tr:
        runner = ClusterRunner(cfg, x, y, latency=None, transport=tr,
                               device="cpu", round_timeout_s=120.0,
                               pipeline=pipeline, masters=masters, **kw)
        runner.provision(timeout_s=120.0)
        w = runner.run(iters)
        runner.shutdown_workers()
    return runner, w


@pytest.fixture(scope="module")
def socket_data():
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=200, d=D)
    return np.array(x), np.array(y)


@pytest.fixture(scope="module")
def one_master_socket_run(socket_data):
    x, y = socket_data
    return socket_run(x, y, 1)


@pytest.mark.slow
@pytest.mark.parametrize("masters", [2, 3])
def test_runner_masters_over_sockets_bit_identical(socket_data,
                                                   one_master_socket_run,
                                                   masters):
    """``--pipeline full`` over 8 worker processes: the group encodes the
    dataset, each round's weights (the split encode, from the prefetched
    mask shares) and folds each result into its shard of the streaming
    decode.  The weights equal the one-master run's and the replay's."""
    x, y = socket_data
    r1, w1 = one_master_socket_run
    rs, ws = socket_run(x, y, masters)
    for r in (r1, rs):
        assert all(sorted(map(int, rec.survivors)) == list(range(7))
                   for rec in r.records.values())
    assert torch.equal(ws, w1)
    assert torch.equal(ws, replay(rs, x, y, SOCKET_ITERS))
    assert torch.equal(w1, replay(r1, x, y, SOCKET_ITERS))
    assert "masters" not in r1.wait_stats()
    check_group(rs, masters)


@pytest.mark.slow
def test_socket_elastic_kill_join_sharded_masters_bit_identical():
    """``tests/test_socket_cluster.py``'s elastic acceptance on the port:
    worker 2 killed at round 2 (heartbeat death, then LEAVE at a fence),
    the late worker 8 admitted from the spare evaluation point (Join
    frame, then JOIN at its fence), the master role sharded S = 2 over d;
    the weights bit-identical to train_reference on the spare-extended
    config replaying the observed responder trace.

    The reference's test is red: its 60 rounds at d = 32 end in about half
    a second, before the killed worker has been silent for the 0.5 s
    heartbeat timeout, so no LEAVE is made (its join and its bit-identity
    hold; the port's runner does the same at those settings).  Here worker
    7 sleeps 0.1 s before each reply, so while the fleet is one short
    (from the kill to the join at round 20) every round waits for it: 18
    rounds of at least 0.1 s put the killed worker's silence past the 1 s
    timeout before the join."""
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=400, d=32)
    x, y = np.array(x), np.array(y)
    iters = 30
    runner, w = socket_run(x, y, 2, iters=iters, pipeline="off",
                           die_at_round={2: 2}, join_at_round={8: 20},
                           sleep_s={7: 0.1}, heartbeat_timeout_s=1.0,
                           spares=1)
    assert runner.cfg.N == 9                 # spare-extended config
    ms = runner.membership
    kinds = {(tr_.kind, tr_.worker) for tr_ in ms.transitions}
    assert ("join", 8) in kinds, "the late worker was never admitted"
    assert ("leave", 2) in kinds, "the killed worker was never retired"
    assert ms.epoch == len(ms.transitions) >= 2
    assert 2 not in ms.view() and 8 in ms.view()
    join_round = next(t.round for t in ms.transitions if t.kind == "join")
    leave_round = next(t.round for t in ms.transitions if t.kind == "leave")
    for t, rec in runner.records.items():
        if t >= join_round:
            assert 8 in set(map(int, rec.dispatched))
        if t >= leave_round:
            assert 2 not in set(map(int, rec.dispatched))
    stats = runner.wait_stats()
    check_group(runner, 2, decode=False)
    assert stats["membership"]["joins"] >= 1.0
    assert stats["membership"]["leaves"] >= 1.0
    assert torch.equal(w, replay(runner, x, y, iters))
