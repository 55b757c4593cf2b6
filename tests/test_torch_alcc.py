"""The port's ALCC float engine (core/alcc.py, core/protocol/alcc_engine.py,
cluster/alcc_mlp.py and the runner's ``engine="alcc"``) against the
reference's, on the CPU.

The reference's randomness reaches the port through ``JaxALCCDraws``,
which replays its keys: ``ksetup, kloop = split(key)``, the dataset masks
from ``split(ksetup)[0]`` (the MLP's from ``split(ksetup, 3)``, with its
initial weights), round t's masks from ``round_key(kloop, t)`` and its
batch from ``draw_batch``.  Tolerances:

  * shares and decode matrices: the same float64 arithmetic on the same
    inputs; held to SHARE_RTOL (torch's and numpy's float64 matmuls may
    block the sum differently);
  * logistic weights after a few rounds: ALCC_SOCKET_TOL, the reference's
    own tolerance between its workers' float32 products and its replay's
    (the same summation-order difference, amplified by the least-squares
    decode: 1.75e-4 at r = 2, sigma 3);
  * MLP weights: MLP_ATOL (the same, through gelu and a softmax);
  * the port's in-process runs against the port's own replays: bit for bit;
    socket runs within ALCC_SOCKET_TOL, the reference's tolerance.

``tests/test_alcc.py``'s cases that reach no JAX object, and
``tests/test_alcc_properties.py``'s property tests, re-run against the port
through ``torch_parity``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster import ClusterRunner as JRunner  # noqa: E402
from repro.cluster import alcc_mlp as jmlp  # noqa: E402
from repro.cluster import make_latency as j_make_latency  # noqa: E402
from repro.core import alcc as jalcc  # noqa: E402
from repro.core.protocol import alcc_engine as je  # noqa: E402
from repro.core.protocol import engine as jeng  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.cluster import alcc_mlp as tmlp  # noqa: E402
from repro_torch.cluster import latency as tlat  # noqa: E402
from repro_torch.cluster.runner import ClusterRunner as TRunner  # noqa: E402
from repro_torch.core import alcc as talcc  # noqa: E402
from repro_torch.core.protocol import alcc_engine as te  # noqa: E402
from repro_torch.core.protocol.draws import TorchALCCDraws  # noqa: E402
from repro_torch.launch.cpml_cluster import (  # noqa: E402
    ALCC_MLP_LOSS_TOL, ALCC_SOCKET_TOL)
from test_torch_protocol import W_ATOL_TRAIN  # noqa: E402
import torch_parity  # noqa: E402

SHARE_RTOL = 1e-12
MLP_ATOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


class JaxALCCDraws:
    """The reference's ALCC draws (jax.random, threefry) behind the port's
    seam."""

    def __init__(self, cfg, key, iters, mlp=False):
        self.cfg, self.iters, self.mlp = cfg, iters, mlp
        self.ksetup, self.kloop = jax.random.split(key)

    def data_masks(self, shape):
        if self.mlp:                                   # mlp_setup
            kx = jax.random.split(self.ksetup, 3)[0]
        else:                                          # setup
            kx = jax.random.split(self.ksetup)[0]
        return torch.from_numpy(np.array(
            jax.random.normal(kx, tuple(shape), jnp.float32)))

    def round_masks(self, t, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jeng.round_key(self.kloop, t), tuple(shape), jnp.float32)))

    def batch(self, t, mk, rows):
        return torch.from_numpy(np.array(jeng.draw_batch(
            self.cfg, self.kloop, self.iters, mk, t))).to(torch.int64)

    def mlp_init(self, d, hidden, c):
        _, k1, k2 = jax.random.split(self.ksetup, 3)
        w1 = jax.random.normal(k1, (d, hidden), jnp.float32) / np.sqrt(d)
        w2 = jax.random.normal(k2, (hidden, c), jnp.float32) / np.sqrt(hidden)
        return torch.from_numpy(np.array(w1)), torch.from_numpy(np.array(w2))


def configs(**kw):
    return je.ALCCConfig(**kw), te.ALCCConfig(**kw)


def logreg_data(c=1, m=96, d=12):
    key = jax.random.PRNGKey(1)
    if c == 1:
        x, y = jsyn.mnist_like(key, m=m, d=d)
    else:
        x, y = jsyn.multiclass_mnist_like(key, m=m, d=d, c=c)
    return np.array(x), np.array(y)


def t_(a):
    return torch.from_numpy(np.array(a))


CASES = {
    "binary": dict(N=8, K=2, T=1),
    "multiclass_batch": dict(N=8, K=2, T=1, c=3, batch_rows=16),
    "r2_sigma3": dict(N=12, K=2, T=1, r=2, sigma=3.0),
}


# -- the reference's own cases, against the port --

# the two CLI smokes run the port's CLI on its default device, CUDA; they
# run with --device cpu in tests/test_torch_cli.py
ALCC_CASES = torch_parity.reference_cases(
    "test_alcc", exclude=("test_cli_alcc_sim_smoke",
                          "test_cli_alcc_mlp_sim_smoke"))
PROPERTY_CASES = torch_parity.reference_cases("test_alcc_properties",
                                              properties=True)


def test_reference_case_lists():
    """The harness found the reference's numpy-only cases (the CLI's
    refusal matrix among them) and its four property tests."""
    assert {c.values[1] for c in ALCC_CASES} == {
        "test_thresholds_match_field_formulas",
        "test_point_sets_disjoint_and_bounded",
        "test_colliding_point_sets_rejected", "test_error_budget_monotone",
        "test_config_below_threshold_rejected",
        "test_pipeline_hooks_refused", "test_cli_refusals"}
    assert len(PROPERTY_CASES) == 4


@pytest.mark.parametrize("module,name,params", ALCC_CASES + PROPERTY_CASES)
def test_reference_case_against_port(module, name, params, request):
    torch_parity.run_case(module, name, params, request)


# -- AnalogScheme: the reference's JAX-keyed units, with numpy masks, on
#    numpy and on tensors --

def _scheme(**kw):
    return talcc.AnalogScheme(**{"N": 10, "K": 3, "T": 2, **kw})


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_encode_decode_identity_and_sum(kind):
    s = _scheme()
    rng = np.random.default_rng(0)
    parts = rng.normal(size=(3, 4, 5))
    masks = talcc.draw_masks(rng.normal(size=(2, 4, 5)).astype(np.float32),
                             1.0)
    if kind == "torch":
        parts, masks = torch.from_numpy(parts), torch.from_numpy(masks)
    shares = talcc.encode(s, parts, masks)
    assert shares.shape == (10, 4, 5) and type(shares) is type(parts)
    dec, info = s.decode(shares, np.arange(10), deg_f=1)
    summed, _ = s.decode_sum(shares, np.arange(10), deg_f=1)
    assert not info["fallback"] and info["rows"] == info["need"] == 5
    np.testing.assert_allclose(np.asarray(dec), np.asarray(parts), atol=1e-9)
    np.testing.assert_allclose(np.asarray(summed),
                               np.asarray(dec).sum(axis=0), rtol=1e-12)


def _gamma(n: int, eps: float) -> float:
    """gamma_n = n*u / (1 - n*u), u = eps / 2: the relative bound on an
    n-term dot product in that precision, in any summation order."""
    u = eps / 2
    return n * u / (1 - n * u)


@pytest.mark.parametrize("survivor_seed", [0, 1, 2, 3])
def test_decode_from_any_threshold_subset(survivor_seed):
    """Both decode paths against the exact product, each within float64's
    own bound for the product it computes.  The numpy path is ``C.T @
    flat`` and the torch path ``ct @ used``, which sum in other orders;
    where the decode cancels (|C|ᵀ|r| far above the result) each may err
    by gamma_n |C|ᵀ|r|, so a bound taken from the operands, element by
    element, is what float64 can hold both to.  The exact product is taken
    in np.longdouble, whose own gamma_n joins the bound."""
    s = _scheme()
    rng = np.random.default_rng(survivor_seed)
    parts = rng.normal(size=(3, 6))
    shares = talcc.encode(s, parts, rng.normal(size=(2, 6)))
    surv = rng.permutation(10)[: talcc.degree_threshold(3, 2, 2)]
    dec, info = s.decode(shares[surv] ** 2, surv, deg_f=2)
    np.testing.assert_allclose(dec, parts ** 2, atol=1e-7)
    dec_t, info_t = s.decode(torch.from_numpy(shares[surv] ** 2), surv, 2)
    assert info_t == info
    C, _ = s.decode_matrix(surv, 2)
    n = info["rows"]
    r = (shares[surv] ** 2)[:n]
    exact = C.T.astype(np.longdouble) @ r.astype(np.longdouble)
    bound = ((_gamma(n, np.finfo(np.float64).eps)
              + _gamma(n, float(np.finfo(np.longdouble).eps)))
             * (np.abs(C).T @ np.abs(r)))
    for got in (dec, dec_t.numpy()):
        assert got.dtype == np.float64
        assert (np.abs(got - exact) <= bound).all(), np.max(
            np.abs(got - exact) / bound)
    assert (np.abs(dec_t.numpy() - dec) <= 2 * bound).all()


@pytest.mark.parametrize("sigma", [0.0, 100.0])
def test_masks_cancel_within_budget(sigma):
    s = _scheme(sigma=sigma)
    rng = np.random.default_rng(2)
    parts = rng.normal(size=(3, 8))
    masks = talcc.draw_masks(rng.normal(size=(2, 8)).astype(np.float32),
                             sigma)
    results = talcc.encode(s, parts, masks).astype(np.float32)
    dec, info = s.decode(results, np.arange(10), deg_f=1)
    assert np.max(np.abs(dec - parts)) <= max(info["abs_err_budget"], 1e-12)


def test_encode_replicated_and_fallback():
    s = _scheme(cond_max=0.0)
    w = np.arange(6, dtype=np.float64).reshape(3, 2)
    masks = np.random.default_rng(6).normal(size=(2, 3, 2))
    for value in (w, torch.from_numpy(w)):
        shares = talcc.encode_replicated(s, value, masks if isinstance(
            value, np.ndarray) else torch.from_numpy(masks))
        dec, info = s.decode(shares, np.arange(10), deg_f=1)
        assert info["fallback"] and info["rows"] == 10
        for k in range(s.K):
            np.testing.assert_allclose(np.asarray(dec[k]), w, atol=1e-8)


def test_scheme_matrices_equal_reference():
    """The host-built points, encode matrix and decode matrices (square
    and fallback) are the reference's numpy code on the same inputs."""
    for kw, surv in ((dict(N=10, K=3, T=2), [7, 1, 4, 0, 9, 3, 2, 8, 5]),
                     (dict(N=10, K=3, T=2, cond_max=0.0), list(range(10)))):
        js, ts = jalcc.AnalogScheme(**kw), talcc.AnalogScheme(**kw)
        for name in ("alphas", "betas", "encode_matrix"):
            assert np.array_equal(getattr(js, name), getattr(ts, name))
        for deg in (1, 2):
            cj, ij = js.decode_matrix(surv, deg)
            ct, it = ts.decode_matrix(surv, deg)
            assert np.array_equal(cj, ct) and ij == it


# -- the logistic engine against the reference --

@pytest.mark.parametrize("case", list(CASES))
def test_setup_and_round_against_reference(case):
    cj, ct = configs(**CASES[case])
    x, y = logreg_data(ct.c)
    key = jax.random.PRNGKey(5)
    draws = JaxALCCDraws(cj, key, 3)
    want = je.setup(cj, draws.ksetup, x, y)
    got = te.setup(ct, t_(x), t_(y), draws=draws)
    assert (got.m, got.mk) == (want.m, want.mk)
    np.testing.assert_allclose(got.x_shares.numpy(), want.x_shares,
                               rtol=SHARE_RTOL, atol=0)
    for name in ("xq_parts", "y_parts", "xty"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=SHARE_RTOL, atol=1e-12)
    # round 2's weight shares from the same weights, then one decode of the
    # reference's own float32 worker results
    w2 = np.random.default_rng(0).normal(size=(12, ct.c)).astype(np.float32)
    ws_j = je.encode_round_shares(cj, jeng.round_key(draws.kloop, 2), w2)
    ws_t = te.encode_round_shares(ct, draws, 2, t_(w2))
    np.testing.assert_allclose(ws_t.numpy(), ws_j, rtol=1e-6, atol=1e-6)
    order = np.random.default_rng(1).permutation(ct.N)
    cbar = je.poly_coeffs(cj)
    fastest = np.stack([je.worker_eval(cbar, want.x_shares[w], ws_j[w])
                        for w in order]).astype(np.float32)
    xg_j, info_j = cj.scheme.decode_sum(fastest, order, 2 * cj.r + 1)
    xg_t, info_t = ct.scheme.decode_sum(t_(fastest), order, 2 * ct.r + 1)
    np.testing.assert_allclose(xg_t.numpy(), xg_j, rtol=SHARE_RTOL,
                               atol=1e-12)
    assert info_t == info_j
    # the port's worker function on the same shares, float32
    got_f = te.worker_eval(t_(cbar), t_(want.x_shares[order[0]]),
                           t_(ws_j[order[0]]))
    np.testing.assert_allclose(got_f.numpy(), fastest[0], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_train_reference_and_oracle_against_reference(case):
    cj, ct = configs(**CASES[case])
    x, y = logreg_data(ct.c)
    key = jax.random.PRNGKey(3)
    iters = 6
    draws = JaxALCCDraws(cj, key, iters)
    rolled = lambda t: np.roll(np.arange(ct.N), t)        # noqa: E731
    wj, _ = je.train_reference(cj, key, x, y, iters, survivor_fn=rolled)
    wt, _ = te.train_reference(ct, x, y, iters, survivor_fn=rolled,
                               draws=draws, device="cpu")
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj),
                               atol=ALCC_SOCKET_TOL)
    oj = je.float_oracle(cj, key, x, y, iters)
    ot = te.float_oracle(ct, x, y, iters, draws=draws, device="cpu")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=W_ATOL_TRAIN)


@pytest.mark.parametrize("case", ["binary", "multiclass_batch"])
def test_runner_alcc_against_reference_and_own_replay(case):
    """In process: the port's runner has the reference runner's responder
    orders, weights within ALCC_SOCKET_TOL, and is bit-identical to the port's
    own train_reference over its trace; the wait_stats alcc block and the
    decode metrics agree."""
    cj, ct = configs(**CASES[case])
    x, y = logreg_data(ct.c)
    key = jax.random.PRNGKey(7)
    iters = 5
    draws = JaxALCCDraws(cj, key, iters)
    jr = JRunner(cj, key, x, y, j_make_latency("lognormal", seed=5),
                 engine="alcc")
    wj = jr.run(iters)
    tr = TRunner(ct, x, y, tlat.make_latency("lognormal", seed=5),
                 engine="alcc", draws=draws, device="cpu")
    wt = tr.run(iters)
    for t in range(iters):
        assert np.array_equal(jr.records[t].survivors, tr.records[t].survivors)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj),
                               atol=ALCC_SOCKET_TOL)
    w_ref, _ = te.train_reference(ct, x, y, iters, eta=tr.eta,
                                  survivor_fn=tr.survivor_fn(), draws=draws,
                                  device="cpu")
    assert torch.equal(wt, w_ref)
    sj, st = jr.wait_stats()["alcc"], tr.wait_stats()["alcc"]
    assert sj["fallbacks"] == st["fallbacks"]
    np.testing.assert_allclose(st["cond"]["mean"], sj["cond"]["mean"],
                               rtol=1e-12)
    assert tr.metrics.gauge("cpml_alcc_decode_cond").value > 1.0


def test_runner_alcc_default_draws_replay_and_fallback_rows():
    """The port's own draws, every round held to its last arrival and
    cond_max forcing the fallback: each decode reads ALL responders
    (info["rows"], not the threshold), and the run replays bit for bit."""
    ct = te.ALCCConfig(N=8, K=2, T=1, cond_max=0.0)
    x, y = logreg_data()
    tr = TRunner(ct, x, y, tlat.make_latency("lognormal", seed=1),
                 engine="alcc", draws=TorchALCCDraws(11, "cpu"),
                 device="cpu", collect_all=True)
    w = tr.run(5)
    assert tr.wait_stats()["alcc"]["fallbacks"]["n"] == 5.0
    assert all(len(r.survivors) == r.n_responders == ct.N > ct.threshold
               for r in tr.records.values())
    w_ref, _ = te.train_reference(ct, x, y, 5, eta=tr.eta,
                                  survivor_fn=tr.survivor_fn(),
                                  draws=TorchALCCDraws(11, "cpu"),
                                  device="cpu")
    assert torch.equal(w, w_ref)


def test_runner_alcc_refuses_exact_only_machinery():
    ct = te.ALCCConfig(N=8, K=2, T=1)
    x, y = logreg_data()
    lat = tlat.make_latency("deterministic", seed=0)
    for kw in (dict(pipeline="full"), dict(masters=2), dict(spares=1)):
        with pytest.raises(ValueError, match="exact-engine only"):
            TRunner(ct, x, y, lat, engine="alcc", device="cpu", **kw)


# -- the MLP --

def mlp_data(c=4, m=96, d=12):
    x, y = jsyn.multiclass_mnist_like(jax.random.PRNGKey(2), m=m, d=d, c=c)
    return np.array(x), np.array(y)


@pytest.mark.parametrize("batch_rows", [None, 16])
def test_mlp_against_reference_and_own_replay(batch_rows):
    """The port's MLP runner under the reference's draws: the reference
    runner's responder orders, weights within MLP_ATOL of its run, the
    port's run bit-identical to the port's replay, and both losses within
    ALCC_MLP_LOSS_TOL of the plaintext oracle (the port's oracle within
    MLP_ATOL of the reference's)."""
    cj, ct = configs(N=8, K=2, T=1, c=4, batch_rows=batch_rows)
    x, y = mlp_data()
    key = jax.random.PRNGKey(9)
    iters, hidden = 6, 8
    draws = JaxALCCDraws(cj, key, iters, mlp=True)
    jr = jmlp.ALCCMLPRunner(cj, key, x, y, hidden,
                            latency=j_make_latency("lognormal", seed=3),
                            eta=0.1)
    w1j, w2j = jr.run(iters)
    tr = tmlp.ALCCMLPRunner(ct, x, y, hidden,
                            tlat.make_latency("lognormal", seed=3),
                            draws=draws, device="cpu", eta=0.1)
    w1t, w2t = tr.run(iters)
    for rid in jr.survivors:
        assert np.array_equal(jr.survivors[rid], tr.survivors[rid])
    np.testing.assert_allclose(w1t.numpy(), np.asarray(w1j), atol=MLP_ATOL)
    np.testing.assert_allclose(w2t.numpy(), np.asarray(w2j), atol=MLP_ATOL)
    w1r, w2r, hist = tmlp.train_reference(ct, x, y, hidden, iters, 0.1,
                                          survivor_fn=tr.survivor_fn(),
                                          draws=draws, device="cpu")
    assert torch.equal(w1t, w1r) and torch.equal(w2t, w2r)
    assert len(hist) == iters
    o1j, o2j = je.mlp_oracle(cj, key, x, y, hidden, iters, eta=0.1)
    o1t, o2t = te.mlp_oracle(ct, x, y, hidden, iters, 0.1, draws=draws,
                             device="cpu")
    np.testing.assert_allclose(o1t.numpy(), np.asarray(o1j), atol=MLP_ATOL)
    np.testing.assert_allclose(o2t.numpy(), np.asarray(o2j), atol=MLP_ATOL)
    loss, _ = tr.metrics_now()
    loss_o, _ = te.mlp_metrics(tr.state, o1t, o2t)
    assert abs(loss - loss_o) <= ALCC_MLP_LOSS_TOL
    loss_j, _ = jr.metrics_now()
    assert abs(loss - loss_j) <= MLP_ATOL


def test_mlp_middle_against_reference():
    """One middle from the same decoded activations: the W2 gradient, the
    layer-1 deltas (the tanh gelu's VJP), loss and accuracy."""
    rng = np.random.default_rng(4)
    z1 = rng.normal(size=(10, 8)).astype(np.float32)
    w2 = rng.normal(size=(8, 4)).astype(np.float32)
    yb = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 10)]
    mask = (np.arange(10) < 9).astype(np.float32)
    want = je._mlp_middle(z1, w2, yb, mask)
    got = te._mlp_middle(t_(z1), t_(w2), t_(yb), t_(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# -- over sockets: the port's master and CPU worker processes --

def _cli(args, tmp_path, name):
    out = tmp_path / f"{name}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cpml_cluster",
         "--device", "cpu", "--m", "200", "--d", "12", "--iters", "4",
         "--engine", "alcc", "--transport", "socket", *args,
         "--json-out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout, json.loads(out.read_text())


@pytest.mark.slow
def test_socket_alcc_within_tolerance_of_replay(tmp_path):
    """N=8 CPU worker processes, worker 3 straggling: the weights within
    ALCC_SOCKET_TOL of train_reference over the trace, every worker on
    the CPU with no kernel launch."""
    out, res = _cli(["--straggle-worker", "3", "--straggle-sleep", "0.05"],
                    tmp_path, "alcc")
    assert res["replay_max_abs_diff"] <= ALCC_SOCKET_TOL
    assert "(tolerance 1e-03): OK" in out
    reports = res["worker_reports"]
    assert sorted(r["worker"] for r in reports) == list(range(8))
    assert all(r["device"] == "cpu" and r["rounds"] >= 1 for r in reports)
    assert res["wait_stats"]["alcc"]["fallbacks"]["n"] == 0.0


@pytest.mark.slow
def test_socket_alcc_mlp_within_tolerance_and_oracle(tmp_path):
    out, res = _cli(["--model", "mlp", "--classes", "4", "--hidden", "8"],
                    tmp_path, "mlp")
    assert res["replay_max_abs_diff"] <= ALCC_SOCKET_TOL
    assert abs(res["loss_coded"] - res["loss_oracle"]) <= ALCC_MLP_LOSS_TOL
    assert all(r["device"] == "cpu" and r["rounds"] >= 1
               for r in res["worker_reports"])


def test_case1_fleet_diverges_in_the_reference_too():
    """A reference-side fact the port keeps: at Case 1's fleet (N = 40,
    K = 13, T = 1) the Chebyshev encode extrapolates a degree-13
    interpolant from betas within ±0.45 to alphas out to ±1, its entries
    pass 1e6, and the float32 worker results swamp the gradient: both
    packages' train_reference leave the float oracle's weights by orders
    of magnitude within two rounds."""
    cj, ct = configs(N=40, K=13, T=1)
    assert np.abs(ct.scheme.encode_matrix).max() > 1e6
    x, y = logreg_data(m=130, d=8)
    key = jax.random.PRNGKey(3)
    wj, _ = je.train_reference(cj, key, x, y, 2)
    wt, _ = te.train_reference(ct, x, y, 2, draws=JaxALCCDraws(cj, key, 2),
                               device="cpu")
    oracle = te.float_oracle(ct, x, y, 2, draws=JaxALCCDraws(cj, key, 2),
                             device="cpu")
    assert float(oracle.abs().max()) < 10.0
    assert not (np.abs(np.asarray(wj)) < 1e6).all()
    assert not (wt.abs() < 1e6).all()
