"""The port's protocol (the whole slice) against repro.core.protocol on the
CPU: setup, one teacher-forced round, and free-running training.

Field values (shares, worker results, decoded parts) must be bit-equal.
Float values (weights) are held to a tolerance, because torch and XLA sum
float32 in different orders in xqᵀ·targets and in the K-sum of
parts_to_gradient.  The reference's randomness reaches the port through
``JaxDraws``, an object with the port's draws interface that replays the
reference's key derivation (engine.py, encode.py, lagrange.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import field as jf  # noqa: E402
from repro.core import lagrange as jl  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.protocol import compute as jcompute  # noqa: E402
from repro.core.protocol import decode as jdecode  # noqa: E402
from repro.core.protocol import encode as jencode  # noqa: E402
from repro.core.protocol import engine as je  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.protocol import compute as tcompute  # noqa: E402
from repro_torch.core.protocol import engine as te  # noqa: E402

# One ulp-scale float32 summation-order difference per round, compounded
# over a few rounds at |w| < 1.
W_ATOL_ROUND = 1e-5
W_ATOL_TRAIN = 1e-4


class JaxDraws:
    """The reference's draws (jax.random, threefry) behind the port's seam."""

    def __init__(self, cfg, key, iters):
        self.cfg = cfg
        self.ksetup, self.kloop = jax.random.split(key)
        self.iters = iters

    def dataset_masks(self, T, mk, d, p):
        kx, _ = jax.random.split(self.ksetup)              # engine.setup
        return torch.from_numpy(np.array(jl.draw_masks(kx, T, (mk, d), p)))

    def round(self, t, wbar_shape, T, p):
        kq, km = jax.random.split(je.round_key(self.kloop, t))  # encode_weights
        u = jax.random.uniform(kq, tuple(wbar_shape))
        masks = jl.draw_masks(km, T, tuple(wbar_shape), p)
        return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(masks))

    def batch(self, t, mk, rows):
        idx = je.draw_batch(self.cfg, self.kloop, self.iters, mk, t)
        return torch.from_numpy(np.array(idx)).to(torch.int64)


def configs(**kw):
    cj = jp.CPMLConfig(**kw)
    return cj, convert.config_from_reference(dataclasses.asdict(cj))


def dataset(c, m, d):
    if c == 1:
        x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=m, d=d, margin=12.0)
    else:
        x, y = jsyn.multiclass_mnist_like(jax.random.PRNGKey(42), m=m, d=d, c=c)
    return np.array(x), np.array(y)


def rolled(N, drop):
    return lambda t: np.roll(np.arange(N), t)[: N - drop]


CASES = {
    "binary": dict(cfg=dict(N=8, K=2, T=1), m=131, d=12, drop=0),
    "multiclass_batch_drop": dict(cfg=dict(N=8, K=2, T=1, c=3, batch_rows=16),
                                  m=131, d=12, drop=1),
    "r2_p30": dict(cfg=dict(N=12, K=2, T=1, r=2, p=jf.P30), m=101, d=10,
                   drop=0),
}


# More heads than the first CUDA kernel took (c*r > 32): held on the round
# only, where the worker step runs all 33 heads.
ROUND_CASES = {**CASES, "heads_c33": dict(cfg=dict(N=8, K=2, T=1, c=33),
                                          m=131, d=12, drop=0)}


def test_config_conversion_and_refusals():
    cj, ct = configs(N=8, K=2, T=1, c=3, batch_rows=5)
    assert (ct.threshold, ct.grad_scale) == (cj.threshold, cj.grad_scale)
    assert ct.headroom_bits(1.0, 100) == cj.headroom_bits(1.0, 100)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tp.CPMLConfig(N=8, K=2, T=1, backend="shard")
    with pytest.raises(ValueError):
        tp.CPMLConfig(N=6, K=2, T=1)                 # below threshold
    with pytest.raises(ValueError):
        convert.config_from_reference({**dataclasses.asdict(cj), "zzz": 1})


@pytest.mark.parametrize("case", list(CASES))
def test_setup_bit_equal(case):
    spec = CASES[case]
    cj, ct = configs(**spec["cfg"])
    x, y = dataset(ct.c, spec["m"], spec["d"])
    key = jax.random.PRNGKey(5)
    draws = JaxDraws(cj, key, 1)
    want = jp.setup(cj, draws.ksetup, jnp.asarray(x), jnp.asarray(y))
    got = tp.setup(ct, torch.as_tensor(x), torch.as_tensor(y), draws=draws)
    assert (got.m, got.mk) == (want.m, want.mk)
    assert got.x_shares.dtype == torch.int32
    for name in ("x_shares", "xq_real", "xq_parts", "y", "y_parts", "w"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    np.testing.assert_allclose(got.xty.numpy(), np.asarray(want.xty),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["binary", "multiclass_batch_drop",
                                  "heads_c33"])
def test_teacher_forced_round_bit_equal(case):
    """The reference's state and w2 go across through convert; weight
    shares, all N worker results and the decoded parts are bit-equal, and
    the new w2 agrees within W_ATOL_ROUND."""
    spec = ROUND_CASES[case]
    cj, ct = configs(**spec["cfg"])
    x, y = dataset(ct.c, spec["m"], spec["d"])
    key = jax.random.PRNGKey(9)
    draws = JaxDraws(cj, key, 4)
    ref_state = jp.setup(cj, draws.ksetup, jnp.asarray(x), jnp.asarray(y))
    state = convert.state_from_reference(
        {f.name: np.asarray(getattr(ref_state, f.name))
         for f in dataclasses.fields(ref_state)}, "cpu")
    w2_np = (np.random.default_rng(0).normal(size=(spec["d"], ct.c)) * 0.3
             ).astype(np.float32)
    w2j, w2t = jnp.asarray(w2_np), torch.as_tensor(w2_np)
    eta, t = 0.7, 2
    surv = rolled(ct.N, spec["drop"])(t)
    dmat, order = je.survivor_round(cj, surv)
    bidx = None
    if ct.batch_rows is not None:
        bidx = je.draw_batch(cj, draws.kloop, 4, ref_state.mk, t)

    shares_j = jencode.encode_weights(cj, je.round_key(draws.kloop, t), w2j)
    cbar = je.poly_coeffs(cj)
    xb = ref_state.x_shares if bidx is None else \
        jnp.take(ref_state.x_shares, bidx, axis=1)
    results_j = jcompute.all_worker_results(cj, jnp.asarray(cbar), xb, shares_j)
    fastest_j = jnp.take(results_j, jnp.asarray(order), axis=0)
    parts_j = jdecode.decode_parts(cj, fastest_j, jnp.asarray(dmat))
    w_new_j = je._round_update(
        cj, w2j, fastest_j, ref_state.xq_parts, ref_state.y_parts,
        je._w_internal(cj, ref_state.xty), jnp.asarray(dmat), bidx,
        jnp.float32(eta), jnp.int32(ref_state.m))

    bidx_t = None if bidx is None else torch.from_numpy(np.array(bidx)).long()
    shares_t = te.encode_round_shares(ct, draws, t, w2t)
    assert np.array_equal(shares_t.numpy(), np.asarray(shares_j))
    xb_t = state.x_shares if bidx_t is None else state.x_shares[:, bidx_t]
    results_t = tcompute.all_worker_results(ct, torch.as_tensor(cbar), xb_t,
                                            shares_t)
    assert np.array_equal(results_t.numpy(), np.asarray(results_j))
    dmat_t, order_t = torch.as_tensor(np.array(dmat)), torch.as_tensor(order)
    parts_t = te.round_parts(ct, state, shares_t, dmat_t, order_t, bidx_t)
    assert np.array_equal(parts_t.numpy(), np.asarray(parts_j))
    w_new_t = te._round_update(ct, state, w2t, results_t[order_t], dmat_t,
                               bidx_t, eta)
    np.testing.assert_allclose(w_new_t.numpy(), np.asarray(w_new_j),
                               rtol=0, atol=W_ATOL_ROUND)
    # the in-process round composes the same pieces
    run = te.round_fn(ct, state, eta, draws)
    assert torch.equal(run(t, w2t, dmat_t, order_t, bidx_t), w_new_t)


@pytest.mark.parametrize("case", list(CASES))
def test_free_running_training_matches_reference(case):
    spec = CASES[case]
    cj, ct = configs(**spec["cfg"])
    x, y = dataset(ct.c, spec["m"], spec["d"])
    key = jax.random.PRNGKey(7)
    iters, eta = 5, 1.5
    sfn = rolled(ct.N, spec["drop"]) if spec["drop"] else None
    w_j, hist_j = jp.train_reference(cj, key, jnp.asarray(x), jnp.asarray(y),
                                     iters=iters, eta=eta, survivor_fn=sfn,
                                     eval_every=1)
    kw = dict(eta=eta, survivor_fn=sfn, eval_every=1, device="cpu")
    w_t, hist_t = tp.train_reference(ct, x, y, iters,
                                     draws=JaxDraws(cj, key, iters), **kw)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=W_ATOL_TRAIN)
    assert [h["iter"] for h in hist_t] == [h["iter"] for h in hist_j]
    for ht, hj in zip(hist_t, hist_j):
        assert abs(ht["acc"] - hj["acc"]) <= 0.01
    # train (the loop over _round) == train_reference (the round_fn hook)
    w_loop, hist_loop = tp.train(ct, x, y, iters,
                                 draws=JaxDraws(cj, key, iters), **kw)
    assert torch.equal(w_loop, w_t) and hist_loop == hist_t


def test_train_defaults_to_cuda():
    """Without device="cpu" an entry point needs CUDA; here it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cj, ct = configs(N=8, K=2, T=1)
    x, y = dataset(1, 20, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.train(ct, x, y, 1)
