"""The port's BGW baseline (repro_torch.core.mpc_baseline) against the
reference's on the CPU.

The reference's randomness reaches the port through ``JaxMPCDraws``, an
object with the port's MPC draws interface that replays the reference's
key derivation: ``ksetup/kloop`` split, ``iteration_key``, the
``kw/kq/kred`` split of ``step_keys`` and ``reshare_keys(kred[j])[i]``.
Field values (shares, sub-shares, combined shares, gradient shares,
reconstructions) must be bit-equal, teacher-forced from the same weights;
trained weights are held to W_ATOL_TRAIN, since torch and XLA sum float32
in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cluster import mpc_runner as jrunner  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import mpc_baseline as jm  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import field as tf  # noqa: E402
from repro_torch.core import mpc_baseline as tm  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.core.protocol.draws import TorchMPCDraws  # noqa: E402
from test_torch_protocol import W_ATOL_TRAIN  # noqa: E402
import torch_parity  # noqa: E402


class JaxMPCDraws:
    """The reference's MPC draws (jax.random, threefry) behind the port's
    seam."""

    def __init__(self, cfg, key):
        self.cfg = cfg
        self.ksetup, self.kloop = jax.random.split(key)        # train()

    def data_masks(self, T, m, d, p):                          # setup()
        return torch.from_numpy(np.array(jax.random.randint(
            self.ksetup, (T, m, d), 0, p, dtype=jnp.int32)))

    def _keys(self, t):                                        # step_keys()
        kw, kq, *kred = jax.random.split(
            jm.iteration_key(self.kloop, t), 3 + self.cfg.r)
        return kw, kq, kred

    def step(self, t, wbar_shape, T, p):
        kw, kq, _ = self._keys(t)
        u = jax.random.uniform(kq, tuple(wbar_shape))          # quantize
        masks = jax.random.randint(kw, (T, *wbar_shape), 0, p,
                                   dtype=jnp.int32)            # share()
        return torch.from_numpy(np.array(u)), torch.from_numpy(
            np.array(masks))

    def reshare_seed(self, t, phase):
        return self._keys(t)[2][phase]

    def reshare_masks(self, seed, worker, T, shape, p):
        k = jm.reshare_keys(self.cfg, seed)[worker]
        return torch.from_numpy(np.array(jax.random.randint(
            k, (T, *shape), 0, p, dtype=jnp.int32)))


class KeyDraws(JaxMPCDraws):
    """Reshare masks under a bare key (``degree_reduce(cfg, key, ...)``)."""

    def __init__(self, cfg):
        self.cfg = cfg


def configs(**kw):
    cj = jm.MPCConfig(**kw)
    return cj, tm.MPCConfig(**dataclasses.asdict(cj))


def dataset(m=120, d=10):
    x, y = jsyn.mnist_like(jax.random.PRNGKey(42), m=m, d=d, margin=12.0)
    return np.array(x), np.array(y)


def t_(a):
    return torch.from_numpy(np.array(a))


def assert_bit_equal(got, want, what=""):
    assert np.array_equal(np.asarray(got), np.asarray(want)), what


# -- the configuration and the Shamir primitives --

@pytest.mark.parametrize("N,T", [(7, 3), (8, 1), (5, 0), (40, 1)])
@pytest.mark.parametrize("p", [jf.P, jf.P30])
def test_config_host_values_equal_reference(N, T, p):
    cj, ct = configs(N=N, T=T, r=2, p=p)
    assert np.array_equal(cj.alphas, ct.alphas)
    assert np.array_equal(cj.lambda0, ct.lambda0)
    for count in (1, 2 * T + 1, N):
        assert np.array_equal(cj.lambda0_first(count),
                              ct.lambda0_first(count))
    assert cj.grad_scale == ct.grad_scale
    assert np.array_equal(jm.poly_coeffs(cj), tm.poly_coeffs(ct))


def test_requires_honest_majority():
    with pytest.raises(AssertionError):
        tm.MPCConfig(N=6, T=3)


@pytest.mark.parametrize("N,T", [(7, 3), (5, 0), (8, 1)])
@pytest.mark.parametrize("p", [jf.P, jf.P30])
def test_share_and_reconstruct_bit_equal(N, T, p):
    cj, ct = configs(N=N, T=T, p=p)
    key = jax.random.PRNGKey(3)
    v = jax.random.randint(jax.random.PRNGKey(4), (4, 6), 0, p,
                           dtype=jnp.int32)
    want = jm.share(cj, key, v)
    masks = jax.random.randint(key, (T, 4, 6), 0, p, dtype=jnp.int32)
    got = tm.share(ct, t_(v), t_(masks))
    assert got.dtype == torch.int32 and got.shape == (N, 4, 6)
    assert_bit_equal(got, want)
    assert_bit_equal(tm.reconstruct(ct, got, T), v)
    assert_bit_equal(tm.reconstruct(ct, got, T),
                     jm.reconstruct(cj, want, T))


@pytest.mark.parametrize("p", [jf.P, jf.P30])
def test_subshares_combine_and_degree_reduce_bit_equal(p):
    """The reshare of one degree-2T product sharing, piece by piece and as
    the vectorized oracle, against the reference."""
    cj, ct = configs(N=7, T=3, p=p)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    a = jax.random.randint(k1, (8,), 0, p, dtype=jnp.int32)
    b = jax.random.randint(k2, (8,), 0, p, dtype=jnp.int32)
    prod = jf.mulmod(jm.share(cj, k1, a), jm.share(cj, k2, b), p)
    draws = KeyDraws(cj)
    # the reference's exchange: gathered[j, i] is source i's sub-share for
    # recipient j, and recipient j's new share is its combine
    gathered = jnp.swapaxes(jax.vmap(
        lambda k, v: jm.make_subshares(cj, k, v))(jm.reshare_keys(cj, k3),
                                                  prod), 0, 1)
    for i in range(cj.N):
        sub_t = tm.make_subshares(
            ct, t_(prod[i]), tm.reshare_masks(ct, draws, k3, i, (8,)))
        assert_bit_equal(sub_t, gathered[:, i], f"sub-shares of source {i}")
    red_t = tm.degree_reduce(ct, draws, k3, t_(prod))
    for j in range(cj.N):
        want = jm.combine_subshares(cj, gathered[j])
        assert_bit_equal(tm.combine_subshares(ct, t_(gathered[j])), want)
        assert_bit_equal(red_t[j], want, f"reduced share of worker {j}")
    assert_bit_equal(tm.reconstruct(ct, red_t, ct.T), jf.mulmod(a, b, p))


def test_reconstruct_at_any_subset_bit_equal():
    cj, ct = configs(N=8, T=3)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    a = jax.random.randint(k1, (6,), 0, jf.P, dtype=jnp.int32)
    b = jax.random.randint(k2, (6,), 0, jf.P, dtype=jnp.int32)
    prod = jf.mulmod(jm.share(cj, k1, a), jm.share(cj, k2, b), jf.P)
    ref = tm.reconstruct(ct, t_(prod), 2 * ct.T)
    assert_bit_equal(ref, jm.reconstruct(cj, prod, 2 * cj.T))
    rng = np.random.default_rng(0)
    for _ in range(5):
        subset = rng.permutation(8)[: 2 * ct.T + 1]
        got = tm.reconstruct_at(ct, t_(prod)[torch.from_numpy(subset)],
                                subset)
        assert_bit_equal(got, jm.reconstruct_at(
            cj, prod[jnp.asarray(subset)], subset))
        assert torch.equal(got, ref)


def test_a_share_looks_uniform():
    """One share of constant data looks uniform over F_p (TorchMPCDraws)."""
    ct = tm.MPCConfig(N=5, T=2)
    v = torch.ones(512, dtype=torch.int32)
    masks = TorchMPCDraws(0).step(0, (512,), ct.T, ct.p)[1]
    vals = tm.share(ct, v, masks)[0].double().numpy() / ct.p
    assert abs(vals.mean() - 0.5) < 0.05
    assert abs(vals.var() - 1 / 12) < 0.02


# -- one iteration, teacher-forced, and training (r = 2 in
#    test_torch_mpc_degree2.py: the reference's compiles take ~45 s each) --

CASES = {"r1": dict(N=7, T=3, r=1), "r2_p30": dict(N=5, T=2, r=2, p=jf.P30)}


def check_iteration_hooks(case, iterations):
    """setup, encode_step, every worker's local products and reshares
    (all_g_shares) and the reconstruction, from the same weights."""
    cj, ct = configs(**CASES[case])
    x, y = dataset()
    key = jax.random.PRNGKey(7)
    draws = JaxMPCDraws(cj, key)
    ksetup, kloop = jax.random.split(key)
    sj = jm.setup(cj, ksetup, jnp.asarray(x), jnp.asarray(y))
    st = tm.setup(ct, torch.from_numpy(x), torch.from_numpy(y), draws)
    assert_bit_equal(st.x_shares, sj.x_shares)
    for i in range(ct.N):
        assert torch.equal(st.x_shares_t[i], st.x_shares[i].T)
    np.testing.assert_allclose(st.xty.numpy(), np.asarray(sj.xty), rtol=0,
                               atol=1e-4)
    cbar_j = jnp.asarray(jm.poly_coeffs(cj))
    cbar_t = torch.from_numpy(tm.poly_coeffs(ct))
    w = jax.random.normal(jax.random.PRNGKey(9), (x.shape[1],)) * 0.3
    for t in iterations:
        key_t = jm.iteration_key(kloop, t)
        ws_j, kred = jm.encode_step(cj, key_t, w)
        ws_t, seeds = tm.encode_step(ct, draws, t, t_(w))
        assert_bit_equal(ws_t, ws_j, f"w shares, iteration {t}")
        assert len(seeds) == ct.r
        for i in (0, ct.N - 1):
            z_j = jm.worker_mul(cj, sj.x_shares[i], ws_j[i])
            z_t = tm.worker_mul(ct, st.x_shares_t[i], ws_t[i])
            assert_bit_equal(z_t, z_j, f"z of worker {i}")
            s_j = jm.s_init(cj, cbar_j, z_j[:, 0])
            s_t = tm.s_init(ct, cbar_t, z_t[:, 0])
            assert_bit_equal(s_t, s_j)
            if ct.r > 1:
                assert_bit_equal(
                    tm.s_accum(ct, cbar_t[2], s_t, z_t[:, 1]),
                    jm.s_accum(cj, cbar_j[2], s_j, z_j[:, 1]))
            assert_bit_equal(tm.worker_final(ct, st.x_shares[i], s_t),
                             jm.worker_final(cj, sj.x_shares[i], s_j))
        g_j = jrunner._all_g_shares(cj, key_t, w, sj.x_shares)
        g_t = tm.all_g_shares(ct, draws, t, t_(w), st)
        assert_bit_equal(g_t, g_j, f"gradient shares, iteration {t}")
        dec_t = tm.reconstruct(ct, g_t, 2 * ct.T)
        assert_bit_equal(dec_t, jm.reconstruct(cj, g_j, 2 * cj.T))
        eom = float(np.float32(0.5 / sj.m))
        np.testing.assert_allclose(
            tm.finish_update(ct, t_(w), dec_t, st.xty, eom).numpy(),
            np.asarray(jm.finish_update(cj, w, jnp.asarray(dec_t.numpy()),
                                        sj.xty, jnp.float32(eom))),
            rtol=0, atol=1e-5)


def check_train(case, iters=3):
    cj, ct = configs(**CASES[case])
    x, y = dataset()
    key = jax.random.PRNGKey(7)
    w_j, h_j = jm.train(cj, key, jnp.asarray(x), jnp.asarray(y), iters,
                        eval_every=iters)
    w_t, h_t = tm.train(ct, x, y, iters, eval_every=iters,
                        draws=JaxMPCDraws(cj, key), device="cpu")
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=W_ATOL_TRAIN)
    assert h_t[-1]["iter"] == h_j[-1]["iter"] == iters
    assert h_t[-1]["loss"] == pytest.approx(h_j[-1]["loss"], abs=1e-4)


def test_iteration_hooks_bit_equal():
    check_iteration_hooks("r1", (3,))


def test_train_matches_reference():
    check_train("r1")


def test_train_is_deterministic_and_needs_cuda_unless_cpu():
    ct = tm.MPCConfig(N=5, T=2)
    x, y = dataset(m=60, d=6)
    runs = [tm.train(ct, x, y, 2, draws=TorchMPCDraws(3), device="cpu")[0]
            for _ in range(2)]
    assert torch.equal(*runs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.train(ct, x, y, 1)


def test_mpc_matches_cpml_trajectory():
    """The port's counterpart of test_mpc.py's: same quantization and
    surrogate, so near-identical training curves; differences come only
    from independent stochastic weight draws."""
    x, y = dataset(m=400, d=30)
    _, mh = tm.train(tm.MPCConfig(N=7, T=3, r=1), x, y, 6, eval_every=6,
                     draws=TorchMPCDraws(7), device="cpu")
    _, ch = tp.train(tp.CPMLConfig(N=7, K=2, T=1, r=1), x, y, 6,
                     eval_every=6, draws=tp.TorchDraws(7), device="cpu")
    assert abs(mh[-1]["loss"] - ch[-1]["loss"]) < 2e-3


def test_torch_mpc_draws_are_per_iteration_and_per_worker():
    """Iteration t's draws do not depend on earlier iterations, and a
    worker's reshare masks are a function of (seed, worker) alone, the
    same on any draws object."""
    a, b = TorchMPCDraws(1), TorchMPCDraws(1)
    a.step(0, (5, 1), 1, tf.P)
    for x, y in zip(a.step(3, (5, 1), 1, tf.P), b.step(3, (5, 1), 1, tf.P)):
        assert torch.equal(x, y)
    seed = a.reshare_seed(3, 0)
    assert seed == b.reshare_seed(3, 0) != a.reshare_seed(3, 1)
    assert torch.equal(a.reshare_masks(seed, 2, 1, (4, 1), tf.P),
                       TorchMPCDraws(99).reshare_masks(seed, 2, 1, (4, 1),
                                                       tf.P))
    assert not torch.equal(a.reshare_masks(seed, 2, 1, (4, 1), tf.P),
                           a.reshare_masks(seed, 3, 1, (4, 1), tf.P))


# -- the reference's test_mpc.py cases whose interfaces match --

CASES_MPC = torch_parity.reference_cases("test_mpc")


def test_every_pure_case_reruns():
    assert {c.values[1] for c in CASES_MPC} >= {
        "test_requires_honest_majority"}


@pytest.mark.parametrize("module,name,params", CASES_MPC)
def test_reference_case(module, name, params, request):
    torch_parity.run_case(module, name, params, request)
