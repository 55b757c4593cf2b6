"""repro_torch.core.field against repro.core.field, bit for bit (CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import exact_modmatmul  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro_torch.core import field as tf  # noqa: E402

PRIMES = [jf.P, jf.P30]


def both(a):
    return jnp.asarray(a, jnp.int32), torch.as_tensor(np.asarray(a, np.int32))


def same(j, t):
    return np.array_equal(np.asarray(j), t.numpy()) and t.dtype == torch.int32


def test_constants_match():
    assert (tf.P, tf.P30, tf.LIMB_BITS) == (jf.P, jf.P30, jf.LIMB_BITS)
    for p in PRIMES:
        assert tf.n_limbs(p) == jf.n_limbs(p)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_elementwise_ops_bit_equal(p, kind):
    rng = np.random.default_rng(1)
    if kind == "random":
        a_np = rng.integers(0, p, 4096)
        b_np = rng.integers(0, p, 4096)
        a_np[:4] = [0, 1, p - 1, p - 2]
    else:
        a_np = np.full(64, p - 1)
        b_np = np.full(64, p - 1)
    (aj, at), (bj, bt) = both(a_np), both(b_np)
    assert same(jf.addmod(aj, bj, p), tf.addmod(at, bt, p))
    assert same(jf.submod(aj, bj, p), tf.submod(at, bt, p))
    assert same(jf.negmod(aj, p), tf.negmod(at, p))
    assert same(jf.mulmod(aj, bj, p), tf.mulmod(at, bt, p))
    assert same(jf.powmod(aj, 5, p), tf.powmod(at, 5, p))
    # invmod is Fermat in both packages; python's pow is the ground truth
    # (the reference's eager 30-bit exponentiation is slow op by op).
    nz = np.where(a_np[:32] == 0, 1, a_np[:32])
    want = [pow(int(v), p - 2, p) for v in nz]
    assert tf.invmod(torch.as_tensor(nz, dtype=torch.int32), p).tolist() == want
    assert same(jf.double_mod(aj, 13, p), tf.double_mod(at, 13, p))
    for lj, lt in zip(jf.limbs(aj, p), tf.limbs(at, p)):
        assert same(lj, lt)


@pytest.mark.parametrize("p", PRIMES)
def test_fmod_is_floor_mod_on_negatives(p):
    x_np = np.array([-1, -p, -p - 1, -(2 ** 31) + 1, 0, p, p + 5, 2 ** 31 - 1],
                    np.int64).astype(np.int32)
    xj, xt = both(x_np)
    got = tf.fmod(xt, p)
    assert same(jf.fmod(xj, p), got)
    assert (got >= 0).all() and (got < p).all()


@pytest.mark.parametrize("p", PRIMES)
def test_signed_maps_bit_equal(p):
    half = (p - 1) // 2
    x_np = np.array([0, 1, half - 1, half, half + 1, p - 1])
    xj, xt = both(x_np)
    assert np.array_equal(np.asarray(jf.to_signed(xj, p)),
                          tf.to_signed(xt, p).numpy())
    s_np = np.array([-half, -1, 0, 1, half - 1])
    sj, st = both(s_np)
    assert same(jf.from_signed(sj, p), tf.from_signed(st, p))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("shape", [
    (8, 16, 8), (128, 256, 128), (100, 300, 50), (1, 1, 1), (257, 129, 65),
    (64, 1000, 32), (33, 17, 1),
])
def test_matmul_bit_equal(p, shape):
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K)
    a_np = rng.integers(0, p, (M, K))
    b_np = rng.integers(0, p, (K, N))
    (aj, at), (bj, bt) = both(a_np), both(b_np)
    got = tf.matmul(at, bt, p)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert (got.numpy().astype(object) == exact_modmatmul(a_np, b_np, p)).all()
    assert same(jf.matmul(aj, bj, p), got)


@pytest.mark.parametrize("p", PRIMES)
def test_matmul_extreme_values(p):
    a = torch.full((32, 512), p - 1, dtype=torch.int32)
    b = torch.full((512, 16), p - 1, dtype=torch.int32)
    got = tf.matmul(a, b, p).numpy().astype(object)
    assert (got == exact_modmatmul(a.numpy(), b.numpy(), p)).all()


def test_matmul_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tf.matmul(torch.zeros((2, 3), dtype=torch.int32),
                  torch.zeros((4, 2), dtype=torch.int32))


@pytest.mark.parametrize("p", PRIMES)
def test_host_builders_equal(p):
    ev = np.arange(5, 13)
    ip = np.arange(1, 5)
    assert np.array_equal(jf.host_lagrange_coeffs(ev, ip, p),
                          tf.host_lagrange_coeffs(ev, ip, p))
    assert np.array_equal(jf.host_vandermonde_inv(ev, p),
                          tf.host_vandermonde_inv(ev, p))
    assert jf.host_inv(12345, p) == tf.host_inv(12345, p)
