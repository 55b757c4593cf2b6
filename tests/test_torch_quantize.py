"""repro_torch quantize + sigmoid_poly against the reference, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import field as jf  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.core import sigmoid_poly as jsp  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402
from repro_torch.core import sigmoid_poly as tsp  # noqa: E402

PRIMES = [jf.P, jf.P30]


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("lc", [0, 6, 10])
def test_quantized_coeffs_identical(p, r, lc):
    want = jsp.quantized_coeffs(r, 2, 4, lc, p)
    got = tsp.quantized_coeffs(r, 2, 4, lc, p)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert tsp.gradient_scale_poly(2, 4, r, lc) == \
        jsp.gradient_scale_poly(2, 4, r, lc)
    assert tsp.fit_sigmoid(r) == jsp.fit_sigmoid(r)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_gbar_field_bit_equal(p, r):
    rng = np.random.default_rng(r)
    xw = rng.integers(0, p, (37, 4, r)).astype(np.int32)
    xw[0] = p - 1
    cbar = jsp.quantized_coeffs(r, 2, 4, 6, p).astype(np.int32)
    want = np.asarray(jsp.gbar_field(jnp.asarray(xw), jnp.asarray(cbar), p))
    got = tsp.gbar_field(torch.as_tensor(xw), torch.as_tensor(cbar), p)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("lx", [2, 5])
def test_quantize_data_bit_equal(p, lx):
    rng = np.random.default_rng(lx)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    x[0, :4] = [0.125, -0.125, 0.375, -0.375]    # exact half-points at lx=2
    want = np.asarray(jq.quantize_data(jnp.asarray(x), lx, p))
    got = tq.quantize_data(torch.as_tensor(x), lx, p)
    assert np.array_equal(got.numpy(), want)
    l = lx + 3
    assert np.array_equal(tq.dequantize(got, l, p).numpy(),
                          np.asarray(jq.dequantize(jnp.asarray(want), l, p)))
    assert tq.gradient_scale(lx, 4, 2) == jq.gradient_scale(lx, 4, 2)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("shape,r", [((31,), 1), ((17, 3), 2), ((8, 10), 3)])
def test_quantize_weights_bit_equal_given_reference_uniforms(p, shape, r):
    """The randomness seam: fed the reference's jax.random.uniform draws,
    the port's stochastic quantization gives the same field elements."""
    rng = np.random.default_rng(len(shape) + r)
    w = (rng.normal(size=shape) * 0.7).astype(np.float32)
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (*shape, r)))
    want = np.asarray(jq.quantize_weights(key, jnp.asarray(w), 4, r, p))
    got = tq.quantize_weights(torch.as_tensor(w), torch.as_tensor(u), 4, p)
    assert got.shape == (*shape, r) and np.array_equal(got.numpy(), want)


def test_quantize_weights_rejects_mismatched_uniforms():
    with pytest.raises(ValueError):
        tq.quantize_weights(torch.zeros(5), torch.zeros((4, 2)), 4)
