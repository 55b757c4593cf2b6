"""repro_torch.core.lagrange against repro.core.lagrange, bit for bit, with
the reference's masks fed through the randomness seam."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import field as jf  # noqa: E402
from repro.core import lagrange as jl  # noqa: E402
from repro_torch.core import field as tf  # noqa: E402
from repro_torch.core import lagrange as tl  # noqa: E402


def schemes(N, K, T, p):
    return jl.CodingScheme(N, K, T, p), tl.CodingScheme(N, K, T, p)


@pytest.mark.parametrize("p", [jf.P, jf.P30])
@pytest.mark.parametrize("N,K,T", [(8, 2, 1), (7, 3, 0), (12, 2, 3)])
def test_encode_decode_bit_equal(p, N, K, T):
    js, ts = schemes(N, K, T, p)
    assert np.array_equal(js.encode_matrix, ts.encode_matrix)
    rng = np.random.default_rng(N + K + T)
    parts = rng.integers(0, p, (K, 6, 5)).astype(np.int32)
    masks = np.array(jl.draw_masks(jax.random.PRNGKey(N), T, (6, 5), p))
    pj, mj = jnp.asarray(parts), jnp.asarray(masks)
    pt, mt = torch.as_tensor(parts), torch.as_tensor(masks)

    want = np.asarray(jl.encode(js, pj, mj, p))
    got = tl.encode(ts, pt, mt, p)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    data = tl.encode_data(ts, pt, p)
    mask = tl.encode_masks(ts, mt, p)
    assert np.array_equal(data.numpy(), np.asarray(jl.encode_data(js, pj, p)))
    assert np.array_equal(mask.numpy(), np.asarray(jl.encode_masks(js, mj, p)))
    # the split encode is exact: data rows + mask rows == whole encode
    assert torch.equal(tf.addmod(data, mask, p), got)

    # decode any threshold survivors of a degree-1 "worker function"
    need = jl.degree_threshold(K, T, 1)
    surv = rng.permutation(N)[:need]
    res = got.numpy()[surv]
    dec = tl.decode(ts, torch.as_tensor(res), surv, 1, p)
    assert np.array_equal(dec.numpy(),
                          np.asarray(jl.decode(js, jnp.asarray(res), surv, 1, p)))
    assert np.array_equal(dec.numpy(), parts)        # exact recovery
    s = tl.decode_sum(ts, torch.as_tensor(res), surv, 1, p)
    assert np.array_equal(
        s.numpy(), np.asarray(jl.decode_sum(js, jnp.asarray(res), surv, 1, p)))


def test_decode_needs_threshold_survivors():
    _, ts = schemes(8, 2, 1, jf.P)
    res = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        tl.decode(ts, res, np.arange(2), 1)


def test_coding_scheme_matrices_and_thresholds():
    js, ts = schemes(9, 3, 1, jf.P)
    surv = np.array([0, 2, 4, 5, 8])
    assert np.array_equal(js.decode_matrix(surv), ts.decode_matrix(surv))
    assert np.array_equal(js.coeff_matrix(surv), ts.coeff_matrix(surv))
    assert tl.recovery_threshold(3, 1, 2) == jl.recovery_threshold(3, 1, 2)
    with pytest.raises(ValueError):
        tl.CodingScheme(3, 3, 1)


def test_draw_masks_shape_and_range():
    g = torch.Generator().manual_seed(0)
    m = tl.draw_masks(g, 2, (4, 3), jf.P30)
    assert m.shape == (2, 4, 3) and m.dtype == torch.int32
    assert int(m.min()) >= 0 and int(m.max()) < jf.P30
    assert tl.draw_masks(g, 0, (4, 3)).shape == (0, 4, 3)
