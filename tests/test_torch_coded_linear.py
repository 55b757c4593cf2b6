"""The port's Lagrange-coded linear layer against ``repro.core.coded_linear``:
with the reference's masks fed through the seam, shares and decoded field
values are bit-equal; then the cases of tests/test_coded_linear.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import coded_linear as jcl  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import lagrange as jlag  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro_torch.core import coded_linear as tcl  # noqa: E402
from repro_torch.core import field as tf  # noqa: E402
from repro_torch.core import quantize as tq  # noqa: E402


def layer(seed, N=8, K=5, T=2, d=48, v=40, m=12):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    return w, h


def port_layer(seed, N=8, K=5, T=2, **kw):
    cfg = tcl.CodedLinearConfig(N=N, K=K, T=T, lh=7, lw=7)
    w, h = layer(seed, N, K, T, **kw)
    gen = torch.Generator().manual_seed(seed)
    shares = tcl.encode_weights(cfg, torch.as_tensor(w), gen=gen)
    return cfg, torch.as_tensor(w), torch.as_tensor(h), shares


@pytest.mark.parametrize("p", [jf.P30, jf.P])
@pytest.mark.parametrize("N,K,T,drop", [(8, 5, 2, ()), (8, 5, 2, (0,)),
                                        (9, 5, 2, (2, 5)), (6, 4, 1, (2,)),
                                        (3, 3, 0, ())])
def test_field_values_bit_equal_to_reference(p, N, K, T, drop):
    jcfg = jcl.CodedLinearConfig(N=N, K=K, T=T, lh=7, lw=7, p=p)
    tcfg = tcl.CodedLinearConfig(N=N, K=K, T=T, lh=7, lw=7, p=p)
    w, h = layer(N + K + T + len(drop), N, K, T, v=10 * K)
    key = jax.random.PRNGKey(N * K + T)
    d, v = w.shape
    # the reference's own mask draw, fed through the port's seam
    masks = np.array(jlag.draw_masks(key, T, (d, v // K), p))
    want_shares = np.asarray(jcl.encode_weights(jcfg, key, jnp.asarray(w)))
    shares = tcl.encode_weights(tcfg, torch.as_tensor(w),
                                masks=torch.as_tensor(masks))
    assert shares.dtype == torch.int32
    assert np.array_equal(shares.numpy(), want_shares)

    surv = np.array([i for i in range(N) if i not in drop])
    used = surv[: jcfg.threshold]
    hq = jq.quantize_data(jnp.asarray(h), jcfg.lh, p)
    jres = jax.vmap(lambda ws: jcl.worker_matmul(jcfg, hq, ws))(
        jnp.asarray(want_shares)[jnp.asarray(used)])
    jdec = np.asarray(jlag.decode(jcfg.scheme, jres, used, deg_f=1, p=p))
    want_field = jdec.transpose(1, 0, 2).reshape(h.shape[0], -1)
    results, t_used = tcl.shard_results(tcfg, torch.as_tensor(h), shares, surv)
    assert np.array_equal(t_used, used)
    assert np.array_equal(results.numpy(), np.asarray(jres))
    field_vals = tcl.decode_field(tcfg, results, t_used)
    assert np.array_equal(field_vals.numpy(), want_field)
    # ... which is the direct product H̄ W̄ mod p
    wq = tq.quantize_data(torch.as_tensor(w), tcfg.lw, p)
    hqt = tq.quantize_data(torch.as_tensor(h), tcfg.lh, p)
    assert torch.equal(field_vals, tf.matmul(hqt, wq, p))
    got = tcl.coded_head_apply(tcfg, torch.as_tensor(h), shares, surv)
    want = jcl.coded_head_apply(jcfg, jnp.asarray(h), jnp.asarray(want_shares),
                                survivors=surv)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_exact_vs_quantized_reference():
    cfg, w, h, shares = port_layer(0)
    got = tcl.coded_head_apply(cfg, h, shares)
    want = h @ w
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 0.02, rel     # fixed-point error only


@pytest.mark.parametrize("drop", [[0], [7]])
def test_straggler_sets_decode_identically(drop):
    # N=8, K=5, T=2 -> threshold 7: tolerates exactly one loss
    cfg, w, h, shares = port_layer(1)
    base = tcl.coded_head_apply(cfg, h, shares)
    surv = np.array([i for i in range(cfg.N) if i not in drop])
    assert torch.equal(base, tcl.coded_head_apply(cfg, h, shares, surv))


def test_two_shard_losses_with_wider_code():
    cfg, w, h, shares = port_layer(2, N=9, K=5, T=2)   # threshold 7 of 9
    base = tcl.coded_head_apply(cfg, h, shares)
    surv = np.array([i for i in range(cfg.N) if i not in (2, 5)])
    assert torch.equal(base, tcl.coded_head_apply(cfg, h, shares, surv))


def test_threshold_requirement():
    cfg, *_ = port_layer(3)
    assert cfg.threshold == 7        # K+T = 5+2
    with pytest.raises(ValueError):
        tcl.CodedLinearConfig(N=6, K=5, T=2)
    with pytest.raises(ValueError, match="masks or a generator"):
        tcl.encode_weights(cfg, torch.zeros((4, 10)))
    with pytest.raises(ValueError, match="divide"):
        tcl.encode_weights(cfg, torch.zeros((4, 11)),
                           gen=torch.Generator().manual_seed(0))


def test_weight_privacy_masking():
    """T=2: any 2 shares of a ZERO weight matrix are pure mask — uniform."""
    cfg = tcl.CodedLinearConfig(N=6, K=2, T=2)
    w = torch.zeros((8, 10))
    samples = []
    for i in range(100):
        shares = tcl.encode_weights(cfg, w,
                                    gen=torch.Generator().manual_seed(i))
        samples.append(shares[0].numpy().ravel())
    vals = np.concatenate(samples).astype(np.float64) / cfg.p
    assert abs(vals.mean() - 0.5) < 0.03
    assert abs(vals.var() - 1 / 12) < 0.01
