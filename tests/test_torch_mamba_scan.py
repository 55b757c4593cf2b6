"""The port's plain selective scan against the reference's oracle and its
Pallas kernel (interpret mode), plus the CPU-side behaviour of the CUDA
wrapper.  The CUDA kernel itself is held against the plain version on the
GPU by chip_smoke.py.  Tolerance 1e-4, the reference kernel test's own:
the same float32 recurrence summed in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import mamba_scan as jms  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402

ATOL = 1e-4


def make_inputs(seed, B, S, di, n, h0_scale=0.0):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, S, di)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(f32)
    bm = (rng.standard_normal((B, S, n)) * 0.5).astype(f32)
    cm = (rng.standard_normal((B, S, n)) * 0.5).astype(f32)
    a_log = np.log(rng.uniform(0.3, 2.0, (di, n))).astype(f32)
    d = rng.standard_normal(di).astype(f32)
    h0 = (rng.standard_normal((B, di, n)) * h0_scale).astype(f32)
    return x, dt, bm, cm, a_log, d, h0


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < ATOL, err


# (B, S, di, n, blk_di, blk_s) of tests/test_kernels_mamba.py, then a
# non-zero h0 and a bf16 x.
CASES = [
    (1, 16, 8, 4, 8, 8, 0.0, "f32"),
    (2, 33, 16, 4, 8, 16, 0.0, "f32"),
    (2, 64, 32, 8, 16, 32, 0.0, "f32"),
    (2, 33, 16, 4, 8, 16, 0.7, "f32"),
    (2, 24, 16, 16, 16, 8, 0.7, "bf16"),
]


@pytest.mark.parametrize("B,S,di,n,blk_di,blk_s,h0_scale,xdt", CASES)
def test_plain_scan_equals_reference_oracle_and_pallas(B, S, di, n, blk_di,
                                                       blk_s, h0_scale, xdt):
    args = make_inputs(B * S + di + n, B, S, di, n, h0_scale)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.as_tensor(a) for a in args]
    if xdt == "bf16":
        jargs[0] = jargs[0].astype(jnp.bfloat16)
        targs[0] = targs[0].to(torch.bfloat16)
        assert np.array_equal(np.asarray(jargs[0].astype(jnp.float32)),
                              targs[0].float().numpy())
    y, h = ref.selective_scan_ref(*targs)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    y_ref, h_ref = jms.ref_selective_scan(*jargs)
    close(y, y_ref)
    close(h, h_ref)
    y_pl, h_pl = jms.selective_scan(*jargs, blk_di=blk_di, blk_s=blk_s,
                                    interpret=True)
    close(y, y_pl)
    close(h, h_pl)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    targs = [torch.as_tensor(a) for a in make_inputs(1, 2, 5, 8, 4, 0.3)]
    ops.reset_launches()
    y, h = ops.selective_scan(*targs)
    y_ref, h_ref = ref.selective_scan_ref(*targs)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert kernels.LAUNCHES["selective_scan"] == 0


def test_wrapper_refuses_cpu_tensors():
    targs = [torch.as_tensor(a) for a in make_inputs(2, 1, 3, 4, 2)]
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tms.selective_scan(*targs)
    assert kernels.LAUNCHES["selective_scan"] == 0
