"""The port's plain selective scan against the reference's oracle and its
Pallas kernel (interpret mode), plus the CPU-side behaviour of the CUDA
wrapper.  The CUDA kernel itself is held against the plain version on the
GPU by chip_smoke.py.  Tolerance 1e-4, the reference kernel test's own:
the same float32 recurrence summed in another order."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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


def test_bf16_ab_mode_with_chunk_1_is_the_recurrence_on_rounded_a_b():
    """``ssm_dtype="bf16"`` with chunks of one step: the chunk's running
    products are a_t and b_t themselves, so h_t = a_t h_{t-1} + b_t in
    float32 on a and b rounded to bf16, exactly."""
    x, dt, bm, cm, a_log, d, h0 = (torch.as_tensor(a) for a in
                                   make_inputs(3, 2, 9, 8, 4, 0.5))
    y, h = ref.selective_scan_ref(x, dt, bm, cm, a_log, d, h0, "bf16", 1)
    A = -torch.exp(a_log)
    hh, ys = h0, []
    for t in range(x.shape[1]):
        a_t = torch.exp(dt[:, t, :, None] * A).bfloat16().float()
        b_t = (dt[:, t, :, None] * bm[:, t, None, :]
               * x[:, t, :, None]).bfloat16().float()
        hh = a_t * hh + b_t
        ys.append((hh * cm[:, t, None, :]).sum(-1) + d * x[:, t])
    assert torch.equal(h, hh) and torch.equal(y, torch.stack(ys, 1))


@pytest.mark.parametrize("chunk", [4, 7, 9, 64])
def test_bf16_ab_mode_restarts_at_chunk_boundaries(chunk):
    """The state at a chunk boundary carries over in float32: a run of S
    steps equals its first k·chunk steps followed by the rest from their
    h_last, whatever chunk; and the mode lies near the float32 scan (bf16
    a and b: within 2^-6 of the largest output)."""
    S = 9
    x, dt, bm, cm, a_log, d, h0 = (torch.as_tensor(a) for a in
                                   make_inputs(4, 2, S, 8, 4, 0.5))
    y, h = ref.selective_scan_ref(x, dt, bm, cm, a_log, d, h0, "bf16", chunk)
    cut = min(chunk, S - 1)
    if chunk < S:
        y1, h1 = ref.selective_scan_ref(x[:, :cut], dt[:, :cut], bm[:, :cut],
                                        cm[:, :cut], a_log, d, h0, "bf16",
                                        chunk)
        y2, h2 = ref.selective_scan_ref(x[:, cut:], dt[:, cut:], bm[:, cut:],
                                        cm[:, cut:], a_log, d, h1, "bf16",
                                        chunk)
        assert torch.equal(y, torch.cat([y1, y2], 1)) and torch.equal(h, h2)
    y32, h32 = ref.selective_scan_ref(x, dt, bm, cm, a_log, d, h0)
    assert not torch.equal(y, y32)
    assert float((y - y32).abs().max()) < 2.0 ** -6 * float(y32.abs().max())


def test_ops_passes_the_mode_and_refuses_bad_ones():
    targs = [torch.as_tensor(a) for a in make_inputs(5, 2, 6, 8, 4, 0.3)]
    ops.reset_launches()
    got = ops.selective_scan(*targs, "bf16", 4)
    want = ref.selective_scan_ref(*targs, "bf16", 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for mode, chunk in (("fp8", 4), ("bf16", 0)):
        with pytest.raises(ValueError, match="ssm_dtype"):
            ops.selective_scan(*targs, mode, chunk)
        with pytest.raises(ValueError, match="ssm_dtype"):
            tms.check_mode(mode, chunk)
    assert kernels.LAUNCHES["selective_scan"] == 0


# -- the gradient: the plain reverse recurrence (what csrc/mamba_scan_bwd.cu
#    computes) against autograd, jax.grad and gradcheck.  Tolerance: each
#    gradient within 1e-5 of its largest magnitude (float32 sums over
#    channels, batch and time in another order).
GRAD_REL = 1e-5
GRAD_NAMES = ("x", "dt", "bm", "cm", "a_log", "d", "h0")


def close_rel(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * max(float(np.abs(want).max()), 1e-30), (name, err)


def cotangents(seed, B, S, di, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, di)).astype(np.float32),
            rng.standard_normal((B, di, n)).astype(np.float32))


@pytest.mark.parametrize("S", [1, 33, 130])
@pytest.mark.parametrize("n", [1, 16])
def test_plain_backward_matches_autograd_and_jax_grad(S, n):
    B, di = 2, 6
    args = make_inputs(S + n, B, S, di, n, h0_scale=0.7)
    dy, dh = cotangents(S * n, B, S, di, n)
    got = ref.selective_scan_bwd_ref(*(torch.as_tensor(a) for a in args),
                                     torch.as_tensor(dy), torch.as_tensor(dh))
    targs = [torch.as_tensor(a).requires_grad_(True) for a in args]
    y, h = ref.selective_scan_ref(*targs)
    auto = torch.autograd.grad((y * torch.as_tensor(dy)).sum()
                               + (h * torch.as_tensor(dh)).sum(), targs)
    _, vjp = jax.vjp(jms.ref_selective_scan, *(jnp.asarray(a) for a in args))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    for name, g, a, j in zip(GRAD_NAMES, got, auto, jgrads):
        assert g.dtype == torch.float32
        close_rel(g, a, name)
        close_rel(g, j, name)


class _PlainScanFn(torch.autograd.Function):
    """The plain scan with the plain reverse recurrence as its backward."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        return ref.selective_scan_ref(*ins)

    @staticmethod
    def backward(ctx, dy, dh_last):
        return ref.selective_scan_bwd_ref(*ctx.saved_tensors, dy, dh_last)


def test_scan_fn_passes_gradcheck_in_float64():
    """``selective_scan_bwd_ref`` against finite differences of
    ``selective_scan_ref``, both in float64."""
    args = [torch.as_tensor(a, dtype=torch.float64).requires_grad_(True)
            for a in make_inputs(11, 2, 5, 3, 4, h0_scale=0.5)]
    assert torch.autograd.gradcheck(_PlainScanFn.apply, args)


def test_ops_differentiates_the_plain_version_on_the_cpu():
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in make_inputs(9, 2, 7, 5, 3, 0.5)]
    ops.reset_launches()
    y, h = ops.selective_scan(*args)
    assert y.grad_fn is not None
    assert "SelectiveScanFn" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert all(a.grad is not None for a in args)
    assert kernels.LAUNCHES["selective_scan"] == 0
    assert kernels.LAUNCHES["selective_scan_bwd"] == 0


def test_bf16_ab_mode_backward_raises_naming_its_item():
    """``SelectiveScanFn`` runs on the card only; its backward refuses the
    bf16 a/b mode before it reads a saved tensor."""
    ctx = types.SimpleNamespace(ssm_dtype="bf16", saved_tensors=())
    dy, dh = (torch.as_tensor(t) for t in cotangents(10, 1, 6, 4, 2))
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="list 1b item 8"):
        tms.SelectiveScanFn.backward(ctx, dy, dh)
    assert kernels.LAUNCHES["selective_scan_bwd"] == 0


def test_backward_wrapper_refuses_cpu_tensors():
    args = [torch.as_tensor(a) for a in make_inputs(2, 1, 3, 4, 2)]
    dy, dh = (torch.as_tensor(t) for t in cotangents(2, 1, 3, 4, 2))
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tms.selective_scan_bwd(*args, dy, dh)
    assert kernels.LAUNCHES["selective_scan_bwd"] == 0
