"""The port's plain selective scan against the reference's oracle and its
Pallas kernel (interpret mode), plus the CPU-side behaviour of the CUDA
wrapper.  The CUDA kernel itself is held against the plain version on the
GPU by chip_smoke.py.  Tolerance 1e-4, the reference kernel test's own:
the same float32 recurrence summed in another order."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import mamba_scan as jms  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from test_torch_models import JRC, RC, carried  # noqa: E402

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


def test_backward_wrapper_refuses_cpu_tensors():
    args = [torch.as_tensor(a) for a in make_inputs(2, 1, 3, 4, 2)]
    dy, dh = (torch.as_tensor(t) for t in cotangents(2, 1, 3, 4, 2))
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tms.selective_scan_bwd(*args, dy, dh)
    assert kernels.LAUNCHES["selective_scan_bwd"] == 0


# -- the gradient in the bf16 a/b mode.  The plain backward
#    (``selective_scan_bwd_ref(..., "bf16", chunk)``, what the backward
#    kernel computes in that mode) is the exact gradient of the mode's
#    forward with its bf16 roundings straight-through: held to autograd of
#    such a model in float64 within GRAD_REL (1e-5) of each gradient's
#    largest magnitude.  Against ``jax.grad`` of the reference (a tree
#    of bf16 combines, and cotangents rounded to bf16 wherever the
#    reference casts) only an RMS bound holds: AB16_GRAD_RMS of the
#    reference gradient's RMS, each gradient.  The float32 mode's gradient
#    lies about as far from it (the reference's own roundings set that
#    floor), so the float64 check is the one that tells the modes apart.
AB16_GRAD_RMS = 1e-2


def _st(v):
    """v rounded to bf16 with a straight-through derivative."""
    return v + (v.to(torch.bfloat16).to(v.dtype) - v).detach()


def st_ab16_scan(x, dt, bm, cm, a_log, d, h0, chunk):
    """The bf16 a/b mode's forward with every rounding straight-through."""
    A = -torch.exp(a_log)
    h, ys = h0, []
    for t in range(x.shape[1]):
        if t % chunk == 0:
            H, Ac, Bc = h, torch.ones_like(h), torch.zeros_like(h)
        a = _st(torch.exp(dt[:, t, :, None] * A))
        b = _st(dt[:, t, :, None] * bm[:, t, None, :] * x[:, t, :, None])
        Ac, Bc = _st(a * Ac), _st(_st(a * Bc) + b)
        h = Ac * H + Bc
        ys.append((h * cm[:, t, None, :]).sum(-1) + d * x[:, t])
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("chunk", [1, 3, 8, 40])
@pytest.mark.parametrize("n", [1, 16])
def test_ab16_plain_backward_is_the_straight_through_gradient(chunk, n):
    """Chunks of 1, 3 and 8 steps and one longer than S = 21, float64."""
    B, S, di = 2, 21, 6
    args = [torch.as_tensor(a, dtype=torch.float64)
            for a in make_inputs(100 * chunk + n, B, S, di, n, 0.7)]
    dy, dh = (torch.as_tensor(t, dtype=torch.float64)
              for t in cotangents(chunk + n, B, S, di, n))
    got = ref.selective_scan_bwd_ref(*args, dy, dh, "bf16", chunk)
    targs = [a.clone().requires_grad_(True) for a in args]
    y, h = st_ab16_scan(*targs, chunk)
    want_y, want_h = ref.selective_scan_ref(*args, "bf16", chunk)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    auto = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), targs)
    for name, g, a in zip(GRAD_NAMES, got, auto):
        assert g.dtype == torch.float64
        close_rel(g, a, name)


def test_ab16_plain_backward_differs_from_the_float32_modes():
    """The mode's gradient is not the float32 recurrence's: at chunk 8 they
    differ by far more than GRAD_REL (the check above tells them apart)."""
    args = [torch.as_tensor(a, dtype=torch.float64)
            for a in make_inputs(7, 2, 21, 6, 16, 0.7)]
    dy, dh = (torch.as_tensor(t, dtype=torch.float64)
              for t in cotangents(7, 2, 21, 6, 16))
    ab = ref.selective_scan_bwd_ref(*args, dy, dh, "bf16", 8)
    f32 = ref.selective_scan_bwd_ref(*args, dy, dh)
    worst = max(float((g - w).abs().max() / w.abs().max())
                for g, w in zip(ab, f32))
    assert worst > 100 * GRAD_REL, worst


def jax_ab16_core(x, dt, bm, cm, a_log, d, h0, chunk):
    """The reference's bf16 a/b scan core: ``mamba_mix``'s chunk loop
    (``repro/models/mamba.py``) over its ``_discretize`` and
    ``_chunk_scan``, from the activations after the conv and projections."""
    B, S, di = x.shape
    p = {"A_log": a_log, "D": d}
    chunk = min(chunk, S)
    nch = -(-S // chunk)
    pad = ((0, 0), (0, nch * chunk - S), (0, 0))
    x, dt, bm, cm = (jnp.pad(t, pad) for t in (x, dt, bm, cm))
    a, b = jmamba._discretize(p, dt, bm, x, jnp.bfloat16)

    def to_chunks(t):
        return t.reshape(B, nch, chunk, *t.shape[2:]).swapaxes(0, 1)

    def chunk_step(h, inputs):
        a_c, b_c, c_c, x_c = inputs
        h_all, h_last = jmamba._chunk_scan(a_c, b_c, h)
        y = jnp.einsum("blin,bln->bli", h_all, c_c) + d * x_c
        return h_last, y

    h_last, ys = jax.lax.scan(chunk_step, h0, tuple(
        to_chunks(t) for t in (a, b, cm, x)))
    return ys.swapaxes(0, 1).reshape(B, -1, di)[:, :S], h_last


def jax_grad(fn, args, cots):
    """``jax.vjp`` of ``fn`` at ``args`` applied to ``cots``, jitted."""
    def vjp(args, cots):
        return jax.vjp(fn, *args)[1](cots)
    return jax.jit(vjp)(jax.tree.map(jnp.asarray, tuple(args)),
                        jax.tree.map(jnp.asarray, tuple(cots)))


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(((got - want) ** 2).mean())
                 / max(np.sqrt((want ** 2).mean()), 1e-30))


def test_ab16_plain_backward_against_jax_grad_of_the_reference_core():
    """Chunk 8, S = 21 (a ragged last chunk), a non-zero h0."""
    B, S, di, n, chunk = 2, 21, 16, 16, 8
    args = make_inputs(21, B, S, di, n, 0.5)
    dy, dh = cotangents(22, B, S, di, n)
    got = ref.selective_scan_bwd_ref(*(torch.as_tensor(a) for a in args),
                                     torch.as_tensor(dy), torch.as_tensor(dh),
                                     "bf16", chunk)
    want = jax_grad(lambda *a: jax_ab16_core(*a, chunk), args, (dy, dh))
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert rel_rms(g, w) <= AB16_GRAD_RMS, (name, rel_rms(g, w))


def test_ab16_mamba_mix_gradient_against_jax_grad_of_the_reference():
    """falcon-mamba's reduced ``mamba_mix`` (its first layer's parameters,
    carried across) in the mode at scan_chunk 8, S = 21, a non-zero h0:
    the gradient of <y, dy> + <h_last, dh> in x_in, h0 and every parameter
    the mix reads, against ``jax.vjp`` of the reference's ``mamba_mix``."""
    jcfg, tcfg, params, model = carried("f32", "falcon-mamba-7b")
    rng = np.random.default_rng(15)
    B, S, di, n = 2, 21, tcfg.d_inner, tcfg.ssm_state
    x = (rng.standard_normal((B, S, di)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, di, n)) * 0.5).astype(np.float32)
    dy, dh = cotangents(16, B, S, di, n)
    assert S % JRC.scan_chunk != 0
    jrc = dataclasses.replace(JRC, ssm_dtype="bf16")
    p = jax.tree.map(lambda t: t[0], params["seg0"]["params"]["mamba"])
    jp, jx, jh = jax_grad(lambda p_, x_, h_: jmamba.mamba_mix(
        jcfg, jrc, p_, x_, h_), (p, x, h0), (dy, dh))
    mod = model.segments[0][0].mamba
    mod.requires_grad_(True)
    tx, th = (torch.as_tensor(t).requires_grad_(True) for t in (x, h0))
    y, h = tmamba.mamba_mix(tcfg, dataclasses.replace(RC, ssm_dtype="bf16"),
                            mod, tx, th)
    ((y * torch.as_tensor(dy)).sum()
     + (h * torch.as_tensor(dh)).sum()).backward()
    got = {"x_in": tx.grad, "h0": th.grad,
           **{k: v.grad for k, v in mod.named_parameters()
              if v.grad is not None}}
    want = {"x_in": jx, "h0": jh, **{k: jp[k] for k in got
                                      if k not in ("x_in", "h0")}}
    assert set(got) >= {"x_in", "h0", "A_log", "D", "conv_w", "conv_b",
                        "x_proj", "dt_proj", "dt_bias"}
    for k, g in got.items():
        assert rel_rms(g, want[k]) <= AB16_GRAD_RMS, (k, rel_rms(g, want[k]))


def test_ops_ab16_mode_gradient_is_the_plain_backward():
    """On CPU tensors that need a gradient the mode runs
    ``ops.PlainAB16ScanFn``: the plain forward's values and the plain
    backward's gradients, in the inputs' dtypes (x and dt bfloat16 here);
    no kernel launched.  The float32 mode stays autograd of the plain
    forward."""
    args = [torch.as_tensor(a) for a in make_inputs(12, 2, 13, 5, 4, 0.5)]
    args[0], args[1] = args[0].bfloat16(), args[1].bfloat16()
    dy, dh = (torch.as_tensor(t) for t in cotangents(12, 2, 13, 5, 4))
    leaves = [a.clone().requires_grad_(True) for a in args]
    ops.reset_launches()
    y, h = ops.selective_scan(*leaves, "bf16", 4)
    assert type(y.grad_fn).__name__ == "PlainAB16ScanFnBackward"
    want_y, want_h = ref.selective_scan_ref(*args, "bf16", 4)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    ((y * dy).sum() + (h * dh).sum()).backward()
    want = ref.selective_scan_bwd_ref(*args, dy, dh, "bf16", 4)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, w.to(leaf.dtype))
    y32, _ = ops.selective_scan(*leaves)
    assert "PlainAB16" not in type(y32.grad_fn).__name__
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_scan_fn_backward_hands_the_kernel_its_mode(monkeypatch):
    """``SelectiveScanFn`` keeps the forward's mode and chunk and passes
    them to the backward kernel's dispatcher op (whose kernel runs on the
    card)."""
    seen = []

    def fake_bwd(*a):
        seen.append(a[9:])
        return tuple(torch.zeros_like(t) for t in a[:7])

    monkeypatch.setattr(tms, "scan_bwd_op", fake_bwd)
    ins = tuple(torch.as_tensor(a) for a in make_inputs(3, 1, 5, 4, 2))
    dy, dh = (torch.as_tensor(t) for t in cotangents(3, 1, 5, 4, 2))
    for mode in (("bf16", 7), ("f32", 0)):
        ctx = types.SimpleNamespace(mode=mode, saved_tensors=ins)
        grads = tms.SelectiveScanFn.backward(ctx, dy, dh)
        assert grads[7:] == (None, None) and len(grads) == 9
    assert seen == [("bf16", 7), ("f32", 0)]


@pytest.mark.parametrize("mode", [("f32", 0), ("bf16", 7)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_meta_tensors_reach_the_ops_fakes_alone(xdt, mode):
    """On meta tensors ``ops.selective_scan`` and its gradient go through
    the dispatcher ops ``repro_torch::selective_scan`` and ``_bwd`` to
    their fakes: the plain version's shapes and dtypes on the same inputs
    (the gradients in their inputs' dtypes), no launch, and each op's flop
    formula (``scan_flops``, ``scan_bwd_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    B, S, di, n = 2, 9, 6, 3
    cpu = [torch.as_tensor(a) for a in make_inputs(5, B, S, di, n, 0.7)]
    cpu[0], cpu[1] = cpu[0].to(xdt), cpu[1].to(xdt)
    want = ref.selective_scan_ref(*cpu, *mode)
    meta = [t.to("meta").requires_grad_(True) for t in cpu]
    ops.reset_launches()
    with FlopCounterMode(display=False) as fc:
        y, h = ops.selective_scan(*meta, *mode)
        (y.sum() + h.sum()).backward()
    for got, w in zip((y, h), want):
        assert got.is_meta and got.shape == w.shape and got.dtype == w.dtype
    for t in meta:
        assert t.grad.is_meta and t.grad.shape == t.shape
        assert t.grad.dtype == t.dtype
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts == {"repro_torch.selective_scan":
                      tms.scan_flops(B, S, di, n),
                      "repro_torch.selective_scan_bwd":
                      tms.scan_bwd_flops(B, S, di, n)}
    assert tms.scan_flops(B, S, di, n) == 2 * (2 * B * S * di * n + B * S * di)


def test_the_scan_ops_have_no_cpu_kernel():
    """A CPU tensor never reaches the ops (``ops.selective_scan`` sends it
    to the plain version); given one, the dispatcher refuses."""
    ins = [torch.as_tensor(a) for a in make_inputs(1, 1, 4, 2, 2)]
    with pytest.raises(NotImplementedError, match="CPU"):
        tms.scan_op(*ins, "f32", 0)
