"""What the port's CUDA kernels compute, held here without a GPU.

``modmatmul``: the launch plan (rows per thread, columns per thread, K
split, blocks) that the wrapper computes in Python, and an exact
Python-int model of the kernel's arithmetic (uint64 sums folded every L
products, Barrett's reduction per output, K-slices summed) against
(a @ b) mod p.  ``selective_scan``: bf16 dt read as such equals its float32
widening, and the kernel's exp2 form of the recurrence in float32 stays
within 1e-5 of the reference's oracle.  The kernels themselves are held
against their plain versions on the GPU by chip_smoke.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import exact_modmatmul  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.kernels import mamba_scan as jms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import modmatmul as tmm  # noqa: E402

PRIMES = [jf.P, jf.P30]
U64 = 1 << 64

# modmatmul on the main paths: Case 1's dataset encode, weight encodes
# (c = 1, r = 1 and c = 10, r = 2) and decodes (c = 1 and 10); the coded
# head's per-shard product and its encode.
MAIN_SHAPES = {
    "dataset_encode": (40, 14, -(-12396 // 13) * 1568),   # m/K rows x d
    "weight_encode_c1r1": (40, 14, 1568),
    "weight_encode_c10r2": (40, 14, 1568 * 20),
    "decode_c1": (13, 40, 1568),
    "decode_c10": (13, 40, 1568 * 10),
    "coded_head_shard": (4, 4096, 16256),
    "coded_head_encode": (6, 5, 4096 * 16256),
}
EDGE_SHAPES = [(1, 1, 1), (1, 4096, 1), (4, 4096, 255), (17, 129, 65),
               (257, 129, 65), (5, 33, 257), (3, 7, 1000003), (16, 64, 4096),
               (40, 153651, 257)]


def check_plan_invariants(pl: tmm.Plan) -> None:
    M, K, N = pl.M, pl.K, pl.N
    assert pl.rows in tmm.ROW_TILES
    # the row template never exceeds M's next power of two, and the last
    # group pads fewer rows than one template
    assert pl.rows <= 1 << (M - 1).bit_length()
    assert pl.groups * pl.rows - M < pl.rows
    assert pl.cols in (1, 4) and (pl.cols == 1 or (N % 4 == 0 and pl.rows <= 8))
    assert 32 <= pl.threads <= tmm.MAX_THREADS and pl.threads % 32 == 0
    assert pl.splits >= 1 and pl.slice >= 1
    assert pl.slice * (pl.splits - 1) < K <= pl.slice * pl.splits
    assert pl.splits == 1 or pl.slice >= tmm.MIN_SLICE
    assert pl.blocks < 2 ** 31


@pytest.mark.parametrize("name", sorted(MAIN_SHAPES))
def test_main_path_plan_fills_the_card_or_splits_k(name):
    pl = tmm.plan(*MAIN_SHAPES[name])
    check_plan_invariants(pl)
    assert pl.blocks >= tmm.SMS or pl.splits > 1, pl


@pytest.mark.parametrize("name", sorted(MAIN_SHAPES))
@pytest.mark.parametrize("sms", [66, 114])
def test_plan_fills_a_card_of_fewer_sms(name, sms):
    """The plan follows the card's SM count (an H100 PCIe has 114): every
    main-path shape still fills it or splits K, and a split aims at that
    card's threads, not at 132 SMs'."""
    pl = tmm.plan(*MAIN_SHAPES[name], sms=sms)
    check_plan_invariants(pl)
    assert pl.blocks >= sms or pl.splits > 1, pl
    if pl.splits > 1:
        threads = pl.groups * -(-pl.N // pl.cols) * pl.splits
        assert threads >= sms * tmm.THREADS_PER_SM
        assert pl.splits <= tmm.plan(*MAIN_SHAPES[name]).splits


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_edge_plan_invariants(shape):
    for vec in (True, False):
        pl = tmm.plan(*shape, vec=vec)
        check_plan_invariants(pl)
        assert vec or pl.cols == 1


def test_plan_at_the_coded_head_and_case1():
    """The shapes the design was cut for: the head encode's 6 rows take one
    template of 8 (not 16) with 4 columns a thread; the shard's 16,256
    columns split K; the dataset encode's 40 rows take five groups of 8."""
    enc = tmm.plan(*MAIN_SHAPES["coded_head_encode"])
    assert (enc.rows, enc.cols, enc.splits) == (8, 4, 1)
    shard = tmm.plan(*MAIN_SHAPES["coded_head_shard"])
    assert shard.rows == 4 and shard.splits > 1
    assert shard.groups * -(-16256 // shard.cols) * shard.splits \
        >= tmm.SMS * tmm.THREADS_PER_SM
    ds = tmm.plan(*MAIN_SHAPES["dataset_encode"])
    assert (ds.rows, ds.groups, ds.splits) == (8, 5, 1)


def test_fold_every_bound():
    """L is the largest n with (2^32-1)(c+1) + n (p-1)^2 < 2^64."""
    assert build.fold_every(jf.P) == 76825
    assert build.fold_every(jf.P30) == 16
    for p in PRIMES:
        L, c = build.fold_every(p), (1 << 32) % p
        assert (2 ** 32 - 1) * (c + 1) + L * (p - 1) ** 2 < U64
        assert (2 ** 32 - 1) * (c + 1) + (L + 1) * (p - 1) ** 2 >= U64
    with pytest.raises(ValueError):
        build.fold_every(1 << 30)


def fp_fold(acc: int, c: int) -> int:
    return (acc >> 32) * c + (acc & 0xFFFFFFFF)


def fp_reduce(x: int, p: int) -> int:
    """field.cuh's Barrett reduction, with its 32-bit wrap."""
    assert 0 <= x < U64
    q = (x * (U64 // p)) >> 64
    r = (x - q * p) & 0xFFFFFFFF
    assert x - q * p == r < 2 * p
    return r - p if r >= p else r


def kernel_model(a: np.ndarray, b: np.ndarray, p: int, pl: tmm.Plan,
                 fold_every: int) -> np.ndarray:
    """modmatmul.cu's arithmetic in Python ints: per K-slice, uint64 sums
    folded every ``fold_every`` products (the sum only grows between folds,
    so its bound is checked just before each fold and at the end), reduced
    by Barrett; then the slices' residues summed and reduced."""
    ao, bo = a.astype(object), b.astype(object)
    K = a.shape[1]
    c = (1 << 32) % p
    slices = []
    for s in range(pl.splits):
        acc = np.zeros((a.shape[0], b.shape[1]), dtype=object)
        k = s * pl.slice
        k_end = min(K, k + pl.slice)
        while k < k_end:
            k1 = min(k_end, k + fold_every)
            acc = acc + ao[:, k:k1] @ bo[k:k1]
            assert max(acc.flat) < U64
            if k1 - k == fold_every:
                acc = np.vectorize(lambda v: fp_fold(v, c), otypes=[object])(acc)
            k = k1
        slices.append(np.vectorize(lambda v: fp_reduce(v, p),
                                   otypes=[object])(acc))
    total = sum(slices)
    return np.vectorize(lambda v: fp_reduce(v, p), otypes=[object])(total)


def test_barrett_reduce_matches_mod():
    rng = np.random.default_rng(11)
    for p in PRIMES:
        xs = [0, 1, p - 1, p, 2 * p - 1, U64 - 1, U64 - p, (p - 1) ** 2,
              (2 ** 32 - 1) * ((1 << 32) % p + 1)]
        xs += [int(v) for v in rng.integers(0, 2 ** 63, 200, dtype=np.int64)]
        xs += [(int(v) << 1) | 1 for v in rng.integers(0, 2 ** 63, 200,
                                                        dtype=np.int64)]
        for x in xs:
            assert fp_reduce(x, p) == x % p


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("extra", [0, 1, "2L+1"])
@pytest.mark.parametrize("inputs", ["p_minus_1", "random"])
def test_fold_model_at_the_fold_interval(p, extra, inputs):
    """K = L, L+1, 2L+1: the model of the kernel, with the plan's K-slices
    and with one slice that folds at every interval, equals (a @ b) mod p."""
    L = build.fold_every(p)
    K = 2 * L + 1 if extra == "2L+1" else L + extra
    M, N = 2, 3
    if inputs == "p_minus_1":
        a = np.full((M, K), p - 1, np.int64)
        b = np.full((K, N), p - 1, np.int64)
    else:
        rng = np.random.default_rng(K)
        a = rng.integers(0, p, (M, K))
        b = rng.integers(0, p, (K, N))
    want = exact_modmatmul(a, b, p)
    natural = tmm.plan(M, K, N)
    one_slice = tmm.Plan(M, K, N, natural.rows, 1, 32, 1, K)
    for pl in (natural, one_slice):
        got = kernel_model(a, b, p, pl, L)
        assert (got == want).all(), pl


def test_fold_model_catches_a_late_fold():
    """The model is tight: folding one product later than L overflows."""
    p = jf.P30
    L = build.fold_every(p)
    K = 2 * L + 2
    a = np.full((1, K), p - 1, np.int64)
    b = np.full((K, 1), p - 1, np.int64)
    with pytest.raises(AssertionError):
        kernel_model(a, b, p, tmm.Plan(1, K, 1, 1, 1, 32, 1, K), L + 1)


# -- selective scan -------------------------------------------------------

def scan_inputs(seed, B, S, di, n, h0_scale=0.5):
    """The reference kernel test's distributions, drawn with numpy."""
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


@pytest.mark.parametrize("x_bf16", [False, True])
def test_plain_scan_reads_bf16_dt_as_its_float32_widening(x_bf16):
    """The serve path hands the scan its bf16 dt: widening to float32 is
    exact, so the plain version gives the same bits either way."""
    args = [torch.as_tensor(a) for a in scan_inputs(3, 2, 37, 24, 16)]
    if x_bf16:
        args[0] = args[0].to(torch.bfloat16)
    dt16 = args[1].to(torch.bfloat16)
    y16, h16 = ref.selective_scan_ref(args[0], dt16, *args[2:])
    y32, h32 = ref.selective_scan_ref(args[0], dt16.float(), *args[2:])
    assert torch.equal(y16, y32) and torch.equal(h16, h32)


def exp2_scan(x, dt, bm, cm, a_log, d, h0):
    """The kernel's recurrence in float32: A2 = -exp(A_log) log2 e once,
    then exp2(dt A2) per step, y_t = D x_t + sum_j h_j C_j."""
    A2 = -torch.exp(a_log) * math.log2(math.e)
    h = h0.clone()
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t = x[:, t].float(), dt[:, t].float()
        a_t = torch.exp2(dt_t[:, :, None] * A2[None])
        h = a_t * h + (dt_t * x_t)[:, :, None] * bm[:, t, None, :]
        ys.append(d * x_t + (h * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("B,S,di,n,h0_scale", [(1, 16, 8, 4, 0.0),
                                               (2, 64, 32, 16, 0.7),
                                               (2, 33, 24, 3, 0.7),
                                               (1, 200, 16, 1, 0.0)])
def test_exp2_form_within_1e5_of_reference_oracle(B, S, di, n, h0_scale):
    args = scan_inputs(B + S + di + n, B, S, di, n, h0_scale)
    y, h = exp2_scan(*(torch.as_tensor(a) for a in args))
    y_ref, h_ref = jms.ref_selective_scan(*(jnp.asarray(a) for a in args))
    assert float(np.abs(y.numpy() - np.asarray(y_ref)).max()) < 1e-5
    assert float(np.abs(h.numpy() - np.asarray(h_ref)).max()) < 1e-5


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("n,x_dtype,dt_dtype", [
    (1, BF16, BF16), (3, F32, BF16), (4, BF16, F32), (5, F32, F32),
    (8, BF16, BF16), (9, F32, BF16), (16, BF16, F32), (16, BF16, BF16)])
def test_scan_operands_pad_to_16_states_and_one_dtype(n, x_dtype, dt_dtype):
    """What the wrapper hands the kernel: x and dt in one dtype (bf16 only
    when both are; a widening is exact), and Bm, Cm packed into 16 float32
    states with zeros past n, from slices of one projection."""
    gen = torch.Generator().manual_seed(n)
    B, S, di = 2, 5, 24
    x = torch.randn((B, S, di), generator=gen).to(x_dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen)).to(dt_dtype)
    proj = torch.randn((B, S, 2 * n + 3), generator=gen)
    bm, cm = proj[..., 3:3 + n], proj[..., 3 + n:]
    xk, dtk, bc = tms.operands(x, dt, bm, cm)
    want = BF16 if x_dtype == dt_dtype == BF16 else F32
    assert xk.dtype == dtk.dtype == want
    assert xk.is_contiguous() and dtk.is_contiguous()
    assert torch.equal(xk.float(), x.float())
    assert torch.equal(dtk.float(), dt.float())
    assert bc.shape == (B, S, 2, tms.MAX_STATE) and bc.dtype == F32
    assert bc.is_contiguous()
    assert torch.equal(bc[:, :, 0, :n], bm) and torch.equal(bc[:, :, 1, :n], cm)
    assert not bc[..., n:].any()


def test_mamba_mix_hands_the_scan_its_bf16_dt(monkeypatch):
    """The serve path's call site: in bf16, ``mamba_mix`` passes dt (and
    Bm, Cm) to the scan uncast, and its output equals the float32-dt
    path's bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import mamba
    from repro_torch.models import model as TM

    cfg = registry.reduced_config(registry.get_config("falcon-mamba-7b"))
    model = TM.Model(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    p = model.segments[0][0].mamba
    gen = torch.Generator().manual_seed(0)
    x_in = torch.randn((2, 9, cfg.d_inner), generator=gen).to(torch.bfloat16)
    seen = []
    scan = ops.selective_scan

    def spy(x, dt, bm, cm, *rest):
        seen.append((x.dtype, dt.dtype, bm.dtype, cm.dtype))
        return scan(x, dt, bm, cm, *rest)

    monkeypatch.setattr(ops, "selective_scan", spy)
    with torch.inference_mode():
        y, h = mamba.mamba_mix(cfg, RunConfig(), p, x_in)
    assert seen[0] == (torch.bfloat16,) * 4
    monkeypatch.setattr(ops, "selective_scan",
                        lambda x, dt, bm, cm, *rest: scan(
                            x, dt.float(), bm.float(), cm.float(), *rest))
    with torch.inference_mode():
        y32, h32 = mamba.mamba_mix(cfg, RunConfig(), p, x_in)
    assert torch.equal(y, y32) and torch.equal(h, h32)


# -- the scan's backward: csrc/mamba_scan_bwd.cu's chunked decomposition --
#    (summaries per chunk, the two carries, each chunk's reverse walk) and
#    its launch plan.  Tolerance: each gradient within 1e-5 of its largest
#    magnitude, as tests/test_torch_mamba_scan.py holds the plain backward
#    (float32 sums over channels, batch and time in another order).

import functools  # noqa: E402

import jax  # noqa: E402

GRAD_REL = 1e-5
LOG2E = math.log2(math.e)


def _ftz(t):
    """ex2.approx.ftz's flush of subnormal float32 results to zero."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(t), t)


def chunked_bwd_model(x, dt, bm, cm, a_log, d, h0, dy, dh_last, L, exp2,
                      wrong_carry=False):
    """The kernel's three steps in the inputs' dtype, chunks of L steps.

    1. Each chunk from zero: hloc (its forward from h = 0), gamma = sum_t
       P_t dy_t C_t with P_t = a_f ... a_t, and D = sum_t dt_t.
    2. The carries: H_0 = h0, H_{c+1} = P_c H_c + hloc_c; Gamma_last =
       dh_last, Gamma_{c-1} = gamma_c + P_c Gamma_c, P_c = exp(D_c A)
       (``wrong_carry``: without its P_c).
    3. Each chunk's reverse recurrence from (H_c, Gamma_c).
    ``exp2``: a_t = exp2(dt log2e A) and P_c = exp2(D_c log2e A), subnormal
    results flushed to zero, as the kernel's ex2.approx.ftz; else exp.
    Returns the gradients as ``ref.selective_scan_bwd_ref`` orders them,
    and whether some P_t underflowed to 0 inside a chunk.
    """
    B, S, di = x.shape
    A = -torch.exp(a_log)

    def decay(z):  # exp(z A) for z (B, di) -> (B, di, n)
        if exp2:
            return _ftz(torch.exp2((z * LOG2E)[..., None] * A))
        return torch.exp(z[..., None] * A)

    u = dt * x
    spans = [range(f, min(f + L, S)) for f in range(0, S, L)]
    hloc, gam, dsum, p_zero = [], [], [], False
    for span in spans:
        h, g, P = torch.zeros_like(h0), torch.zeros_like(h0), torch.ones_like(h0)
        D = torch.zeros_like(x[:, 0])
        for t in span:
            a = decay(dt[:, t])
            P = P * a
            h = a * h + u[:, t, :, None] * bm[:, t, None, :]
            g = g + P * (dy[:, t, :, None] * cm[:, t, None, :])
            D = D + dt[:, t]
            p_zero |= t > span[0] and bool((P == 0).any())
        hloc.append(h)
        gam.append(g)
        dsum.append(D)
    Pc = [decay(D) for D in dsum]
    H = [h0]
    for c in range(len(spans) - 1):
        H.append(Pc[c] * H[c] + hloc[c])
    G = [dh_last] * len(spans)
    for c in range(len(spans) - 1, 0, -1):
        G[c - 1] = gam[c] + (G[c] if wrong_carry else Pc[c] * G[c])
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    dA = torch.zeros_like(h0)
    for c, span in enumerate(spans):
        hs = [H[c]]
        for t in span:
            hs.append(decay(dt[:, t]) * hs[-1]
                      + u[:, t, :, None] * bm[:, t, None, :])
        g = G[c]
        for k in reversed(range(len(span))):
            t = span[k]
            a = decay(dt[:, t])
            g = g + dy[:, t, :, None] * cm[:, t, None, :]
            dcm[:, t] = (dy[:, t, :, None] * hs[k + 1]).sum(1)
            dbm[:, t] = (g * u[:, t, :, None]).sum(1)
            gb = (g * bm[:, t, None, :]).sum(-1)
            gha = g * hs[k] * a
            dx[:, t] = gb * dt[:, t] + d * dy[:, t]
            ddt[:, t] = gb * x[:, t] + (gha * A).sum(-1)
            dA = dA + gha * dt[:, t, :, None]
            g = a * g
        if c == 0:
            dh0 = g
    grads = (dx, ddt, dbm, dcm, dA.sum(0) * A, (dy * x).sum((0, 1)), dh0)
    return grads, p_zero


def bwd_case(S, n, big_a=False):
    """Inputs (numpy float32) of a backward case: the forward's, h0 and the
    cotangents dy, dh_last non-zero; ``big_a``: A = -exp(A_log) in
    [-12, -8], so that products of a_t underflow within 16 steps."""
    rng = np.random.default_rng(1000 * S + n + big_a)
    args = list(scan_inputs(int(rng.integers(1 << 30)), 2, S, 5, n, 0.7))
    if big_a:
        args[4] = np.log(rng.uniform(8.0, 12.0, (5, n))).astype(np.float32)
    dy = rng.standard_normal((2, S, 5)).astype(np.float32)
    dh = rng.standard_normal((2, 5, n)).astype(np.float32)
    return (*args, dy, dh)


@functools.lru_cache(maxsize=None)
def jax_bwd(S, n, big_a=False):
    """``jax.vjp`` of the reference's oracle scan at ``bwd_case``."""
    *args, dy, dh = bwd_case(S, n, big_a)
    _, vjp = jax.vjp(jms.ref_selective_scan, *(jnp.asarray(a) for a in args))
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(dy),
                                             jnp.asarray(dh))))


def bwd_rel_errs(got, want):
    """max |got - want| over max |want|, per gradient."""
    out = []
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        out.append(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30))
    return out


def run_bwd_model(S, n, L, mode, big_a=False, wrong_carry=False):
    dtype = torch.float64 if mode == "f64" else torch.float32
    ins = [torch.as_tensor(a).to(dtype) for a in bwd_case(S, n, big_a)]
    got, p_zero = chunked_bwd_model(*ins, L, mode == "f32_exp2", wrong_carry)
    return got, ref.selective_scan_bwd_ref(*ins), jax_bwd(S, n, big_a), p_zero


BWD_CASES = sorted({(L, S) for L in (1, 7, 16)
                    for S in (1, L - 1, L, L + 1, 3 * L + 5) if S >= 1})


@pytest.mark.parametrize("L,S", BWD_CASES)
@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("mode", ["f64", "f32_exp2"])
def test_chunked_backward_model_matches_reference_and_jax(L, S, n, mode):
    """One chunk (S <= L), a ragged last chunk of one step (S = L + 1) and
    several chunks; h0 and dh_last non-zero."""
    got, want, jgrads, _ = run_bwd_model(S, n, L, mode)
    for g in got:
        assert g.dtype == (torch.float64 if mode == "f64" else torch.float32)
    assert max(bwd_rel_errs(got, want)) <= GRAD_REL
    assert max(bwd_rel_errs(got, jgrads)) <= GRAD_REL


def test_chunked_backward_model_where_products_underflow():
    """A = -exp(A_log) in [-12, -8]: within a chunk of 16 steps the running
    product P_t underflows to 0 (flushed, as ex2.approx.ftz flushes); the
    terms it multiplies are below float32's range, so the gradients still
    match."""
    got, want, jgrads, p_zero = run_bwd_model(53, 16, 16, "f32_exp2",
                                              big_a=True)
    assert p_zero
    assert max(bwd_rel_errs(got, want)) <= GRAD_REL
    assert max(bwd_rel_errs(got, jgrads)) <= GRAD_REL


def test_chunked_backward_model_catches_a_wrong_carry():
    """Gamma carried without its P_c factor: the gradients of every chunk
    but the last are wrong, far beyond the tolerance."""
    got, want, _, _ = run_bwd_model(26, 16, 7, "f64", wrong_carry=True)
    assert max(bwd_rel_errs(got, want)) > 100 * GRAD_REL


# -- the bf16 a/b mode's backward: csrc/mamba_scan_bwd.cu's kAB16 path.
#    Its chunks are the mode's (RunConfig.scan_chunk), each split into plan
#    chunks of L steps where it is longer (summaries walk a mode chunk in
#    order; the carries chain mode chunks, and plan chunks inside one).
#    Tolerance: each gradient within 1e-5 of its largest magnitude, as above
#    (float32 sums in another order; the roundings to bf16 are the same
#    operations on the same values).

def _bf(t):
    """t rounded to bf16 (to nearest even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def chunked_bwd_ab16_model(x, dt, bm, cm, a_log, d, h0, dy, dh_last, M, L,
                           wrong_carry=False):
    """The kernel's three steps in the bf16 a/b mode, float32: mode chunks
    of M steps (at most S), each cut into plan chunks of L steps (L = M
    where M <= L).

    1. Each mode chunk's forward from A_c = 1, B_c = 0, in order: A_c and
       B_c at its last step, gamma_c = sum_t A_c,t dy_t C_t; per plan chunk
       s, (A_c, B_c) entering it, P_s (its product of the rounded a_t) and
       gamma'_s = sum_t P_s,t dy_t C_t.
    2. The carries: H_0 = h0, H_{c+1} = A_c,last H_c + B_c,last; Gamma_last
       = dh_last, Gamma_{c-1} = gamma_c + A_c,last Gamma_c (``wrong_carry``:
       P_c, the product of the rounded a_t, in place of A_c,last: what the
       float32 mode's carry would take), dh0 = Gamma_{-1}; inside a mode
       chunk from its last plan chunk, G = Gamma_c, G <- gamma'_s + P_s G.
    3. Each plan chunk's reverse walk from (H_c, its (A_c, B_c), its G).
    """
    B, S, di = x.shape
    M = min(M, S)
    L = min(L, M)
    A = -torch.exp(a_log)
    dyc = dy[..., None] * cm[:, :, None, :]                   # (B, S, di, n)

    def step(t, Ac, Bc):
        e = torch.exp(dt[:, t, :, None] * A)
        a = _bf(e)
        b = _bf(dt[:, t, :, None] * bm[:, t, None, :] * x[:, t, :, None])
        return e, a, _bf(a * Ac), _bf(_bf(a * Bc) + b)

    mode_chunks = [range(f, min(f + M, S)) for f in range(0, S, M)]
    segs = [[span[k:k + L] for k in range(0, len(span), L)]
            for span in mode_chunks]
    one, zero = torch.ones_like(h0), torch.zeros_like(h0)
    acar, bcar, gam, seg_ab, seg_p, seg_g = [], [], [], {}, {}, {}
    for c, span in enumerate(mode_chunks):
        Ac, Bc, gm = one, zero, zero
        for p, seg in enumerate(segs[c]):
            seg_ab[c, p] = (Ac, Bc)
            P, gs = one, zero
            for t in seg:
                _, a, Ac, Bc = step(t, Ac, Bc)
                P = P * a
                gs = gs + P * dyc[:, t]
                gm = gm + Ac * dyc[:, t]
            seg_p[c, p], seg_g[c, p] = P, gs
        acar.append(Ac)
        bcar.append(Bc)
        gam.append(gm)
    H = [h0]
    for c in range(len(mode_chunks) - 1):
        H.append(acar[c] * H[c] + bcar[c])
    G, gseg = dh_last, {}
    for c in reversed(range(len(mode_chunks))):
        Gs, Pc = G, one
        for p in reversed(range(len(segs[c]))):
            gseg[c, p] = Gs
            Gs = seg_g[c, p] + seg_p[c, p] * Gs
            Pc = Pc * seg_p[c, p]
        G = gam[c] + (Pc if wrong_carry else acar[c]) * G
    dh0 = G
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    dA = torch.zeros_like(h0)
    u = dt * x
    for c in range(len(mode_chunks)):
        for p, seg in enumerate(segs[c]):
            Ac, Bc = seg_ab[c, p]
            hs = [Ac * H[c] + Bc]
            for t in seg:
                _, _, Ac, Bc = step(t, Ac, Bc)
                hs.append(Ac * H[c] + Bc)
            g = gseg[c, p]
            for k in reversed(range(len(seg))):
                t = seg[k]
                e, a, _, _ = step(t, one, zero)
                g = g + dyc[:, t]
                dcm[:, t] = (dy[:, t, :, None] * hs[k + 1]).sum(1)
                dbm[:, t] = (g * u[:, t, :, None]).sum(1)
                gb = (g * bm[:, t, None, :]).sum(-1)
                gha = g * hs[k] * e
                dx[:, t] = gb * dt[:, t] + d * dy[:, t]
                ddt[:, t] = gb * x[:, t] + (gha * A).sum(-1)
                dA = dA + gha * dt[:, t, :, None]
                g = a * g
    return dx, ddt, dbm, dcm, dA.sum(0) * A, (dy * x).sum((0, 1)), dh0


def run_ab16_model(S, n, M, L, wrong_carry=False):
    ins = [torch.as_tensor(a) for a in bwd_case(S, n)]
    got = chunked_bwd_ab16_model(*ins, M, L, wrong_carry)
    return got, ref.selective_scan_bwd_ref(*ins, "bf16", M)


AB16_BWD_CASES = [(M, L, S) for M, L in ((1, 8), (3, 8), (8, 8), (8, 64),
                                         (7, 7), (20, 8), (37, 16))
                  for S in (1, M, M + 1, 3 * M + 5)]


@pytest.mark.parametrize("M,L,S", AB16_BWD_CASES)
def test_ab16_chunked_backward_model_matches_the_plain_backward(M, L, S):
    """One plan chunk a mode chunk (M <= L: chunks of 1, 3, 7, 8 steps),
    mode chunks cut into plan chunks of L (M = 20 and 37: 8- and 16-step
    plan chunks with a ragged last), one mode chunk (S <= M), a ragged last
    mode chunk of one step, several; h0 and dh_last non-zero."""
    for n in (1, 16):
        got, want = run_ab16_model(S, n, M, L)
        assert max(bwd_rel_errs(got, want)) <= GRAD_REL, (M, L, S, n)


def test_ab16_chunked_backward_model_catches_a_wrong_carry():
    """The carry across a mode chunk's start through P_c (the product of
    the rounded a_t, which the float32 mode's carry would take) in place
    of the chunk's own rounded A_c,last: beyond the tolerance."""
    got, want = run_ab16_model(40, 16, 9, 8, wrong_carry=True)
    assert max(bwd_rel_errs(got, want)) > 10 * GRAD_REL


BWD_PLAN_SHAPES = {
    "hymba_train": (4, 2048, 3200, 16),
    "falcon_train": (4, 2048, 8192, 16),
    "S1": (4, 1, 8192, 16),
    "long_S8192": (1, 8192, 8192, 16),
    "di1001_n3": (2, 45, 1001, 3),
}


@pytest.mark.parametrize("name", sorted(BWD_PLAN_SHAPES))
@pytest.mark.parametrize("xbytes", [2, 4])
def test_backward_plan_grid_and_scratch(name, xbytes):
    """Every grid dimension within the card's limits, the chunk one the C
    entry takes, the grid covering the SMs twice where any chunk can, and
    the scratch the wrapper allocates (``bwd_buffers``) as the kernel's
    source lays it out."""
    B, S, di, _ = BWD_PLAN_SHAPES[name]
    pl = tms.plan_bwd(B, S, di, xbytes)
    assert pl.chunk in tms.BWD_CHUNKS
    assert pl.chunk % tms.BWD_SUB == 0 and pl.chunk <= tms.BWD_MAX_CHUNK
    nck = -(-S // pl.chunk)
    gx, gy, gz = pl.grid
    assert (gx - 1) * tms.BWD_CHANNELS < di <= gx * tms.BWD_CHANNELS
    assert (gy, gz) == (nck, B) and max(gy, gz) <= 65535 and gx < 2 ** 31
    assert pl.threads == gx * gy * gz * tms.BWD_THREADS
    assert (pl.blocks * pl.chunks * B >= 2 * tms.SMS * pl.per_sm
            or pl.chunk == min(tms.BWD_CHUNKS))
    bufs = tms.bwd_buffers(pl, "meta")
    want = {"hcar": (B, nck, di, 16), "gcar": (B, nck, di, 16),
            "dsum": (B, nck, di), "dbc_part": (gx, B, S, 2, 16),
            "da_part": (B, nck, di, 16), "dd_part": (B, nck, di)}
    assert {k: tuple(v.shape) for k, v in bufs.items()} == want
    assert all(v.dtype == torch.float32 for v in bufs.values())
    # the chunk kernel's shared memory: ring, history, warps' sums, checkpoints
    tile = 8 * (32 * 4 + 32 * (2 * xbytes + 4))
    assert pl.smem == 2 * tile + 8 * 128 * 16 + 4 * 8 * 32 * 4 \
        + pl.chunk // 8 * 128 * 16
    assert pl.smem <= 232_448


def test_backward_plan_fills_the_card_at_hymbas_training_shape():
    """At least 8x the 12,800 threads of the single-chunk kernel, and five
    blocks an SM (the kernel's launch bounds) at 64-step chunks."""
    for xbytes in (2, 4):
        pl = tms.plan_bwd(4, 2048, 3200, xbytes)
        assert pl.chunk == 64 and pl.per_sm == 5
        assert pl.threads >= 8 * 12_800
        assert pl.blocks * pl.chunks * 4 >= 2 * tms.SMS * pl.per_sm


def test_backward_plan_forced_chunks_and_refusals():
    pl = tms.plan_bwd(4, 65, 3200, 2, chunk=64)
    assert (pl.chunk, pl.chunks) == (64, 2)
    for bad in (0, 4, 12, tms.BWD_MAX_CHUNK + tms.BWD_SUB):
        with pytest.raises(ValueError, match="multiple of"):
            tms.plan_bwd(4, 65, 3200, 2, chunk=bad)
    with pytest.raises(ValueError, match="chunks"):
        tms.plan_bwd(1, 65536 * 64 + 1, 32, 2)


AB16_PLAN_CASES = {
    # (B, S, di, mode chunk): the training shapes at run_config's 128, the
    # chunks the card's checks take, a chunk of at least S, S = 1
    "hymba_train_128": (4, 2048, 3200, 128),
    "falcon_train_128": (4, 2048, 8192, 128),
    "hymba_100": (4, 2048, 3200, 100),
    "hymba_300": (4, 2048, 3200, 300),
    "chunk1": (2, 512, 3200, 1),
    "chunk7": (2, 45, 1000, 7),
    "chunk_ge_S": (2, 300, 3200, 4096),
    "S1": (4, 1, 8192, 128),
    "chunk1_long": (1, 70_000, 32, 1),
}


@pytest.mark.parametrize("name", sorted(AB16_PLAN_CASES))
@pytest.mark.parametrize("xbytes", [2, 4])
def test_ab16_backward_plan_grid_and_scratch(name, xbytes):
    """The bf16 a/b mode's plan: a plan chunk never spans two of the mode's
    chunks (M = min(chunk, S)): one plan chunk a mode chunk where M is at
    most the plan's L (of any length, 1 included), else ceil(M / L) of them
    with L a multiple of BWD_SUB; the grid (blocks * chunks, 1, B) within
    the card's limits whatever S (more than 65535 chunks included); the
    scratch as the kernel's source lays it out; the C entry's refusals
    mirrored (chunk at most BWD_MAX_CHUNK)."""
    B, S, di, chunk = AB16_PLAN_CASES[name]
    M = min(chunk, S)
    pl = tms.plan_bwd(B, S, di, xbytes, ab_chunk=M)
    assert pl.ab_chunk == M and 1 <= pl.chunk <= tms.BWD_MAX_CHUNK
    if M <= pl.chunk or pl.per_ab == 1:
        assert pl.chunk == M and pl.per_ab == 1
    else:
        assert pl.chunk in tms.BWD_CHUNKS and pl.per_ab == -(-M // pl.chunk)
    nab = -(-S // M)
    assert pl.ab_chunks == nab and pl.chunks == nab * pl.per_ab
    gx, gy, gz = pl.grid
    assert (gx, gy, gz) == (pl.blocks * pl.chunks, 1, B) and gx < 2 ** 31
    # every step lies in exactly one plan chunk, inside one mode chunk
    starts = sorted(c * M + p * pl.chunk for c in range(nab)
                    for p in range(pl.per_ab) if c * M + p * pl.chunk < S)
    cover = [t for f in starts
             for t in range(f, min(f + pl.chunk, (f // M + 1) * M, S))]
    assert cover == list(range(S))
    car = (B, nab, di, 16)
    seg = (B, pl.chunks, di, 16)
    want = {"hcar": car, "acar": car, "gcar": car,
            "dbc_part": (pl.blocks, B, S, 2, 16), "da_part": seg,
            "dd_part": (B, pl.chunks, di)}
    if pl.per_ab > 1:
        want.update(abseg=seg, pseg=seg, gseg=seg)
    bufs = tms.bwd_buffers(pl, "meta")
    assert {k: tuple(v.shape) for k, v in bufs.items()} == want
    assert pl.smem == tms.bwd_smem(pl.chunk, xbytes) <= 232_448


def test_ab16_backward_plan_at_the_training_shape():
    """hymba's training shape in chunks of 128: plan chunks of 64 (five
    blocks an SM, as the float32 mode's), two a mode chunk; forced to 128,
    one plan chunk a mode chunk."""
    pl = tms.plan_bwd(4, 2048, 3200, 2, ab_chunk=128)
    assert (pl.chunk, pl.per_ab, pl.chunks, pl.per_sm) == (64, 2, 32, 5)
    pl = tms.plan_bwd(4, 2048, 3200, 2, chunk=128, ab_chunk=128)
    assert (pl.chunk, pl.per_ab, pl.chunks) == (128, 1, 16)


def test_ab16_backward_plan_forced_chunks_and_refusals():
    """A forced plan chunk: a multiple of BWD_SUB up to BWD_MAX_CHUNK, or one
    of at least the mode's chunk (then the mode's chunk itself)."""
    assert tms.plan_bwd(2, 45, 1000, 2, chunk=12, ab_chunk=7).chunk == 7
    assert tms.plan_bwd(2, 300, 32, 2, chunk=8, ab_chunk=300).per_ab == 38
    for bad in (0, 4, 12, tms.BWD_MAX_CHUNK + tms.BWD_SUB):
        with pytest.raises(ValueError, match="multiple of"):
            tms.plan_bwd(2, 300, 32, 2, chunk=bad, ab_chunk=20)


# -- coded_grad -----------------------------------------------------------

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import coded_grad as tcg  # noqa: E402

N1, MK1, D1 = 40, -(-12396 // 13), 1568    # Case 1's worker step
CG_SHAPES = {
    "case1_c1_r1": (N1, MK1, D1, 1, 1),
    "case1_c10_r2": (N1, MK1, D1, 10, 2),
    "case1_c33_r1": (N1, MK1, D1, 33, 1),
    "case1_c5_r7": (N1, MK1, D1, 5, 7),
    "small_c17_r2": (8, 131, 97, 17, 2),
    "tiny_c1_r33": (3, 9, 21, 1, 33),
    "one_row_one_column": (2, 1, 1, 1, 1),
    "cli_c33_defaults": (8, 1000, 128, 33, 1),
    "wide_d8192_c10_r2": (40, 300, 8192, 10, 2),
    "reread_d60000": (2, 5, 60000, 2, 1),
    "many_workers": (4000, 7, 33, 2, 2),
}


def check_cg_plan(pl: tcg.Plan, sms: int) -> None:
    assert pl.smem == tcg.smem_bytes(pl.d, pl.c, pl.r, pl.rows, pl.stages,
                                     pl.group, pl.chunk, pl.threads,
                                     pl.part_smem)
    assert pl.smem <= tcg.SMEM_OPTIN
    # head groups: whole heads, each head exactly once, at most GROUP_COLS
    # Z columns unless one head alone is wider
    assert [h for g in pl.head_groups for h in g] == list(range(pl.c))
    assert all(len(g) * pl.r <= tcg.GROUP_COLS or len(g) == 1
               for g in pl.head_groups)
    assert pl.chunk in tcg.CHUNKS and pl.chunk <= 32
    assert pl.chunk == tcg.chunk_for(pl.group, pl.r)
    assert 1 <= pl.rows <= min(tcg.TILE_ROWS, pl.mk)
    assert pl.stages in (0, 1, 2)
    # the re-read route only where not even one row can be staged
    assert (pl.stages == 0) == (4 * pl.d + 16 > tcg.SMEM_OPTIN)
    assert 32 <= pl.threads <= tcg.THREADS and pl.threads % 32 == 0
    assert pl.threads <= 32 * -(-pl.d // 32)
    # splits x tiles cover mk, no split is empty
    assert pl.tiles_per * (pl.splits - 1) < pl.tiles <= pl.tiles_per * pl.splits
    assert pl.tiles_per * pl.rows * (pl.splits - 1) < pl.mk
    assert 1 <= pl.splits <= 65535 and pl.N <= 65535
    # one wave: never more blocks than the card holds at once, unless the
    # workers alone are more
    assert pl.blocks <= max(pl.N, sms * tcg.blocks_per_sm(pl.smem, pl.threads))


@pytest.mark.parametrize("name", sorted(CG_SHAPES))
@pytest.mark.parametrize("sms", [132, 114, 66])
def test_coded_grad_plan_invariants(name, sms):
    check_cg_plan(tcg.plan(*CG_SHAPES[name], sms=sms), sms)


@pytest.mark.parametrize("sms", [132, 114])
def test_coded_grad_plan_fills_the_card_at_case1(sms):
    """Case 1 (c = 1): two 8-row stages and the residues in shared memory,
    two blocks an SM, and enough splits per worker that every SM holds a
    block (an H100 SXM has 132 SMs, an H100 PCIe 114)."""
    pl = tcg.plan(*CG_SHAPES["case1_c1_r1"], sms=sms)
    assert (pl.rows, pl.stages, pl.part_smem) == (8, 2, True)
    assert tcg.blocks_per_sm(pl.smem, pl.threads) == 2
    assert sms <= pl.blocks <= 2 * sms
    assert pl.blocks > 2 * sms - N1    # one more split would not fit


def test_coded_grad_plan_many_heads_keep_residues_in_global_memory():
    """At 33 heads d x c residues (207 KB) do not fit beside the ring: the
    block keeps them in its slot, and the tile stays 8 rows x 2 stages."""
    pl = tcg.plan(*CG_SHAPES["case1_c33_r1"])
    assert not pl.part_smem and (pl.rows, pl.stages) == (8, 2)
    assert [len(g) for g in pl.head_groups] == [32, 1]


def fp_reduce_all(a, p):
    return np.vectorize(lambda v: fp_reduce(int(v), p), otypes=[object])(a)


def coded_grad_model(x, w, cbar, p, pl: tcg.Plan, fold_every: int):
    """coded_grad.cu's arithmetic in Python ints, worker by worker: each
    block's tiles; per head group, step 1 as each thread sums its columns
    k ≡ t (mod threads) in uint64, folded every ``fold_every`` products,
    then adds the threads' sums (raw where ``raw_sums``, else Barrett
    residues) and reduces; step 2's heads with
    Barrett products; step 3 adding ROW_BLOCK rows of products to each
    residue before a Barrett; then the splits' residues summed and reduced.
    Every uint64 is checked below 2^64 where it is largest."""
    N, mk, d = x.shape
    c, r = w.shape[2:]
    c32 = (1 << 32) % p
    fold = np.vectorize(lambda v: fp_fold(v, c32), otypes=[object])
    cb = [int(v) for v in cbar]
    raw = tcg.raw_sums(d, p) and fold_every == build.fold_every(p)
    out = np.zeros((N, d, c), dtype=object)
    for n in range(N):
        xo = x[n].astype(object)
        wo = w[n].reshape(d, c * r).astype(object)
        slots = []
        for s in range(pl.splits):
            part = np.zeros((d, c), dtype=object)
            for t in range(s * pl.tiles_per,
                           min(pl.tiles, (s + 1) * pl.tiles_per)):
                xt = xo[t * pl.rows:(t + 1) * pl.rows]
                for g in pl.head_groups:
                    cols = slice(g.start * r, g.stop * r)
                    z = np.zeros((len(xt), len(g) * r), dtype=object)
                    for k0 in range(min(pl.threads, d)):
                        ks = np.arange(k0, d, pl.threads)
                        acc = np.zeros_like(z)
                        for q in range(0, len(ks), fold_every):
                            if q:
                                acc = fold(acc)
                            kk = ks[q:q + fold_every]
                            acc = acc + xt[:, kk] @ wo[kk, cols]
                            assert max(acc.flat) < U64
                        # raw: the threads' uint64 sums add unreduced
                        z = z + (acc if raw else fp_reduce_all(acc, p))
                        assert max(z.flat) < U64
                    z = fp_reduce_all(z, p)
                    z = z.reshape(len(xt), len(g), r)
                    sv = np.full((len(xt), len(g)), cb[0], dtype=object)
                    prod = None
                    for e in range(1, r + 1):
                        prod = z[..., 0] if e == 1 else \
                            fp_reduce_all(prod * z[..., e - 1], p)
                        sv = (sv + fp_reduce_all(cb[e] * prod, p)) % p
                    for rb in range(0, len(xt), tcg.ROW_BLOCK):
                        acc = (part[:, g.start:g.stop]
                               + xt[rb:rb + tcg.ROW_BLOCK].T
                               @ sv[rb:rb + tcg.ROW_BLOCK])
                        assert max(acc.flat) < U64
                        part[:, g.start:g.stop] = fp_reduce_all(acc, p)
            slots.append(part)
        out[n] = fp_reduce_all(sum(slots), p)
    return out


HEADS = [(1, 1), (10, 2), (33, 1), (17, 2), (1, 33)]


def cg_inputs(p, c, r, inputs):
    """Random inputs at a small shape on the plan's own launch, or
    all-(p-1) inputs at the fold interval: 32 threads of L+1 columns each
    (d = 32 L + 1, so thread 0 folds) and tiles of L+1 rows, split in two."""
    if inputs == "random":
        N, mk, d = 2, 19, 40
        rng = np.random.default_rng(c * 100 + r)
        x = rng.integers(0, p, (N, mk, d))
        w = rng.integers(0, p, (N, d, c, r))
        cbar = rng.integers(0, p, r + 1)
        return x, w, cbar, tcg.plan(N, mk, d, c, r)
    L = build.fold_every(p)
    N, mk, d = 1, 2 * (L + 1) + 1, 32 * L + 1
    x = np.full((N, mk, d), p - 1, np.int64)
    w = np.full((N, d, c, r), p - 1, np.int64)
    cbar = np.full(r + 1, p - 1, np.int64)
    pl = tcg.fixed_plan(N, mk, d, c, r, rows=L + 1, stages=2, part_smem=True,
                        threads=32, splits=2)
    return x, w, cbar, pl


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("c,r", HEADS)
@pytest.mark.parametrize("inputs", ["random", "p_minus_1_at_fold"])
def test_coded_grad_model_bit_equal_reference(p, c, r, inputs):
    """The model of the kernel equals the JAX reference's
    ``coded_grad_mc_ref``, worker by worker, at c*r above the first
    kernel's 32 and at r = 33.  All-(p-1) inputs at the fold interval run
    only at P30 (L = 16; P's L = 76,825 columns a thread is too wide for
    Python ints), with a random-shape all-(p-1) case at P."""
    if inputs == "p_minus_1_at_fold" and p == jf.P:
        x, w, cbar, pl = cg_inputs(p, c, r, "random")
        x, w, cbar = np.full_like(x, p - 1), np.full_like(w, p - 1), \
            np.full_like(cbar, p - 1)
    else:
        x, w, cbar, pl = cg_inputs(p, c, r, inputs)
    check_cg_plan(pl, tcg.SMS) if inputs == "random" else None
    got = coded_grad_model(x, w, cbar, p, pl, build.fold_every(p))
    for n in range(x.shape[0]):
        want = np.asarray(jref.coded_grad_mc_ref(
            jnp.asarray(x[n], jnp.int32), jnp.asarray(w[n], jnp.int32),
            jnp.asarray(cbar, jnp.int32), p))
        assert np.array_equal(got[n].astype(np.int64), want.astype(np.int64))


def test_coded_grad_model_catches_a_late_fold():
    """The model is tight: folding one product later than L overflows at
    the fold interval's all-(p-1) inputs."""
    p = jf.P30
    x, w, cbar, pl = cg_inputs(p, 1, 1, "p_minus_1_at_fold")
    coded_grad_model(x, w, cbar, p, pl, build.fold_every(p))
    with pytest.raises(AssertionError):
        coded_grad_model(x, w, cbar, p, pl, build.fold_every(p) + 1)


@pytest.mark.parametrize("d,p,raw", [(1568, jf.P, True), (76825, jf.P, True),
                                     (76826, jf.P, False), (16, jf.P30, True),
                                     (17, jf.P30, False)])
def test_coded_grad_raw_sums_bound(d, p, raw):
    """Step 1 sums a row's d products unreduced only while d (p-1)^2 stays
    below 2^64 and no thread folds: Case 1 (d = 1568 at P) does."""
    assert tcg.raw_sums(d, p) == raw
    if raw:
        assert d * (p - 1) ** 2 < U64 and d <= build.fold_every(p)
