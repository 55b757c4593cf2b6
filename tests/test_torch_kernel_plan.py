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
    model = TM.Model(cfg, dtype=torch.bfloat16, seed=0)
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
