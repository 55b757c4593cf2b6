"""The port's plain kernel versions against the reference's oracles and its
Pallas kernels (interpret mode), plus the CPU-side behaviour of the CUDA
wrappers.  The CUDA kernels themselves are held against these plain
versions on the GPU by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import exact_modmatmul  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import sigmoid_poly as jsp  # noqa: E402
from repro.kernels import modmatmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import coded_grad as tcg  # noqa: E402
from repro_torch.kernels import modmatmul as tmm  # noqa: E402

PRIMES = [jf.P, jf.P30]


def ints(rng, p, shape):
    return rng.integers(0, p, shape).astype(np.int32)


def cbar_of(r, p):
    return np.asarray(jsp.quantized_coeffs(r, 2, 4, 6, p), np.int32)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("mk,d,r", [(64, 32, 1), (300, 64, 2), (257, 96, 3),
                                    (16, 8, 1)])
def test_coded_grad_ref_bit_equal(p, mk, d, r):
    rng = np.random.default_rng(mk + d + r)
    x, w, cbar = ints(rng, p, (mk, d)), ints(rng, p, (d, r)), cbar_of(r, p)
    want = np.asarray(jref.coded_grad_ref(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(cbar), p))
    got = ref.coded_grad_ref(torch.as_tensor(x), torch.as_tensor(w),
                             torch.as_tensor(cbar), p)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("mk,d,c,r", [(64, 32, 3, 1), (100, 48, 10, 2),
                                      (17, 8, 2, 3)])
def test_coded_grad_mc_ref_bit_equal(p, mk, d, c, r):
    rng = np.random.default_rng(mk * c + r)
    x, w, cbar = ints(rng, p, (mk, d)), ints(rng, p, (d, c, r)), cbar_of(r, p)
    want = np.asarray(jref.coded_grad_mc_ref(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(cbar), p))
    got = ref.coded_grad_mc_ref(torch.as_tensor(x), torch.as_tensor(w),
                                torch.as_tensor(cbar), p)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,mk,d,c,r", [(jf.P, 16, 8, 1, 1),
                                        (jf.P30, 9, 4, 2, 1)])
def test_plain_versions_equal_pallas_interpret(p, mk, d, c, r):
    """The reference's Pallas kernels in interpret mode == the port's plain
    versions, multi-head and (for c == 1) binary.  Interpret mode costs
    seconds per case here, so the set is small; the shape sweep runs
    against the pure-jnp oracles above."""
    rng = np.random.default_rng(7 * mk + c)
    x, w, cbar = ints(rng, p, (mk, d)), ints(rng, p, (d, c, r)), cbar_of(r, p)
    xj, wj, cj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(cbar)
    xt, wt, ct = torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(cbar)
    pallas = np.asarray(jops.coded_grad_mc(xj, wj, cj, p, use_pallas=True))
    assert np.array_equal(ref.coded_grad_mc_ref(xt, wt, ct, p).numpy(), pallas)
    if c == 1:
        pallas1 = np.asarray(jops.coded_grad(xj, wj[:, 0, :], cj, p,
                                             use_pallas=True))
        assert np.array_equal(
            ref.coded_grad_ref(xt, wt[:, 0, :], ct, p).numpy(), pallas1)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("shape", [(8, 16, 8), (1, 1, 1), (40, 14, 300)])
def test_modmatmul_ref_equals_pallas_interpret(p, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + N)
    a, b = ints(rng, p, (M, K)), ints(rng, p, (K, N))
    want = np.asarray(jmm.modmatmul(jnp.asarray(a), jnp.asarray(b), p,
                                    interpret=True))
    got = ref.modmatmul_ref(torch.as_tensor(a), torch.as_tensor(b), p)
    assert np.array_equal(got.numpy(), want)


def test_reduce_every_bound():
    """R is the largest n with (p-1) + n (p-1)^2 < 2^64."""
    assert build.reduce_every(jf.P) == 76921
    assert build.reduce_every(jf.P30) == 16
    for p in PRIMES:
        R = build.reduce_every(p)
        assert (p - 1) + R * (p - 1) ** 2 < 2 ** 64
        assert (p - 1) + (R + 1) * (p - 1) ** 2 >= 2 ** 64
    with pytest.raises(ValueError):
        build.reduce_every(1 << 30)


@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_ref_at_reduction_boundary(p):
    """All-(p-1) inputs at K = R, R+1, 2R+1: the plain version against
    python ints, and against the Pallas kernel at P30's K = 2R+1 = 33
    (interpret mode compiles per shape, so one K)."""
    R = build.reduce_every(p)
    for K in (R, R + 1, 2 * R + 1):
        a = np.full((2, K), p - 1, np.int32)
        b = np.full((K, 3), p - 1, np.int32)
        got = ref.modmatmul_ref(torch.as_tensor(a), torch.as_tensor(b), p)
        assert (got.numpy().astype(object) == exact_modmatmul(a, b, p)).all()
        if p == jf.P30 and K == 2 * R + 1:
            want = np.asarray(jmm.modmatmul(jnp.asarray(a), jnp.asarray(b), p,
                                            interpret=True))
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", PRIMES)
def test_ops_workers_axis_matches_per_worker_reference(p):
    rng = np.random.default_rng(3)
    N, mk, d, c, r = 3, 11, 7, 2, 2
    x, w, cbar = ints(rng, p, (N, mk, d)), ints(rng, p, (N, d, c, r)), \
        cbar_of(r, p)
    got = ops.coded_grad(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(cbar), p)
    assert got.shape == (N, d, c)
    for i in range(N):
        want = np.asarray(jref.coded_grad_mc_ref(
            jnp.asarray(x[i]), jnp.asarray(w[i]), jnp.asarray(cbar), p))
        assert np.array_equal(got[i].numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never hand back the plain result."""
    a = torch.zeros((2, 3), dtype=torch.int32)
    b = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tmm.modmatmul(a, b, jf.P)
    x = torch.zeros((2, 5, 3), dtype=torch.int32)
    w = torch.zeros((2, 3, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tcg.coded_grad(x, w, torch.zeros(2, dtype=torch.int32), jf.P)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("modmatmul")


def test_launch_counts_only_kernel_launches():
    ops.reset_launches()
    assert ops.LAUNCHES is kernels.LAUNCHES
    a = torch.ones((2, 3), dtype=torch.int32)
    ops.modmatmul(a, a.T.contiguous(), jf.P)
    ops.coded_grad(torch.ones((1, 2, 3), dtype=torch.int32),
                   torch.ones((1, 3, 1, 1), dtype=torch.int32),
                   torch.ones(2, dtype=torch.int32), jf.P)
    f = torch.ones((1, 2, 3))
    ops.selective_scan(f, f, torch.ones((1, 2, 4)), torch.ones((1, 2, 4)),
                       torch.zeros((3, 4)), torch.ones(3),
                       torch.zeros((1, 3, 4)))
    with pytest.raises(ValueError):
        tmm.modmatmul(a, a.T.contiguous(), jf.P)
    assert ops.LAUNCHES == {"modmatmul": 0, "coded_grad": 0,
                            "selective_scan": 0, "selective_scan_bwd": 0}
