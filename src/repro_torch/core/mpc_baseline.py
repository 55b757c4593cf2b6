"""BGW-style MPC baseline (paper §5 + Appendix A.5) on torch tensors.

Mirrors ``repro/core/mpc_baseline.py``: Shamir secret sharing of the whole
quantized dataset at every worker plus a multi-round BGW protocol for the
gradient polynomial, with CodedPrivateML's quantization and sigmoid
surrogate, so the two systems compute the same update:

  * share:       [S]_i = S + sum_t R_t alpha_i^t           (degree-T Shamir)
  * multiply:    local product -> degree-2T sharing
  * reduce:      every worker re-shares its product share with fresh
                 degree-T masks; every worker combines what it received with
                 Lagrange-at-0 weights: one all-to-all round per
                 multiplication
  * reconstruct: interpolate at 0 from 2T+1 shares.

Differences from the reference:

  * randomness comes from a draws object (core/protocol/draws.py,
    ``TorchMPCDraws``): the dataset masks, iteration t's uniforms and
    weight-share masks, one reshare seed per degree reduction, and each
    source worker's reshare masks drawn from (seed, worker).  The
    reference's ``reshare_keys`` split becomes ``reshare_masks``;
  * a worker's two local products run on the ``modmatmul`` kernel with the
    long dimension on the kernel's columns: zᵀ = w̄ᵀ·X̄ᵀ reads X̄ᵀ (d, m),
    which a worker keeps beside X̄ (``MPCState.x_shares_t``), and
    gᵀ = sᵀ·X̄ reads X̄ itself.  Exact either way, so the field values are
    the reference's;
  * a whole-dataset share is formed one worker at a time, and a degree
    reduction accumulates one source worker at a time, so the peak memory
    stays near the shares' own size (6.2 GB of X̄ and X̄ᵀ at Case 1 for 40
    workers).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import field, quantize, sigmoid_poly
from repro_torch.core.protocol.draws import TorchMPCDraws


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    N: int
    T: int
    r: int = 1
    lx: int = 2
    lw: int = 4
    lc: int = 6
    p: int = field.P

    def __post_init__(self):
        assert self.N >= 2 * self.T + 1, (
            f"BGW needs N >= 2T+1, got N={self.N}, T={self.T}")

    @functools.cached_property
    def alphas(self) -> np.ndarray:
        return np.arange(1, self.N + 1, dtype=np.int64)

    @functools.cached_property
    def lambda0(self) -> np.ndarray:
        """Lagrange-at-0 coefficients for all N points (degree < N interp)."""
        return _lagrange_at_zero(self.alphas, self.p)

    def lambda0_first(self, count: int) -> np.ndarray:
        return _lagrange_at_zero(self.alphas[:count], self.p)

    @property
    def grad_scale(self) -> int:
        return sigmoid_poly.gradient_scale_poly(self.lx, self.lw, self.r,
                                                self.lc)


def _lagrange_at_zero(points: np.ndarray, p: int) -> np.ndarray:
    pts = [int(x) % p for x in points]
    lam = []
    for i, ai in enumerate(pts):
        num, den = 1, 1
        for l, al in enumerate(pts):
            if l != i:
                num = num * al % p
                den = den * ((al - ai) % p) % p
        lam.append(num * field.host_inv(den, p) % p)
    return np.array(lam, dtype=np.int64)


def _combine(lam: np.ndarray, values: torch.Tensor, p: int) -> torch.Tensor:
    """sum_i lam[i] * values[i] mod p over the leading axis (each product
    reduced before the sum, so N terms stay below 2^63 for any p < 2^30)."""
    n = len(lam)
    lam_t = torch.as_tensor(np.asarray(lam, np.int64), device=values.device)
    prods = torch.remainder(
        lam_t.view(n, *([1] * (values.ndim - 1))) * values[:n].to(torch.int64),
        p)
    return torch.remainder(prods.sum(0), p).to(torch.int32)


# ---------------------------------------------------------------------------
# Shamir primitives (leading axis = workers)
# ---------------------------------------------------------------------------

# int64 elements of one temporary in ``share``: a whole-dataset share is
# formed one worker at a time, a small one for all workers at once
SHARE_CHUNK_ELEMENTS = 1 << 24


def share(cfg: MPCConfig, value: torch.Tensor, masks: torch.Tensor
          ) -> torch.Tensor:
    """Degree-T Shamir shares of ``value`` with ``masks`` (T, *value.shape)
    -> (N, *value.shape) int32, formed for as many workers at a time as
    keep a temporary within SHARE_CHUNK_ELEMENTS."""
    out = torch.empty((cfg.N, *value.shape), dtype=torch.int32,
                      device=value.device)
    if cfg.T == 0:
        out.copy_(value.expand(cfg.N, *value.shape))
        return out
    v64 = value.to(torch.int64)
    m64 = masks.to(device=value.device, dtype=torch.int64)
    chunk = max(1, SHARE_CHUNK_ELEMENTS // max(1, value.numel()))
    alphas = torch.as_tensor(cfg.alphas, device=value.device)
    for i0 in range(0, cfg.N, chunk):
        a = alphas[i0:i0 + chunk].view(-1, *([1] * value.ndim))
        apow = torch.ones_like(a)
        acc = v64.expand(len(a), *value.shape).clone()
        for t in range(cfg.T):
            apow = apow * a % cfg.p                         # alpha^(t+1)
            acc.add_(apow * m64[t])
            torch.remainder(acc, cfg.p, out=acc)
        out[i0:i0 + chunk] = acc
    return out


def reshare_masks(cfg: MPCConfig, draws, seed, worker: int,
                  shape: tuple[int, ...]) -> torch.Tensor:
    """The masks with which source ``worker`` re-shares under one degree
    reduction's ``seed``: the one derivation the single-host oracle
    (``degree_reduce``) and a worker process (launch/cpml_worker.py) use."""
    return draws.reshare_masks(seed, int(worker), cfg.T, tuple(shape), cfg.p)


def make_subshares(cfg: MPCConfig, value: torch.Tensor, masks: torch.Tensor
                   ) -> torch.Tensor:
    """Worker-side re-share: fresh degree-T shares of this worker's product
    share, one per recipient -> (N, *value.shape).  Row j goes to peer j."""
    return share(cfg, value, masks)


def combine_subshares(cfg: MPCConfig, gathered: torch.Tensor) -> torch.Tensor:
    """Recipient-side combine: (N_from, *s) sub-shares (ordered by source
    worker) -> this worker's new degree-T share, via Lagrange-at-0 weights.
    Needs sub-shares from all N sources: the barrier of every BGW
    multiplication."""
    return _combine(cfg.lambda0, gathered, cfg.p)


def degree_reduce(cfg: MPCConfig, draws, seed, shares: torch.Tensor
                  ) -> torch.Tensor:
    """BGW degree reduction: (N, *s) degree-2T shares -> degree-T shares.

    Every source re-shares (``make_subshares`` under its ``reshare_masks``)
    and every recipient combines (``combine_subshares``); the all-to-all
    exchange is accumulated one source at a time."""
    shape = tuple(shares.shape[1:])
    acc = torch.zeros((cfg.N, *shape), dtype=torch.int64,
                      device=shares.device)
    for i, lam in enumerate(cfg.lambda0):
        sub = make_subshares(cfg, shares[i],
                             reshare_masks(cfg, draws, seed, i, shape))
        acc.add_(sub.to(torch.int64), alpha=int(lam))
        torch.remainder(acc, cfg.p, out=acc)
    return acc.to(torch.int32)


def reconstruct(cfg: MPCConfig, shares: torch.Tensor, degree: int
                ) -> torch.Tensor:
    """Interpolate the secret (value at 0) from the first degree+1 shares."""
    need = degree + 1
    assert cfg.N >= need, f"cannot reconstruct degree {degree} from {cfg.N}"
    return _combine(cfg.lambda0_first(need), shares, cfg.p)


def reconstruct_at(cfg: MPCConfig, shares: torch.Tensor,
                   workers: np.ndarray) -> torch.Tensor:
    """Interpolate the secret from the shares of any worker subset:
    ``shares[i]`` is worker ``workers[i]``'s.  Any 2T+1 correct shares of a
    degree-2T sharing give the same field element as ``reconstruct``, so
    the cluster master may reconstruct from the first 2T+1 arrivals."""
    idx = np.asarray(workers, dtype=np.int64)
    return _combine(_lagrange_at_zero(cfg.alphas[idx], cfg.p), shares, cfg.p)


# ---------------------------------------------------------------------------
# The private gradient protocol (same math as CPML's Eq. 19)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MPCState:
    w: torch.Tensor
    x_shares: torch.Tensor          # (N, m, d): the whole dataset, per worker
    x_shares_t: torch.Tensor | None  # (N, d, m) contiguous, when kept
    xty: torch.Tensor
    m: int
    xq_real: torch.Tensor
    y: torch.Tensor


def setup(cfg: MPCConfig, x: torch.Tensor, y: torch.Tensor, draws,
          w0: torch.Tensor | None = None, *, transposed: bool = True
          ) -> MPCState:
    """Quantize and Shamir-share the dataset.  ``transposed=False`` keeps no
    X̄ᵀ (a master whose workers compute needs none)."""
    m, d = x.shape
    xq = quantize.quantize_data(x, cfg.lx, cfg.p)
    x_shares = share(cfg, xq, draws.data_masks(cfg.T, m, d, cfg.p))
    x_shares_t = None
    if transposed:
        x_shares_t = torch.empty((cfg.N, d, m), dtype=torch.int32,
                                 device=x.device)
        for i in range(cfg.N):
            x_shares_t[i].copy_(x_shares[i].T)
    xq_real = quantize.dequantize(xq, cfg.lx, cfg.p)
    xty = xq_real.T @ y.to(torch.float32)
    w = w0 if w0 is not None else torch.zeros(d, dtype=torch.float32,
                                              device=x.device)
    return MPCState(w=w, x_shares=x_shares, x_shares_t=x_shares_t, xty=xty,
                    m=m, xq_real=xq_real, y=y)


# --- per-phase hooks: the pieces one worker (or the master) runs.  The
# cluster runtime (cluster/mpc_runner.py, launch/cpml_worker.py "mpc" mode)
# composes exactly these, so a cluster run is bit-identical to ``train``.

def poly_coeffs(cfg: MPCConfig) -> np.ndarray:
    """The quantized sigmoid-surrogate coefficients c̄."""
    return np.asarray(
        sigmoid_poly.quantized_coeffs(cfg.r, cfg.lx, cfg.lw, cfg.lc, cfg.p),
        dtype=np.int32)


def step_keys(cfg: MPCConfig, draws, t: int, d: int):
    """Iteration t's draws: (uniforms (d, r) of the weight quantization,
    weight-share masks (T, d, r), one reshare seed per degree reduction)."""
    u, masks = draws.step(t, (d, cfg.r), cfg.T, cfg.p)
    return u, masks, [draws.reshare_seed(t, j) for j in range(cfg.r)]


def encode_step(cfg: MPCConfig, draws, t: int, w: torch.Tensor):
    """Master-side start of iteration t: quantize and Shamir-share the
    weights.  Returns (w_shares (N, d, r), reshare seeds)."""
    u, masks, seeds = step_keys(cfg, draws, t, w.shape[0])
    wbar = quantize.quantize_weights(w, u.to(w.device), cfg.lw, cfg.p)
    return share(cfg, wbar, masks), seeds


def worker_mul(cfg: MPCConfig, x_share_t: torch.Tensor,
               w_share: torch.Tensor) -> torch.Tensor:
    """Local multiply Z = [X̄] @ [w̄]: secret x secret -> degree-2T (m, r),
    computed as (w̄ᵀ · X̄ᵀ)ᵀ from X̄ᵀ (d, m)."""
    return field.matmul(w_share.T.contiguous(), x_share_t, cfg.p).T


def s_init(cfg: MPCConfig, cbar: torch.Tensor, prod: torch.Tensor
           ) -> torch.Tensor:
    """s = c̄_0 + c̄_1 z after the first degree reduction."""
    return field.addmod(cbar[0].expand(prod.shape),
                        field.mulmod(cbar[1], prod, cfg.p), cfg.p)


def s_accum(cfg: MPCConfig, cbar_i: torch.Tensor, s: torch.Tensor,
            prod: torch.Tensor) -> torch.Tensor:
    """s += c̄_i z^i for the higher-degree surrogate terms."""
    return field.addmod(s, field.mulmod(cbar_i, prod, cfg.p), cfg.p)


def worker_final(cfg: MPCConfig, x_share: torch.Tensor, s: torch.Tensor
                 ) -> torch.Tensor:
    """Final local multiply G-share = [X̄]ᵀ s -> degree-2T (d,), computed as
    sᵀ · X̄ from X̄ (m, d)."""
    return field.matmul(s[None, :].contiguous(), x_share, cfg.p)[0]


def finish_update(cfg: MPCConfig, w: torch.Tensor, decoded: torch.Tensor,
                  xty: torch.Tensor, eta_over_m: float) -> torch.Tensor:
    """Master-side end of one iteration: dequantize + gradient step
    (``eta_over_m`` a float32 value, as the reference forms it)."""
    xg = quantize.dequantize(decoded, cfg.grad_scale, cfg.p)
    return w - eta_over_m * (xg - xty)


def eta_over_m(eta: float, m: int) -> float:
    """eta / m rounded to float32, exact as a python float."""
    return float(np.float32(eta / m))


def all_g_shares(cfg: MPCConfig, draws, t: int, w: torch.Tensor,
                 state: MPCState) -> torch.Tensor:
    """All N workers' final degree-2T gradient shares of iteration t: one
    BGW iteration up to (not including) reconstruction, from the hooks."""
    cbar = torch.as_tensor(poly_coeffs(cfg), device=w.device)
    w_shares, seeds = encode_step(cfg, draws, t, w)                # (N, d, r)
    # round 1: Z = X̄ w̄ʲ, secret x secret -> degree 2T, then reduce
    z = torch.stack([worker_mul(cfg, state.x_shares_t[i], w_shares[i])
                     for i in range(cfg.N)])                       # (N, m, r)
    z = degree_reduce(cfg, draws, seeds[0], z)
    # rounds 2..r: running products of z columns (elementwise)
    prod = z[..., 0]
    s = s_init(cfg, cbar, prod)
    for i in range(2, cfg.r + 1):
        prod = field.mulmod(prod, z[..., i - 1], cfg.p)            # deg 2T
        prod = degree_reduce(cfg, draws, seeds[i - 1], prod)
        s = s_accum(cfg, cbar[i], s, prod)
    # final multiplication G = X̄ᵀ s: degree 2T, reconstructed directly
    return torch.stack([worker_final(cfg, state.x_shares[i], s[i])
                        for i in range(cfg.N)])                    # (N, d)


def step(cfg: MPCConfig, draws, t: int, state: MPCState, eta: float
         ) -> MPCState:
    """One BGW iteration, all N workers on this device: the single-host
    oracle the cluster runtime is held to."""
    g = all_g_shares(cfg, draws, t, state.w, state)
    decoded = reconstruct(cfg, g, 2 * cfg.T)
    w = finish_update(cfg, state.w, decoded, state.xty,
                      eta_over_m(eta, state.m))
    return dataclasses.replace(state, w=w)


def train(cfg: MPCConfig, x, y, iters: int, eta: float | None = None,
          eval_every: int = 0, *, draws=None,
          device: str | torch.device | None = None
          ) -> tuple[torch.Tensor, list[dict[str, float]]]:
    """``iters`` BGW iterations.  Returns (w, history).  Runs on CUDA unless
    ``device="cpu"``; ``draws`` defaults to ``TorchMPCDraws(0, device)``."""
    from repro_torch.core import protocol as cpml
    dev = _device.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, device=dev)
    draws = draws if draws is not None else TorchMPCDraws(0, dev)
    state = setup(cfg, x, y, draws)
    if eta is None:
        eta = cpml.lipschitz_eta(state.xq_real)
    history = []
    for t in range(iters):
        state = step(cfg, draws, t, state, eta)
        if eval_every and (t + 1) % eval_every == 0:
            l, a = cpml.loss_and_accuracy(state.w, state.xq_real, state.y)
            history.append({"iter": t + 1, "loss": float(l), "acc": float(a)})
    return state.w, history
