"""Plain reference of the coded training round (CodedPrivateML, Algorithm 1).

Independent of the program under test: it imports nothing of it and takes
nothing it made.  From the raw dataset (x, y) and the seed it works out
again the quantization, the Lagrange code, the shares, the worker
polynomial, the decode and the gradient step.

  * Field values are exact.  A product mod p is one float64 matmul per
    12-bit limb of the right operand: a left entry < 2^24 times a limb
    < 2^12, summed over at most 2^16 terms, stays below 2^53, so every
    partial sum is an exact integer in any summation order.
  * Real values (the dequantized data and gradient, the step size, the
    weights) are float64 by default; ``real`` names another dtype, such
    as bfloat16 for the lower-precision control.
  * Randomness: the judge does not need the program's random stream.  It
    reads the masks off the program's shares (``recover_rows``) and holds
    them to the uniform distribution on F_p (``mask_bin_gap``); ``Draws`` is
    the reference's own seeded stream, which the control uses when it
    stands in the program's place.
  * The code: interpolation points beta = 1..K+T, evaluation points alpha
    = K+T+1..K+T+N; the sigmoid surrogate is the degree-r least-squares fit
    on [-4, 4] (2001 points), its coefficients scaled by 2^(lc + (r-i)(lx+lw)).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

LIMB = 12
MAX_INNER = 1 << 16


# ---------------------------------------------------------------------------
# Randomness: the reference's own stream
# ---------------------------------------------------------------------------

def seed_of(*tags) -> int:
    """A 63-bit integer from the tags' repr."""
    digest = hashlib.sha256(repr(tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Draws:
    """Dataset masks and round uniforms and masks, on a CPU generator
    seeded from (seed, purpose, round)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _gen(self, *tags) -> torch.Generator:
        return torch.Generator().manual_seed(seed_of(self.seed, *tags))

    def dataset_masks(self, T: int, mk: int, d: int, p: int) -> torch.Tensor:
        return torch.randint(0, p, (T, mk, d), generator=self._gen("dataset"),
                             dtype=torch.int64)

    def round(self, t: int, shape: tuple[int, ...], T: int, p: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self._gen("round", int(t))
        u = torch.rand(tuple(shape), generator=g, dtype=torch.float32)
        masks = torch.randint(0, p, (T, *shape), generator=g,
                              dtype=torch.int64)
        return u, masks


MASK_BINS = 16


def mask_bin_gap(masks: torch.Tensor, p: int) -> float:
    """The largest relative gap, over MASK_BINS equal bins of [0, p), between
    the masks' count in a bin and its expectation under the uniform
    distribution; infinite where a mask lies outside [0, p)."""
    m = masks.reshape(-1).to(torch.int64)
    if bool(((m < 0) | (m >= p)).any()):
        return float("inf")
    edges = [p * i // MASK_BINS for i in range(MASK_BINS + 1)]
    counts = torch.bincount(torch.bucketize(
        m, torch.tensor(edges[1:-1], dtype=torch.int64, device=m.device),
        right=True), minlength=MASK_BINS).to(torch.float64)
    want = torch.tensor([(hi - lo) * m.numel() / p
                         for lo, hi in zip(edges, edges[1:])],
                        dtype=torch.float64, device=m.device)
    return float(((counts - want).abs() / want).max())


# ---------------------------------------------------------------------------
# Exact field arithmetic
# ---------------------------------------------------------------------------

def field_matmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Exact (a @ b) mod p for integer tensors in [0, p), p < 2^24; batched
    like ``torch.matmul``.  Returns int64."""
    if p >= 1 << 24:
        raise ValueError(f"field_matmul needs p < 2^24, got {p}")
    if a.shape[-1] >= MAX_INNER:
        raise ValueError(f"contraction {a.shape[-1]} breaks float64 exactness")
    af = a.to(torch.float64)
    b = b.to(torch.int64)
    out = None
    for j in range(2):
        limb = ((b >> (LIMB * j)) & ((1 << LIMB) - 1)).to(torch.float64)
        part = torch.remainder(torch.matmul(af, limb).to(torch.int64), p)
        part = torch.remainder(part * pow(2, LIMB * j, p), p)
        out = part if out is None else torch.remainder(out + part, p)
    return out


def lagrange_matrix(eval_pts: list[int], interp_pts: list[int], p: int
                    ) -> np.ndarray:
    """M[i, j] = prod_{l != i} (e_j - b_l) / (b_i - b_l) mod p: the value at
    e_j of the polynomial through the interpolation points is
    sum_i M[i, j] * value_i.  Python ints."""
    out = np.zeros((len(interp_pts), len(eval_pts)), dtype=np.int64)
    for i, bi in enumerate(interp_pts):
        den = 1
        for l, bl in enumerate(interp_pts):
            if l != i:
                den = den * (bi - bl) % p
        inv = pow(den, p - 2, p)
        for j, e in enumerate(eval_pts):
            num = 1
            for l, bl in enumerate(interp_pts):
                if l != i:
                    num = num * (e - bl) % p
            out[i, j] = num * inv % p
    return out


def betas(K: int, T: int) -> list[int]:
    return list(range(1, K + T + 1))


def alphas(N: int, K: int, T: int) -> list[int]:
    return list(range(K + T + 1, K + T + 1 + N))


def signed(v: torch.Tensor, p: int) -> torch.Tensor:
    """[0, p) -> signed integers, the upper half negative."""
    v = v.to(torch.int64)
    return torch.where(v >= (p - 1) // 2, v - p, v)


def sigmoid_coeffs(r: int, lx: int, lw: int, lc: int, p: int) -> list[int]:
    """The worker polynomial's field coefficients c̄_0..c̄_r."""
    z = np.linspace(-4.0, 4.0, 2001)
    vand = np.stack([z ** i for i in range(r + 1)], axis=1)
    coeffs, *_ = np.linalg.lstsq(vand, 1.0 / (1.0 + np.exp(-z)), rcond=None)
    return [int(round(float(c) * 2 ** (lc + (r - i) * (lx + lw)))) % p
            for i, c in enumerate(coeffs)]


# ---------------------------------------------------------------------------
# The protocol's stages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Code:
    """Static parameters: the configuration's numbers and the heads."""
    N: int
    K: int
    T: int
    r: int
    c: int
    lx: int
    lw: int
    lc: int
    p: int

    @property
    def threshold(self) -> int:
        return (2 * self.r + 1) * (self.K + self.T - 1) + 1

    @property
    def grad_scale(self) -> int:
        return self.lc + self.lx + self.r * (self.lx + self.lw)

    def encode_matrix(self) -> np.ndarray:
        """(K+T, N): share i = sum_j U[j, i] * stacked_j."""
        return lagrange_matrix(alphas(self.N, self.K, self.T),
                               betas(self.K, self.T), self.p)

    def decode_matrix(self, survivors) -> np.ndarray:
        """(R, K): part k = sum_i D[i, k] * result of survivor i."""
        pts = [alphas(self.N, self.K, self.T)[int(i)] for i in survivors]
        return lagrange_matrix(betas(self.K, self.T)[: self.K], pts, self.p)

    def interp_matrix(self, workers) -> np.ndarray:
        """(K+T, K+T): the values at beta of the degree K+T-1 polynomial
        through the shares of ``workers`` (K+T of them)."""
        pts = [alphas(self.N, self.K, self.T)[int(i)] for i in workers]
        return lagrange_matrix(betas(self.K, self.T), pts, self.p)


def _columns(mat: np.ndarray, rows: torch.Tensor, p: int, n_out: int
             ) -> torch.Tensor:
    """(mat.T @ rows) mod p for (len(mat), *shape) field rows, a block of
    columns at a time -> (n_out, *shape) int64."""
    u = torch.as_tensor(mat.T.copy(), device=rows.device)
    flat = rows.reshape(rows.shape[0], -1)
    out = torch.empty((n_out, flat.shape[1]), dtype=torch.int64,
                      device=rows.device)
    step = 1 << 20
    for s in range(0, flat.shape[1], step):
        out[:, s:s + step] = field_matmul(u, flat[:, s:s + step], p)
    return out.reshape(n_out, *rows.shape[1:])


def encode(code: Code, stacked: torch.Tensor) -> torch.Tensor:
    """(K+T, *shape) field rows -> (N, *shape) shares."""
    return _columns(code.encode_matrix(), stacked, code.p, code.N)


def quantize_data(x: torch.Tensor, lx: int, p: int) -> torch.Tensor:
    """Round(2^lx x) as floor(2^lx x + 0.5) in float32, into [0, p)."""
    q = torch.floor(x.to(torch.float32) * float(2 ** lx) + 0.5).to(torch.int64)
    return torch.remainder(q, p)


def quantize_weights(w: torch.Tensor, u: torch.Tensor, lw: int, p: int
                     ) -> torch.Tensor:
    """Stochastic rounding of 2^lw w with uniforms u (*w.shape, r), into
    [0, p): floor + [u < frac], computed in w's dtype."""
    scaled = w * float(2 ** lw)
    low = torch.floor(scaled)
    up = (u.to(w.device) < (scaled - low)[..., None]).to(torch.int64)
    return torch.remainder(low.to(torch.int64)[..., None] + up, p)


def worker_results(code: Code, x_shares: torch.Tensor, w_shares: torch.Tensor,
                   block: int = 8) -> torch.Tensor:
    """Every worker's X̃ᵀ ḡ(X̃ W̃) mod p: (N, mk, d), (N, d, c, r) ->
    (N, d, c) int64, in blocks of workers."""
    p = code.p
    cbar = sigmoid_coeffs(code.r, code.lx, code.lw, code.lc, p)
    N, mk, d = x_shares.shape
    out = []
    for s in range(0, N, block):
        xs = x_shares[s:s + block]
        ws = w_shares[s:s + block].reshape(xs.shape[0], d, -1)
        xw = field_matmul(xs, ws, p).reshape(xs.shape[0], mk, code.c, code.r)
        g = torch.full(xw.shape[:-1], cbar[0], dtype=torch.int64,
                       device=xw.device)
        prod = None
        for i in range(1, code.r + 1):
            col = xw[..., i - 1]
            prod = col if prod is None else torch.remainder(prod * col, p)
            g = torch.remainder(g + torch.remainder(cbar[i] * prod, p), p)
        out.append(field_matmul(xs.transpose(1, 2), g, p))
    return torch.cat(out, 0)


def decode(code: Code, results: torch.Tensor, survivors) -> torch.Tensor:
    """(R, d, c) results of ``survivors`` in order -> (K, d, c) parts."""
    dmat = torch.as_tensor(code.decode_matrix(survivors).T.copy(),
                           device=results.device)
    flat = results.reshape(results.shape[0], -1)
    return field_matmul(dmat, flat, code.p).reshape(code.K,
                                                    *results.shape[1:])


def recover_rows(code: Code, shares: torch.Tensor) -> torch.Tensor:
    """(N, *shape) shares -> (K+T, *shape): the values at beta_1..beta_K+T of
    the polynomial through the first K+T shares."""
    kt = code.K + code.T
    return _columns(code.interp_matrix(range(kt)), shares[:kt], code.p, kt)


def lipschitz_eta(xq_real: torch.Tensor) -> float:
    """eta = 4 m / lambda_max(X̄ᵀX̄) over the padded rows, lambda by 50
    power iterations from the normalised ones vector."""
    m, d = xq_real.shape
    v = torch.ones(d, dtype=xq_real.dtype, device=xq_real.device) / math.sqrt(d)
    for _ in range(50):
        v = xq_real.T @ (xq_real @ v)
        v = v / (torch.linalg.norm(v) + 1e-30)
    lam = v @ (xq_real.T @ (xq_real @ v))
    return float(4.0 * m / lam)


@dataclasses.dataclass
class Dataset:
    """The master's side after the dataset encode."""
    code: Code
    m: int                      # real rows
    mk: int                     # rows a part (padded m / K)
    x_shares: torch.Tensor      # (N, mk, d) int64
    xq_real: torch.Tensor       # (m_padded, d) real
    targets: torch.Tensor       # (m_padded, c) real
    eta: float


def quantized_parts(code: Code, x: torch.Tensor) -> torch.Tensor:
    """The quantized dataset, padded with zero rows to a multiple of K and
    split: (K, mk, d) int64 field rows."""
    m, d = x.shape
    xq = quantize_data(x, code.lx, code.p)
    xq = torch.cat([xq, xq.new_zeros(((-m) % code.K, d))], 0)
    return xq.reshape(code.K, -1, d)


def setup(code: Code, x: torch.Tensor, y: torch.Tensor, masks: torch.Tensor,
          real: torch.dtype = torch.float64) -> Dataset:
    """Quantize, pad, split and encode the dataset with the T (mk, d)
    ``masks``; the step size."""
    m, d = x.shape
    parts = quantized_parts(code, x)
    mk = parts.shape[1]
    stacked = torch.cat([parts, masks.to(device=x.device,
                                         dtype=torch.int64)], 0)
    x_shares = encode(code, stacked)
    xq = parts.reshape(-1, d)
    xq_real = (signed(xq, code.p).to(torch.float64)
               * 2.0 ** -code.lx).to(real)
    pad = xq.shape[0] - m
    yp = torch.cat([y.to(torch.int64), y.new_zeros(pad).to(torch.int64)])
    if code.c == 1:
        targets = yp.to(real)[:, None]
    else:
        targets = torch.nn.functional.one_hot(yp, code.c).to(real)
    return Dataset(code, m, mk, x_shares, xq_real, targets,
                   lipschitz_eta(xq_real))


def gradient_step(ds: Dataset, w: torch.Tensor, parts: torch.Tensor
                  ) -> torch.Tensor:
    """w (d, c) real and the round's decoded (K, d, c) parts -> next w."""
    code = ds.code
    xg = (signed(parts, code.p).to(torch.float64)
          * 2.0 ** -code.grad_scale).to(w.dtype).sum(0)
    xty = ds.xq_real.T @ ds.targets
    return w - (ds.eta / ds.m) * (xg - xty.to(w.dtype))


def round_update(ds: Dataset, w: torch.Tensor, wbar: torch.Tensor,
                 masks: torch.Tensor, survivors) -> dict[str, torch.Tensor]:
    """One full-batch round from the quantized weights W̄ (d, c, r) and the
    T masks: the weight shares, every worker's result, the decoded parts
    and the next w."""
    code = ds.code
    stacked = torch.cat([wbar[None].expand(code.K, *wbar.shape),
                         masks.to(device=wbar.device, dtype=torch.int64)], 0)
    w_shares = encode(code, stacked)
    results = worker_results(code, ds.x_shares, w_shares)
    parts = decode(code, results[list(survivors)], survivors)
    return {"w_shares": w_shares, "results": results, "parts": parts,
            "w": gradient_step(ds, w, parts)}


def loss(ds: Dataset, w: torch.Tensor) -> float:
    """The mean one-vs-all logistic loss over the real rows (the binary
    loss when c = 1)."""
    x = ds.xq_real[: ds.m].to(torch.float64)
    t = ds.targets[: ds.m].to(torch.float64)
    z = x @ w.to(torch.float64)
    # log sigmoid(z) and log sigmoid(-z), stable at any |z|
    return float(-(t * torch.nn.functional.logsigmoid(z)
                   + (1 - t) * torch.nn.functional.logsigmoid(-z)).mean())
