"""Analog Lagrange coded computing over the reals; mirrors
``repro/core/alcc.py``.

The exact engine (core/lagrange.py) codes over F_p.  This module is the
same code over float arithmetic ("Approximated Coded Computing", arXiv
2406.04747): the K + T interpolation points (betas) and the N evaluation
points (alphas) are Chebyshev nodes, the T privacy masks are Gaussian
(std sigma), and the decode is a least-squares solve against a
Chebyshev-basis Vandermonde system, whose only error is float roundoff
amplified by its condition number and by the magnitude the masks inject
(``error_budget``).

The scheme's matrices are built in numpy on the host, once per scheme or
survivor pattern (cached).  ``encode`` and ``decode`` take numpy arrays,
as the reference's do, or torch tensors, which they keep on their device
(float64, the master's precision).  ``draw_masks`` scales standard
normals that come from the randomness seam (core/protocol/draws.py) where
the reference draws them with ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def recovery_threshold(K: int, T: int, r: int) -> int:
    """Responders of the degree-(2r+1) logistic round: (2r+1)(K+T-1)+1,
    as in the exact scheme."""
    return (2 * r + 1) * (K + T - 1) + 1


def degree_threshold(K: int, T: int, deg_f: int) -> int:
    """Responders needed for a degree-``deg_f`` worker polynomial."""
    return deg_f * (K + T - 1) + 1


def chebyshev_nodes(n: int) -> np.ndarray:
    """n Chebyshev first-kind nodes cos(pi(2i+1)/2n) on (-1, 1), float64,
    ascending."""
    i = np.arange(n, dtype=np.float64)
    return np.sort(np.cos(np.pi * (2.0 * i + 1.0) / (2.0 * n)))


@dataclasses.dataclass(frozen=True)
class AnalogScheme:
    """Static data of one real-valued Lagrange code.

    ``beta_scale`` shrinks the beta nodes toward 0 so they interleave
    strictly inside the alpha spread; ``cond_max`` is the square solve's
    conditioning ceiling beyond which ``decode`` falls back to a
    least-squares solve over ALL received responses.
    """
    N: int                   # workers / shares
    K: int                   # parallelization (data split)
    T: int                   # analog privacy masks
    sigma: float = 1.0       # mask std dev (privacy knob)
    beta_scale: float = 0.45
    cond_max: float = 1e8

    def __post_init__(self):
        assert self.K >= 1 and self.T >= 0 and self.N >= self.K + self.T, (
            f"need N >= K+T, got N={self.N} K={self.K} T={self.T}")
        assert self.sigma >= 0.0 and 0.0 < self.beta_scale < 1.0

    @functools.cached_property
    def alphas(self) -> np.ndarray:
        """N evaluation points: Chebyshev nodes on (-1, 1)."""
        return chebyshev_nodes(self.N)

    @functools.cached_property
    def betas(self) -> np.ndarray:
        """K+T interpolation points: scaled Chebyshev nodes, checked
        disjoint from the alphas (two odd orders both hold 0)."""
        b = self.beta_scale * chebyshev_nodes(self.K + self.T)
        both = np.concatenate([b, self.alphas])
        assert np.min(np.diff(np.sort(both))) > 1e-12, (
            "alpha/beta evaluation points collide; pick another beta_scale")
        return b

    @functools.cached_property
    def encode_matrix(self) -> np.ndarray:
        """U (K+T, N) float64: U[j, i] = L_j(alpha_i); shares = Uᵀ @ stacked."""
        return lagrange_basis(self.alphas, self.betas)

    def mask_points(self) -> np.ndarray:
        """The T beta nodes carrying masks (the last T)."""
        return self.betas[self.K:]

    def decode_matrix(self, survivors, deg_f: int
                      ) -> tuple[np.ndarray, dict]:
        """C (S_used, K) float64 + info so that decoded[k] = C[:, k] @ results.

        The first ``degree_threshold`` survivors give a square system; when
        its condition number exceeds ``cond_max``, ALL survivors form an
        overdetermined one, solved through the pseudo-inverse.  info:
        {"cond", "fallback", "rows", "need"}; ``cond`` is that of the
        system solved.
        """
        surv = tuple(int(w) for w in np.asarray(survivors).ravel())
        return _decode_matrix_cached(self, surv, int(deg_f))

    def decode(self, results, survivors, deg_f: int):
        """Recover {h(beta_k)}_{k<K} from survivor evaluations.

        results: (S, *res_shape) evaluations h(alpha_i) in survivor order,
        numpy or a torch tensor.  Returns ((K, *res_shape) float64 of the
        same kind, on the same device, info); info adds ``abs_err_budget``,
        cond * eps32 * max|results read|.
        """
        C, info = self.decode_matrix(survivors, deg_f)
        rows = info["rows"]
        if isinstance(results, torch.Tensor):
            used = results[:rows].to(torch.float64)
            ct = _decode_matrix_t(self, tuple(int(w) for w in
                                              np.asarray(survivors).ravel()),
                                  int(deg_f), used.device)
            out = (ct @ used.reshape(rows, -1)).reshape(self.K,
                                                        *results.shape[1:])
            mx = float(used.abs().max()) if used.numel() else 0.0
        else:
            results = np.asarray(results, dtype=np.float64)
            flat = results[:rows].reshape(rows, -1)
            out = (C.T @ flat).reshape(self.K, *results.shape[1:])
            mx = float(np.max(np.abs(results[:rows]))) if flat.size else 0.0
        info = dict(info)
        info["abs_err_budget"] = error_budget(info["cond"], mx)
        return out, info

    def decode_sum(self, results, survivors, deg_f: int):
        """sum_k h(beta_k), the aggregated-gradient read."""
        decoded, info = self.decode(results, survivors, deg_f)
        return decoded.sum(axis=0), info


def lagrange_basis(at: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """L (len(nodes), len(at)) float64: L[j, i] = prod_{l!=j}
    (at_i - nodes_l) / (nodes_j - nodes_l)."""
    at = np.asarray(at, np.float64)
    nodes = np.asarray(nodes, np.float64)
    n = nodes.shape[0]
    out = np.empty((n, at.shape[0]), np.float64)
    for j in range(n):
        others = np.delete(nodes, j)
        num = np.prod(at[:, None] - others[None, :], axis=1)
        den = np.prod(nodes[j] - others)
        out[j] = num / den
    return out


def encode(scheme: AnalogScheme, parts, masks):
    """Encode K stacked parts + T Gaussian masks into N float64 shares.

    parts: (K, *shape); masks: (T, *shape); numpy, or torch tensors on one
    device.  Returns (N, *shape) float64 of the same kind: the degree-
    (K+T-1) interpolant through (betas, [parts; masks]) at the alphas.
    Callers ship float32 to workers.
    """
    if isinstance(parts, torch.Tensor):
        parts = parts.to(torch.float64)
        stacked = (torch.cat([parts, masks.to(parts.device, torch.float64)])
                   if scheme.T else parts)
        ut = _encode_matrix_t(scheme, parts.device)
        shares = ut @ stacked.reshape(scheme.K + scheme.T, -1)
        return shares.reshape(scheme.N, *parts.shape[1:])
    parts = np.asarray(parts, np.float64)
    if scheme.T:
        stacked = np.concatenate(
            [parts, np.asarray(masks, np.float64)], axis=0)
    else:
        stacked = parts
    flat = stacked.reshape(scheme.K + scheme.T, -1)
    shares = scheme.encode_matrix.T @ flat                # (N, prod(shape))
    return shares.reshape(scheme.N, *parts.shape[1:])


def encode_replicated(scheme: AnalogScheme, value, masks):
    """Encode ONE value replicated at every data point (the weight encode:
    v(beta_k) = W for all k <= K, Gaussian at the mask points)."""
    if isinstance(value, torch.Tensor):
        value = value.to(torch.float64)
        return encode(scheme, value[None].expand(scheme.K, *value.shape),
                      masks)
    parts = np.broadcast_to(np.asarray(value, np.float64)[None],
                            (scheme.K, *np.shape(value)))
    return encode(scheme, parts, masks)


def draw_masks(z, sigma: float):
    """T Gaussian mask matrices of std ``sigma``, float64, from z, their
    (T, *shape) float32 standard normals drawn through the randomness seam
    (``TorchALCCDraws`` or a test's replay of the reference's keys).  Any
    value decodes (the masks cancel at the betas); sigma sets the privacy
    level and the roundoff it costs."""
    if isinstance(z, torch.Tensor):
        return z.to(torch.float64) * float(sigma)
    return np.asarray(z, np.float64) * float(sigma)


def error_budget(cond: float, max_abs: float, eps: float = _EPS32) -> float:
    """A-priori absolute decode-error bound: cond * eps * max|evaluation|
    (float32 worker arithmetic, amplified by the solve's conditioning)."""
    return float(cond) * float(eps) * float(max_abs)


@functools.lru_cache(maxsize=64)
def _encode_matrix_t(scheme: AnalogScheme, device: torch.device
                     ) -> torch.Tensor:
    """Uᵀ (N, K+T) float64 on ``device``, built once per (scheme, device)."""
    return torch.as_tensor(scheme.encode_matrix.T.copy(), dtype=torch.float64,
                           device=device)


@functools.lru_cache(maxsize=256)
def _decode_matrix_t(scheme: AnalogScheme, surv: tuple[int, ...],
                     deg_f: int, device: torch.device) -> torch.Tensor:
    """Cᵀ (K, S_used) float64 on ``device``, once per survivor pattern."""
    C, _ = _decode_matrix_cached(scheme, surv, deg_f)
    return torch.as_tensor(C.T.copy(), dtype=torch.float64, device=device)


@functools.lru_cache(maxsize=256)
def _decode_matrix_cached(scheme: AnalogScheme, surv: tuple[int, ...],
                          deg_f: int) -> tuple[np.ndarray, dict]:
    from numpy.polynomial import chebyshev

    deg = deg_f * (scheme.K + scheme.T - 1)
    need = deg + 1
    assert len(surv) >= need, (
        f"need {need} survivors for deg(f)={deg_f}, got {len(surv)}")
    B = chebyshev.chebvander(scheme.betas[: scheme.K], deg)   # (K, deg+1)
    A_sq = chebyshev.chebvander(scheme.alphas[list(surv[:need])], deg)
    cond = float(np.linalg.cond(A_sq))
    if cond <= scheme.cond_max or len(surv) == need:
        # h(betas) = B A^{-1} h(alphas): solve Aᵀ C = Bᵀ once per pattern
        C = (np.linalg.solve(A_sq.T, B.T).T if cond < 1e15
             else B @ np.linalg.pinv(A_sq))
        return C.T, {"cond": cond, "fallback": False,
                     "rows": need, "need": need}
    # ill-conditioned square system: least squares over all received
    # responses (deterministic given the survivor tuple)
    A_all = chebyshev.chebvander(scheme.alphas[list(surv)], deg)
    cond_all = float(np.linalg.cond(A_all))
    C = B @ np.linalg.pinv(A_all)
    return C.T, {"cond": cond_all, "fallback": True,
                 "rows": len(surv), "need": need}
