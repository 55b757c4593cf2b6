"""Lagrange coded computing (paper §3.2, §3.4); mirrors
``repro/core/lagrange.py``.

Encoding is a mod-p matmul of the stacked parts and masks against the
(K+T, N) encoding matrix U (Eq. 12); decoding reads h(beta_k) off any
R = deg(f)(K+T-1)+1 surviving evaluations with a second Lagrange matrix.
Masks come in as tensors (the randomness seam); ``draw_masks`` draws them
from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import field


def recovery_threshold(K: int, T: int, r: int) -> int:
    """Minimum surviving workers: (2r+1)(K+T-1)+1 (Theorem 1)."""
    return (2 * r + 1) * (K + T - 1) + 1


def degree_threshold(K: int, T: int, deg_f: int) -> int:
    """Threshold for a polynomial worker function of degree deg_f."""
    return deg_f * (K + T - 1) + 1


@dataclasses.dataclass(frozen=True)
class CodingScheme:
    """All static data of one Lagrange code: evaluation points + matrices."""
    N: int          # number of workers / shares
    K: int          # parallelization (dataset split)
    T: int          # privacy threshold
    p: int = field.P

    def __post_init__(self):
        if not (self.K >= 1 and self.T >= 0 and self.N >= self.K + self.T):
            raise ValueError(f"need N >= K+T, got N={self.N} K={self.K} "
                             f"T={self.T}")

    @functools.cached_property
    def betas(self) -> np.ndarray:
        # K+T distinct interpolation points: 1..K+T (disjoint from alphas).
        return np.arange(1, self.K + self.T + 1, dtype=np.int64)

    @functools.cached_property
    def alphas(self) -> np.ndarray:
        # N distinct evaluation points, disjoint from betas.
        start = self.K + self.T + 1
        return np.arange(start, start + self.N, dtype=np.int64)

    @functools.cached_property
    def encode_matrix(self) -> np.ndarray:
        """U in F_p^{(K+T) x N} of Eq. (12)."""
        return field.host_lagrange_coeffs(self.alphas, self.betas, self.p)

    def decode_matrix(self, survivors: np.ndarray) -> np.ndarray:
        """D in F_p^{len(survivors) x K}: h(beta_k) = sum_i D[i,k] h(alpha_i)."""
        pts = self.alphas[np.asarray(survivors)]
        return field.host_lagrange_coeffs(self.betas[: self.K], pts, self.p)

    def coeff_matrix(self, survivors: np.ndarray) -> np.ndarray:
        """V^{-1}: recovers the coefficients of h from survivor evaluations."""
        pts = self.alphas[np.asarray(survivors)]
        return field.host_vandermonde_inv(pts, self.p)


@functools.lru_cache(maxsize=64)
def _encode_matrix_t(scheme: CodingScheme, start: int, stop: int,
                     device: torch.device) -> torch.Tensor:
    """U[start:stop]ᵀ (N, stop-start) as int32 on ``device``, built once per
    (code, rows, device): the host Lagrange solve is pure python, and the
    per-round weight encode would otherwise redo it and copy it over."""
    return torch.as_tensor(scheme.encode_matrix[start:stop].T.copy(),
                           dtype=torch.int32, device=device)


def _encode_rows(scheme: CodingScheme, stacked: torch.Tensor, rows: slice,
                 p: int) -> torch.Tensor:
    """Shares contributed by a contiguous row-slice of the encode matrix U."""
    part_shape = stacked.shape[1:]
    flat = stacked.reshape(stacked.shape[0], -1).contiguous()
    ut = _encode_matrix_t(scheme, rows.start, rows.stop, stacked.device)
    shares = field.matmul(ut, flat, p)                  # (N, prod(shape))
    return shares.reshape(scheme.N, *part_shape)


def encode(scheme: CodingScheme, x_parts: torch.Tensor, masks: torch.Tensor,
           p: int | None = None) -> torch.Tensor:
    """Encode stacked parts + masks into N shares (Eq. 12).

    x_parts: (K, *part_shape) int32; masks: (T, *part_shape) int32.
    Returns (N, *part_shape).
    """
    p = p or scheme.p
    stacked = torch.cat([x_parts, masks.to(x_parts.device)], 0) \
        if scheme.T else x_parts
    return _encode_rows(scheme, stacked, slice(0, scheme.K + scheme.T), p)


def encode_data(scheme: CodingScheme, x_parts: torch.Tensor,
                p: int | None = None) -> torch.Tensor:
    """The data-row contribution U[:K]ᵀ X̄ of a split encode."""
    p = p or scheme.p
    return _encode_rows(scheme, x_parts, slice(0, scheme.K), p)


def encode_masks(scheme: CodingScheme, masks: torch.Tensor,
                 p: int | None = None) -> torch.Tensor:
    """The mask-row contribution U[K:]ᵀ Z of a split encode (zeros if T=0)."""
    p = p or scheme.p
    if scheme.T == 0:
        return torch.zeros((scheme.N, *masks.shape[1:]), dtype=torch.int32,
                           device=masks.device)
    return _encode_rows(scheme, masks, slice(scheme.K, scheme.K + scheme.T), p)


def draw_masks(gen: torch.Generator, T: int, part_shape: tuple[int, ...],
               p: int = field.P) -> torch.Tensor:
    """T i.i.d. uniform matrices over F_p, drawn on ``gen``'s device."""
    return torch.randint(0, p, (T, *part_shape), generator=gen,
                         dtype=torch.int32, device=gen.device)


def decode(scheme: CodingScheme, results: torch.Tensor, survivors: np.ndarray,
           deg_f: int, p: int | None = None) -> torch.Tensor:
    """Recover {h(beta_k)}_{k in [K]} from survivor evaluations (§3.4).

    results: (S, *res_shape) evaluations h(alpha_i) in survivor order.
    Returns (K, *res_shape).
    """
    p = p or scheme.p
    need = degree_threshold(scheme.K, scheme.T, deg_f)
    if len(survivors) < need:
        raise ValueError(f"need {need} survivors for deg(f)={deg_f}, "
                         f"got {len(survivors)}")
    survivors = np.asarray(survivors)[:need]
    res_shape = results.shape[1:]
    flat = results[:need].reshape(need, -1).contiguous()
    dt = torch.as_tensor(scheme.decode_matrix(survivors).T.copy(),
                         dtype=torch.int32, device=results.device)  # (K, S)
    out = field.matmul(dt, flat, p)
    return out.reshape(scheme.K, *res_shape)


def decode_sum(scheme: CodingScheme, results: torch.Tensor,
               survivors: np.ndarray, deg_f: int,
               p: int | None = None) -> torch.Tensor:
    """sum_k h(beta_k), the paper's Eq. (23)."""
    p = p or scheme.p
    decoded = decode(scheme, results, survivors, deg_f, p)
    out = decoded[0]
    for k in range(1, scheme.K):
        out = field.addmod(out, decoded[k], p)
    return out
