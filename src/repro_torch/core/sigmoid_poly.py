"""Polynomial sigmoid surrogate and its field form (paper §3.3).

Mirrors ``repro/core/sigmoid_poly.py``:

    ĝ(z) = sum_i c_i z^i                        (Eq. 15, least-squares fit)
    ḡ(X̄, W̄) = sum_i c̄_i prod_{j<=i} (X̄ w̄^j)   (Eq. 17, over F_p)

Every term of ḡ is aligned to the scale lc + r(lx+lw) by pre-multiplying
lower-degree coefficients with the missing (2^{lx+lw})^{r-i} factor.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import field

FIT_LO, FIT_HI = -4.0, 4.0


@functools.lru_cache(maxsize=None)
def fit_sigmoid(r: int, z_min: float = FIT_LO, z_max: float = FIT_HI,
                num: int = 2001) -> tuple[float, ...]:
    """Degree-r least-squares fit of the sigmoid on [z_min, z_max] (Eq. 15)."""
    z = np.linspace(z_min, z_max, num)
    y = 1.0 / (1.0 + np.exp(-z))
    V = np.stack([z ** i for i in range(r + 1)], axis=1)
    coeffs, *_ = np.linalg.lstsq(V, y, rcond=None)
    return tuple(float(c) for c in coeffs)


def quantized_coeffs(r: int, lx: int, lw: int, lc: int = 6,
                     p: int = field.P,
                     z_range: tuple[float, float] = (FIT_LO, FIT_HI)
                     ) -> np.ndarray:
    """c̄_i = round(c_i · 2^{lc + (r-i)(lx+lw)}) mod p, as int64."""
    coeffs = fit_sigmoid(r, *z_range)
    out = []
    for i, c in enumerate(coeffs):
        scale = 2 ** (lc + (r - i) * (lx + lw))
        out.append(int(round(c * scale)) % p)
    return np.array(out, dtype=np.int64)


def gradient_scale_poly(lx: int, lw: int, r: int, lc: int = 6) -> int:
    """Total scale of X̄ᵀḡ under quantized_coeffs: lc + lx + r(lx+lw)."""
    return lc + lx + r * (lx + lw)


def gbar_field(xw: torch.Tensor, cbar: torch.Tensor, p: int = field.P
               ) -> torch.Tensor:
    """ḡ over F_p from the per-degree products XW̄ (Eq. 17).

    xw: (..., r) field elements, column j is X̄ @ w̄^j.  cbar: (r+1,) field
    coefficients.  Returns (...,) field elements.
    """
    r = xw.shape[-1]
    cbar = cbar.to(torch.int32)
    out = cbar[0].expand(xw.shape[:-1])
    prod = None
    for i in range(1, r + 1):
        prod = xw[..., i - 1] if prod is None else field.mulmod(
            prod, xw[..., i - 1], p)
        out = field.addmod(out, field.mulmod(cbar[i], prod, p), p)
    return out.to(torch.int32)
