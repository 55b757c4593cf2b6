"""Quantization between R and F_p (paper §3.1); mirrors
``repro/core/quantize.py``.

  * dataset:  X̄ = phi(Round(2^lx · X))                      (Eq. 6)
  * weights:  w̄^j = phi(Round_stoc(2^lw · w)), j = 1..r      (Eqs. 8-10)
  * inverse:  Q_p^{-1}(x̄; l) = 2^{-l} · phi^{-1}(x̄)          (Eq. 24)

``quantize_weights`` takes its uniforms as an argument: this is the
randomness seam, so a test can feed it the reference's draws.
"""
from __future__ import annotations

import torch

from repro_torch.core import field


def quantize_data(x: torch.Tensor, lx: int, p: int = field.P) -> torch.Tensor:
    """Deterministic round-half-up quantization of the dataset (Eq. 5-6)."""
    scaled = x * (2.0 ** lx)
    rounded = torch.floor(scaled + 0.5).to(torch.int32)
    return field.from_signed(rounded, p)


def quantize_weights(w: torch.Tensor, u: torch.Tensor, lw: int,
                     p: int = field.P) -> torch.Tensor:
    """r independent stochastic quantizations of w (Eq. 9-10).

    u: uniforms in [0, 1) of shape (*w.shape, r).  Returns W̄ of the same
    shape: column j is one unbiased realization.
    """
    if tuple(u.shape[:-1]) != tuple(w.shape):
        raise ValueError(f"uniforms {tuple(u.shape)} do not match w "
                         f"{tuple(w.shape)} + (r,)")
    scaled = w * (2.0 ** lw)
    floor = torch.floor(scaled)
    frac = scaled - floor
    rounded = floor[..., None] + (u < frac[..., None]).to(scaled.dtype)
    return field.from_signed(rounded.to(torch.int32), p)


def dequantize(x: torch.Tensor, l: int, p: int = field.P) -> torch.Tensor:
    """Q_p^{-1} of Eq. (24): field -> real with total scale 2^{-l}."""
    return field.to_signed(x, p).to(torch.float32) * (2.0 ** (-l))


def gradient_scale(lx: int, lw: int, r: int) -> int:
    """Fixed-point scale of the decoded gradient, l = lx + r(lx+lw)."""
    return lx + r * (lx + lw)


def wire_itemsize(p: int = field.P) -> int:
    """Bytes per element that carry F_p losslessly, ceil(bits(p-1) / 8): 3
    for the 24-bit P, 4 for P30.  Wire v2's PACKED encoding narrows int32
    payloads to this width (cluster/wire.py)."""
    return max(1, ((p - 1).bit_length() + 7) // 8)
