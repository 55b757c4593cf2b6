"""Decode stage: survivor pattern -> decode matrix -> field decode -> real.

Mirrors the batch decode of ``repro/core/protocol/decode.py``: the decode
matrix of a survivor set is built on the host (cached per pattern) and
applied as one field matmul.  The reference's streaming decoder
(``DecodePlan``, ``StreamingDecoder``) is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import field, quantize
from repro_torch.core.lagrange import CodingScheme
from repro_torch.core.protocol.config import CPMLConfig


def make_decode_matrix(cfg: CPMLConfig, survivors: np.ndarray,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """(R, K) int32 decode matrix of the first ``threshold`` survivors."""
    surv = np.asarray(survivors)[: cfg.threshold]
    return torch.as_tensor(
        _cached_decode_matrix(cfg.scheme, tuple(int(i) for i in surv)),
        dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=512)
def _cached_decode_matrix(scheme: CodingScheme, survivors: tuple[int, ...]
                          ) -> np.ndarray:
    """Host Lagrange-coefficient solve, cached per (scheme, pattern)."""
    return scheme.decode_matrix(np.asarray(survivors))


def decode_parts(cfg: CPMLConfig, results: torch.Tensor,
                 decode_mat: torch.Tensor) -> torch.Tensor:
    """Recover the K per-part field results h(beta_k) from survivors.

    results: (R, d, c) evaluations h(alpha_i) in survivor order.
    Returns (K, d, c), exactly X̄_kᵀ ḡ(X̄_k, W̄) mod p.
    """
    flat = results.reshape(results.shape[0], -1)
    out = field.matmul(decode_mat.T.contiguous(), flat.contiguous(), cfg.p)
    return out.reshape(cfg.K, *results.shape[1:])


def parts_to_gradient(cfg: CPMLConfig, parts: torch.Tensor) -> torch.Tensor:
    """(K, d, c) decoded field parts -> real (d, c) gradient."""
    return quantize.dequantize(parts, cfg.grad_scale, cfg.p).sum(dim=0)


def decode_gradient(cfg: CPMLConfig, results: torch.Tensor,
                    decode_mat: torch.Tensor) -> torch.Tensor:
    """Decode the K sub-gradients and sum them in the real domain, which
    buys log2(K) bits of wrap-around headroom per part.  (R, d, c) -> (d, c).
    """
    return parts_to_gradient(cfg, decode_parts(cfg, results, decode_mat))
