"""Encode stage: quantize + Lagrange-encode datasets and weights.

Mirrors ``repro/core/protocol/encode.py`` (Algorithm 1 lines 1-3).  The
dataset is encoded once; weights every round.  Masks and uniforms come in
from a draws object or as tensors (``draws.py``), never from a hidden RNG.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import field, lagrange, quantize
from repro_torch.core.protocol.config import CPMLConfig


def pad_rows(x: torch.Tensor, K: int) -> torch.Tensor:
    pad = (-x.shape[0]) % K
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], 0)
    return x


def encode_dataset(cfg: CPMLConfig, draws, x: torch.Tensor
                   ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Returns shares (N, m/K, d) + master-side cleartext context."""
    xq = pad_rows(quantize.quantize_data(x, cfg.lx, cfg.p), cfg.K)
    mk = xq.shape[0] // cfg.K
    parts = xq.reshape(cfg.K, mk, xq.shape[-1])
    masks = draws.dataset_masks(cfg.T, mk, xq.shape[-1], cfg.p)
    shares = lagrange.encode(cfg.scheme, parts, masks.to(x.device), cfg.p)
    return shares, {"xq": xq, "m_padded": xq.shape[0]}


def encode_weights(cfg: CPMLConfig, w: torch.Tensor, u: torch.Tensor,
                   masks: torch.Tensor) -> torch.Tensor:
    """Quantize w (Eq. 9-10) with uniforms u and Lagrange-encode W̄ with the
    T masks (Eq. 13-14).  w: (d,) or (d, c).  Returns (N, *w.shape, r).

    v(beta_i) = W̄ for every i <= K, with fresh masks each round.
    """
    wbar = quantize.quantize_weights(w, u.to(w.device), cfg.lw, cfg.p)
    parts = wbar[None].expand(cfg.K, *wbar.shape)
    return lagrange.encode(cfg.scheme, parts, masks.to(w.device), cfg.p)


def weight_mask_shares(cfg: CPMLConfig, masks: torch.Tensor) -> torch.Tensor:
    """W-independent half of ``encode_weights``: the masks' encoded
    contribution (N, *w_shape, r), computable before W is known."""
    return lagrange.encode_masks(cfg.scheme, masks, cfg.p)


def encode_weights_finish(cfg: CPMLConfig, u: torch.Tensor,
                          mask_shares: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """W-dependent half: quantize w, encode the data rows, add the masks.

    ``encode_weights_finish(cfg, u, weight_mask_shares(cfg, masks), w)
    == encode_weights(cfg, w, u, masks)`` bit for bit.
    """
    wbar = quantize.quantize_weights(w, u.to(w.device), cfg.lw, cfg.p)
    parts = wbar[None].expand(cfg.K, *wbar.shape)
    data = lagrange.encode_data(cfg.scheme, parts, cfg.p)
    return field.addmod(data, mask_shares.to(w.device), cfg.p)
