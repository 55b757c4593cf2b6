"""Lagrange-coded linear layer (the LM head); mirrors
``repro/core/coded_linear.py``.

The weight matrix W (d, v) is quantized into F_p, cut into K column blocks,
padded with T random mask blocks and Lagrange-encoded into N shares W̃_i.
Shard i computes Y_i = H̄ @ W̃_i; f is degree 1 in W̃, so ANY K+T of the N
results reconstruct all K true column blocks exactly, and any T shares
reveal nothing of W.  The per-shard products go through ``field.matmul``:
on the card, one ``modmatmul`` launch per surviving shard.

``encode_weights`` takes its masks as an argument or draws them from a
``torch.Generator`` (the randomness seam).  ``coded_head_apply_sharded``
places one share a rank along a mesh axis (``parallel/compat.py``): each
rank computes its own share's product (one ``modmatmul`` launch on the
card), one ``all_gather`` brings every rank all N results, and each
decodes the static survivors, replicated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import field, lagrange, quantize
from repro_torch.parallel import compat


@dataclasses.dataclass(frozen=True)
class CodedLinearConfig:
    N: int              # shards (devices in the coded group)
    K: int              # data blocks (useful fraction = K/N)
    T: int              # privacy threshold
    lh: int = 6         # activation quantization bits (scale 2^lh)
    lw: int = 6         # weight quantization bits
    p: int = field.P30  # 30-bit prime: more headroom for d-long dot products

    def __post_init__(self):
        if self.N < self.K + self.T:
            raise ValueError(f"need N >= K+T (degree-1 threshold), got N={self.N}"
                             f" K={self.K} T={self.T}")

    @property
    def threshold(self) -> int:
        return lagrange.degree_threshold(self.K, self.T, deg_f=1)

    @property
    def scheme(self) -> lagrange.CodingScheme:
        return lagrange.CodingScheme(self.N, self.K, self.T, self.p)


def encode_weights(cfg: CodedLinearConfig, w: torch.Tensor,
                   gen: torch.Generator | None = None,
                   masks: torch.Tensor | None = None) -> torch.Tensor:
    """w: (d, v) real -> coded shares (N, d, v/K) in F_p.  Done once.

    The T masks (T, d, v/K) come from ``masks`` or are drawn on ``gen``.
    """
    d, v = w.shape
    if v % cfg.K:
        raise ValueError(f"vocab {v} must divide into K={cfg.K} blocks")
    wq = quantize.quantize_data(w, cfg.lw, cfg.p)
    parts = wq.reshape(d, cfg.K, v // cfg.K).permute(1, 0, 2)  # (K, d, v/K)
    if masks is None:
        if gen is None:
            raise ValueError("encode_weights needs masks or a generator")
        masks = lagrange.draw_masks(gen, cfg.T, tuple(parts.shape[1:]), cfg.p)
    return lagrange.encode(cfg.scheme, parts, masks, cfg.p)


def worker_matmul(cfg: CodedLinearConfig, h_q: torch.Tensor,
                  w_share: torch.Tensor) -> torch.Tensor:
    """One shard's compute: H̄ @ W̃_i over F_p.  (m, d) x (d, v/K)."""
    return field.matmul(h_q, w_share, cfg.p)


def decode_field(cfg: CodedLinearConfig, results: torch.Tensor,
                 survivors: np.ndarray) -> torch.Tensor:
    """(S, m, v/K) survivor results -> (m, v) field values H̄ W̄ mod p."""
    dec = lagrange.decode(cfg.scheme, results, survivors, deg_f=1, p=cfg.p)
    return dec.permute(1, 0, 2).reshape(results.shape[1], -1)


def decode_output(cfg: CodedLinearConfig, results: torch.Tensor,
                  survivors: np.ndarray) -> torch.Tensor:
    """(S, m, v/K) survivor results -> (m, v) real logits."""
    return quantize.dequantize(decode_field(cfg, results, survivors),
                               cfg.lh + cfg.lw, cfg.p)


def shard_results(cfg: CodedLinearConfig, h: torch.Tensor,
                  w_shares: torch.Tensor, survivors: np.ndarray | None = None
                  ) -> tuple[torch.Tensor, np.ndarray]:
    """Quantize h (m, d) and run the first K+T surviving shards.

    Returns (results (K+T, m, v/K), the shard indices used)."""
    surv = np.arange(cfg.N) if survivors is None else np.asarray(survivors)
    used = surv[: cfg.threshold]
    h_q = quantize.quantize_data(h, cfg.lh, cfg.p)
    return torch.stack([worker_matmul(cfg, h_q, w_shares[int(i)])
                        for i in used]), used


def coded_head_apply(cfg: CodedLinearConfig, h: torch.Tensor,
                     w_shares: torch.Tensor,
                     survivors: np.ndarray | None = None) -> torch.Tensor:
    """Full coded projection: h (m, d) real -> logits (m, v) real.

    ``survivors=None`` uses the first K+T shards (no failures); pass any
    index set of size >= K+T to simulate stragglers/failures.
    """
    results, used = shard_results(cfg, h, w_shares, survivors)
    return decode_output(cfg, results, used)


def gathered_results(cfg: CodedLinearConfig, mesh, axis: str,
                     h: torch.Tensor, w_shares: torch.Tensor,
                     survivors: tuple[int, ...] | None = None
                     ) -> tuple[torch.Tensor, np.ndarray]:
    """``shard_results`` with one share a rank along ``axis`` (size N):
    every rank's H̄ @ W̃_i, gathered on every rank.

    Returns (results (K+T, m, v/K) of the first K+T survivors, their
    indices)."""
    if compat.axis_size(axis, mesh) != cfg.N:
        raise ValueError(f"mesh axis {axis!r} must hold the N={cfg.N} shares")
    surv = np.arange(cfg.N) if survivors is None else np.asarray(survivors)
    used = surv[: cfg.threshold]
    h_q = quantize.quantize_data(h, cfg.lh, cfg.p)

    def body(ws: torch.Tensor) -> torch.Tensor:
        res = worker_matmul(cfg, h_q, ws[0])[None]                # (1, m, v/K)
        return compat.all_gather(res, axis, 0, tiled=True)       # (N, m, v/K)

    results = compat.shard_map(body, mesh, ((axis,),), ())(w_shares)
    return results[torch.as_tensor(used, device=results.device)], used


def coded_head_apply_sharded(cfg: CodedLinearConfig, mesh, axis: str,
                             h: torch.Tensor, w_shares: torch.Tensor,
                             survivors: tuple[int, ...] | None = None
                             ) -> torch.Tensor:
    """``coded_head_apply`` with one share a rank along ``axis`` (size N).

    ``survivors`` is a static index tuple (the runtime's heartbeat monitor
    picks it).  No collective in a share's product; one ``all_gather``
    plays "send to master"; the decode is a replicated (threshold x K)
    field product on every rank.
    """
    return decode_output(cfg, *gathered_results(cfg, mesh, axis, h, w_shares,
                                                survivors))
