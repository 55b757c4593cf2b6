"""Gradient compression from the paper's own stochastic quantizer (Eq. 8);
mirrors ``repro/optim/compress.py``.

Each leaf is quantized to ``bits``-bit integers with a per-leaf scale, an
unbiased stochastic rounding.  The uniforms come in through the
randomness seam: an explicit ``u`` (a dict of them for a tree), as the
reference's ``jax.random`` draws in the parity tests, or a
``torch.Generator`` for a standalone run.
"""
from __future__ import annotations

import torch

Tree = dict[str, torch.Tensor]


def quantize_grad(g: torch.Tensor, bits: int = 8, *,
                  u: torch.Tensor | None = None,
                  gen: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unbiased stochastic fixed-point quantization with uniforms ``u`` (of
    g's shape; drawn from ``gen`` when not given).  Returns (q int32,
    scale)."""
    g = g.to(torch.float32)
    if u is None:
        u = torch.rand(g.shape, generator=gen, device=g.device)
    maxval = torch.clamp(g.abs().max(), min=1e-12)
    levels = (1 << (bits - 1)) - 1
    scaled = g / maxval * levels
    floor = torch.floor(scaled)
    q = floor + (u < scaled - floor)
    return q.to(torch.int32), maxval / levels


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Tree, bits: int = 8, *, u: Tree | None = None,
                  gen: torch.Generator | None = None) -> tuple[Tree, Tree]:
    """Quantize every leaf, with its own uniforms ``u[name]`` (or fresh ones
    from ``gen``); returns (q_tree, scales)."""
    qs, scales = {}, {}
    for k, g in grads.items():
        qs[k], scales[k] = quantize_grad(
            g, bits, u=None if u is None else u[k], gen=gen)
    return qs, scales


def decompress_tree(q_tree: Tree, scales: Tree) -> Tree:
    return {k: dequantize_grad(q, scales[k]) for k, q in q_tree.items()}
