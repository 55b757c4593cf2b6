"""Deterministic synthetic datasets (offline stand-ins for MNIST).

Mirrors the distributions of ``repro/data/synthetic.py`` with a numpy
``Generator``: the same distribution, not the same bits.  Sparse
non-negative pixel-like features in [0, 1] with a planted linear
separator; the paper's binary MNIST task is (m, d) = (12396, 1568).
Returns float32 numpy arrays; the caller puts them on its device.

``lm_batch`` and ``feature_probe_data`` return torch tensors, drawn from a
``torch.Generator`` or taken through the randomness seam (their tokens,
normals and uniforms as explicit arguments), so the parity tests feed
them the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import numpy as np
import torch


def _pixels(rng: np.random.Generator, m: int, d: int, sparsity: float
            ) -> np.ndarray:
    x = rng.random((m, d), dtype=np.float32)
    mask = rng.random((m, d), dtype=np.float32) > sparsity
    return np.where(mask, x, np.float32(0.0))        # mostly-zero "pixels"


def mnist_like(seed: int, m: int = 12396, d: int = 784,
               sparsity: float = 0.8, margin: float = 4.0
               ) -> tuple[np.ndarray, np.ndarray]:
    """Binary classification with pixel-like features.  Returns (X, y)."""
    rng = np.random.default_rng(seed)
    x = _pixels(rng, m, d, sparsity)
    w_true = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    logits = margin * (x @ w_true)
    logits = logits - np.median(logits)              # balanced classes
    p1 = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(m) < p1).astype(np.float32)
    return x, y


def multiclass_mnist_like(seed: int, m: int = 12396, d: int = 784,
                          c: int = 10, sparsity: float = 0.8,
                          margin: float = 6.0
                          ) -> tuple[np.ndarray, np.ndarray]:
    """c-class task: labels sampled from a softmax over c planted linear
    scores (Gumbel-max).  Returns (X, int32 labels)."""
    rng = np.random.default_rng(seed)
    x = _pixels(rng, m, d, sparsity)
    w_true = (rng.standard_normal((d, c)) / np.sqrt(d)).astype(np.float32)
    logits = margin * (x @ w_true)
    gumbel = -np.log(-np.log(rng.random((m, c)) + 1e-20) + 1e-20)
    labels = np.argmax(logits + gumbel, axis=1).astype(np.int32)
    return x, labels


def lm_batch(batch: int, seq: int, vocab: int, *,
             tokens: torch.Tensor | None = None,
             gen: torch.Generator | None = None,
             device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Synthetic next-token-prediction batch (tokens + shifted labels):
    ``tokens`` (batch, seq + 1) in [0, vocab), or int32 draws from
    ``gen``."""
    if tokens is None:
        tokens = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                               dtype=torch.int32, device=device)
    tokens = torch.as_tensor(tokens, device=device)
    if tuple(tokens.shape) != (batch, seq + 1):
        raise ValueError(f"lm_batch tokens {tuple(tokens.shape)}, expected "
                         f"{(batch, seq + 1)}")
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def feature_probe_data(m: int, d_feat: int, *,
                       draws: tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor] | None = None,
                       gen: torch.Generator | None = None,
                       device: torch.device | str = "cpu"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen-LM-feature probe task: features N(0, 1)/sqrt(d_feat) shifted
    by 0.5 and clipped to [0, 1] (like post-GeLU features), binary labels
    from a planted separator through a sigmoid.  ``draws`` = (standard
    normals (m, d_feat), standard normals (d_feat,), uniforms (m,)), or
    drawn from ``gen``.  Returns (X (m, d_feat), y (m,)) float32."""
    if draws is None:
        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device)
        draws = (normal(m, d_feat), normal(d_feat),
                 torch.rand((m,), generator=gen, device=device))
    z, w_true, u = (torch.as_tensor(t, dtype=torch.float32, device=device)
                    for t in draws)
    x = torch.clamp(z / np.sqrt(d_feat) + 0.5, 0.0, 1.0)
    y = (u < torch.sigmoid(4.0 * (x @ w_true))).to(torch.float32)
    return x, y
