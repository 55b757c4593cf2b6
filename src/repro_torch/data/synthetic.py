"""Deterministic synthetic datasets (offline stand-ins for MNIST).

Mirrors the distributions of ``repro/data/synthetic.py`` with a numpy
``Generator``: the same distribution, not the same bits.  Sparse
non-negative pixel-like features in [0, 1] with a planted linear
separator; the paper's binary MNIST task is (m, d) = (12396, 1568).
Returns float32 numpy arrays; the caller puts them on its device.
"""
from __future__ import annotations

import numpy as np


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
