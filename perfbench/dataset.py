"""The benchmark's dataset, made on the device from the seed.

A torch rewrite of the port's synthetic recipes (``data/synthetic.py``:
``multiclass_mnist_like``, and ``mnist_like`` for one head): sparse
non-negative pixel-like features in [0, 1) with planted linear scores, a
stand-in for the paper's MNIST subset.  The same distribution, not the same
bits.  One ``torch.Generator`` on the device, a few large calls.
"""
from __future__ import annotations

import math

import torch

from perfbench.references.cpml_round import seed_of


def make(seed: int, m: int, d: int, c: int, sparsity: float, margin: float,
         device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x (m, d) float32, y (m,)): int32 class ids from a Gumbel-max over
    c planted scores when c > 1, else 0/1 float32 labels through a sigmoid
    of the planted score less its median."""
    g = torch.Generator(device=device).manual_seed(seed_of("perfbench-data",
                                                           int(seed)))
    x = torch.rand((m, d), generator=g, device=device)
    keep = torch.rand((m, d), generator=g, device=device) > sparsity
    x = torch.where(keep, x, torch.zeros((), device=device))
    if c == 1:
        w_true = torch.randn((d,), generator=g, device=device) / math.sqrt(d)
        logits = margin * (x @ w_true)
        logits = logits - torch.median(logits)
        u = torch.rand((m,), generator=g, device=device)
        return x, (u < torch.sigmoid(logits)).to(torch.float32)
    w_true = torch.randn((d, c), generator=g, device=device) / math.sqrt(d)
    logits = margin * (x @ w_true)
    u = torch.rand((m, c), generator=g, device=device)
    gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return x, torch.argmax(logits + gumbel, dim=1).to(torch.int32)
