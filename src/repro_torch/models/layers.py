"""Substrate layers; mirrors ``repro/models/layers.py``.

The parameter template leaf, ``rmsnorm`` (the mamba path) and
``gelu_mlp`` (the ALCC MLP).  Attention, the other MLPs and rope wait for
the dense and hybrid slice (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ParamSpec(NamedTuple):
    """Template leaf: shape + logical axis names + dtype + init.

    The logical axis names are the reference's sharding hints, kept as
    documentation (the port runs on one device).  Leaves left at the
    default bf16 take the model's parameter dtype (``models/model.py``);
    leaves that name float32 stay float32.
    """
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"      # normal | zeros | ones


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    """gelu(x @ w1) @ w2 with the tanh gelu, ``jax.nn.gelu``'s default."""
    return torch.nn.functional.gelu(x @ w1, approximate="tanh") @ w2
