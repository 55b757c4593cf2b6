"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU.  A missing GPU
is an error, never a silent CPU run.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for but absent.
    ``meta`` (shapes only, nothing allocated) is taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run the plain CPU path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
