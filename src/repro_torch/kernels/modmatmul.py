"""Wrapper of the ``modmatmul`` CUDA kernel (``csrc/modmatmul.cu``).

Replaces ``repro/kernels/modmatmul.py::modmatmul``: exact (a @ b) mod p
for int32 field matrices.  Takes CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build


def modmatmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a (M, K), b (K, N) int32 in [0, p), contiguous, on one CUDA device
    -> (M, N) int32.  Launches on the current stream."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"modmatmul kernel needs CUDA tensors; {name} is "
                             f"on {t.device}")
        if t.dtype != torch.int32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"modmatmul kernel needs a contiguous 2-D int32 "
                             f"{name}, got {t.dtype} {tuple(t.shape)}")
    if a.device != b.device or a.shape[1] != b.shape[0]:
        raise ValueError(f"modmatmul shapes/devices {tuple(a.shape)}@{a.device}"
                         f" x {tuple(b.shape)}@{b.device}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.library("modmatmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.modmatmul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               M, K, N, p, build.reduce_every(p), stream)
    build.check(err, "modmatmul")
    kernels.LAUNCHES["modmatmul"] += 1
    return out
