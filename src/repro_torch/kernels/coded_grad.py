"""Wrapper of the ``coded_grad`` CUDA kernel (``csrc/coded_grad.cu``).

Replaces ``repro/kernels/coded_grad.py::coded_grad`` / ``coded_grad_mc``:
the fused worker step f = X̃ᵀ ḡ(X̃ W̃) mod p, here for all N workers in one
launch.  Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build

MAX_CR = 32   # c * r bound of the kernel's register arrays


def coded_grad(x: torch.Tensor, w: torch.Tensor, cbar: torch.Tensor,
               p: int) -> torch.Tensor:
    """x (N, mk, d), w (N, d, c, r), cbar (r+1,) int32 on one CUDA device
    -> (N, d, c) int32 in [0, p).  Launches on the current stream."""
    for name, t, nd in (("x", x, 3), ("w", w, 4), ("cbar", cbar, 1)):
        if t.device.type != "cuda":
            raise ValueError(f"coded_grad kernel needs CUDA tensors; {name} is "
                             f"on {t.device}")
        if t.dtype != torch.int32 or t.ndim != nd:
            raise ValueError(f"coded_grad kernel needs a {nd}-D int32 {name}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    N, mk, d = x.shape
    _, _, c, r = w.shape
    if (w.shape[:2] != (N, d) or cbar.shape[0] != r + 1 or c * r > MAX_CR
            or not x.is_contiguous() or w.device != x.device
            or cbar.device != x.device):
        raise ValueError(f"coded_grad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} cbar {tuple(cbar.shape)} "
                         f"(contiguous x, c*r <= {MAX_CR}, one device)")
    # W̃ transposed to (N, c*r, d) so the kernel's reads of it coalesce.
    wt = w.reshape(N, d, c * r).transpose(1, 2).contiguous()
    cb = cbar.contiguous()
    scratch = torch.empty((N, d, c), dtype=torch.int64, device=x.device)
    out = torch.empty((N, d, c), dtype=torch.int32, device=x.device)
    lib = build.library("coded_grad")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.coded_grad_launch(x.data_ptr(), wt.data_ptr(), cb.data_ptr(),
                                scratch.data_ptr(), out.data_ptr(),
                                N, mk, d, c, r, p, build.reduce_every(p),
                                stream)
    build.check(err, "coded_grad")
    kernels.LAUNCHES["coded_grad"] += 1
    return out
