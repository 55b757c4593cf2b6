"""Dispatch between the CUDA kernels and their plain versions.

A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel or raises.  The scan goes through its dispatcher ops
(``mamba_scan.scan_op``), on whose meta or fake tensors only the fake runs.
There is no fallback from a CUDA tensor to the plain version and no switch
that turns the kernels off.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels import coded_grad as _cg
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import modmatmul as _mm

__all__ = ["LAUNCHES", "PlainAB16ScanFn", "coded_grad", "modmatmul",
           "reset_launches", "selective_scan"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def modmatmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Exact (a @ b) mod p: a (M, K), b (K, N) int32 -> (M, N) int32."""
    if _on_cpu(a, b):
        return ref.modmatmul_ref(a, b, p)
    return _mm.modmatmul(a.contiguous(), b.contiguous(), p)


def coded_grad(x: torch.Tensor, w: torch.Tensor, cbar: torch.Tensor,
               p: int) -> torch.Tensor:
    """All N workers' f = X̃ᵀ ḡ(X̃ W̃) mod p: x (N, mk, d), w (N, d, c, r),
    cbar (r+1,) -> (N, d, c) int32."""
    if _on_cpu(x, w, cbar):
        return ref.coded_grad_workers_ref(x, w, cbar, p)
    return _cg.coded_grad(x.contiguous(), w, cbar, p)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor, ssm_dtype: str = "f32", chunk: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan: x, dt (B, S, di); bm, cm (B, S, n);
    a_log (di, n); d (di,); h0 (B, di, n) -> (y (B, S, di) float32,
    h_last (B, di, n) float32).  ``ssm_dtype="bf16"``: a and b rounded to
    bf16 and combined in chunks of ``chunk`` steps (``RunConfig``'s
    ``ssm_dtype`` and ``scan_chunk``).

    CPU tensors take the plain version: autograd differentiates the plain
    float32 scan, and in the bf16 a/b mode ``PlainAB16ScanFn`` pairs the
    plain forward with the plain backward, the function the backward
    kernel computes (float32 cotangents).  Any other tensor goes to the
    dispatcher op ``mamba_scan.scan_op`` (through ``SelectiveScanFn``,
    which pairs it with ``scan_bwd_op``, where a gradient is needed), and
    the dispatcher picks by device: a CUDA tensor launches the kernel, or
    the wrapper raises; a meta or fake tensor reaches the op's fake, which
    gives the outputs' shapes and dtypes and launches nothing."""
    _ms.check_mode(ssm_dtype, chunk)
    ins = (x, dt, bm, cm, a_log, d, h0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    if _on_cpu(*ins):
        if grad and ssm_dtype == "bf16":
            return PlainAB16ScanFn.apply(*ins, chunk)
        return ref.selective_scan_ref(*ins, ssm_dtype, chunk)
    if grad:
        return _ms.SelectiveScanFn.apply(*ins, ssm_dtype, chunk)
    return _ms.scan_op(*ins, ssm_dtype, chunk)


class PlainAB16ScanFn(torch.autograd.Function):
    """The bf16 a/b mode on CPU tensors: ``ref.selective_scan_ref`` with
    ``ref.selective_scan_bwd_ref`` as its gradient, each gradient in its
    input's dtype.  ``apply(x, dt, bm, cm, a_log, d, h0, chunk)``."""

    @staticmethod
    def forward(ctx, x, dt, bm, cm, a_log, d, h0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, bm, cm, a_log, d, h0)
        return ref.selective_scan_ref(x, dt, bm, cm, a_log, d, h0, "bf16",
                                      chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        ins = ctx.saved_tensors
        grads = ref.selective_scan_bwd_ref(*ins, dy, dh_last, "bf16",
                                           ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)), None)
