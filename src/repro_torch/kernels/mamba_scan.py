"""Wrapper of the ``selective_scan`` CUDA kernel (``csrc/mamba_scan.cu``).

Replaces ``repro/kernels/mamba_scan.py::selective_scan``: the fused
Mamba-1 selective scan, h in registers across the whole sequence; with
``ssm_dtype="bf16"`` the reference model's bf16 a/b chunked scan
(``RunConfig.ssm_dtype``).  Takes CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build

MAX_STATE = 16   # the kernel keeps 16 states in registers; n <= 16 are live


def operands(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """x and dt in the one dtype the kernel reads them in, and Bm, Cm packed
    into the (B, S, 2, MAX_STATE) float32 tensor it stages, zero past n.

    x and dt stay bfloat16 when both are (the serve path); otherwise both
    are widened to float32, which is exact for bfloat16.
    """
    same_bf16 = x.dtype == dt.dtype == torch.bfloat16
    x, dt = (t.contiguous() if same_bf16 or t.dtype == torch.float32
             else t.float().contiguous() for t in (x, dt))
    B, S, n = bm.shape
    bc = torch.empty((B, S, 2, MAX_STATE), dtype=torch.float32,
                     device=x.device)
    bc[:, :, 0, :n] = bm
    bc[:, :, 1, :n] = cm
    if n < MAX_STATE:
        bc[..., n:] = 0
    return x, dt, bc


def check_mode(ssm_dtype: str, chunk: int) -> None:
    """``ssm_dtype`` "f32" (the float32 recurrence) or "bf16" (a and b
    rounded to bf16 and combined in chunks of ``chunk`` >= 1 steps)."""
    if ssm_dtype not in ("f32", "bf16"):
        raise ValueError(f"selective_scan ssm_dtype must be 'f32' or 'bf16', "
                         f"got {ssm_dtype!r}")
    if ssm_dtype == "bf16" and chunk < 1:
        raise ValueError(f"selective_scan ssm_dtype='bf16' needs chunk >= 1, "
                         f"got {chunk}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor, ssm_dtype: str = "f32", chunk: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, S, di); bm, cm (B, S, n); a_log (di, n); d (di,);
    h0 (B, di, n), on one CUDA device -> (y (B, S, di), h_last (B, di, n)),
    both float32.  Launches on the current stream.  ``ssm_dtype="bf16"``
    runs the bf16 a/b mode in chunks of ``chunk`` steps (``check_mode``).

    x and dt are read as bfloat16 when both are, so the serve path hands
    over its bfloat16 dt without a float32 copy; any other pair is read as
    float32 (``operands``).  Bm and Cm (slices of one projection) are
    packed into one zero-padded (B, S, 2, 16) float32 tensor; a_log, d and
    h0 are cast to contiguous float32.
    """
    named = (("x", x), ("dt", dt), ("bm", bm), ("cm", cm), ("a_log", a_log),
             ("d", d), ("h0", h0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"selective_scan kernel needs CUDA tensors; {name}"
                             f" is on {t.device}")
        if not t.is_floating_point() or t.device != x.device:
            raise ValueError(f"selective_scan kernel needs float tensors on one"
                             f" device; {name} is {t.dtype} on {t.device}")
    if x.ndim != 3:
        raise ValueError(f"selective_scan x must be (B, S, di), got "
                         f"{tuple(x.shape)}")
    B, S, di = x.shape
    n = bm.shape[-1]
    want = {"dt": (B, S, di), "bm": (B, S, n), "cm": (B, S, n),
            "a_log": (di, n), "d": (di,), "h0": (B, di, n)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan {name} {tuple(t.shape)}, expected "
                             f"{want[name]} for x {tuple(x.shape)}")
    if min(B, S, di, n) < 1 or n > MAX_STATE or B > 65535:
        raise ValueError(f"selective_scan needs B, S, di >= 1, 1 <= n <= "
                         f"{MAX_STATE} and B <= 65535; got B={B} S={S} di={di} "
                         f"n={n}")
    check_mode(ssm_dtype, chunk)
    x, dt, bc = operands(x, dt, bm, cm)
    f32 = [t.float().contiguous() for t in (a_log, d, h0)]
    # cp.async moves 16-byte chunks of x and dt rows when they allow it
    vec = di % 8 == 0 and x.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, n), dtype=torch.float32, device=x.device)
    lib = build.library("mamba_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mamba_scan_launch(x.data_ptr(), dt.data_ptr(), bc.data_ptr(),
                                *(t.data_ptr() for t in f32),
                                y.data_ptr(), h_last.data_ptr(), B, S, di, n,
                                int(x.dtype == torch.bfloat16), int(vec),
                                int(ssm_dtype == "bf16"), min(chunk, S),
                                stream)
    build.check(err, "selective_scan")
    kernels.LAUNCHES["selective_scan"] += 1
    return y, h_last
