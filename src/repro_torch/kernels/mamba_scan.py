"""Wrappers of the ``selective_scan`` CUDA kernel (``csrc/mamba_scan.cu``)
and of its gradient (``csrc/mamba_scan_bwd.cu``), and ``SelectiveScanFn``,
the autograd function that joins them.

``selective_scan`` replaces ``repro/kernels/mamba_scan.py::selective_scan``:
the fused Mamba-1 selective scan, h in registers across the whole
sequence; with ``ssm_dtype="bf16"`` the reference model's bf16 a/b chunked
scan (``RunConfig.ssm_dtype``).  ``selective_scan_bwd`` is the port's own:
the reference trains through its plain jnp scan.  Both take CUDA tensors
only; ``kernels/ops.py`` sends CPU tensors to the plain versions.
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


def _check(kernel: str, named: tuple[tuple[str, torch.Tensor], ...]
           ) -> tuple[int, int, int, int]:
    """Refuse what the kernel does not take: ``named`` holds x, dt, bm, cm,
    a_log, d, h0 (then dy (B, S, di) and dh_last (B, di, n) for the
    gradient), float tensors on one CUDA device.  Returns (B, S, di, n)."""
    x = named[0][1]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel needs CUDA tensors; {name}"
                             f" is on {t.device}")
        if not t.is_floating_point() or t.device != x.device:
            raise ValueError(f"{kernel} kernel needs float tensors on one"
                             f" device; {name} is {t.dtype} on {t.device}")
    if x.ndim != 3:
        raise ValueError(f"{kernel} x must be (B, S, di), got "
                         f"{tuple(x.shape)}")
    B, S, di = x.shape
    n = named[2][1].shape[-1]
    want = {"dt": (B, S, di), "bm": (B, S, n), "cm": (B, S, n),
            "a_log": (di, n), "d": (di,), "h0": (B, di, n), "dy": (B, S, di),
            "dh_last": (B, di, n)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{kernel} {name} {tuple(t.shape)}, expected "
                             f"{want[name]} for x {tuple(x.shape)}")
    if min(B, S, di, n) < 1 or n > MAX_STATE or B > 65535:
        raise ValueError(f"{kernel} needs B, S, di >= 1, 1 <= n <= "
                         f"{MAX_STATE} and B <= 65535; got B={B} S={S} di={di} "
                         f"n={n}")
    return B, S, di, n


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
    B, S, di, n = _check("selective_scan", (
        ("x", x), ("dt", dt), ("bm", bm), ("cm", cm), ("a_log", a_log),
        ("d", d), ("h0", h0)))
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


# csrc/mamba_scan_bwd.cu's kCh and kL: channels a block (one partial of dB
# and dC each) and steps between the state checkpoints; the kernel refuses
# other values
BWD_CHANNELS = 64
BWD_CHUNK = 16


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The float32 scan's gradient: the forward's inputs, dy (B, S, di) and
    dh_last (B, di, n), on one CUDA device -> (dx, ddt (B, S, di); dbm, dcm
    (B, S, n); da_log (di, n); dd (di,); dh0 (B, di, n)), as
    ``ref.selective_scan_bwd_ref`` computes them.  Launches on the current
    stream.

    x and dt are read as the forward reads them (``operands``), and dx and
    ddt are written in that dtype: bfloat16 when x and dt both are
    (computed in float32, rounded to nearest even), else float32.  The
    other gradients are float32.  The kernel
    writes its sums over channels (dbm, dcm) as one partial a block of
    ``BWD_CHANNELS`` channels and its sums over time (da_log, dd) as one
    partial a batch row; ``torch.sum`` folds them, so the result is the
    same whatever order the blocks run in.  Scratch: the state at every
    ``BWD_CHUNK``-th step, B * ceil(S / 16) * 16 * di floats.
    """
    B, S, di, n = _check("selective_scan_bwd", (
        ("x", x), ("dt", dt), ("bm", bm), ("cm", cm), ("a_log", a_log),
        ("d", d), ("h0", h0), ("dy", dy), ("dh_last", dh_last)))
    x, dt, bc = operands(x, dt, bm, cm)
    f32 = [t.float().contiguous() for t in (a_log, d, h0, dy, dh_last)]
    dev = x.device
    blocks = -(-di // BWD_CHANNELS)
    hck = torch.empty((B, -(-S // BWD_CHUNK), MAX_STATE, di),
                      dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, di), dtype=x.dtype, device=dev)
    ddt = torch.empty_like(dx)
    dbc = torch.empty((blocks, B, S, 2, MAX_STATE), dtype=torch.float32,
                      device=dev)
    da = torch.empty((B, di, n), dtype=torch.float32, device=dev)
    dd = torch.empty((B, di), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, di, n), dtype=torch.float32, device=dev)
    lib = build.library("mamba_scan_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mamba_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), bc.data_ptr(),
        *(t.data_ptr() for t in f32),
        *(t.data_ptr() for t in (hck, dx, ddt, dbc, da, dd, dh0)),
        B, S, di, n, int(x.dtype == torch.bfloat16), BWD_CHANNELS, BWD_CHUNK,
        stream)
    build.check(err, "selective_scan_bwd")
    kernels.LAUNCHES["selective_scan_bwd"] += 1
    dbc = dbc.sum(0)
    return (dx, ddt, dbc[:, :, 0, :n], dbc[:, :, 1, :n], da.sum(0), dd.sum(0),
            dh0)


class SelectiveScanFn(torch.autograd.Function):
    """``selective_scan`` with its gradient, ``selective_scan_bwd``, on CUDA
    tensors (``kernels/ops.py`` lets autograd differentiate the plain
    version on the CPU).  The gradients come back in their inputs' dtypes:
    the kernel writes bfloat16 dx and ddt when x and dt are both bfloat16
    (the model's path), and the rest are cast from float32.  Under
    ``torch.utils.checkpoint`` the forward runs twice a step and its saved
    inputs go with each run's context.

    ``apply(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk)`` ->
    (y, h_last).  The bf16 a/b mode's backward is not written: it raises.
    """

    @staticmethod
    def forward(ctx, x, dt, bm, cm, a_log, d, h0, ssm_dtype="f32", chunk=0):
        check_mode(ssm_dtype, chunk)
        ctx.ssm_dtype = ssm_dtype
        ctx.save_for_backward(x, dt, bm, cm, a_log, d, h0)
        return selective_scan(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        if ctx.ssm_dtype != "f32":
            raise NotImplementedError(
                "the selective scan's backward in the bf16 a/b mode "
                "(ssm_dtype='bf16') is not ported: ROADMAP.md list 1b item 8; "
                "train with RunConfig's default ssm_dtype='f32'")
        ins = ctx.saved_tensors
        grads = selective_scan_bwd(*ins, dy, dh_last)
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)), None, None)
