"""Wrappers of the ``selective_scan`` CUDA kernel (``csrc/mamba_scan.cu``)
and of its gradient (``csrc/mamba_scan_bwd.cu``), and ``SelectiveScanFn``,
the autograd function that joins them.

``selective_scan`` replaces ``repro/kernels/mamba_scan.py::selective_scan``:
the fused Mamba-1 selective scan, h in registers across the whole
sequence; with ``ssm_dtype="bf16"`` the reference model's bf16 a/b chunked
scan (``RunConfig.ssm_dtype``).  ``selective_scan_bwd`` is the port's own,
in both modes: the reference trains through its plain jnp scan.  Both take
CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the plain
versions.

Each is also a dispatcher op, ``torch.ops.repro_torch.selective_scan`` and
``torch.ops.repro_torch.selective_scan_bwd`` (``scan_op``, ``scan_bwd_op``,
each with a fake), so that the scan is one op to whatever watches the
dispatcher (``launch/hlo_analysis.py``, ``torch.utils.flop_counter``).
The dispatcher picks by the tensors' device: CUDA tensors run the
wrapper, which launches the kernel as above; meta and fake tensors run
the op's fake, which only gives the outputs' shapes and dtypes (the dry
run, ``launch/dryrun.py``); a CPU tensor has no kernel there
(``kernels/ops.py`` never sends one).  Each op has a flop formula
(``register_flop_formula``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.modmatmul import SMS, sm_count

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


# csrc/mamba_scan_bwd.cu's layout, which the kernel refuses to change:
# channels a block (one dB/dC partial each), threads a block (a quad of 4
# states a channel), steps a sub-chunk (a tile of the ring and the history
# kept in shared memory), most steps a chunk, tiles in the ring
BWD_CHANNELS = 32
BWD_THREADS = 4 * BWD_CHANNELS
BWD_SUB = 8
BWD_MAX_CHUNK = 256
BWD_STAGES = 2
# The plan's chunks, largest first: 64 steps keeps five blocks on an SM
BWD_CHUNKS = (64, 32, 16, 8)
# Blocks an SM that the chunk kernel's registers allow: its __launch_bounds__
# (kMinBlocks) holds it to 65536 / (5 * 128) = 102 registers a thread
BWD_REG_BLOCKS = 5
SM_SMEM = 233_472         # shared memory an SM gives its blocks (228 KB)
BLOCK_SMEM_RESERVED = 1024  # the system's share of it, per block
MAX_GRID_YZ = 65535
MAX_GRID_X = 2 ** 31 - 1


def bwd_smem(chunk: int, xbytes: int) -> int:
    """The chunk kernel's dynamic shared memory for ``chunk`` steps and x,
    dt of ``xbytes`` bytes (2 bf16, 4 float32): a ring of BWD_STAGES tiles
    (BWD_SUB steps of B_t/C_t, x, dt and dy), the history of a sub-chunk,
    the warps' dB/dC sums and one checkpoint a sub-chunk but the last (16
    bytes a thread each: 4 states of h, or in the bf16 a/b mode 4 pairs of
    the running products A_c, B_c in bf16)."""
    tile = BWD_SUB * (2 * MAX_STATE * 4 + BWD_CHANNELS * (2 * xbytes + 4))
    hist = BWD_SUB * BWD_THREADS * 16
    red = BWD_THREADS // 32 * BWD_SUB * 2 * MAX_STATE * 4
    return BWD_STAGES * tile + hist + red + chunk // BWD_SUB * BWD_THREADS * 16


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's launch: chunks of ``chunk`` steps, a grid of
    (``blocks`` channel blocks, ``chunks``, B) blocks of BWD_THREADS for the
    summary and chunk kernels (the carry kernel: one thread per (b, i, j)),
    ``smem`` bytes of dynamic shared memory for the chunk kernel and
    ``per_sm`` of its blocks on an SM, as its shared memory and registers
    allow.

    ``ab_chunk`` > 0: the bf16 a/b mode, whose own chunks of ``ab_chunk``
    (at most S) steps the plan's chunks never span: each of the mode's
    chunks is ``per_ab`` plan chunks of ``chunk`` steps (its last one
    shorter), and the grid is (blocks * chunks, 1, B), channel blocks
    fastest, so that any number of chunks fits; the summary kernel runs
    one block per (channel block, mode chunk)."""
    B: int
    S: int
    di: int
    xbytes: int
    chunk: int
    ab_chunk: int = 0

    @property
    def per_ab(self) -> int:
        return -(-self.ab_chunk // self.chunk) if self.ab_chunk else 1

    @property
    def ab_chunks(self) -> int:
        return -(-self.S // self.ab_chunk) if self.ab_chunk else 0

    @property
    def chunks(self) -> int:
        if self.ab_chunk:
            return self.ab_chunks * self.per_ab
        return -(-self.S // self.chunk)

    @property
    def blocks(self) -> int:
        return -(-self.di // BWD_CHANNELS)

    @property
    def grid(self) -> tuple[int, int, int]:
        if self.ab_chunk:
            return (self.blocks * self.chunks, 1, self.B)
        return (self.blocks, self.chunks, self.B)

    @property
    def threads(self) -> int:
        return self.blocks * self.chunks * self.B * BWD_THREADS

    @property
    def smem(self) -> int:
        return bwd_smem(self.chunk, self.xbytes)

    @property
    def per_sm(self) -> int:
        return min(SM_SMEM // (self.smem + BLOCK_SMEM_RESERVED),
                   BWD_REG_BLOCKS)

    @property
    def scratch(self) -> dict[str, tuple[int, ...]]:
        """float32 buffers.  The float32 mode: the summaries, then the
        carries (hcar, gcar), each chunk's dt sum, and the partials
        ``torch.sum`` folds.  The bf16 a/b mode, per mode chunk: B_c and
        A_c at its last step, then the state entering it (hcar; acar), its
        adjoint sum, then the carry into its last step (gcar); where a mode
        chunk is split (``per_ab`` > 1), per plan chunk: A_c, B_c entering
        it as bf16 pairs (abseg), its product of a_t (pseg), its adjoint
        sum, then the carry into its last step (gseg); the partials."""
        B, S, di, nck = self.B, self.S, self.di, self.chunks
        part = {"dbc_part": (self.blocks, B, S, 2, MAX_STATE),
                "da_part": (B, nck, di, MAX_STATE), "dd_part": (B, nck, di)}
        if not self.ab_chunk:
            return {"hcar": (B, nck, di, MAX_STATE),
                    "gcar": (B, nck, di, MAX_STATE), "dsum": (B, nck, di),
                    **part}
        car = (B, self.ab_chunks, di, MAX_STATE)
        out = {"hcar": car, "acar": car, "gcar": car}
        if self.per_ab > 1:
            seg = (B, nck, di, MAX_STATE)
            out.update(abseg=seg, pseg=seg, gseg=seg)
        return {**out, **part}


@functools.lru_cache(maxsize=256)
def plan_bwd(B: int, S: int, di: int, xbytes: int, sms: int = SMS,
             chunk: int | None = None, ab_chunk: int = 0) -> BwdPlan:
    """The backward's launch on a card of ``sms`` SMs: the largest of
    BWD_CHUNKS whose grid covers the SMs twice at the chunk kernel's
    occupancy (the smallest when none does), or ``chunk`` itself, a
    multiple of BWD_SUB up to BWD_MAX_CHUNK, where a check forces it.

    ``ab_chunk`` >= 1: the bf16 a/b mode in chunks of ``ab_chunk`` steps.
    A plan chunk is then min(L, M) for the mode's chunk M = min(ab_chunk,
    S), so that M <= L keeps one plan chunk a mode chunk, of any length;
    a forced ``chunk`` may also be one of at least M steps."""
    if ab_chunk:
        M = min(ab_chunk, S)
        if chunk is not None and not (
                1 <= chunk <= BWD_MAX_CHUNK
                and (chunk % BWD_SUB == 0 or chunk >= M)):
            raise ValueError(f"selective_scan_bwd chunk must be a multiple of "
                             f"{BWD_SUB} up to {BWD_MAX_CHUNK}, or at least "
                             f"the mode's chunk {M} and at most "
                             f"{BWD_MAX_CHUNK}, got {chunk}")
        for L in ((chunk,) if chunk is not None else BWD_CHUNKS):
            pl = BwdPlan(B, S, di, xbytes, min(L, M), M)
            if pl.blocks * pl.chunks * B >= 2 * sms * pl.per_sm:
                break
        if pl.blocks * max(pl.chunks, pl.ab_chunks) > MAX_GRID_X:
            raise ValueError(f"selective_scan_bwd: S={S} needs {pl.chunks} "
                             f"chunks of {pl.chunk} on {pl.blocks} channel "
                             f"blocks, more than {MAX_GRID_X} blocks")
        return pl
    if chunk is not None:
        if chunk < 1 or chunk % BWD_SUB or chunk > BWD_MAX_CHUNK:
            raise ValueError(f"selective_scan_bwd chunk must be a multiple of "
                             f"{BWD_SUB} up to {BWD_MAX_CHUNK}, got {chunk}")
        pl = BwdPlan(B, S, di, xbytes, chunk)
    else:
        for L in BWD_CHUNKS:
            pl = BwdPlan(B, S, di, xbytes, L)
            if pl.blocks * pl.chunks * B >= 2 * sms * pl.per_sm:
                break
    if pl.chunks > MAX_GRID_YZ:
        raise ValueError(f"selective_scan_bwd: S={S} needs {pl.chunks} chunks "
                         f"of {pl.chunk}, more than {MAX_GRID_YZ}")
    return pl


def bwd_buffers(pl: BwdPlan, device) -> dict[str, torch.Tensor]:
    """The plan's scratch (``BwdPlan.scratch``), uninitialised float32."""
    return {k: torch.empty(v, dtype=torch.float32, device=device)
            for k, v in pl.scratch.items()}


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                       h0: torch.Tensor, dy: torch.Tensor,
                       dh_last: torch.Tensor, ssm_dtype: str = "f32",
                       chunk: int = 0) -> tuple[torch.Tensor, ...]:
    """The scan's gradient: the forward's inputs, dy (B, S, di) and
    dh_last (B, di, n), on one CUDA device -> (dx, ddt (B, S, di); dbm, dcm
    (B, S, n); da_log (di, n); dd (di,); dh0 (B, di, n)), as
    ``ref.selective_scan_bwd_ref`` computes them, in the forward's mode
    (``ssm_dtype``, ``chunk``: ``check_mode``).  Launches three kernels
    on the current stream (``csrc/mamba_scan_bwd.cu``: the chunks'
    summaries, the carries between chunks, each chunk's backward) with
    ``plan_bwd``'s chunks, then ``torch.sum`` folds the partials.

    x and dt are read as the forward reads them (``operands``), and dx and
    ddt are written in that dtype: bfloat16 when x and dt both are
    (computed in float32, rounded to nearest even), else float32.  The
    other gradients are float32.  The kernel writes its sums over channels
    (dbm, dcm) as one partial a block of ``BWD_CHANNELS`` channels and its
    sums over time (da_log, dd) as one partial a (batch row, chunk); the
    folds do not depend on the order the blocks run in, so two calls give
    the same bits.  Scratch: ``BwdPlan.scratch``.
    """
    return run_bwd(None, x, dt, bm, cm, a_log, d, h0, dy, dh_last, ssm_dtype,
                   chunk)


def run_bwd(plan_chunk: int | None, x: torch.Tensor, dt: torch.Tensor,
            bm: torch.Tensor, cm: torch.Tensor, a_log: torch.Tensor,
            d: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
            dh_last: torch.Tensor, ssm_dtype: str = "f32", chunk: int = 0
            ) -> tuple[torch.Tensor, ...]:
    """``selective_scan_bwd`` with the plan's chunk forced to
    ``plan_chunk`` (None: ``plan_bwd``'s own), as a check forces one."""
    B, S, di, n = _check("selective_scan_bwd", (
        ("x", x), ("dt", dt), ("bm", bm), ("cm", cm), ("a_log", a_log),
        ("d", d), ("h0", h0), ("dy", dy), ("dh_last", dh_last)))
    check_mode(ssm_dtype, chunk)
    ab_chunk = min(chunk, S) if ssm_dtype == "bf16" else 0
    x, dt, bc = operands(x, dt, bm, cm)
    f32 = [t.float().contiguous() for t in (a_log, d, h0, dy, dh_last)]
    dev = x.device
    pl = plan_bwd(B, S, di, x.element_size(), sm_count(dev), plan_chunk,
                  ab_chunk)
    buf = bwd_buffers(pl, dev)
    dx = torch.empty((B, S, di), dtype=x.dtype, device=dev)
    ddt = torch.empty_like(dx)
    dh0 = torch.empty((B, di, n), dtype=torch.float32, device=dev)
    # cp.async moves 16-byte chunks of x, dt and dy rows when they allow it
    vec = di % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, dt, f32[3]))
    lib = build.library("mamba_scan_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [buf[k].data_ptr() if k in buf else None
           for k in ("hcar", "gcar", "dsum", "acar", "abseg", "pseg", "gseg")]
    err = lib.mamba_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), bc.data_ptr(),
        *(t.data_ptr() for t in f32), *ptr[:3],
        dx.data_ptr(), ddt.data_ptr(),
        *(buf[k].data_ptr() for k in ("dbc_part", "da_part", "dd_part")),
        dh0.data_ptr(), *ptr[3:], B, S, di, n, int(x.dtype == torch.bfloat16),
        int(vec), BWD_CHANNELS, pl.chunk, pl.smem, ab_chunk, stream)
    build.check(err, "selective_scan_bwd")
    kernels.LAUNCHES["selective_scan_bwd"] += 1
    dbc = buf["dbc_part"].sum(0)
    return (dx, ddt, dbc[:, :, 0, :n], dbc[:, :, 1, :n],
            buf["da_part"].sum((0, 1))[:, :n], buf["dd_part"].sum((0, 1)), dh0)


# ---------------------------------------------------------------------------
# dispatcher ops
# ---------------------------------------------------------------------------

# Defined with ``torch.library.define`` and ``impl``: ``custom_op`` runs a
# kernel through ``torch._disable_dynamo``, whose first call imports
# ``torch._dynamo``, seconds in every process that runs the scan.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("selective_scan(Tensor x, Tensor dt, Tensor bm, Tensor cm, "
            "Tensor a_log, Tensor d, Tensor h0, str ssm_dtype, int chunk) "
            "-> (Tensor, Tensor)")
_LIB.define("selective_scan_bwd(Tensor x, Tensor dt, Tensor bm, Tensor cm, "
            "Tensor a_log, Tensor d, Tensor h0, Tensor dy, Tensor dh_last, "
            "str ssm_dtype, int chunk) -> (Tensor, Tensor, Tensor, Tensor, "
            "Tensor, Tensor, Tensor)")


@torch.library.impl("repro_torch::selective_scan", "cuda", lib=_LIB)
def _scan_cuda(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk):
    """``selective_scan`` as the op ``repro_torch::selective_scan``: (y
    (B, S, di), h_last (B, di, n)), both float32, the kernel launched.
    Its flops: ``scan_flops``."""
    return selective_scan(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk)


@torch.library.register_fake("repro_torch::selective_scan", lib=_LIB)
def _scan_fake(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk):
    B, S, di = x.shape
    n = bm.shape[-1]
    return (x.new_empty((B, S, di), dtype=torch.float32),
            x.new_empty((B, di, n), dtype=torch.float32))


@torch.library.impl("repro_torch::selective_scan_bwd", "cuda", lib=_LIB)
def _scan_bwd_cuda(x, dt, bm, cm, a_log, d, h0, dy, dh_last, ssm_dtype,
                   chunk):
    """``selective_scan_bwd`` as the op ``repro_torch::selective_scan_bwd``:
    (dx, ddt, dbm, dcm, da_log, dd, dh0), dx and ddt in x's read dtype
    (``operands``), the rest float32, the kernels launched.  dbm and dcm
    are copied out of the kernel's one (B, S, 2, n) fold, since an op's
    outputs do not alias each other.  Its flops: ``scan_bwd_flops``."""
    g = selective_scan_bwd(x, dt, bm, cm, a_log, d, h0, dy, dh_last,
                           ssm_dtype, chunk)
    return (g[0], g[1], g[2].clone(), g[3].clone(), *g[4:])


@torch.library.register_fake("repro_torch::selective_scan_bwd", lib=_LIB)
def _scan_bwd_fake(x, dt, bm, cm, a_log, d, h0, dy, dh_last, ssm_dtype,
                   chunk):
    xdt = (torch.bfloat16 if x.dtype == dt.dtype == torch.bfloat16
           else torch.float32)
    B, S, di = x.shape
    n = bm.shape[-1]

    def f32(*shape):
        return x.new_empty(shape, dtype=torch.float32)

    return (x.new_empty((B, S, di), dtype=xdt),
            x.new_empty((B, S, di), dtype=xdt), f32(B, S, n), f32(B, S, n),
            f32(di, n), f32(di), f32(B, di, n))


# the ops as callables: CUDA tensors launch the kernels, meta and fake
# tensors reach the fakes
scan_op = torch.ops.repro_torch.selective_scan.default
scan_bwd_op = torch.ops.repro_torch.selective_scan_bwd.default


def scan_flops(B: int, S: int, di: int, n: int) -> int:
    """The forward op's flops: the recurrence h <- exp(dt a) h + dt b x and
    the readout y <- y + c h are one multiply-add each a (b, s, i, j), the
    skip y <- y + d x one a (b, s, i); 2 flops a multiply-add, so
    2 (2 B S di n + B S di)."""
    return 2 * (2 * B * S * di * n + B * S * di)


def scan_bwd_flops(B: int, S: int, di: int, n: int) -> int:
    """The backward op's flops: the forward's state again, the adjoint
    g <- exp(dt a) g + c dy, and the sums into db, dc and da, one
    multiply-add each a (b, s, i, j); dx and dd one each a (b, s, i); so
    2 (5 B S di n + 2 B S di)."""
    return 2 * (5 * B * S * di * n + 2 * B * S * di)


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _scan_flop_formula(x_shape, dt_shape, bm_shape, *args, out_shape=None,
                       **kwargs) -> int:
    return scan_flops(*x_shape, bm_shape[-1])


@register_flop_formula(torch.ops.repro_torch.selective_scan_bwd)
def _scan_bwd_flop_formula(x_shape, dt_shape, bm_shape, *args,
                           out_shape=None, **kwargs) -> int:
    return scan_bwd_flops(*x_shape, bm_shape[-1])


class SelectiveScanFn(torch.autograd.Function):
    """``scan_op`` with its gradient, ``scan_bwd_op``, in either mode
    (``kernels/ops.py`` sends CPU tensors to the plain versions).  On CUDA
    tensors the two ops launch the kernels; on meta or fake tensors they
    reach their fakes and nothing else.  The gradients come back in their
    inputs' dtypes: the kernel writes bfloat16 dx and ddt when x and dt
    are both bfloat16 (the model's path), and the rest are cast from
    float32.  Under ``torch.utils.checkpoint`` the forward runs twice a
    step and its saved inputs go with each run's context.

    ``apply(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk)`` ->
    (y, h_last).
    """

    @staticmethod
    def forward(ctx, x, dt, bm, cm, a_log, d, h0, ssm_dtype="f32", chunk=0):
        check_mode(ssm_dtype, chunk)
        ctx.mode = (ssm_dtype, chunk)
        ctx.save_for_backward(x, dt, bm, cm, a_log, d, h0)
        return scan_op(x, dt, bm, cm, a_log, d, h0, ssm_dtype, chunk)

    @staticmethod
    def backward(ctx, dy, dh_last):
        ins = ctx.saved_tensors
        grads = scan_bwd_op(*ins, dy, dh_last, *ctx.mode)
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)), None, None)
