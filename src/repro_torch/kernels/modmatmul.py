"""Wrapper of the ``modmatmul`` CUDA kernel (``csrc/modmatmul.cu``).

Replaces ``repro/kernels/modmatmul.py::modmatmul``: exact (a @ b) mod p
for int32 field matrices.  Takes CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain version.  ``plan`` chooses the kernel's
tiling from the shapes; it is plain Python so that the CPU tests reach it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import build

SMS = 132   # streaming multiprocessors of an H100 SXM: plan's default
# Threads the plan aims to keep on each SM: half of its 2048, enough loads in
# flight for the byte bound.  Fewer on the card, and K is split across blocks.
THREADS_PER_SM = 1024
MIN_SLICE = 64              # least depth of a K-slice
ROW_TILES = (16, 8, 4, 2, 1)
MAX_THREADS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's tiling for (M, K) @ (K, N).

    rows: output rows per thread (a template of the kernel); row groups of
    that many rows run as neighbouring blocks.  cols: output columns per
    thread (4 with 128-bit loads and stores, or 1).  threads: per block.
    splits: K-slices of ``slice`` depth each, summed by a second kernel
    when there are two or more.
    """
    M: int
    K: int
    N: int
    rows: int
    cols: int
    threads: int
    splits: int
    slice: int

    @property
    def groups(self) -> int:
        return _cdiv(self.M, self.rows)

    @property
    def col_blocks(self) -> int:
        return _cdiv(_cdiv(self.N, self.cols), self.threads)

    @property
    def blocks(self) -> int:
        return self.groups * self.col_blocks * self.splits


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the CUDA card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int, vec: bool = True, sms: int = SMS) -> Plan:
    """Tiling for the shapes on a card of ``sms`` SMs; ``vec`` when B's rows
    may be read 16 bytes at a time (aligned pointer).

    rows minimises groups x (rows + 2): a row group costs its rows'
    multiply-adds plus about two for its own read of B's column, so M = 6
    takes one group of 8, M = 40 five of 8 and M = 13 one of 16.  Columns
    go 4 to a thread only where that still fills the card.  Where the
    threads fall short of THREADS_PER_SM on every SM, K is split into
    slices of at least MIN_SLICE.  Where the blocks fall short of the SMs, blocks shrink
    to as few as 32 threads, and then row groups to fewer rows (more
    groups), so that small products take one launch and still spread.
    """
    target = sms * THREADS_PER_SM
    rows = min(ROW_TILES, key=lambda r: (_cdiv(M, r) * (r + 2), -r))
    cols = 4 if (vec and N % 4 == 0 and rows <= 8
                 and _cdiv(M, rows) * (N // 4) >= target) else 1
    col_threads = _cdiv(N, cols)
    splits = 1
    if _cdiv(M, rows) * col_threads < target and K >= 2 * MIN_SLICE:
        splits = min(_cdiv(target, _cdiv(M, rows) * col_threads),
                     K // MIN_SLICE)
    slice_ = _cdiv(K, splits)
    splits = _cdiv(K, slice_)

    def blocks(rows: int, threads: int) -> int:
        return _cdiv(M, rows) * splits * _cdiv(col_threads, threads)

    threads = min(MAX_THREADS, 32 * _cdiv(col_threads, 32))
    while threads > 32 and blocks(rows, threads) < sms:
        threads = max(32, threads // 64 * 32)
    while rows > 1 and blocks(rows, threads) < sms:
        rows //= 2
    return Plan(M, K, N, rows, cols, threads, splits, slice_)


@functools.lru_cache(maxsize=256)
def _params(pl: Plan, p: int) -> build.ModmatmulParams:
    """The kernel's argument block: the plan, p, the fold interval L,
    2^32 mod p and floor(2^64 / p)."""
    return build.ModmatmulParams(pl.M, pl.K, pl.N, pl.rows, pl.cols,
                                 pl.threads, pl.splits, pl.slice, p,
                                 build.fold_every(p), (1 << 32) % p,
                                 (1 << 64) // p)


def modmatmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a (M, K), b (K, N) int32 in [0, p), contiguous, on one CUDA device
    -> (M, N) int32.  Launches on the current stream: one kernel, or two
    when K is split (counted as one launch of ``modmatmul``)."""
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
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    return run(a, b, p, plan(M, K, N, vec=b.data_ptr() % 16 == 0,
                             sms=sm_count(a.device)))


def run(a: torch.Tensor, b: torch.Tensor, p: int, pl: Plan) -> torch.Tensor:
    """Launch the kernel with the tiling ``pl`` (``plan``'s, or another one
    a check wants to force, such as a single K-slice) on operands that
    ``modmatmul`` has checked; M, K, N >= 1."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    partial = (torch.empty((pl.splits, M, N), dtype=torch.int32,
                           device=a.device) if pl.splits > 1 else None)
    lib = build.library("modmatmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.modmatmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), _params(pl, p), stream)
    build.check(err, "modmatmul")
    kernels.LAUNCHES["modmatmul"] += 1
    return out
