"""Wrapper of the ``coded_grad`` CUDA kernel (``csrc/coded_grad.cu``).

Replaces ``repro/kernels/coded_grad.py::coded_grad`` / ``coded_grad_mc``:
the fused worker step f = X̃ᵀ ḡ(X̃ W̃) mod p for all N workers, any number
of heads c and any degree r.  Each row tile of X̃ is staged in shared
memory once and feeds both products, so X̃ is read from device memory
once; a call is one launch, or two when a worker's rows are split across
blocks.  Takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version.  ``plan`` chooses the launch from the shapes; it is
plain Python so that the CPU tests reach it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.modmatmul import SMS, sm_count

SMEM_OPTIN = 232_448     # shared bytes one block may opt into (sm_90)
SMEM_PER_SM = 233_472    # shared bytes of an SM
SMEM_RESERVED = 1_024    # shared bytes the CUDA runtime reserves per block
THREADS = 256            # per block at most (the kernel's launch bound)
ROW_BLOCK = 8            # rows of the kernel's register blocks (kRB)
TILE_ROWS = 8            # rows of a staged tile, at most (one register block)
GROUP_COLS = 32          # Z columns of a head group: whole heads, at least one
CHUNKS = (1, 2, 4)       # step 1's column chunks (register templates)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch for x (N, mk, d), w (N, d, c, r).

    rows: X̃ rows per tile.  stages: tiles in the shared-memory ring (2 or
    1; 0 is the re-read route, where the tile stays in global memory).
    group: heads of a head group.  chunk: step 1's Z columns per pass.
    threads: per block.  splits: blocks per worker, each walking
    ``tiles_per`` consecutive tiles; a second kernel sums their residues
    when there are two or more.  part_smem: the block's (d, c) residues
    live in shared memory (else in its slot of the scratch, or in the
    output).  smem: dynamic shared bytes per block.
    """
    N: int
    mk: int
    d: int
    c: int
    r: int
    rows: int
    stages: int
    group: int
    chunk: int
    threads: int
    splits: int
    tiles_per: int
    part_smem: bool
    smem: int

    @property
    def tiles(self) -> int:
        return _cdiv(self.mk, self.rows)

    @property
    def blocks(self) -> int:
        return self.splits * self.N

    @property
    def head_groups(self) -> list[range]:
        return [range(h, min(self.c, h + self.group))
                for h in range(0, self.c, self.group)]


def smem_bytes(d: int, c: int, r: int, rows: int, stages: int, group: int,
               chunk: int, threads: int, part_smem: bool) -> int:
    """The kernel's dynamic shared memory: the ring (each stage 16-byte
    rounded, plus 4 words for the tile's alignment shift), two reduction
    buffers of uint64, Z and s of a head group, and the residues when kept
    there."""
    stage = _cdiv(rows * d, 4) * 4 + 4
    words = (stages * stage + 2 * 2 * (threads // 32) * ROW_BLOCK * chunk
             + rows * group * r + rows * group + (d * c if part_smem else 0))
    return 4 * words


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``smem`` shared bytes and ``threads`` threads an SM holds."""
    return max(1, min(2048 // threads,
                      SMEM_PER_SM // (smem + SMEM_RESERVED)))


def chunk_for(group: int, r: int) -> int:
    """Step 1's register template: the group's Z columns, up to 4."""
    return min(CHUNKS, key=lambda ch: (ch < min(group * r, 4), ch))


@functools.lru_cache(maxsize=256)
def plan(N: int, mk: int, d: int, c: int, r: int, sms: int = SMS) -> Plan:
    """Launch for the shapes on a card of ``sms`` SMs.

    Heads go in groups of whole heads of at most GROUP_COLS Z columns
    (one head when r alone is wider).  The tile is TILE_ROWS rows (fewer
    when mk is smaller); the first layout that fits is taken, in this
    order: two stages with the residues in shared memory at two blocks an
    SM, two stages with the residues in global memory at two blocks, the
    same at one block (the opt-in), then fewer rows, then one stage of
    one row, then the re-read route.  Each worker's tiles are split over
    as many blocks as fill the card's resident slots once (at least one).
    """
    threads = min(THREADS, 32 * _cdiv(d, 32))
    group = max(1, min(c, GROUP_COLS // r))
    chunk = chunk_for(group, r)
    rows0 = min(TILE_ROWS, mk)
    half = SMEM_PER_SM // 2 - SMEM_RESERVED

    def size(rows: int, stages: int, part: bool) -> int:
        return smem_bytes(d, c, r, rows, stages, group, chunk, threads, part)

    choice = None
    for rows in sorted({rows0, *(x for x in (4, 2, 1) if x < rows0)},
                       reverse=True):
        for budget in (half, SMEM_OPTIN):
            for part in (True, False):
                if size(rows, 2, part) <= budget:
                    choice = (rows, 2, part)
                    break
            if choice:
                break
        if choice:
            break
    if choice is None:
        for stages in (1, 0):
            for part in (True, False):
                if size(1, stages, part) <= SMEM_OPTIN:
                    choice = (1, stages, part)
                    break
            if choice:
                break
    if choice is None:
        raise ValueError(f"coded_grad: no launch fits d = {d}, c = {c}, "
                         f"r = {r} in {SMEM_OPTIN} shared bytes")
    rows, stages, part = choice
    return fixed_plan(N, mk, d, c, r, rows, stages, part, threads,
                      sms * blocks_per_sm(size(rows, stages, part), threads)
                      // N)


def fixed_plan(N: int, mk: int, d: int, c: int, r: int, rows: int,
               stages: int, part_smem: bool, threads: int,
               splits: int) -> Plan:
    """The launch with rows, stages, residue placement, threads and (at
    most) splits given, head groups and chunk as ``plan`` takes them: the
    plan's last step, and the way a check forces a tiling (rows per tile
    at the fold interval, the re-read route at a small shape)."""
    group = max(1, min(c, GROUP_COLS // r))
    chunk = chunk_for(group, r)
    smem = smem_bytes(d, c, r, rows, stages, group, chunk, threads, part_smem)
    tiles = _cdiv(mk, rows)
    tiles_per = _cdiv(tiles, max(1, min(tiles, splits)))
    return Plan(N, mk, d, c, r, rows, stages, group, chunk, threads,
                _cdiv(tiles, tiles_per), tiles_per, part_smem, smem)


def raw_sums(d: int, p: int) -> bool:
    """Step 1 may add a whole row's d products unreduced, across threads
    too: d (p-1)^2 < 2^64, and no thread folds (d <= L).  True at P for
    d <= 76,825, so Case 1 skips a Barrett per partial sum; at P30 only
    for d <= 16."""
    return d <= min(build.reduce_every(p), build.fold_every(p))


@functools.lru_cache(maxsize=256)
def _params(pl: Plan, p: int) -> build.CodedGradParams:
    """The kernel's argument block: the plan, whether step 1 sums raw, p,
    the fold interval L, 2^32 mod p and floor(2^64 / p)."""
    return build.CodedGradParams(
        pl.N, pl.mk, pl.d, pl.c, pl.r, pl.rows, pl.stages, pl.group, pl.chunk,
        pl.threads, pl.splits, pl.tiles_per, int(pl.part_smem), pl.smem,
        int(raw_sums(pl.d, p)), p, build.fold_every(p), (1 << 32) % p,
        (1 << 64) // p)


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
    if (w.shape[:2] != (N, d) or cbar.shape[0] != r + 1 or N > 65535
            or not x.is_contiguous() or w.device != x.device
            or cbar.device != x.device):
        raise ValueError(f"coded_grad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} cbar {tuple(cbar.shape)} "
                         f"(contiguous x, N <= 65535, one device)")
    if r == 0:
        raise ValueError(f"coded_grad needs a degree r >= 1, w {tuple(w.shape)}")
    if min(N, mk, d, c) == 0:   # an empty sum
        return torch.zeros((N, d, c), dtype=torch.int32, device=x.device)
    return run(x, w, cbar, p, plan(N, mk, d, c, r, sm_count(x.device)))


def run(x: torch.Tensor, w: torch.Tensor, cbar: torch.Tensor, p: int,
        pl: Plan) -> torch.Tensor:
    """Launch the kernel with the plan ``pl`` (``plan``'s, or another one a
    check wants to force, such as rows per tile at the fold interval) on
    operands that ``coded_grad`` has checked."""
    N, _, d = x.shape
    c = w.shape[2]
    out = torch.empty((N, d, c), dtype=torch.int32, device=x.device)
    slot = (torch.empty((pl.splits, N, d, c), dtype=torch.int32,
                        device=x.device) if pl.splits > 1 else None)
    lib = build.library("coded_grad")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.coded_grad_launch(
        x.data_ptr(), w.contiguous().data_ptr(), cbar.contiguous().data_ptr(),
        None if slot is None else slot.data_ptr(), out.data_ptr(),
        _params(pl, p), stream)
    build.check(err, "coded_grad")
    kernels.LAUNCHES["coded_grad"] += 1
    return out
