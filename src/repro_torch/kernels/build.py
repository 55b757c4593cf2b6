"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

into ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so a checkout builds everything itself
and an unchanged tree reuses its build.  ``-Xptxas -v``'s report of
registers, shared memory and spills is kept beside each library
(``<name>.log``).  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("modmatmul", "coded_grad", "mamba_scan", "mamba_scan_bwd")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


class ModmatmulParams(ctypes.Structure):
    """``MatmulParams`` of csrc/modmatmul.cu: the shapes, the launch plan and
    the field constants, built once per (shape, p) so that a call passes
    six arguments (ctypes converts each argument on every call)."""
    _fields_ = [("M", _I), ("K", _I), ("N", ctypes.c_longlong), ("rows", _I),
                ("cols", _I), ("threads", _I), ("splits", _I), ("slice", _I),
                ("p", ctypes.c_uint), ("fold_every", _I), ("c32", ctypes.c_uint),
                ("bm", ctypes.c_ulonglong)]


class CodedGradParams(ctypes.Structure):
    """``CodedGradParams`` of csrc/coded_grad.cu: the shapes, the launch
    plan (kernels/coded_grad.py: plan) and the field constants."""
    _fields_ = [("N", _I), ("mk", _I), ("d", _I), ("c", _I), ("r", _I),
                ("rows", _I), ("stages", _I), ("group", _I), ("chunk", _I),
                ("threads", _I), ("splits", _I), ("tiles_per", _I),
                ("part_smem", _I), ("smem", _I), ("raw", _I), ("p", ctypes.c_uint),
                ("fold_every", _I), ("c32", ctypes.c_uint),
                ("bm", ctypes.c_ulonglong)]


_ARGTYPES = {
    # a, b, c, partial, params, stream
    "modmatmul_launch": [_P, _P, _P, _P, ctypes.POINTER(ModmatmulParams), _P],
    # x, w, cbar, slot, out, params, stream
    "coded_grad_launch": [_P, _P, _P, _P, _P, ctypes.POINTER(CodedGradParams),
                          _P],
    # x, dt, bc, a_log, d, h0, y, h_last, B, S, di, n, bf16, vec, ab_bf16,
    # chunk, stream
    "mamba_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P],
    # x, dt, bc, a_log, d, h0, dy, dh_last, hcar, gcar, dsum, dx, ddt,
    # dbc_part, da_part, dd_part, dh0, acar, abseg, pseg, gseg, B, S, di, n,
    # bf16, vec, channels, chunk, smem, ab_chunk, stream
    "mamba_scan_bwd_launch": [_P] * 21 + [_I] * 10 + [_P],
}


def _check_prime(p: int) -> None:
    if not 2 < p < 1 << 30:
        raise ValueError(f"the kernels need 2 < p < 2^30, got {p}")


def reduce_every(p: int) -> int:
    """Largest R with (p-1) + R (p-1)^2 < 2^64 (16 for P30, 76921 for P):
    the products a uint64 sum that starts below p can take.  ``coded_grad``
    adds 8 to a residue, and a row's d unreduced where d <= R
    (``coded_grad.raw_sums``).  Capped at 2^20."""
    _check_prime(p)
    return min((2 ** 64 - p) // (p - 1) ** 2, 1 << 20)


def fold_every(p: int) -> int:
    """Largest L with (2^32-1)(c+1) + L (p-1)^2 < 2^64, c = 2^32 mod p:
    ``modmatmul`` folds each uint64 accumulator to lo + hi c (at most
    (2^32-1)(c+1), field.cuh) at least every L products (16 for P30, 76825
    for P).  Capped at 2^30 to fit a C int; folding more often is exact."""
    _check_prime(p)
    c = (1 << 32) % p
    return min((2 ** 64 - 1 - (2 ** 32 - 1) * (c + 1)) // (p - 1) ** 2, 1 << 30)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels are built on the machine with the GPU")


def digest(*parts: bytes) -> str:
    """The 16 hex digits of sha256 over ``parts``: a build directory's name,
    so that a change to any source or flag builds anew beside the old."""
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def source_hash() -> str:
    parts = [repr(FLAGS).encode()]
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            parts += [f.name.encode(), f.read_bytes()]
    return digest(*parts)


def compile_into(out_dir: Path, jobs: dict[str, tuple[Path, Callable[
        [Path], list[str]]]], what: str) -> None:
    """Run each job's compiler command, all started together.  A job is
    ``name: (target, command)``: ``command(tmp)`` writes a file of this
    process's own beside ``target``, which replaces ``target`` atomically
    when the command succeeds, so that concurrent builds never see half
    a library.  Each command's output is kept as ``<name>.log`` in
    ``out_dir``.  Raises with the output of every command that failed."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (target, command) in jobs.items():
        tmp = target.with_name(f"{name}.{os.getpid()}.tmp{target.suffix}")
        procs[name] = (target, tmp, subprocess.Popen(
            command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (target, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(failed))


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, in parallel.

    Returns {name: path of lib<name>.so}.  Raises with nvcc's output when a
    build fails.
    """
    out_dir = BUILD_ROOT / source_hash()
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    todo = [name for name in SOURCES if not libs[name].exists()]
    if todo:
        nvcc = nvcc_path()
        compile_into(out_dir, {
            name: (libs[name], lambda tmp, name=name: [
                nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")])
            for name in todo}, "nvcc")
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[f"{name}_launch"]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
