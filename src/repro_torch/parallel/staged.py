"""The host-staged collective backend for ranks that share one card.

``csrc/staged_backend.cpp`` is a c10d ``Backend`` that copies each
collective's CUDA tensors to host memory, runs the collective on a gloo
backend of the same group and copies the results back.  It is compiled
at first use with the host's C++ compiler, against torch's headers and
libraries (no ninja), into ``build/repro_torch_staged/<hash>/`` at the
repository root, keyed by a hash of the source, the flags and the torch
version, by the kernels' own build step (``kernels/build.py:
compile_into``); ``launch/mesh.py: run_ranks`` builds it before any rank
starts.

``register()`` makes ``"staged"`` a backend name torch knows for the given
devices; a group then starts with ``init_process_group(ROUTE, ...)``:
gloo for host tensors, the staged backend for CUDA tensors.  Nothing is
built or registered when this module is imported.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
import sys
import sysconfig
import threading
from pathlib import Path

from repro_torch.kernels import build as kbuild

NAME = "staged"
ROUTE = f"cpu:gloo,cuda:{NAME}"
SOURCE = Path(__file__).resolve().parent / "csrc" / "staged_backend.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_staged")
FLAGS = ("-std=c++17", "-O1", "-shared", "-fPIC", "-w")

_lock = threading.Lock()
_module = None


def compiler() -> str:
    """The C++ compiler: $CXX, else c++ or g++ on PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler ($CXX, c++, g++) to build the staged "
                       "collective backend")


def _command(out: Path) -> list[str]:
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cmd = [compiler(), *FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
           "-DTORCH_EXTENSION_NAME=staged_backend",
           f"-I{sysconfig.get_paths()['include']}"]
    cmd += [f"-I{p}" for p in cpp_extension.include_paths()]
    cmd += [str(SOURCE), "-o", str(out)]
    for lib in cpp_extension.library_paths():
        cmd += [f"-L{lib}", f"-Wl,-rpath,{lib}"]
    cmd += ["-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_python"]
    return cmd


def source_hash() -> str:
    import torch

    return kbuild.digest(repr((FLAGS, torch.__version__,
                               sys.version_info[:2])).encode(),
                         SOURCE.read_bytes())


def build() -> Path:
    """The compiled extension, built if this tree has none yet.  Raises
    with the compiler's output when the build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / f"staged_backend{sysconfig.get_config_var('EXT_SUFFIX')}"
    if not lib.exists():
        kbuild.compile_into(out_dir, {"staged_backend": (lib, _command)},
                            f"building {SOURCE.name}")
    return lib


def module():
    """The loaded extension, built on first use."""
    global _module
    with _lock:
        if _module is None:
            import torch  # noqa: F401  (the extension links torch's libraries)

            path = build()
            spec = importlib.util.spec_from_file_location("staged_backend",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        return _module


def _create(store, rank: int, size: int, timeout):
    import torch.distributed as dist

    inner = dist.ProcessGroupGloo(store, rank, size, timeout)
    return module().create(inner, rank, size)


def register(devices: tuple[str, ...] = ("cuda",)) -> None:
    """Make ``NAME`` a backend of this process for ``devices`` (once)."""
    import torch.distributed as dist

    module()
    if NAME.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(NAME, _create, devices=list(devices))
