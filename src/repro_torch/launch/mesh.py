"""Meshes of the port, and the launcher of its SPMD ranks.

Mirrors ``repro/launch/mesh.py``.  ``make_local_mesh`` and ``mesh_chips``
describe the devices one process sees, ``torch.cuda.device_count()``
cards on the GPU and one device on the CPU (as the reference's tests see
one CPU device): a ``LocalMesh`` carries what the placement rules read
(``axis_names`` and ``shape``, ``parallel/rules.py``) and its devices;
nothing is placed on it.

``compat_make_mesh`` builds the reference's named mesh over the ranks of
an initialised ``torch.distributed`` world, as a ``DeviceMesh`` whose
dims ``parallel/compat.py`` names and on which the model's ``DTensor``s
live (``parallel/rules.py``).  The reference forces N host devices in one
process; the port starts N processes instead, with ``run_ranks``.
``backend_for`` is the collectives' route: NCCL where every rank has its
own card, the host-staged backend (``parallel/staged.py``) where ranks
share one, gloo on the CPU.  ``make_production_mesh`` builds the
reference's 256- and 512-chip meshes over a world of that many ranks:
``torchrun`` over NCCL on as many cards, or the dry run's fake world
(``launch/dryrun.py: fake_world``), where nothing is sent or allocated.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]            # axis name -> size
    devices: tuple[torch.device, ...]


def local_devices() -> list[torch.device]:
    """Every card torch sees, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_local_mesh(model: int = 1) -> LocalMesh:
    """Small mesh over whatever devices exist: a model axis of up to
    ``model`` devices, the rest on the data axis."""
    devs = local_devices()
    model = min(model, len(devs))
    data = len(devs) // model
    return LocalMesh(("data", "model"), {"data": data, "model": model},
                     tuple(devs[: data * model]))


def mesh_chips(mesh: LocalMesh) -> int:
    return len(mesh.devices)


def compat_make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the ranks
    of the initialised world, in rank order (``run_ranks`` starts one).

    Its device type is where its tensors live: the card under NCCL and
    the staged route, the host under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("compat_make_mesh needs an initialised "
                           "torch.distributed world (launch.mesh.run_ranks)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks;"
                         f" the world has {world}")
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


PRODUCTION_CHIPS = {False: 256, True: 512}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the initialised world: (16, 16)
    named (data, model), 256 ranks; with ``multi_pod`` (2, 16, 16) named
    (pod, data, model), 512 ranks, the ``pod`` axis carrying data
    parallelism only.  Raises ``ValueError`` on a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = PRODUCTION_CHIPS[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != want:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a world of {want} ranks; this one has "
                         f"{'none' if world is None else world}")
    return compat_make_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Rank launcher
# ---------------------------------------------------------------------------

def backend_for(world: int, device: str | torch.device) -> str:
    """The process group's backend for ``world`` ranks on ``device``.

    ``nccl`` where every rank has its own card; where ranks share a card
    (NCCL refuses two ranks on one device, and gloo's CUDA path hangs in
    DTensor's functional collectives) ``staged.ROUTE``: gloo for host
    tensors, the host-staged backend for CUDA ones; ``gloo`` on the CPU.
    The rule decides; a backend that fails is an error, not a cue to try
    another."""
    from repro_torch.parallel import staged

    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= world:
        return "nccl"
    return staged.ROUTE


def init_backend(backend: str) -> None:
    """What a process does before it joins a group over ``backend``: the
    staged route's backend registered (its build is the launcher's)."""
    from repro_torch.parallel import staged

    if staged.NAME in backend:
        staged.register()


@dataclasses.dataclass
class RankRun:
    results: list[Any]       # what the rank function returned, by rank
    backend: str
    startup_s: float         # start of the first rank to the last one's group


class RankFailure(RuntimeError):
    """A rank raised, died or did not finish: the whole run failed."""


def _rank_main(rank: int, world: int, backend: str, device_type: str,
               init_file: str, timeout: float, fn: Callable, args: tuple,
               results) -> None:
    """One rank: join the group, run ``fn(rank, world, *args)``, report."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_backend(backend)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        ready = time.time()
        out = fn(rank, world, *args)
        results.put((rank, None, out, ready))
    except BaseException:
        results.put((rank, traceback.format_exc(), None, None))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable[..., Any], world: int, args: tuple = (), *,
              device: str | torch.device = "cpu", timeout: float = 600.0
              ) -> RankRun:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``torch.distributed`` group, and return what each returned.

    ``fn`` and ``args`` are pickled (``fn`` by its import path); ``fn``
    returns host values (numbers, numpy arrays).  The group rendezvous
    through a ``FileStore`` in a fresh temporary directory, so concurrent
    runs never share a port.  Every rank sets one intra-op thread and, on
    the GPU, the card ``rank % device_count``.  The CUDA kernels and, on
    the staged route, its backend are built here, before any rank starts,
    so that no two ranks build into one directory.  A rank that raises or
    dies, or a run past
    ``timeout`` seconds, raises ``RankFailure``; every rank still alive is
    then killed.
    """
    dev = torch.device(device)
    backend = backend_for(world, dev)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        from repro_torch.parallel import staged
        build.build_all()
        if staged.NAME in backend:
            staged.build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = [ctx.Process(target=_rank_main, args=(
        rank, world, backend, dev.type, os.path.join(tmp, "store"), timeout,
        fn, args, results)) for rank in range(world)]
    t0 = time.time()
    got: dict[int, tuple[Any, float]] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                item = results.get(timeout=1.0)
            except queue_mod.Empty:
                item = None
            if item is None:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank flushes its result before it exits: read it
                    try:
                        item = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RankFailure(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                elif time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(got))
                    raise RankFailure(f"ranks {missing} did not finish within "
                                      f"{timeout} s")
                else:
                    continue
            rank, err, out, ready = item
            if err is not None:
                raise RankFailure(f"rank {rank} of {world} failed:\n{err}")
            got[rank] = (out, ready)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return RankRun(results=[got[r][0] for r in range(world)], backend=backend,
                   startup_s=max(got[r][1] for r in range(world)) - t0)
