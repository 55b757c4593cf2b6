"""Meshes for the port's placement policy.

Mirrors ``repro/launch/mesh.py``'s ``make_local_mesh`` and ``mesh_chips``:
a small (data, model) mesh over the devices torch sees,
``torch.cuda.device_count()`` cards on the GPU and one device on the CPU
(as the reference's tests see one CPU device).  A ``LocalMesh`` carries
what the placement rules read (``axis_names`` and ``shape``,
``parallel/rules.py``) and its devices; nothing is placed on it.
``compat_make_mesh`` and ``make_production_mesh`` (the reference's
256- and 512-chip XLA meshes) need more than one card and refuse:
ROADMAP.md list 1b item 7 and queue 1 item 12.
"""
from __future__ import annotations

import dataclasses

import torch


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
    raise NotImplementedError(
        "compat_make_mesh builds an XLA device mesh; the port's multi-card "
        "mesh is not ported yet: ROADMAP.md list 1b item 7")


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the 256- and 512-chip production meshes are not ported yet: "
        "ROADMAP.md list 1b item 7 and queue 1 item 12")
