"""Carry the reference's configuration and state across to the port.

The reference's objects never cross directly (the port imports nothing of
``repro``): the caller flattens them to plain python and numpy first,
``dataclasses.asdict(cfg)`` for a config and the ``CPMLState`` fields as
numpy arrays for a state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.core.protocol.engine import CPMLState

# Reference fields with no counterpart: the device picks the kernel path,
# and the mesh axis belongs to the unported "shard" backend.
_DROPPED = ("use_kernel", "mesh_axis")


def config_from_reference(d: dict) -> CPMLConfig:
    """``dataclasses.asdict`` of a reference CPMLConfig -> the port's."""
    known = {f.name for f in dataclasses.fields(CPMLConfig)}
    unknown = set(d) - known - set(_DROPPED)
    if unknown:
        raise ValueError(f"reference config fields with no counterpart: "
                         f"{sorted(unknown)}")
    return CPMLConfig(**{k: v for k, v in d.items() if k in known})


def state_from_reference(arrays: dict[str, np.ndarray],
                         device: str | torch.device) -> CPMLState:
    """The reference CPMLState's fields (numpy arrays, python ints for m and
    mk) -> the port's CPMLState on ``device``, dtypes kept."""
    fields = {}
    for f in dataclasses.fields(CPMLState):
        v = arrays[f.name]
        if f.name in ("m", "mk"):
            fields[f.name] = int(v)
        else:
            fields[f.name] = torch.as_tensor(np.array(v), device=device)
    return CPMLState(**fields)
