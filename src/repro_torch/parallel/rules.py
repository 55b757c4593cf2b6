"""Logical-axis -> partition spec rules (divisible-or-replicate policy).

Mirrors ``repro/parallel/rules.py``'s ``logical_rules``, ``spec_for`` and
``act_spec``.  Every parameter template leaf carries logical axis names
(``models/layers.py``: ``ParamSpec.logical``).  The policy:

  * ``embed`` -> 'data'; ``heads`` / ``kv_heads`` / ``ffn`` / ``vocab`` /
    ``inner`` / ``experts`` -> 'model'
  * ``batch`` -> ('pod', 'data') on a mesh with a pod axis, 'data' otherwise
  * ``seq`` -> 'model' with ``seq_parallel`` (activations only)
  * a dim shards ONLY if its size divides the mesh axes' product, and a
    count-qualified name ``heads[n]`` only if the count n does too;
    otherwise it replicates.

A spec is a plain tuple, one entry per dim up to the last sharded one:
None (replicated), an axis name, or a tuple of axis names.  A mesh is any
object with ``axis_names`` and ``shape`` (``launch/mesh.py``), or a
``DeviceMesh`` with named dims (``compat_make_mesh``).

Placing tensors (the reference's ``NamedSharding``, ``use_rules_mesh``
and ``constrain``): ``sharding_for`` maps a template leaf's spec to the
``DTensor`` placements of a ``DeviceMesh``, one a mesh dim, ``Shard(d)``
where the spec names that dim's axis at tensor dim d and ``Replicate()``
elsewhere.  ``use_rules_mesh`` makes a mesh the rules' mesh for a block;
under it ``constrain`` redistributes a ``DTensor`` activation to the
placements of its logical axes, and with no rules mesh it returns its
input.  Neither changes a value.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Iterator


def logical_rules(mesh, seq_parallel: bool = False
                  ) -> dict[str, tuple[str, ...]]:
    axes = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    model_axes = ("model",) if "model" in axes else ()
    return {
        "batch": batch_axes,
        "embed": tuple(a for a in ("data",) if a in axes),
        "heads": model_axes,
        "kv_heads": model_axes,
        "ffn": model_axes,
        "vocab": model_axes,
        "experts": model_axes,
        "inner": model_axes,
        "seq": model_axes if seq_parallel else (),
        "kv_seq": model_axes,   # long-context decode: the cache on seq
    }


class _Axes:
    """A ``DeviceMesh`` as the policy reads a mesh: names and sizes."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.mesh.shape))


def named(mesh):
    """``mesh`` as the policy reads it: ``axis_names`` and a ``shape``
    dict (a ``DeviceMesh`` wrapped, any other mesh itself)."""
    return _Axes(mesh) if hasattr(mesh, "mesh_dim_names") else mesh


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def spec_for(mesh, shape: tuple[int, ...], logical: tuple[str | None, ...],
             seq_parallel: bool = False) -> tuple:
    """The spec of one array, applying divisible-or-replicate."""
    mesh = named(mesh)
    rules = logical_rules(mesh, seq_parallel)
    used: set[str] = set()
    parts: list = []
    for dim, name in zip(shape, logical):
        count = None
        if name and name.endswith("]") and "[" in name:
            base, cnt = name[:-1].split("[")
            name, count = base, int(cnt)
        axes = rules.get(name, ()) if name else ()
        axes = tuple(a for a in axes if a not in used)
        size = _axes_size(mesh, axes)
        if axes and dim % size == 0 and (count is None or count % size == 0):
            parts.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def act_spec(mesh, x_shape: tuple[int, ...],
             logical: tuple[str | None, ...],
             seq_parallel: bool = False) -> tuple:
    return spec_for(mesh, x_shape, logical, seq_parallel)


def shard_dims(mesh, spec: tuple) -> tuple[int | None, ...]:
    """For each of ``mesh``'s dims, the tensor dim of ``spec`` that names
    its axis and so splits over it, or None where no dim names it.  Two
    axes on one dim split it in mesh-dim order, as a ``NamedSharding``
    splits it major to minor."""
    names = named(mesh).axis_names
    out: list[int | None] = [None] * len(names)
    for d, entry in enumerate(spec):
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = d
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``'s dims
    (``shard_dims``): ``Shard(d)``, or ``Replicate()`` where no dim
    names the axis."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if d is None else Shard(d)
                 for d in shard_dims(mesh, spec))


def act_placements(mesh, shape: tuple[int, ...],
                   logical: tuple[str | None, ...]) -> tuple:
    """The placements of an activation of ``shape`` with ``logical``
    axes (``act_spec``'s, as ``DTensor`` placements)."""
    return placements(mesh, spec_for(mesh, tuple(shape), logical))


def sharding_for(mesh, spec_leaf, stacked: bool = False,
                 seq_parallel: bool = False) -> tuple:
    """The placements of a template leaf (``ParamSpec``) on ``mesh``;
    ``stacked`` adds the reference's leading layer dim."""
    shape = ((1,) + spec_leaf.shape) if stacked else spec_leaf.shape
    logical = ((None,) + spec_leaf.logical) if stacked else spec_leaf.logical
    return placements(mesh, spec_for(mesh, shape, logical, seq_parallel))


# process-wide, as the reference's ``_ACTIVE``: block remat recomputes a
# block inside the backward, which autograd runs on its own thread for
# CUDA tensors, and must see the mesh the forward saw
_ACTIVE: dict = {"mesh": None, "seq_parallel": False}


@contextlib.contextmanager
def use_rules_mesh(mesh, seq_parallel: bool = False) -> Iterator:
    """Make ``mesh`` the rules' mesh for the block: the model places its
    activations on it (``constrain``) and takes its mesh-only branches
    (``models/model.py``)."""
    prev = dict(_ACTIVE)
    _ACTIVE.update(mesh=mesh, seq_parallel=seq_parallel)
    try:
        yield mesh
    finally:
        _ACTIVE.update(prev)


def rules_mesh():
    """The mesh of the innermost ``use_rules_mesh`` block, or None."""
    return _ACTIVE["mesh"]


def constrain(x, logical: tuple[str | None, ...]):
    """``x`` redistributed to the placements of ``logical`` under a rules
    mesh (the reference's ``with_sharding_constraint``); ``x`` itself with
    none."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return x
    if not hasattr(x, "placements"):
        raise TypeError("constrain under a rules mesh takes a DTensor: place "
                        "the model on the mesh (models/model.py: "
                        "place_on_mesh)")
    want = placements(mesh, spec_for(mesh, tuple(x.shape), logical,
                                     _ACTIVE["seq_parallel"]))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``: a tensor placed on a mesh.  No
    ``DTensor`` exists before its package is imported, so a process that
    never places one never pays that import (seconds a process where
    ranks share the host's cores)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local(t):
    """This rank's block of ``t`` if it is a ``DTensor``, else ``t``."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """``t`` whole, the same on every rank, if it is a ``DTensor``, else
    ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def gathered(w):
    """A parameter as a product reads it: on a mesh, gathered over every
    mesh dim but ``model`` (the rules shard ``embed`` over ``data``, ZeRO-3
    style, and the reference's compiler gathers it a layer at a time); its
    gradient is reduce-scattered back.  Off a mesh, ``w`` itself."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(p if n == "model" else Replicate()
                 for n, p in zip(names, w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def local_block(full, mesh, placements: tuple):
    """This rank's block of ``full`` under ``placements`` on ``mesh`` (a
    view): a dim split over several mesh dims splits in mesh-dim order."""
    return _block(full, mesh, tuple(p.dim if p.is_shard() else None
                                    for p in placements))


def spec_block(full, mesh, spec: tuple):
    """This rank's block of ``full`` under ``spec`` (``local_block`` of its
    placements, from ``shard_dims`` alone: plain tensors stay off
    ``DTensor``)."""
    return _block(full, mesh, shard_dims(mesh, spec))


def _block(full, mesh, dims: tuple[int | None, ...]):
    x = full
    for i, d in enumerate(dims):
        if d is not None:
            n, r = mesh.size(i), mesh.get_local_rank(i)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                                 f"split into {n} blocks")
            b = x.shape[d] // n
            x = x.narrow(d, r * b, b)
    return x


def zeros(shape: tuple[int, ...], dtype, mesh, placements: tuple,
          device=None):
    """A ``DTensor`` of zeros of global ``shape`` on ``mesh`` laid out as
    ``placements``: each rank allocates its own block only (on the mesh's
    device type unless ``device`` says otherwise)."""
    import torch
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split into {n} blocks")
            local[p.dim] //= n
    dev = mesh.device_type if device is None else device
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=dev),
                              mesh, placements, run_check=False)


def distribute(full, mesh, placements: tuple):
    """``full`` (the same on every rank) as a ``DTensor`` on ``mesh`` laid
    out as ``placements``: each rank keeps a copy of its own block, so
    nothing is sent."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_block(full, mesh, placements).clone(),
                              mesh, placements, run_check=False)
