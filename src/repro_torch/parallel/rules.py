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
object with ``axis_names`` and ``shape`` (``launch/mesh.py``).
"""
from __future__ import annotations

import math


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


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def spec_for(mesh, shape: tuple[int, ...], logical: tuple[str | None, ...],
             seq_parallel: bool = False) -> tuple:
    """The spec of one array, applying divisible-or-replicate."""
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
