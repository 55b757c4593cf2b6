"""The SPMD seam of the port (mirrors ``repro/parallel/compat.py``).

In the reference a sharded body is a ``jax.shard_map`` over a named mesh
axis, and inside it ``jax.lax.all_gather`` and ``jax.lax.axis_index``
name that axis.  Here every rank of a ``torch.distributed`` group runs the
same program on the same (replicated) inputs, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch/mesh.py``: ``compat_make_mesh``):

  * ``shard_map(f, mesh, in_specs, out_specs)`` gives each rank its block of
    each input along the named mesh axes (by its coordinate on each axis)
    and runs ``f`` on the blocks with the mesh active; ``f`` returns a
    replicated value (``out_specs=()``), as the coded bodies' all_gather
    makes it;
  * ``all_gather`` and ``axis_index`` are the collectives of a body;
  * ``use_mesh(mesh)`` is the reference's ``with mesh:``, and
    ``ambient_mesh()`` the mesh it made active.

A spec is the plain tuple of ``parallel/rules.py``: one entry a dim, None
(replicated) or a mesh axis name; ``()`` is fully replicated.

Where the group runs gloo (ranks that share a card, or the CPU) its
collectives move host tensors: a CUDA tensor is staged through host memory
explicitly, and the gathered result copied back to its device.  NCCL
gathers on the device.  Nothing here falls back from one to the other.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch
import torch.distributed as dist

_active = threading.local()


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` the ambient mesh of this thread for the block."""
    stack = _active.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The mesh of the innermost ``use_mesh`` block."""
    stack = getattr(_active, "stack", None)
    if not stack:
        raise RuntimeError("no active mesh: wrap the call in "
                           "`with compat.use_mesh(mesh):`")
    return stack[-1]


def _dim(mesh, axis_name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
    return names.index(axis_name)


def axis_size(axis_name: str, mesh=None) -> int:
    mesh = ambient_mesh() if mesh is None else mesh
    return int(mesh.size(_dim(mesh, axis_name)))


def axis_index(axis_name: str, mesh=None) -> int:
    """This rank's coordinate on the mesh axis (``jax.lax.axis_index``)."""
    mesh = ambient_mesh() if mesh is None else mesh
    return int(mesh.get_local_rank(_dim(mesh, axis_name)))


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0,
               tiled: bool = False, mesh=None) -> torch.Tensor:
    """``jax.lax.all_gather`` over one mesh axis: every rank's ``x`` in
    axis order, stacked on a new dim ``dim`` or, ``tiled``, concatenated
    along ``dim``.  Every rank gets the same tensor on ``x``'s device."""
    mesh = ambient_mesh() if mesh is None else mesh
    i = _dim(mesh, axis_name)
    group = mesh.get_group(i)
    n = int(mesh.size(i))
    src = x.contiguous()
    if dist.get_backend(group) == "gloo":
        # gloo's transport is host memory: gather host copies
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
    return out.to(x.device)


def _block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for d, name in enumerate(spec):
        if name is None:
            continue
        n, i = axis_size(name, mesh), axis_index(name, mesh)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                             f"into {n} blocks along mesh axis {name!r}")
        b = x.shape[d] // n
        x = x.narrow(d, i * b, b)
    return x


def shard_map(f: Callable[..., torch.Tensor], mesh, in_specs: tuple,
              out_specs: tuple) -> Callable[..., torch.Tensor]:
    """``jax.shard_map``: the returned function takes the whole inputs
    (the same on every rank), gives ``f`` this rank's blocks and returns
    what ``f`` returns.  ``in_specs`` holds one spec an input; the output
    must be replicated (``out_specs=()``): every rank holds the same
    tensor, as after an ``all_gather``."""
    if any(name is not None for name in out_specs):
        raise ValueError(f"out_specs {out_specs}: shard_map returns a "
                         f"replicated output, out_specs=()")

    def run(*args: torch.Tensor) -> torch.Tensor:
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} specs")
        blocks = [_block(a, s, mesh) for a, s in zip(args, in_specs)]
        with use_mesh(mesh):
            return f(*blocks)

    return run
