"""The SPMD seam of the port (mirrors ``repro/parallel/compat.py``).

In the reference a sharded body is a ``jax.shard_map`` over a named mesh
axis, and inside it ``jax.lax.all_gather`` and ``jax.lax.axis_index``
name that axis.  Here every rank of a ``torch.distributed`` group runs the
same program on the same (replicated) inputs, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch/mesh.py``: ``compat_make_mesh``):

  * ``shard_map(f, mesh, in_specs, out_specs)`` gives each rank its block of
    each input along the named mesh axes (by its coordinate on each axis)
    and runs ``f`` on the blocks with the mesh active.  On plain tensors
    (the same on every rank) ``f`` returns a replicated value
    (``out_specs=()``), as the coded bodies' all_gather makes it.  On
    ``DTensor`` inputs it is ``local_map`` with the specs' placements: the
    inputs are redistributed to ``in_specs``, ``f`` gets the local
    blocks, its outputs are the blocks of ``DTensor``s laid out as
    ``out_specs`` say, and the whole is differentiable, each input's
    gradient laid out as the input;
  * ``all_gather`` and ``axis_index`` are the collectives of a body;
    ``all_gather_grad`` is the tiled all_gather a differentiable body
    uses, whose backward is a reduce-scatter (``jax.lax.all_gather``'s
    transpose);
  * ``use_mesh(mesh)`` is the reference's ``with mesh:``, and
    ``ambient_mesh()`` the mesh it made active.

A spec is the plain tuple of ``parallel/rules.py``: one entry a dim, None
(replicated) or a mesh axis name; ``()`` is fully replicated.

The group's backend moves the data (``launch/mesh.py: backend_for``):
NCCL on the device, gloo on the host, and where ranks share a card the
staged backend, which copies CUDA tensors through host memory.  Nothing
here falls back from one to another.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

from repro_torch.parallel import rules

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
    src = x.contiguous().reshape(1, -1)
    n = int(mesh.size(i))
    # one output buffer: a staged backend copies it back to the card once
    out = src.new_empty((n, src.shape[1]))
    dist.all_gather_into_tensor(out, src, group=mesh.get_group(i))
    parts = out.view(n, *x.shape).unbind(0)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def all_gather_grad(x: torch.Tensor, axis_name: str, dim: int = 0,
                    mesh=None) -> torch.Tensor:
    """The tiled ``all_gather`` of ``x`` along ``dim`` over one mesh axis,
    differentiable: the backward reduce-scatters the gradient along
    ``dim``, each rank keeping the sum of its block's gradients."""
    mesh = ambient_mesh() if mesh is None else mesh
    i = _dim(mesh, axis_name)
    return _AllGatherTiled.apply(x, mesh.get_group(i), int(mesh.size(i)), dim)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n: int, dim: int):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        src = g.movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // ctx.n, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """x reduced over ``group`` with ``op``, as a new tensor on x's
    device (x is left as it is)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _sharded(spec: tuple) -> bool:
    return any(name is not None for name in spec)


def shard_map(f: Callable[..., Any], mesh, in_specs: tuple,
              out_specs: tuple | list) -> Callable[..., Any]:
    """``jax.shard_map``.  ``in_specs`` holds one spec an input;
    ``out_specs`` is the output's spec, or a list of specs, one an output.

    On ``DTensor`` inputs (a ``DeviceMesh`` with named dims): the inputs
    are redistributed to ``in_specs``' placements and ``f`` runs on the
    local blocks under ``local_map``; it returns ``DTensor``s laid out as
    ``out_specs``.  On plain tensors, the same on every rank: ``f`` gets
    this rank's blocks and returns what it returns, which must be
    replicated (``out_specs=()``), as after an ``all_gather``."""
    outs = out_specs if isinstance(out_specs, list) else [out_specs]
    sharded_out = any(_sharded(s) for s in outs)
    if sharded_out and not hasattr(mesh, "mesh_dim_names"):
        raise ValueError(f"out_specs {out_specs}: a sharded output is a "
                         f"DTensor on a DeviceMesh; on plain tensors "
                         f"shard_map returns a replicated output, "
                         f"out_specs=()")

    def run(*args: torch.Tensor):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} specs")
        if any(rules.is_dtensor(a) for a in args):
            return _local_map(f, mesh, in_specs, outs,
                              isinstance(out_specs, list))(*args)
        if sharded_out:
            raise ValueError(f"out_specs {out_specs} on plain tensors: "
                             f"shard_map returns a replicated output, "
                             f"out_specs=(); pass DTensors for a sharded one")
        blocks = [rules.spec_block(a, mesh, s)
                  for a, s in zip(args, in_specs)]
        with use_mesh(mesh):
            return f(*blocks)

    return run


def _local_map(f, mesh, in_specs, outs, several: bool):
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(rules.placements(mesh, s) for s in in_specs)
    out_pl = tuple(rules.placements(mesh, s) for s in outs)

    def body(*blocks):
        with use_mesh(mesh):
            return f(*blocks)

    return local_map(body,
                     out_placements=out_pl if several else list(out_pl[0]),
                     in_placements=in_pl, in_grad_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)
