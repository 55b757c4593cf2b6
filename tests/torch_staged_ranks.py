"""Rank function of ``test_torch_staged.py``: every collective of the
host-staged backend (``parallel/staged.py``) against gloo's own, in one
group of ranks.  Imports torch and the port only."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel import staged


def _inputs(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    # a transposed view: not contiguous, so the backend stages a copy and
    # writes the result back through the view
    return torch.randn(6, 4, generator=g).t()


def _run(group, rank: int, world: int) -> dict:
    x = _inputs(rank)                         # (4, 6), not contiguous
    out = {}
    o = torch.empty(world * 4, 6)
    dist.all_gather_into_tensor(o, x.contiguous(), group=group)
    out["all_gather_into_tensor"] = o
    parts = [torch.empty(4, 6) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    out["all_gather"] = torch.stack(parts)
    r = torch.empty(4 // world * 1, 6)
    dist.reduce_scatter_tensor(r, x.contiguous(), group=group)
    out["reduce_scatter_tensor"] = r
    for op in ("SUM", "MAX", "MIN"):
        a = x.clone().t().t()                 # a non-contiguous copy
        dist.all_reduce(a, op=getattr(dist.ReduceOp, op), group=group)
        out[f"all_reduce_{op}"] = a.clone()
    t = torch.empty(4, 6)
    dist.all_to_all_single(t, x.contiguous(), group=group)
    out["all_to_all_single"] = t
    ins = list(x.contiguous().chunk(world))
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=group)
    out["all_to_all"] = torch.cat(outs)
    b = x.clone()
    dist.broadcast(b, src=1, group=group)
    out["broadcast"] = b
    red = x.clone()
    dist.reduce(red, dst=0, group=group)
    out["reduce_on_0"] = red if rank == 0 else torch.zeros(0)
    gl = [torch.empty(4, 6) for _ in range(world)] if rank == 0 else None
    dist.gather(x.contiguous(), gl, dst=0, group=group)
    out["gather_on_0"] = torch.stack(gl) if rank == 0 else torch.zeros(0)
    sc = torch.empty(2, 6)
    dist.scatter(sc, list(x.contiguous().chunk(world)) if rank == 0 else None,
                 src=0, group=group)
    out["scatter"] = sc
    if rank == 0:
        dist.send(x.contiguous(), dst=1, group=group)
        out["send_recv"] = torch.zeros(0)
    elif rank == 1:
        rv = torch.empty(4, 6)
        dist.recv(rv, src=0, group=group)
        out["send_recv"] = rv
    dist.barrier(group=group)
    return {k: v.numpy() for k, v in out.items()}


def _functional(group, world: int) -> dict:
    from torch.distributed import _functional_collectives as fc

    x = _inputs(dist.get_rank()).contiguous().requires_grad_(True)
    y = fc.wait_tensor(fc.all_gather_tensor_autograd(x, 0, group))
    (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
    return {"all_gather": y.detach().numpy(), "grad": x.grad.numpy()}


def staged_rank(rank: int, world: int) -> dict:
    """The collectives on a group over the staged backend (registered for
    host tensors here) and on a plain gloo group of the same ranks."""
    staged.register(("cpu",))
    sg = dist.new_group(backend=staged.NAME)
    gg = dist.new_group(backend="gloo")
    return {"staged": _run(sg, rank, world), "gloo": _run(gg, rank, world),
            "staged_functional": _functional(sg, world),
            "gloo_functional": _functional(gg, world),
            "backend": dist.get_backend(sg)}
