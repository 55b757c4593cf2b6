"""Rank functions of the shard-backend tests (``test_torch_shard.py``,
``test_torch_coded_head_sharded.py``), run by ``launch.mesh.run_ranks``.

A spawned rank imports this module by name, so it imports torch, numpy and
the port only, never JAX: the reference's draws and shares reach the ranks
as numpy arrays (``RecordedDraws``).
"""
from __future__ import annotations

import hashlib
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import coded_linear as tcl
from repro_torch.core import protocol as tp
from repro_torch.core.protocol import compute, decode
from repro_torch.core.protocol import engine as te
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import compat


class RecordedDraws:
    """Draws recorded from another draws object, replayed through the seam.

    Holds numpy arrays only, so it pickles into a rank without JAX."""

    def __init__(self, draws, T: int, mk: int, d: int, p: int,
                 wbar_shape: tuple[int, ...], iters: int,
                 batch_rows: int | None):
        self.dataset = draws.dataset_masks(T, mk, d, p).numpy()
        self.rounds = [tuple(a.numpy() for a in draws.round(t, wbar_shape,
                                                            T, p))
                       for t in range(iters)]
        self.batches = ([draws.batch(t, mk, batch_rows).numpy()
                         for t in range(iters)] if batch_rows else None)

    def dataset_masks(self, T, mk, d, p):
        return torch.from_numpy(self.dataset.copy())

    def round(self, t, wbar_shape, T, p):
        u, masks = self.rounds[t]
        return torch.from_numpy(u.copy()), torch.from_numpy(masks.copy())

    def batch(self, t, mk, rows):
        return torch.from_numpy(self.batches[t].copy())


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def _rolled(N: int, drop: int):
    return (lambda t: np.roll(np.arange(N), t)[: N - drop]) if drop else None


def _compat_units(rank: int, world: int) -> dict:
    out: dict = {}
    m1 = tmesh.compat_make_mesh((world,), ("workers",))
    x = torch.arange(2 * world * 3).reshape(2 * world, 3)
    seen = {}

    def body(xb, cols, full):
        seen["rows"], seen["cols"], seen["full"] = xb, cols, full
        seen["index"] = compat.axis_index("workers")
        return xb

    back = compat.shard_map(body, m1, (("workers",), (None, "workers"), ()),
                            ())(x, x.T.contiguous(), x)
    out["rows"] = seen["rows"].numpy()
    out["cols"] = seen["cols"].numpy()
    out["full"] = seen["full"].numpy()
    out["index"] = seen["index"]
    out["returned"] = back.numpy()
    v = torch.tensor([[rank, 10 * rank]])
    out["stacked"] = compat.all_gather(v, "workers", 0, mesh=m1).numpy()
    out["tiled"] = compat.all_gather(v, "workers", 1, tiled=True,
                                     mesh=m1).numpy()
    m2 = tmesh.compat_make_mesh((2, world // 2), ("data", "workers"))
    out["index2"] = (compat.axis_index("data", m2),
                     compat.axis_index("workers", m2))
    out["gather2"] = compat.all_gather(torch.tensor([rank]), "workers",
                                       mesh=m2).numpy()
    errors = {}
    try:
        tmesh.compat_make_mesh((world + 1,), ("workers",))
    except ValueError as e:
        errors["mesh_size"] = str(e)
    cfg = tp.CPMLConfig(N=world, K=2, T=1, backend="shard")
    with compat.use_mesh(m2):
        try:
            compute.all_worker_results(
                cfg, torch.as_tensor(te.poly_coeffs(cfg)),
                torch.zeros((world, 4, 3), dtype=torch.int32),
                torch.zeros((world, 3, 1, 1), dtype=torch.int32))
        except ValueError as e:
            errors["axis_not_n"] = str(e)
    try:
        compat.shard_map(lambda a: a, m1, (("workers",),), ())(
            torch.zeros(world + 1))
    except ValueError as e:
        errors["uneven"] = str(e)
    out["errors"] = errors
    return out


def _draws_sha(seed: int, cfg_kw: dict, mk: int, d: int) -> str:
    """Every draw a run at this config makes, hashed: the same on every
    rank, since ``TorchDraws`` seeds each draw by its tag."""
    cfg = tp.CPMLConfig(**cfg_kw)
    draws = tp.TorchDraws(seed, "cpu")
    arrays = [draws.dataset_masks(cfg.T, mk, d, cfg.p)]
    for t in range(3):
        arrays += list(draws.round(t, (d, cfg.c, cfg.r), cfg.T, cfg.p))
        arrays.append(draws.batch(t, mk, min(mk, 5)))
    return sha(*(a.numpy() for a in arrays))


def _port_case(spec: dict) -> dict:
    """The same run on the shard backend and, in this rank, the vmap one."""
    out = {}
    kw = dict(eta=spec["eta"], survivor_fn=_rolled(spec["cfg"]["N"],
                                                   spec["drop"]),
              eval_every=1, device="cpu")
    for backend in ("shard", "vmap"):
        cfg = tp.CPMLConfig(**spec["cfg"], backend=backend)
        for name, fn in (("train", tp.train),
                         ("train_reference", tp.train_reference)):
            w, hist = fn(cfg, spec["x"], spec["y"], spec["iters"],
                         draws=tp.TorchDraws(spec["seed"], "cpu"), **kw)
            out[f"{backend}_{name}"] = (w.numpy(), hist)
    return out


def _reference_case(spec: dict) -> dict:
    """Teacher-forced rounds from the reference's draws and its w2 each
    round: shares, gathered results and decoded parts; then a free run."""
    cfg = tp.CPMLConfig(**spec["cfg"], backend="shard")
    draws = spec["draws"]
    x = torch.as_tensor(spec["x"])
    y = torch.as_tensor(spec["y"])
    state = tp.setup(cfg, x, y, draws=draws)
    cbar = torch.as_tensor(te.poly_coeffs(cfg))
    rounds = []
    for t, (w2, order, dmat, bidx) in enumerate(spec["rounds"]):
        shares = te.encode_round_shares(cfg, draws, t, torch.as_tensor(w2))
        xb = state.x_shares
        if bidx is not None:
            xb = xb[:, torch.as_tensor(bidx, dtype=torch.int64)]
        results = compute.all_worker_results(cfg, cbar, xb, shares)
        parts = decode.decode_parts(cfg, results[torch.as_tensor(order)],
                                    torch.as_tensor(dmat))
        rounds.append((shares.numpy(), results.numpy(), parts.numpy()))
    w, _ = tp.train_reference(cfg, spec["x"], spec["y"], spec["iters"],
                              eta=spec["eta"],
                              survivor_fn=_rolled(cfg.N, spec["drop"]),
                              draws=draws, device="cpu")
    return {"x_shares": state.x_shares.numpy(), "rounds": rounds,
            "w": w.numpy()}


def protocol_rank(rank: int, world: int, job: dict) -> dict:
    """Every protocol case of ``test_torch_shard.py`` on one rank."""
    out = {"compat": _compat_units(rank, world),
           "draws_sha": _draws_sha(**job["draws"])}
    mesh = tmesh.compat_make_mesh((world,), ("workers",))
    with compat.use_mesh(mesh):
        out["port"] = {name: _port_case(spec)
                       for name, spec in job["port"].items()}
        out["reference"] = {name: _reference_case(spec)
                            for name, spec in job["reference"].items()}
    return out


def head_rank(rank: int, world: int, job: dict) -> dict:
    """``coded_head_apply_sharded`` with and without a killed shard, against
    the one-process ``coded_head_apply`` on the same rank; rank 0 saves what
    every rank computed to ``job["out"]``.  Then rank ``job["fail_rank"]``
    raises, which must fail the whole run."""
    cfg = tcl.CodedLinearConfig(**job["cfg"])
    h = torch.as_tensor(job["h"])
    shares = torch.as_tensor(job["shares"])
    mesh = tmesh.compat_make_mesh((world,), ("shards",))
    got = {}
    for name, surv in job["survivors"].items():
        ops.reset_launches()
        results, used = tcl.gathered_results(cfg, mesh, "shards", h, shares,
                                             surv)
        field = tcl.decode_field(cfg, results, used)
        logits = tcl.coded_head_apply_sharded(cfg, mesh, "shards", h, shares,
                                              surv)
        one = tcl.coded_head_apply(cfg, h, shares, surv)
        got[name] = dict(field=field.numpy(), logits=logits.numpy(),
                         one_process=one.numpy(), used=used,
                         launches=dict(ops.LAUNCHES))
    every = [None] * world
    dist.all_gather_object(every, got)
    if rank == 0:
        with open(job["out"], "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    if rank == job["fail_rank"]:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return got
