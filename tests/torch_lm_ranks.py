"""Rank functions of the LM sharding tests (``test_torch_sharding.py``),
run by ``launch.mesh.run_ranks`` in one group of 4 gloo ranks on the CPU.

A spawned rank imports this module by name, so it imports torch, numpy and
the port only, never JAX: the reference's parameters and run configuration
reach the ranks as numpy arrays and plain dicts.  Rank 0 returns the
arrays the tests compare; every rank returns hashes of what it holds.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.configs import registry
from repro_torch.data.loader import LMBatchLoader
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import rules

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}


def config(arch: str):
    """The reduced config of ``arch``; hymba's with 3 heads and 1 kv head,
    so that a model axis of 2 takes the context-parallel branch."""
    cfg = registry.reduced_config(registry.get_config(arch))
    if arch.startswith("hymba"):
        cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1,
                                  head_dim=16)
    return cfg


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def full(t: torch.Tensor) -> np.ndarray:
    """A copy of the full tensor (a replicated one's is its local tensor,
    which the next step updates in place)."""
    return t.full_tensor().detach().cpu().numpy().copy()


def _rules_case(meshes) -> dict:
    """Every leaf's placements from a DeviceMesh, as strings, by mesh."""
    out = {}
    for name, mesh in meshes.items():
        for arch in ("tinyllama-1.1b", "hymba-1.5b", "falcon-mamba-7b"):
            leaves = TM.param_leaves(config(arch))
            out[(name, arch)] = {k: [repr(p) for p in
                                     rules.sharding_for(mesh, leaf)]
                                 for k, leaf in leaves.items()}
    return out


def _constrain_case(meshes) -> dict:
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    out = {}
    for name, mesh in meshes.items():
        d = rules.distribute(x, mesh, rules.placements(mesh, ()))
        with rules.use_rules_mesh(mesh):
            c = rules.constrain(d, ("batch", "seq", None))
            h = rules.constrain(d, (None, None, "heads[6]"))
        out[name] = {"batch": [repr(p) for p in c.placements],
                     "heads": [repr(p) for p in h.placements],
                     "equal": bool(torch.equal(c.full_tensor(), x)
                                   and torch.equal(h.full_tensor(), x))}
    return out


def _cp_case(meshes, job: dict) -> dict:
    """``context_parallel_attention``'s forward and q, k, v gradients."""
    from torch.distributed.tensor import Replicate

    out = {}
    for mesh_name in job["meshes"]:
        mesh = meshes[mesh_name]
        rep = tuple(Replicate() for _ in range(mesh.ndim))
        for window in job["windows"]:
            q, k, v = (rules.distribute(torch.from_numpy(job[n]), mesh, rep)
                       .requires_grad_(True) for n in ("q", "k", "v"))
            o = layers.context_parallel_attention(
                mesh, q, k, v, causal=True, window=window, **job["blocks"])
            dout = rules.distribute(torch.from_numpy(job["dout"]), mesh,
                                    tuple(o.placements))
            (o * dout).sum().backward()
            got = [full(o)] + [full(t.grad) for t in (q, k, v)]
            out[(mesh_name, window)] = {
                "placements": [repr(p) for p in o.placements],
                "sha": sha(*got), "arrays": got if dist.get_rank() == 0
                else None}
    return out


def _train_case(meshes, job: dict) -> dict:
    """``job["steps"]`` AdamW steps of ``train.train_step_fn`` on each
    mesh from the reference's parameters, on the loader's batches."""
    rc = convert.run_config_from_reference(job["rc"])
    ocfg = topt.OptimizerConfig(**job["opt"])
    out = {}
    for arch, tree in job["params"].items():
        cfg = config(arch)
        for mesh_name in job["meshes"]:
            mesh = meshes[mesh_name]
            model = convert.params_from_reference(cfg, tree)
            model.requires_grad_(True)
            params, state, _ = ttrain.build_sharded_state(cfg, rc, ocfg, mesh,
                                                          model)
            step = ttrain.train_step_fn(cfg, rc, ocfg, model)
            steps = []
            with LMBatchLoader("cpu", job["B"], job["S"], cfg.vocab_size,
                               mesh=mesh) as loader:
                for _ in range(job["steps"]):
                    batch = next(loader)
                    with rules.use_rules_mesh(mesh):
                        params, state, metrics = step(params, state, batch)
                    p = {k: full(t) for k, t in params.items()}
                    mom = {n: {k: full(t) for k, t in state[n].items()}
                           for n in ("mu", "nu")}
                    steps.append({
                        "loss": float(metrics["loss"]),
                        "sha": sha(*(p[k] for k in sorted(p))),
                        "placements": {k: [repr(x) for x in t.placements]
                                       for k, t in params.items()},
                        "params": p if dist.get_rank() == 0 else None,
                        "moments": mom if dist.get_rank() == 0 else None})
            out[(arch, mesh_name)] = steps
    return out


def _loader_case(meshes, job: dict) -> dict:
    out = {}
    for batch in job["batches"]:
        with LMBatchLoader("cpu", batch, job["S"], job["vocab"],
                           mesh=meshes["2x2"]) as loader:
            b = next(loader)
        out[batch] = {"placements": [repr(p) for p in b["tokens"].placements],
                      "tokens": full(b["tokens"]), "labels": full(b["labels"])}
    return out


def _checkpoint_case(meshes, job: dict) -> dict:
    """A (2,2) state saved, restored at (4,1), (1,4) and with no mesh."""
    cfg = config("tinyllama-1.1b")
    rc = convert.run_config_from_reference(job["rc"])
    ocfg = topt.OptimizerConfig()
    model = TM.Model(cfg, dtype=torch.float32, device="cpu", seed=3)
    model.requires_grad_(True)
    params, state, _ = ttrain.build_sharded_state(cfg, rc, ocfg,
                                                  meshes["2x2"], model)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for k, m in state["mu"].items():
            m.copy_(rules.distribute(torch.randn(m.shape, generator=gen),
                                     m.device_mesh, tuple(m.placements)))
    want = {"params": {k: full(t) for k, t in params.items()},
            "mu": {k: full(t) for k, t in state["mu"].items()}}
    writes = []
    real = np.savez

    def savez(*a, **kw):
        writes.append(a[0])
        return real(*a, **kw)

    mgr = ckpt_mod.CheckpointManager(job["dir"])
    with mock.patch.object(ckpt_mod.np, "savez", savez):
        mgr.save(5, {"params": params, "opt_state": state})
    out = {"writes": len(writes), "restored": {}}
    for name in ("4x1", "1x4"):
        mesh = meshes[name]
        fresh = TM.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
        fresh.requires_grad_(True)
        _, _, shardings = ttrain.build_sharded_state(cfg, rc, ocfg, mesh,
                                                     fresh)
        got = mgr.restore(shardings=shardings)
        leaves = TM.param_leaves(cfg)
        out["restored"][name] = {
            "step": got["step"],
            "equal": all(np.array_equal(full(t), want["params"][k])
                         for k, t in got["params"].items())
            and all(np.array_equal(full(t), want["mu"][k])
                    for k, t in got["opt_state"]["mu"].items()),
            "placements_as_rules": all(
                tuple(t.placements) == rules.sharding_for(mesh, leaves[k])
                for k, t in got["params"].items())
            and all(tuple(t.placements) == rules.sharding_for(mesh, leaves[k])
                    for k, t in got["opt_state"]["nu"].items())}
    plain = mgr.restore()
    out["restored"]["none"] = {
        "step": plain["step"],
        "equal": all(np.array_equal(t.numpy(), want["params"][k])
                     for k, t in plain["params"].items()),
        "placements_as_rules": all(type(t) is torch.Tensor
                                   for t in plain["params"].values())}
    return out


_run_config = ttrain.run_config


def float32_run_config(seq: int, batch: int):
    """``launch/train.py``'s run configuration with float32 parameters."""
    return dataclasses.replace(_run_config(seq, batch), param_dtype="float32")


def _driver_case(job: dict) -> dict:
    argv = [*job["argv"], "--checkpoint-dir", job["dir"]]
    if dist.get_rank() == 0:
        argv += ["--json-out", job["json"]]
    with mock.patch.object(ttrain, "run_config", float32_run_config):
        return {"rc": ttrain.main(argv)}


def lm_rank(rank: int, world: int, job: dict) -> dict:
    """Every case of ``test_torch_sharding.py`` on this rank."""
    meshes = {name: tmesh.compat_make_mesh(shape, ("data", "model"))
              for name, shape in MESHES.items()}
    out = {"rank": rank, "backend": dist.get_backend(),
           "pid": os.getpid(),
           "rules": _rules_case(meshes),
           "constrain": _constrain_case(meshes),
           "cp": _cp_case(meshes, job["cp"]),
           "train": _train_case(meshes, job["train"]),
           "loader": _loader_case(meshes, job["loader"]),
           "checkpoint": _checkpoint_case(meshes, job["checkpoint"])}
    out["driver"] = _driver_case(job["driver"])
    return out
