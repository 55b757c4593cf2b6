"""Rank functions of the MoE and encoder-decoder sharding tests
(``test_torch_sharding_moe.py``), run by ``launch.mesh.run_ranks`` in one
group of 4 gloo ranks on the CPU.

A spawned rank imports this module by name, so it imports torch, numpy and
the port only, never JAX: the reference's parameters, frames and run
configuration reach the ranks as numpy arrays and plain dicts.  Rank 0
returns the arrays the tests compare; every rank returns hashes of what it
holds and the routing it computed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.loader import LMBatchLoader
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import model as TM
from repro_torch.models import moe
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import rules
from torch_lm_ranks import MESHES, _driver_case, full, sha

# whisper's 6 heads at a narrow width: a model axis of 4 takes the
# context-parallel branch in the encoder and the decoder; an odd vocab, as
# whisper-tiny's 51865, replicates over model
WHISPER = dict(d_model=96, num_heads=6, num_kv_heads=6, head_dim=16,
               vocab_size=255)


def config(arch: str, **overrides):
    """The reduced config of ``arch`` (whisper's with ``WHISPER``), with
    ``overrides`` on top."""
    cfg = registry.reduced_config(registry.get_config(arch))
    if arch == "whisper-tiny":
        cfg = dataclasses.replace(cfg, **WHISPER)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def place_batch(batch: dict, mesh) -> dict:
    """The batch's tensors as ``DTensor``s laid out as ("batch", "seq",
    None), the reference's input specs (the loader's batches already
    are)."""
    out = {}
    for k, v in batch.items():
        if rules.is_dtensor(v):
            out[k] = v
            continue
        logical = ("batch", "seq", None)[:v.ndim]
        out[k] = rules.distribute(v, mesh, rules.act_placements(
            mesh, v.shape, logical))
    return out


class Routing:
    """Records every routing the MoE layer computes on this rank (both
    dispatch paths): the router logits, each (token, choice)'s expert and
    whether it kept its place under the capacity, in (token, choice)
    order."""

    def __init__(self):
        self.calls: list[dict] = []
        self._einsum, self._sort = moe.einsum_routing, moe.sort_routing

    def einsum(self, cfg, logits, C):
        out = self._einsum(cfg, logits, C)
        _, onehot, _, keep = out
        self._add("einsum", logits, onehot.argmax(-1),
                  (keep & onehot.bool()).any(-1), C)
        return out

    def sort(self, cfg, logits, C):
        out = self._sort(cfg, logits, C)
        _, order, sorted_e, _, keep = out
        idx = torch.empty_like(sorted_e).scatter_(0, order, sorted_e)
        kept = torch.empty_like(keep).scatter_(0, order, keep)
        k = cfg.experts_per_token
        self._add("sort", logits, idx.reshape(-1, k), kept.reshape(-1, k), C)
        return out

    def _add(self, impl, logits, idx, kept, C):
        self.calls.append({"impl": impl, "C": C,
                           "logits": logits.detach().numpy().copy(),
                           "idx": idx.numpy().copy(),
                           "kept": kept.numpy().copy()})

    def patch(self):
        return mock.patch.multiple(moe, einsum_routing=self.einsum,
                                   sort_routing=self.sort)


def _train_case(meshes, job: dict) -> dict:
    """``job["steps"]`` AdamW steps of ``train.train_step_fn`` on each
    (arch, mesh) from the reference's parameters, on the loader's batches
    (and each step's frames for whisper)."""
    rc = convert.run_config_from_reference(job["rc"])
    ocfg = topt.OptimizerConfig(**job["opt"])
    out = {}
    for arch, mesh_name in job["cases"]:
        cfg = config(arch)
        mesh = meshes[mesh_name]
        model = convert.params_from_reference(cfg, job["params"][arch])
        model.requires_grad_(True)
        params, state, _ = ttrain.build_sharded_state(cfg, rc, ocfg, mesh,
                                                      model)
        step = ttrain.train_step_fn(cfg, rc, ocfg, model)
        steps = []
        cp = mock.patch.object(layers, "context_parallel_attention",
                               wraps=layers.context_parallel_attention)
        with LMBatchLoader("cpu", job["B"], job["S"], cfg.vocab_size,
                           mesh=mesh) as loader, cp as cp_calls:
            for i in range(job["steps"]):
                batch = next(loader)
                if cfg.is_encoder_decoder:
                    batch["enc_embeds"] = torch.from_numpy(job["frames"][i])
                batch = place_batch(batch, mesh)
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
                    "cp_calls": cp_calls.call_count,
                    "params": p if dist.get_rank() == 0 else None,
                    "moments": mom if dist.get_rank() == 0 else None})
        out[(arch, mesh_name)] = steps
    return out


def grads_case(cfg, rc, mesh, batch: dict, seed: int) -> dict:
    """The seeded float32 model's backbone output, loss and every gradient
    leaf, on ``mesh`` (full tensors) or, with ``mesh=None``, in one
    process."""
    model = TM.Model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    model.requires_grad_(True)
    if mesh is not None:
        TM.place_on_mesh(cfg, model, mesh)
        batch = place_batch(batch, mesh)
    with (rules.use_rules_mesh(mesh) if mesh is not None else
          contextlib.nullcontext()):
        h, _ = TM.backbone(cfg, rc, model, batch)
        loss = TM.chunked_loss(cfg, rc, model, h, batch["labels"])
        loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        g = p.grad
        if rules.is_dtensor(g):
            g = g.redistribute(g.device_mesh, p.placements)
        grads[k] = rules.full(g).detach().numpy().copy()
    return {"h": rules.full(h).detach().numpy().copy(),
            "loss": float(rules.full(loss.detach())), "grads": grads,
            "placements": ({k: [repr(x) for x in p.placements]
                            for k, p in model.named_parameters()}
                           if mesh is not None else None)}


def drop_batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grads_cases(meshes, job: dict) -> dict:
    """Each case's gradients on its mesh, with the routing every rank
    computed."""
    out = {}
    for name, case in job["cases"].items():
        cfg = config(case["arch"], **case["cfg"])
        rc = dataclasses.replace(ttrain.run_config(job["S"], job["B"]),
                                 **case["rc"])
        routing = Routing()
        with routing.patch():
            got = grads_case(cfg, rc, meshes[case["mesh"]],
                             drop_batch(cfg, job["B"], job["S"], job["seed"]),
                             job["seed"])
        got["routing"] = routing.calls
        if dist.get_rank() != 0:
            got = {"loss": got["loss"], "routing": got["routing"],
                   "placements": got["placements"]}
        out[name] = got
    return out


def _rules_case(meshes, archs) -> dict:
    out = {}
    for name, mesh in meshes.items():
        for arch in archs:
            leaves = TM.param_leaves(config(arch))
            out[(name, arch)] = {k: [repr(p) for p in
                                     rules.sharding_for(mesh, leaf)]
                                 for k, leaf in leaves.items()}
    return out


def moe_rank(rank: int, world: int, job: dict) -> dict:
    """Every case of ``test_torch_sharding_moe.py`` on this rank."""
    meshes = {name: tmesh.compat_make_mesh(shape, ("data", "model"))
              for name, shape in MESHES.items()}
    return {"rank": rank,
            "coords": {name: tuple(m.get_local_rank(i) for i in range(2))
                       for name, m in meshes.items()},
            "rules": _rules_case(meshes, job["rules"]),
            "train": _train_case(meshes, job["train"]),
            "grads": _grads_cases(meshes, job["grads"]),
            "driver": _driver_case(job["driver"])}
