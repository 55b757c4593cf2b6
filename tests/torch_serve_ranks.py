"""Rank functions of the mesh-serving tests (``test_torch_serving_mesh.py``),
run by ``launch.mesh.run_ranks`` in one group of 4 gloo ranks on the CPU.

A spawned rank imports this module by name, so it imports torch, numpy and
the port only, never JAX.  ``serve_case`` runs one case (prefill, teacher-
forced decode steps and, where asked, ``serve.greedy_decode``) on a mesh
or, with ``mesh=None``, in one process: the test runs the same function for
the one-process port.  Rank 0 returns the full logits and caches; every
rank returns its cache blocks' shapes and placements, its greedy tokens and
whether any value it held was nan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.parallel import rules
from torch_lm_ranks import MESHES
from torch_moe_ranks import WHISPER


def config(arch: str, **overrides):
    """The reduced config of ``arch``: hymba's with 3 query heads and 1 kv
    head (a model axis of 2 or 4 takes the context-parallel prefill),
    whisper's with 6 heads (``torch_moe_ranks.WHISPER``)."""
    cfg = registry.reduced_config(registry.get_config(arch))
    if arch.startswith("hymba"):
        cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1,
                                  head_dim=16)
    if arch == "whisper-tiny":
        cfg = dataclasses.replace(cfg, **WHISPER)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def case_inputs(cfg, case: dict) -> dict:
    """The case's tokens (B, S + steps) and, for whisper, its frames
    (B, Se, d), float32, from a numpy seed."""
    rng = np.random.default_rng(case["seed"])
    B, S, n = case["batch"], case["prompt"], case["steps"]
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + n))
           .astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _leaves(cache: dict):
    for seg, leaves in cache.items():
        if seg != "index":
            for name, t in leaves.items():
                yield f"{seg}.{name}", t


def serve_case(case: dict, rc, mesh=None) -> dict:
    """Prefill of the case's prompt into a cache of ``case["cache_len"]``,
    then ``case["steps"]`` decode steps teacher-forced on its tokens and
    one step of its first token from a fresh cache (``init_cache``), with
    the seeded float32 model, on ``mesh`` (inputs placed as
    ``registry.input_specs`` places them) or in one process.  Returns the
    logits of each call and the cache after it, whole, and each cache
    leaf's block shape and placements and the cache's ``input_specs``
    on the mesh; with ``case["greedy"]``, ``serve.greedy_decode``'s tokens
    from the same prompt."""
    cfg = config(case["arch"], **case.get("cfg", {}))
    rc = dataclasses.replace(rc, **case.get("rc", {}))
    ins = case_inputs(cfg, case)
    B, S, L = case["batch"], case["prompt"], case["cache_len"]
    model = TM.Model(cfg, dtype=torch.float32, device="cpu",
                     seed=case["seed"])
    toks = torch.from_numpy(ins["tokens"])
    frames = (torch.from_numpy(ins["frames"]) if "frames" in ins else None)
    pre = dec = want = None
    if mesh is not None:
        TM.place_on_mesh(cfg, model, mesh)
        pre = registry.input_specs(cfg, ShapeConfig("p", S, B, "prefill"),
                                   mesh, rc)
        dec = registry.input_specs(cfg, ShapeConfig("d", L, B, "decode"),
                                   mesh, rc)
        want = {k: (list(v.shape), list(v.spec),
                    [repr(p) for p in v.placements])
                for k, v in _leaves(dec["cache"])}

    def place(t: torch.Tensor, specs, name: str) -> torch.Tensor:
        return t if specs is None else rules.distribute(
            t, mesh, specs[name].placements)

    out: dict = {"logits": [], "cache": [], "blocks": [], "index": [],
                 "nan": False}

    def record(logits, cache):
        out["logits"].append(rules.full(logits).numpy().copy())
        out["nan"] |= bool(torch.isnan(rules.local(logits)).any())
        full, blocks = {}, {}
        for k, t in _leaves(cache):
            full[k] = rules.full(t).numpy().copy()
            out["nan"] |= bool(torch.isnan(rules.local(t)).any())
            if mesh is not None:
                blocks[k] = (list(rules.local(t).shape),
                             [repr(p) for p in t.placements])
        out["cache"].append(full)
        out["blocks"].append(blocks)
        out["index"].append(cache["index"])

    ctx = (rules.use_rules_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    with torch.no_grad(), ctx:
        enc: dict = {}
        if frames is not None:
            enc["enc_out"] = TM.encode(cfg, rc, model,
                                       place(frames, pre, "enc_embeds"))
        batch = {"tokens": place(toks[:, :S], pre, "tokens"), **enc}
        logits, cache = TM.prefill(cfg, rc, model, batch, cache_len=L)
        record(logits, cache)
        for t in range(case["steps"]):
            tok = place(toks[:, S + t: S + t + 1], dec, "tokens")
            logits, cache = TM.decode_step(cfg, rc, model, cache,
                                           {"tokens": tok, **enc})
            record(logits, cache)
        # one step from a fresh cache: only slot 0's rank holds a filled
        # slot
        fresh = TM.init_cache(cfg, rc, B, L, dtype=torch.float32,
                              device="cpu", mesh=mesh)
        logits, cache = TM.decode_step(
            cfg, rc, model, fresh,
            {"tokens": place(toks[:, :1], dec, "tokens"), **enc})
        record(logits, cache)
        if case.get("greedy"):
            out["greedy"] = rules.full(serve.greedy_decode(
                cfg, rc, model, place(toks[:, :S], pre, "tokens"),
                case["steps"], enc_embeds=(
                    None if frames is None else
                    place(frames, pre, "enc_embeds")))).numpy()
    out["want_blocks"] = want
    out["mesh"] = None if mesh is None else {
        n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return out


def serve_rank(rank: int, world: int, job: dict) -> dict:
    """Every case of ``test_torch_serving_mesh.py`` on this rank: rank 0
    keeps the whole arrays, the other ranks what they must agree on."""
    meshes = {name: tmesh.compat_make_mesh(shape, ("data", "model"))
              for name, shape in MESHES.items()}
    rc = convert.run_config_from_reference(job["rc"])
    out = {}
    for name, case in job["cases"].items():
        t0 = time.perf_counter()
        got = serve_case(case, rc, meshes[case["mesh"]])
        got["seconds"] = time.perf_counter() - t0
        if rank != 0:
            got = {k: got[k] for k in ("blocks", "want_blocks", "nan",
                                        "greedy", "index", "seconds")
                   if k in got}
        out[name] = got
    return {"rank": rank, "cases": out}
