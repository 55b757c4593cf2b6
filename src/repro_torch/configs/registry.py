"""--arch <id> resolution and each cell's inputs as a mesh places them;
mirrors ``repro/configs/registry.py``.

``input_specs`` gives the inputs one (arch x shape) cell runs with: token
ids for the LM archs, the stubbed frontends' frame or patch embeddings,
and for a decode cell the decode cache.  Each leaf is an ``InputSpec``:
its shape, dtype, partition spec (``parallel/rules.py``'s tuple) and
``DTensor`` placements on the mesh.  Nothing is allocated: the cache's
shapes come from ``models/model.py``'s ``init_cache`` on the meta device,
and ``init_cache(..., mesh=)`` builds the cache placed the same way.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig

ARCHS: dict[str, str] = {
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1p1b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one step, no NaNs)."""
    d = 64
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    pattern = tuple((kind, min(count, 2)) for kind, count in
                    cfg.block_pattern[:2])
    layers = sum(c for _, c in pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d,
        num_heads=heads, num_kv_heads=kv,
        head_dim=(d // heads if heads else 0),
        d_ff=(128 if cfg.d_ff else 0),
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        moe_d_ff=(64 if cfg.num_experts else 0),
        dense_residual_d_ff=(64 if cfg.dense_residual_d_ff else 0),
        d_inner=(128 if cfg.ssm_state else 0),
        dt_rank=(8 if cfg.ssm_state else 0),
        sliding_window=(32 if cfg.sliding_window else None),
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq_len=16,
        block_pattern=pattern,
    )


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason when skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense decode is "
                       "O(S^2)-infeasible; skipped per brief (DESIGN.md §4)")
    return True, ""


class InputSpec(NamedTuple):
    """One input leaf: shape, dtype, partition spec (one entry a dim up to
    the last sharded one, as ``rules.spec_for`` gives it) and its
    placements on the mesh's dims."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    placements: tuple


def _size(mesh, axes) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes) if axes else 1


def _leaf(mesh, shape, dtype, spec) -> InputSpec:
    from repro_torch.parallel import rules

    while spec and spec[-1] is None:
        spec = spec[:-1]
    return InputSpec(tuple(shape), dtype, tuple(spec),
                     rules.placements(mesh, tuple(spec)))


def _tok(mesh, shape, batch_axes, dtype: torch.dtype = torch.int32
         ) -> InputSpec:
    """A (B, ...) input with its batch over ``batch_axes`` where B divides
    their product, replicated otherwise, and the rest whole."""
    from repro_torch.parallel import rules

    lead = ((batch_axes if len(batch_axes) > 1 else batch_axes[0])
            if batch_axes and shape[0] % _size(rules.named(mesh),
                                               batch_axes) == 0 else None)
    return _leaf(mesh, shape, dtype, (lead,))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rc: RunConfig | None = None) -> dict:
    """The inputs of one cell on ``mesh`` (a ``DeviceMesh`` with named
    dims, or any object with ``axis_names`` and ``shape``), as the
    reference's ``input_specs`` gives them: ``tokens`` (or ``embeds``
    for a vision frontend), ``enc_embeds`` for an encoder-decoder model
    and ``labels`` for a train cell; a decode cell has one new token, the
    encoder output ``enc_out`` and the ``cache`` of length
    ``shape.seq_len``, each leaf placed by ``model.CACHE_LOGICAL``
    (k and v with their sequence over ``model`` where it divides, else
    their kv heads; conv and ssm by ``inner``) and ``index`` replicated."""
    from repro_torch.models import model as M
    from repro_torch.parallel import rules

    rc = rc or RunConfig()
    axes = rules.named(mesh)
    B, S = shape.global_batch, shape.seq_len
    batch_axes = tuple(a for a in ("pod", "data") if a in axes.axis_names)
    bf16 = torch.bfloat16
    frames = (B, cfg.encoder_seq_len, cfg.d_model)
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend in ("vision", "audio") and not cfg.is_encoder_decoder:
            specs["embeds"] = _tok(mesh, (B, S, cfg.d_model), batch_axes,
                                   bf16)
        else:
            specs["tokens"] = _tok(mesh, (B, S), batch_axes)
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = _tok(mesh, frames, batch_axes, bf16)
        if shape.kind == "train":
            specs["labels"] = _tok(mesh, (B, S), batch_axes)
        return specs
    # decode: one new token and a cache of length S
    specs["tokens"] = _tok(mesh, (B, 1), batch_axes)
    if cfg.is_encoder_decoder:
        specs["enc_out"] = _tok(mesh, frames, batch_axes, bf16)
    shapes = M.init_cache(cfg, rc, B, S, device="meta")
    cache: dict = {"index": _leaf(mesh, (), torch.int32, ())}
    for key, seg in shapes.items():
        if key == "index":
            continue
        cache[key] = {name: _leaf(mesh, t.shape, t.dtype, rules.spec_for(
            axes, tuple(t.shape), M.CACHE_LOGICAL[name]))
            for name, t in seg.items()}
    specs["cache"] = cache
    return specs
