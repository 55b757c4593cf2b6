"""--arch <id> resolution; mirrors ``repro/configs/registry.py``.

``input_specs`` (abstract, sharded inputs for the XLA dry run) is not
ported: it belongs to the meta-device dry run (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig

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
