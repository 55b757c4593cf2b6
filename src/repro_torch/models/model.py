"""Model assembly; mirrors ``repro/models/model.py`` for the mamba blocks.

A model is a sequence of SEGMENTS from ``ModelConfig.block_pattern``, each
a list of homogeneous blocks.  The reference scans a segment over stacked
layer parameters; here every layer is its own module, and a Python loop
walks them.  Ported kinds:

  mamba        mamba-1 block                    (falcon-mamba)

The other kinds (dense, moe, hybrid, enc, dec) raise NotImplementedError
naming their ROADMAP item.  Forward modes: ``backbone`` / ``prefill``
(returns the decode cache) and ``decode_step`` (one token, cache update).
Training (``loss_fn``) is not ported: parameters are created without
gradients.  The reference's sharding hints (``constrain``) have no
counterpart on one device.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers, mamba
from repro_torch.models.layers import ParamSpec

# Block kinds not ported yet -> their item in ROADMAP.md's LM substrate list.
UNPORTED = {
    "dense": "queue 1b item 1 (attention, MLP, rope)",
    "moe": "queue 1b item 2 (MoE)",
    "hybrid": "queue 1b item 3 (hybrid attention + mamba)",
    "enc": "queue 1b item 4 (encoder/decoder)",
    "dec": "queue 1b item 4 (encoder/decoder)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError when a block kind of ``cfg`` is not ported."""
    for kind, _ in cfg.block_pattern:
        base = kind.replace("_global", "")
        if base in UNPORTED:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"(ROADMAP.md {UNPORTED[base]})")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not "
                                  f"ported yet (ROADMAP.md {UNPORTED['enc']})")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), init="ones")


class _Init:
    """Makes parameter leaves on ``device`` in the reference's distributions:
    normal leaves N(0, 1/fan_in), drawn from one seeded ``torch.Generator``
    on that device directly in the leaf's dtype; zeros; ones.  Leaves left
    at the default bf16 take ``dtype``.  With ``seed=None`` the leaves are
    left uninitialised, for a caller that fills them (``convert``)."""

    def __init__(self, dtype: torch.dtype, device: torch.device | str,
                 seed: int | None):
        self.dtype, self.device = dtype, torch.device(device)
        self.gen = (None if seed is None else
                    torch.Generator(device=self.device).manual_seed(seed))

    def __call__(self, spec: ParamSpec) -> nn.Parameter:
        dtype = self.dtype if spec.dtype == torch.bfloat16 else spec.dtype
        t = torch.empty(spec.shape, dtype=dtype, device=self.device)
        if self.gen is not None:
            if spec.init == "zeros":
                t.zero_()
            elif spec.init == "ones":
                t.fill_(1)
            else:
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
                t.normal_(0.0, fan_in ** -0.5, generator=self.gen)
        return nn.Parameter(t, requires_grad=False)


class MambaBlock(nn.Module):
    """rmsnorm -> mamba mixer, residual.  ``mamba`` holds the
    ``mamba_template`` leaves by the reference's names."""

    def __init__(self, cfg: ModelConfig, init: _Init):
        super().__init__()
        self.norm1 = init(_norm(cfg))
        self.mamba = nn.ParameterDict(
            {k: init(s) for k, s in mamba.mamba_template(cfg).items()})


class Model(nn.Module):
    """Embedding, segments of blocks, final norm and LM head.

    Parameter names follow the reference's pytree: ``embed``,
    ``final_norm``, ``lm_head`` and ``segments[si][layer]`` for
    ``seg{si}/params`` at that layer.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cpu", seed: int | None = 0):
        super().__init__()
        check_ported(cfg)
        init = _Init(dtype, device, seed)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = init(ParamSpec((v, d), ("vocab", "embed")))
        self.final_norm = init(_norm(cfg))
        self.lm_head = (None if cfg.tie_embeddings else
                        init(ParamSpec((d, v), ("embed", "vocab"))))
        self.segments = nn.ModuleList(
            nn.ModuleList(MambaBlock(cfg, init) for _ in range(count))
            for _, count in cfg.block_pattern)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _conv_tail(x_in: torch.Tensor, cw: int) -> torch.Tensor:
    """The last cw-1 pre-conv inputs (zeros before the sequence start), as
    a copy, so the cache does not keep the whole projection alive."""
    S = x_in.shape[1]
    if S < cw - 1:
        x_in = F.pad(x_in, (0, 0, cw - 1 - S, 0))
    return x_in[:, x_in.shape[1] - (cw - 1):].clone()


def block_forward(cfg: ModelConfig, rc: RunConfig, kind: str,
                  block: MambaBlock, x: torch.Tensor,
                  collect_cache: bool = False):
    """One block.  Returns (x, cache_entry_or_None)."""
    if kind != "mamba":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    p = block.mamba
    h = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
    x_in, z = (h @ p["in_proj"]).chunk(2, dim=-1)
    ym, h_last = mamba.mamba_mix(cfg, rc, p, x_in)
    cache = None
    if collect_cache:
        cache = {"conv": _conv_tail(x_in, cfg.conv_width), "ssm": h_last}
    x = x + (ym * F.silu(z)) @ p["out_proj"]
    return x, cache


def _stack(entries: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Per-layer cache entries -> one (count, ...) tensor per name."""
    return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}


def embed_input(cfg: ModelConfig, model: Model, batch: dict) -> torch.Tensor:
    if "embeds" in batch:                 # stubbed modality frontend
        return batch["embeds"].to(model.embed.dtype)
    return F.embedding(batch["tokens"], model.embed)


def backbone(cfg: ModelConfig, rc: RunConfig, model: Model, batch: dict,
             collect_cache: bool = False):
    """Runs embedding + all segments.  Returns (hidden, caches)."""
    x = embed_input(cfg, model, batch)
    caches = {}
    for si, ((kind, _), seg) in enumerate(zip(cfg.block_pattern,
                                              model.segments)):
        entries = []
        for block in seg:
            x, cache = block_forward(cfg, rc, kind, block, x, collect_cache)
            entries.append(cache)
        if collect_cache:
            caches[f"seg{si}"] = _stack(entries)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return x, caches


def lm_head(cfg: ModelConfig, model: Model, h: torch.Tensor) -> torch.Tensor:
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    return h @ w


def prefill(cfg: ModelConfig, rc: RunConfig, model: Model, batch: dict,
            cache_len: int, return_hidden: bool = False):
    """Prefill: returns (last-position logits, decode cache).

    ``return_hidden=True`` appends the last-position post-final-norm
    hidden state (B, 1, D), the input the Lagrange-coded head
    (``core/coded_linear``) projects instead of ``lm_head``.
    """
    h, caches = backbone(cfg, rc, model, batch, collect_cache=True)
    S = h.shape[1]
    logits = lm_head(cfg, model, h[:, -1:])
    cache = init_cache(cfg, rc, h.shape[0], cache_len, dtype=h.dtype,
                       device=h.device)
    for si in range(len(cfg.block_pattern)):
        src, dst = caches[f"seg{si}"], cache[f"seg{si}"]
        dst["ssm"] = src["ssm"].float()
        dst["conv"] = src["conv"]
    cache["index"] = S
    if return_hidden:
        return logits, cache, h[:, -1:]
    return logits, cache


def init_cache(cfg: ModelConfig, rc: RunConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> dict[str, Any]:
    """Decode cache: mamba segments get O(1) state, conv (count, B, cw-1,
    di) in ``dtype`` and ssm (count, B, di, n) float32; ``index`` is the
    number of tokens seen.  ``max_len`` sizes the attention caches of the
    kinds not ported yet."""
    check_ported(cfg)
    cache: dict[str, Any] = {"index": 0}
    for si, (_, count) in enumerate(cfg.block_pattern):
        cache[f"seg{si}"] = {
            "conv": torch.zeros((count, batch, cfg.conv_width - 1,
                                 cfg.d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((count, batch, cfg.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=device),
        }
    return cache


def decode_block(cfg: ModelConfig, rc: RunConfig, kind: str,
                 block: MambaBlock, x: torch.Tensor,
                 cache_layer: dict[str, torch.Tensor]):
    """One block's single-token step.  Returns (x, new cache entry)."""
    if kind != "mamba":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    p = block.mamba
    hnorm = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
    x_in, z = (hnorm @ p["in_proj"]).chunk(2, dim=-1)
    ym, mcache = mamba.mamba_decode_core(cfg, p, x_in, cache_layer)
    return x + (ym * F.silu(z)) @ p["out_proj"], mcache


def decode_step(cfg: ModelConfig, rc: RunConfig, model: Model, cache: dict,
                batch: dict, return_hidden: bool = False):
    """One decode step: batch {'tokens': (B,1)} -> (logits (B,1,V), cache).

    ``return_hidden=True`` appends the post-final-norm hidden state
    (B, 1, D), mirroring ``prefill``.  The given cache is not modified.
    """
    x = embed_input(cfg, model, batch)
    new_cache: dict[str, Any] = {"index": cache["index"] + 1}
    for si, ((kind, _), seg) in enumerate(zip(cfg.block_pattern,
                                              model.segments)):
        seg_cache = cache[f"seg{si}"]
        entries = []
        for li, block in enumerate(seg):
            x, nc = decode_block(cfg, rc, kind, block, x,
                                 {k: v[li] for k, v in seg_cache.items()})
            entries.append(nc)
        new_cache[f"seg{si}"] = _stack(entries)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = lm_head(cfg, model, x)
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache
