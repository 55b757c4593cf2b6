"""Mamba-1 selective SSM block (falcon-mamba); mirrors
``repro/models/mamba.py``.

Prefill runs the whole sequence through ``kernels.ops.selective_scan``: the
hand-written CUDA kernel on a CUDA tensor, its plain sequential version on
a CPU tensor.  The reference's chunked associative scan (``_chunk_scan``
over materialised (B, chunk, d_inner, n) tensors) has no counterpart here:
the kernel keeps h on chip for the whole sequence.  With the default
``RunConfig.ssm_dtype="f32"`` it computes the same function as the
reference's ``mamba_mix`` (``tests/test_kernels_mamba.py`` holds the
reference kernel against it), and ``scan_chunk`` changes nothing.  With
``ssm_dtype="bf16"`` the kernel rounds a and b to bf16 and combines them
in bf16 within chunks of ``scan_chunk`` steps, h in float32 across
chunks, as the reference does; it combines sequentially where the
reference combines a chunk as a tree, so the two round in another order.

Decode is the exact single-step recurrence with (conv window, ssm state)
carried in the cache, in plain PyTorch as in the reference.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec

Params = Mapping[str, torch.Tensor]


def mamba_template(cfg: ModelConfig, d_model: int | None = None
                   ) -> dict[str, ParamSpec]:
    d = d_model or cfg.d_model
    di, n, dtr, cw = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.conv_width
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamSpec((cw, di), (None, "inner")),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * n), ("inner", None)),
        "dt_proj": ParamSpec((dtr, di), (None, "inner")),
        "dt_bias": ParamSpec((di,), ("inner",), init="ones"),
        "A_log": ParamSpec((di, n), ("inner", None), dtype=torch.float32,
                           init="ones"),
        "D": ParamSpec((di,), ("inner",), dtype=torch.float32, init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _ssm_params(p: Params, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, L, di) post-conv activations -> (dt, B_mat, C_mat) in the
    parameter dtype.

    The projections run in the parameter dtype and the softplus in it too;
    the cast to float32 is the caller's, as the reference casts last: the
    decode step casts all three, and the prefill's scan kernel reads dt and
    Bm/Cm in their own dtype (an exact widening).
    """
    dtr = p["dt_proj"].shape[0]
    n = (p["x_proj"].shape[1] - dtr) // 2
    proj = x @ p["x_proj"]                                   # (B, L, dtr+2n)
    dt = layers.softplus(proj[..., :dtr] @ p["dt_proj"]
                         + p["dt_bias"].to(proj.dtype))      # (B, L, di)
    Bm = proj[..., dtr: dtr + n]                             # (B, L, n)
    Cm = proj[..., dtr + n:]                                 # (B, L, n)
    return dt, Bm, Cm


def _discretize(p: Params, dt: torch.Tensor, Bm: torch.Tensor,
                x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = exp(dt*A) (B,L,di,n); b = dt*B*x (B,L,di,n), float32."""
    A = -torch.exp(p["A_log"].float())                       # (di, n)
    a = torch.exp(dt[..., None] * A[None, None])
    b = dt[..., None] * Bm[:, :, None, :] * x.float()[..., None]
    return a, b


def mamba_mix(cfg: ModelConfig, rc: RunConfig, p: Params, x_in: torch.Tensor,
              h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-scan core.  x_in: (B, S, di) pre-conv.  Returns
    (y (B, S, di) in x_in's dtype, h_last (B, di, n) float32).
    ``rc.ssm_dtype`` and ``rc.scan_chunk`` choose the scan's a/b mode."""
    B, S, di = x_in.shape
    cw = cfg.conv_width
    # depthwise causal conv: the cw shifted slices summed in the
    # reference's order (F.conv1d rounds bf16 differently)
    xp = F.pad(x_in, (0, 0, cw - 1, 0))
    x = sum(xp[:, i: i + S] * p["conv_w"][i] for i in range(cw))
    x = layers.silu(x + p["conv_b"].to(x.dtype))
    dt, Bm, Cm = _ssm_params(p, x)
    if h0 is None:
        h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                         device=x_in.device)
    y, h_last = ops.selective_scan(x, dt, Bm, Cm, p["A_log"], p["D"], h0,
                                   rc.ssm_dtype, rc.scan_chunk)
    return y.to(x_in.dtype), h_last


def mamba_forward(cfg: ModelConfig, rc: RunConfig, p: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """Full mamba block.  x: (B, S, d_model) -> (B, S, d_model)."""
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    y, _ = mamba_mix(cfg, rc, p, x_in)
    return (y * layers.silu(z)) @ p["out_proj"]


def mamba_decode_core(cfg: ModelConfig, p: Params, x_in: torch.Tensor,
                      cache: Mapping[str, torch.Tensor]
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token recurrence on the pre-conv branch input.

    x_in: (B, 1, di); cache: conv (B, cw-1, di), ssm (B, di, n).
    Returns (y (B, 1, di), new cache).  O(1) in context length.
    """
    conv_buf = torch.cat([cache["conv"].to(x_in.dtype), x_in],
                         dim=1)                             # (B, cw, di)
    xc = torch.einsum("bwi,wi->bi", conv_buf, p["conv_w"])[:, None]
    xc = layers.silu(xc + p["conv_b"].to(xc.dtype))
    dt, Bm, Cm = (t.float() for t in _ssm_params(p, xc))   # (B, 1, ...)
    a, b = _discretize(p, dt, Bm, xc)            # (B, 1, di, n)
    h = a[:, 0] * cache["ssm"] + b[:, 0]         # (B, di, n)
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None]
    y = y + p["D"].float() * xc.float()
    return y.to(x_in.dtype), {"conv": conv_buf[:, 1:], "ssm": h}


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Mapping[str, torch.Tensor]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-block single-token step.  x: (B, 1, d_model)."""
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)                # (B, 1, di)
    y, new_cache = mamba_decode_core(cfg, p, x_in, cache)
    return (y * layers.silu(z)) @ p["out_proj"], new_cache
