"""Mixture-of-Experts layer; mirrors ``repro/models/moe.py``.

Top-k routing with two dispatch paths, both as in the reference:
``moe_forward_einsum`` (the default, GShard capacity dispatch: one-hot
dispatch and combine tensors, over-capacity tokens dropped) and
``moe_forward_sort`` (tokens sorted by expert into padded per-expert
slabs).  Arctic's dense residual MLP runs beside either.

Every product is a plain batched matrix product (``torch.einsum``,
``torch.bmm``), as the reference computes them outside any Pallas kernel.
Routing follows the reference bit for bit where it can decide a token's
fate: the top-k is a stable descending sort, so tied logits go to the
lower expert index as ``jax.lax.top_k`` sends them (``torch.topk`` does
not), and positions in an expert count in the same (token, choice) order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import ParamSpec, Params, silu


def moe_template(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """router (d, E) float32; experts' w1, w3 (E, d, ff) and w2 (E, ff, d);
    the dense residual's res_w1, res_w3, res_w2 where the config has one."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    t = {
        "router": ParamSpec((d, e), ("embed", None), dtype=torch.float32),
        "w1": ParamSpec((e, d, ff), ("experts", "embed", None)),
        "w3": ParamSpec((e, d, ff), ("experts", "embed", None)),
        "w2": ParamSpec((e, ff, d), ("experts", None, "embed")),
    }
    if cfg.dense_residual_d_ff:
        dff = cfg.dense_residual_d_ff
        t["res_w1"] = ParamSpec((d, dff), ("embed", "ffn"))
        t["res_w3"] = ParamSpec((d, dff), ("embed", "ffn"))
        t["res_w2"] = ParamSpec((dff, d), ("ffn", "embed"))
    return t


def _top_k_gating(cfg: ModelConfig, router_logits: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., E) logits -> (weights float32, indices int64), both (..., k);
    the weights softmax-normed over the k chosen logits.  Equal logits rank
    by the lower expert index, as ``jax.lax.top_k`` ranks them."""
    k = cfg.experts_per_token
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    return torch.softmax(vals[..., :k].float(), dim=-1), idx[..., :k]


def _dense_residual(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ p["res_w1"]) * (x @ p["res_w3"])) @ p["res_w2"]


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's swiglu on its dispatched slab: xe (G, E, C, d) ->
    (G, E, C, d)."""
    h = torch.einsum("becd,edf->becf", xe, p["w1"])
    h = silu(h) * torch.einsum("becd,edf->becf", xe, p["w3"])
    return torch.einsum("becf,efd->becd", h, p["w2"])


def moe_forward_einsum(cfg: ModelConfig, rc: RunConfig, p: Params,
                       x: torch.Tensor) -> torch.Tensor:
    """GShard dispatch.  x: (B, S, d) -> (B, S, d).

    Tokens form groups of g (one group per batch row, or
    ``rc.moe_group_size`` tokens where that divides B·S); each (group,
    expert) holds C = min(max(4, ceil(g·k·cf / E)), g) tokens, taken in
    (token, choice) order, and the rest are dropped (combine weight zero).
    The combine weights are made in ``rc.moe_combine_dtype`` and cast to
    x's dtype for the combine product.
    """
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    g = S if not rc.moe_group_size else min(rc.moe_group_size, B * S)
    if (B * S) % g:
        g = S
    xg = x.reshape(B * S // g, g, d)
    G = xg.shape[0]
    C = max(4, int(-(-g * k * cfg.capacity_factor // E)))
    C = min(C, g)
    cdt = torch.bfloat16 if rc.moe_combine_dtype == "bf16" else torch.float32
    logits = xg.float() @ p["router"]                       # (G, g, E)
    weights, idx = _top_k_gating(cfg, logits)               # (G, g, k)
    # expert-assignment one-hots, then position-in-expert via cumsum
    onehot = F.one_hot(idx, E).float()                      # (G, g, k, E)
    assign = onehot * weights[..., None]
    flat = onehot.reshape(G, g * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, k, E)
    keep = pos < C
    assign = (assign * keep).to(cdt)
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (torch.where(keep, pos, C)[..., None] == slots).to(cdt)
    combine = (assign[..., None] * pos_oh).sum(2)           # (G, g, E, C)
    dispatch = (combine > 0).to(x.dtype)
    xe = torch.einsum("bsec,bsd->becd", dispatch, xg)
    ye = expert_ffn(p, xe)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)
    out = out.reshape(B, S, d)
    if cfg.dense_residual_d_ff:
        out = out + _dense_residual(p, x)
    return out


def moe_forward_sort(cfg: ModelConfig, rc: RunConfig, p: Params,
                     x: torch.Tensor) -> torch.Tensor:
    """Sort dispatch.  x: (B, S, d) -> (B, S, d).

    The B·S·k (token, choice) pairs are sorted by expert (stable, so each
    expert's tokens keep their order); each expert takes the first
    C = max(4, ceil(B·S·k·cf / E)) into its slab and the rest go to a
    scratch row that is thrown away.  The weighted expert outputs are added
    into each token's row in x's dtype.
    """
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * S
    C = max(4, int(-(-N * k * cfg.capacity_factor // E)))
    xf = x.reshape(N, d)
    logits = xf.float() @ p["router"]
    weights, idx = _top_k_gating(cfg, logits)               # (N, k)
    flat_e = idx.reshape(-1)                                # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position within expert for the capacity check
    same = torch.arange(N * k, device=x.device)
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos_in_e = same - seg_start[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # drop: scratch
    token_of = order // k
    slab = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    slab[slot] = xf[token_of]
    ye = expert_ffn(p, slab[None, : E * C].reshape(1, E, C, d))
    ye = ye.reshape(E * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], 0)
    w_flat = weights.reshape(-1)[order]
    contrib = ye[slot] * w_flat[:, None].to(ye.dtype)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, token_of, contrib)
    if cfg.dense_residual_d_ff:
        out = out + _dense_residual(p, xf)
    return out.reshape(B, S, d)


def moe_forward(cfg: ModelConfig, rc: RunConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    if rc.moe_impl == "sort":
        return moe_forward_sort(cfg, rc, p, x)
    return moe_forward_einsum(cfg, rc, p, x)
