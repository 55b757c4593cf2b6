"""Mixture-of-Experts layer; mirrors ``repro/models/moe.py``.

Top-k routing with two dispatch paths, both as in the reference:
``_einsum_dispatch`` (the default, GShard capacity dispatch: one-hot
dispatch and combine tensors, over-capacity tokens dropped) and
``_sort_dispatch`` (tokens sorted by expert into padded per-expert slabs).
``moe_forward`` picks one and adds arctic's dense residual MLP beside it.

Every product is a plain batched matrix product (``torch.einsum``,
``torch.bmm``), as the reference computes them outside any Pallas kernel.
Routing follows the reference bit for bit where it can decide a token's
fate: the top-k is a stable descending sort, so tied logits go to the
lower expert index as ``jax.lax.top_k`` sends them (``torch.topk`` does
not), and positions in an expert count in the same (token, choice) order.

On a device mesh (``DTensor`` inputs, ``parallel/rules.py``) the layer is
one ``local_map`` body (``_moe_on_mesh``): each rank keeps its batch rows
over the data axes and the tokens replicate over ``model``, so every
``model`` rank routes the same tokens over all E experts alike, then
dispatches into, runs and combines only the experts it holds (the
experts dim shards over ``model`` where E divides it, and replicates
otherwise).  Its output is a partial sum over ``model``, reduced once.
Where the dispatch reads tokens of other ranks' rows (the sort path's
capacity and order over the whole batch, or an einsum group wider than a
rank's rows) the body gathers the rows over the data axes first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import ParamSpec, Params, grad_placements, silu
from repro_torch.parallel import rules


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
    g = rules.gathered
    return (silu(x @ g(p["res_w1"])) * (x @ g(p["res_w3"]))) @ g(p["res_w2"])


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's swiglu on its dispatched slab: xe (G, E, C, d) ->
    (G, E, C, d)."""
    h = torch.einsum("becd,edf->becf", xe, p["w1"])
    h = silu(h) * torch.einsum("becd,edf->becf", xe, p["w3"])
    return torch.einsum("becf,efd->becd", h, p["w2"])


def group_size(rc: RunConfig, B: int, S: int) -> int:
    """The einsum path's tokens a group for a (B, S) batch: one batch row,
    or ``rc.moe_group_size`` where that divides B·S."""
    g = S if not rc.moe_group_size else min(rc.moe_group_size, B * S)
    return S if (B * S) % g else g


def einsum_routing(cfg: ModelConfig, logits: torch.Tensor, C: int):
    """(G, g, E) router logits -> the gating weights (G, g, k), the chosen
    experts' one-hots (G, g, k, E), each (token, choice)'s position in
    every expert's queue in (token, choice) order (G, g, k, E), and the
    capacity mask, position < C."""
    weights, idx = _top_k_gating(cfg, logits)               # (G, g, k)
    G, g, k = idx.shape
    E = logits.shape[-1]
    onehot = F.one_hot(idx, E).float()                      # (G, g, k, E)
    flat = onehot.reshape(G, g * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, k, E)
    return weights, onehot, pos, pos < C


def _einsum_dispatch(cfg: ModelConfig, rc: RunConfig, p: Params,
                     x: torch.Tensor, g: int, lo: int = 0) -> torch.Tensor:
    """GShard dispatch of x (B, S, d) -> (B, S, d) in groups of g tokens
    (``group_size``: one group per batch row, or ``rc.moe_group_size``
    tokens where that divides B·S) through the experts lo.. lo + El - 1
    that ``p`` holds (El = its w1's first dim): routed over all E, then
    dispatched into and combined from those experts only.  Each (group,
    expert) holds C = min(max(4, ceil(g·k·cf / E)), g) tokens, taken in
    (token, choice) order, and the rest are dropped (combine weight zero).
    The combine weights are made in ``rc.moe_combine_dtype`` and cast to
    x's dtype for the combine product."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    El = p["w1"].shape[0]
    xg = x.reshape(B * S // g, g, d)
    C = max(4, int(-(-g * k * cfg.capacity_factor // E)))
    C = min(C, g)
    cdt = torch.bfloat16 if rc.moe_combine_dtype == "bf16" else torch.float32
    logits = xg.float() @ p["router"]                       # (G, g, E)
    weights, onehot, pos, keep = einsum_routing(cfg, logits, C)
    if El != E:
        onehot, pos, keep = (t[..., lo:lo + El] for t in (onehot, pos, keep))
    assign = (onehot * weights[..., None] * keep).to(cdt)
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (torch.where(keep, pos, C)[..., None] == slots).to(cdt)
    combine = (assign[..., None] * pos_oh).sum(2)           # (G, g, El, C)
    dispatch = (combine > 0).to(x.dtype)
    xe = torch.einsum("bsec,bsd->becd", dispatch, xg)
    ye = expert_ffn(p, xe)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)
    return out.reshape(B, S, d)


def sort_routing(cfg: ModelConfig, logits: torch.Tensor, C: int):
    """(N, E) router logits -> the gating weights (N, k), the (token,
    choice) pairs' order sorted by expert (stable), their experts and
    positions in that order, and the capacity mask, position < C."""
    weights, idx = _top_k_gating(cfg, logits)               # (N, k)
    flat_e = idx.reshape(-1)                                # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    same = torch.arange(flat_e.shape[0], device=logits.device)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(logits.shape[-1], device=logits.device))
    pos_in_e = same - seg_start[sorted_e]
    return weights, order, sorted_e, pos_in_e, pos_in_e < C


def _sort_dispatch(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   lo: int = 0) -> torch.Tensor:
    """Sort dispatch of x (B, S, d) -> (B, S, d) through the experts lo..
    lo + El - 1 that ``p`` holds.  The B·S·k (token, choice) pairs are
    sorted by expert (stable, so each expert's tokens keep their order);
    each expert takes the first C = max(4, ceil(B·S·k·cf / E)) into its
    slab and the rest, with the other experts' pairs, go to a scratch row
    that is thrown away.  The weighted expert outputs are added into each
    token's row in x's dtype."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    El = p["w1"].shape[0]
    N = B * S
    C = max(4, int(-(-N * k * cfg.capacity_factor // E)))
    xf = x.reshape(N, d)
    logits = xf.float() @ p["router"]
    weights, order, sorted_e, pos_in_e, keep = sort_routing(cfg, logits, C)
    if El != E:
        keep = keep & (sorted_e >= lo) & (sorted_e < lo + El)
    # the pairs past capacity (or of another rank's experts) go to a
    # scratch row
    slot = torch.where(keep, (sorted_e - lo) * C + pos_in_e, El * C)
    token_of = order // k
    slab = torch.zeros((El * C + 1, d), dtype=x.dtype, device=x.device)
    slab[slot] = xf[token_of]
    ye = expert_ffn(p, slab[None, : El * C].reshape(1, El, C, d))
    ye = ye.reshape(El * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], 0)
    w_flat = weights.reshape(-1)[order]
    contrib = ye[slot] * w_flat[:, None].to(ye.dtype)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, token_of, contrib)
    return out.reshape(B, S, d)


def _moe_on_mesh(cfg: ModelConfig, rc: RunConfig, p: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """The layer on ``DTensor``s: one ``local_map`` body a call.

    x (B, S, d) comes in as ("batch", "seq", None): rows over the data
    axes, replicated over ``model``.  The router and the experts are read
    gathered over the data axes (``rules.gathered``); each ``model`` rank
    holds El = E/tp experts where the experts shard.  The group size and
    the capacity come from the global B·S; where a group or the sort's
    order spans rows of other data ranks, the body all-gathers x's rows
    over the data axes (``compat.all_gather_grad``: its backward
    reduce-scatters), dispatches the whole batch, and keeps its own rows.

    Gradients: the body's output is a partial sum over ``model`` where
    the experts shard (each rank combines its own), so x's gradient and
    the router's (through the gating weights of its experts) are partial
    over ``model``; the router's and the experts' are partial over the data
    axes where the rows shard (each rank's rows' contribution), and are
    reduce-scattered back onto their ``embed`` blocks by
    ``rules.gathered``'s backward."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel import compat

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B, S, _ = x.shape
    xpl = rules.act_placements(mesh, x.shape, ("batch", "seq", None))
    router = rules.gathered(p["router"])
    w = [rules.gathered(p[n]) for n in ("w1", "w3", "w2")]
    rpl, wpl = tuple(router.placements), tuple(w[0].placements)
    mi = names.index("model") if "model" in names else None
    split = mi is not None and wpl[mi].is_shard() and mesh.size(mi) > 1
    row_dims = [i for i, pl in enumerate(xpl) if pl.is_shard()]
    rows = B // math.prod(mesh.size(i) for i in row_dims)
    if rc.moe_impl == "sort":
        gather = rows != B
    else:
        g = group_size(rc, B, S)
        gather = (rows * S) % g != 0

    def over_model(pl: tuple) -> tuple:
        return tuple(Partial() if split and i == mi else q
                     for i, q in enumerate(pl))

    out_pl = over_model(xpl)

    def body(xl, rl, w1, w3, w2):
        lo = mesh.get_local_rank(mi) * w1.shape[0] if split else 0
        if gather:
            # minor mesh dim first: a dim split over several mesh dims
            # splits in mesh-dim order
            for i in reversed(row_dims):
                xl = compat.all_gather_grad(xl, names[i], 0, mesh=mesh)
        pl = {"router": rl, "w1": w1, "w3": w3, "w2": w2}
        if rc.moe_impl == "sort":
            y = _sort_dispatch(cfg, pl, xl, lo)
        else:
            y = _einsum_dispatch(cfg, rc, pl, xl, g, lo)
        return rules.local_block(y, mesh, xpl) if gather else y

    wgrad = grad_placements(wpl, xpl)
    y = local_map(body, out_placements=list(out_pl),
                  in_placements=(xpl, rpl, wpl, wpl, wpl),
                  in_grad_placements=(out_pl,
                                      over_model(grad_placements(rpl, xpl)),
                                      wgrad, wgrad, wgrad),
                  device_mesh=mesh, redistribute_inputs=True)(x, router, *w)
    return y.redistribute(mesh, xpl) if split else y


def moe_forward(cfg: ModelConfig, rc: RunConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the mesh body on ``DTensor``s, else the
    dispatch ``rc.moe_impl`` names; arctic's dense residual beside it (on
    ``DTensor``s too, its ``ffn`` dim over ``model``)."""
    if rules.is_dtensor(x):
        out = _moe_on_mesh(cfg, rc, p, x)
    elif rc.moe_impl == "sort":
        out = _sort_dispatch(cfg, p, x)
    else:
        B, S, _ = x.shape
        out = _einsum_dispatch(cfg, rc, p, x, group_size(rc, B, S))
    if cfg.dense_residual_d_ff:
        out = out + _dense_residual(p, x)
    return out
