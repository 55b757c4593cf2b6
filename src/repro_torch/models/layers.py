"""Substrate layers; mirrors ``repro/models/layers.py``.

The parameter template leaf, ``rmsnorm``, the activations (``silu``,
``softplus``, ``gelu``), the MLPs (``swiglu``, ``gelu_mlp``), ``rope`` and attention: blockwise online-softmax attention
for training and prefill, single-position attention against a cache for
decode, and the QKV/O projection block around them.

Attention is plain PyTorch on the reference's own algorithm: a Python loop
over query blocks, each walking only its statically valid kv tiles
``[lo, hi)`` (causal upper bound, sliding-window lower bound) with the
online softmax carrying (m, l, acc), so masked tiles are never computed.
It is not routed through a fused library attention: their summation order
and bf16 handling differ from the reference's, and ``RunConfig.attn_dtype``
would stop meaning what it means there.

On a device mesh (``DTensor`` inputs, ``parallel/rules.py``) ``rope``
and ``blockwise_attention`` run each rank's block under ``local_map``:
batch over the data axes and heads over ``model`` where they divide, as
the rules place them; a rank whose query heads are sharded while the kv
heads replicate takes the kv heads of its own query heads.
``context_parallel_attention`` is the reference's sequence-sharded
attention for head counts that do not divide the model axis: each
``model`` rank owns S/tp query rows and gathers k and v once.

Decode on a mesh (``cached_decode_attention``) follows the cache's
placement (``models/model.py: CACHE_LOGICAL``): where its sequence
shards over ``model`` each rank writes the new token's slot if it owns it
and scores its own slots, and the ranks combine one float32 split
softmax over ``model``; otherwise every rank attends by heads as
``decode_attention`` does on ``DTensor``s (``_heads_on_mesh``).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.parallel import rules


class ParamSpec(NamedTuple):
    """Template leaf: shape + logical axis names + dtype + init.

    The logical axis names are the reference's sharding hints: on a
    device mesh they place the leaf (``parallel/rules.py``:
    ``sharding_for``).  Leaves left at the
    default bf16 take the model's parameter dtype (``models/model.py``);
    leaves that name float32 stay float32.
    """
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"      # normal | zeros | ones


Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# primitive forwards
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as ``jax.nn.silu`` computes it: x / (1 + exp(-x)) with
    every step rounded to x's dtype (``F.silu`` rounds once, and differs
    from the reference in about a third of bf16 outputs)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it:
    max(x, 0) + log1p(exp(-|x|)), every step rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh gelu as ``jax.nn.gelu`` (approximate, its default) computes
    it: x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))), the
    cube as x * x * x, each constant rounded to x's dtype first and every
    step rounded to it.  ``F.gelu(approximate="tanh")`` rounds once, and
    differs from the reference in about 43% of bf16 outputs; with Python
    float constants torch multiplies a bf16 tensor at a higher precision,
    and 0.25% still differ.  In float32 the two frameworks' tanh differ in
    the last bits."""
    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (silu(x @ w1) * (x @ w3)) @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    """gelu(x @ w1) @ w2 with the tanh gelu, ``jax.nn.gelu``'s default,
    rounded as the reference rounds it (``gelu``)."""
    return gelu(x @ w1) @ w2


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, rotate-half.  x: (B, S, H, D), positions: (B, S).

    The angles are float32; x times cos/sin promotes to float32 and the
    result is cast back to x's dtype, as in the reference.  On ``DTensor``
    inputs each rank rotates its own block (``positions`` laid out as x's
    batch and seq dims)."""
    if rules.is_dtensor(x):
        return _rope_on_mesh(x, positions, theta)
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def grad_placements(param_pl: tuple, act_pl: tuple) -> tuple:
    """The placements of the gradient of an input that a ``local_map``
    body uses beside an activation laid out as ``act_pl``: on a mesh dim
    where the input replicates and the activation is split, each rank
    holds its own block's contribution (``Partial``); elsewhere the
    gradient is laid out as the input."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate() and a.is_shard() else p
                 for p, a in zip(param_pl, act_pl))


def _rope_on_mesh(x, positions, theta: float):
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    heads = f"heads[{x.shape[2]}]"
    xpl = rules.act_placements(mesh, x.shape, ("batch", "seq", heads, None))
    ppl = rules.act_placements(mesh, positions.shape, ("batch", "seq"))
    return local_map(lambda xl, pl: rope(xl, pl, theta),
                     out_placements=list(xpl), in_placements=(xpl, ppl),
                     in_grad_placements=(xpl, ppl), device_mesh=mesh,
                     redistribute_inputs=True)(x, positions)


# ---------------------------------------------------------------------------
# blockwise attention (training / prefill)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """(qb, kb) additive bias: 0 valid, -inf invalid."""
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    if causal:
        valid &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        valid &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.zeros(valid.shape, dtype=torch.float32,
                       device=q_pos.device).masked_fill_(~valid, -torch.inf)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_block: int = 512, kv_block: int = 1024,
                        softcap: float | None = None,
                        compute_dtype: str = "f32",
                        row_offset: int | torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Online-softmax attention.  q: (B,S,H,D), k/v: (B,Sk,KH,D) -> (B,S,H,D).

    Query head h reads kv head h // (H // KH) (grouped-query attention).
    Per query block the kv tile range is static: [window lower bound,
    causal upper bound), so masked tiles are never computed.  q is scaled
    by D**-0.5 and rounded to its dtype first.  ``compute_dtype="bf16"``
    rounds the QK and PV matmul inputs to bf16 and multiplies in float32
    (bf16 inputs, float32 accumulation, as the reference's
    ``preferred_element_type``).  A given ``row_offset`` (query i at
    absolute position row_offset + i) makes every tile live and masked;
    without one the causal offset is Sk - S.  On ``DTensor`` inputs each
    rank attends with its own batch rows and heads (``_heads_on_mesh``).
    """
    if rules.is_dtensor(q):
        return _heads_on_mesh(
            lambda ql, kl, vl: blockwise_attention(
                ql, kl, vl, causal=causal, window=window, q_block=q_block,
                kv_block=kv_block, softcap=softcap,
                compute_dtype=compute_dtype, row_offset=row_offset),
            q, k, v)
    in_dt = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    B, S, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    q_block = min(q_block, S)
    kv_block = min(kv_block, Sk)
    nq = -(-S // q_block)
    nk_total = -(-Sk // kv_block)
    q = (q * (D ** -0.5)).to(q.dtype)
    Sp, Skp = nq * q_block, nk_total * kv_block
    if Sp != S:
        q = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    if Skp != Sk:
        k = F.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
        v = F.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    # q as (B, KH, nq, G*qb, D) and k/v as (B, KH, Skp, D), so each tile's
    # products are one batched matmul per kv head; in the matmul input
    # dtype, then float32 (bf16 products are exact in float32)
    qg = (q.reshape(B, nq, q_block, KH, G, D).permute(0, 3, 1, 4, 2, 5)
          .to(in_dt).float().reshape(B, KH, nq, G * q_block, D))
    kt = k.permute(0, 2, 1, 3).to(in_dt).float()
    vt = v.permute(0, 2, 1, 3).to(in_dt).float()
    dev = q.device
    fixed = row_offset is not None
    offset = row_offset if fixed else Sk - S
    outs = []
    for i in range(nq):
        qi = qg[:, :, i]                                    # (B,KH,G*qb,D)
        q_pos = offset + i * q_block + torch.arange(q_block, device=dev)
        if fixed:
            lo, hi = 0, nk_total
        else:
            hi = (min(nk_total, -(-(offset + (i + 1) * q_block) // kv_block))
                  if causal else nk_total)
            lo = 0
            if window is not None:
                lo = max(0, (offset + i * q_block - window + 1) // kv_block)
            hi = max(hi, lo + 1)
        m = torch.full((B, KH, G, q_block), -torch.inf, device=dev)
        l = torch.zeros((B, KH, G, q_block), device=dev)
        acc = torch.zeros((B, KH, G, q_block, D), device=dev)
        for j in range(lo, hi):
            kj = kt[:, :, j * kv_block:(j + 1) * kv_block]
            vj = vt[:, :, j * kv_block:(j + 1) * kv_block]
            k_pos = j * kv_block + torch.arange(kv_block, device=dev)
            s = (qi @ kj.transpose(-1, -2)).view(B, KH, G, q_block, kv_block)
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            bias = _mask_bias(q_pos, k_pos, causal, window)
            bias.masked_fill_((k_pos >= Sk)[None, :], -torch.inf)
            s = s + bias
            m_new = torch.maximum(m, s.amax(-1))
            # fully masked rows (sliding-window rows whose window misses
            # this tile and every tile before it) leave m_new = -inf, and
            # exp(-inf - -inf) = nan: they subtract 0 instead, so p and
            # corr are exp(-inf) = 0 with a zero gradient (the reference
            # zeroes the nan with a where, whose gradient stays nan)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(m - m_safe)
            l = l * corr + p.sum(-1)
            pv = (p.to(in_dt).float().view(B, KH, G * q_block, kv_block)
                  @ vj).view(B, KH, G, q_block, D)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,qb,KH,G,D)
    out = torch.cat(outs, dim=1)[:, :S]
    return out.reshape(B, S, H, D).to(q.dtype)


def _on_heads(placement) -> bool:
    return placement.is_shard() and placement.dim == 2


def _heads_on_mesh(attend, q, k, v):
    """``attend(q, k, v)`` (``blockwise_attention`` or ``decode_attention``
    on plain tensors) on ``DTensor``s under ``local_map``: batch
    over the data axes and heads over ``model`` where they divide (the
    rules' placements of ``heads[H]`` and ``heads[KH]``).  Where the query
    heads shard and the kv heads do not, each rank takes the kv heads of
    its own query heads, and its k and v gradients are its part of theirs
    (``Partial``); where the query heads do not shard, neither do k and v,
    and every model rank attends with all heads."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, KH = q.shape[2], k.shape[2]
    qpl = rules.act_placements(mesh, q.shape,
                               ("batch", None, f"heads[{H}]", None))
    kvpl = rules.act_placements(mesh, k.shape,
                                ("batch", None, f"heads[{KH}]", None))
    kvpl = tuple(Replicate() if _on_heads(p) and not _on_heads(qp) else p
                 for p, qp in zip(kvpl, qpl))
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    pick = mi is not None and _on_heads(qpl[mi]) and kvpl[mi].is_replicate()
    kvgrad = grad_placements(kvpl, qpl)

    def body(ql, kl, vl):
        if pick:
            hl = ql.shape[2]
            first = mesh.get_local_rank(mi) * hl
            idx = (torch.arange(first, first + hl, device=ql.device)
                   // (H // KH))
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return attend(ql, kl, vl)

    return local_map(body, out_placements=list(qpl),
                     in_placements=(qpl, kvpl, kvpl),
                     in_grad_placements=(qpl, kvgrad, kvgrad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def context_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: int | None = None, q_block: int = 512,
                               kv_block: int = 1024,
                               softcap: float | None = None,
                               compute_dtype: str = "f32") -> torch.Tensor:
    """Sequence-sharded self-attention (the reference's, for head counts
    that do not divide the model axis: hymba's 25, arctic's 56).

    q, k, v: ``DTensor``s (B, S, H|KH, D) on ``mesh``.  Each ``model``
    rank owns S/tp query rows (seq over ``model``, batch over the data
    axes where they divide), all-gathers k and v over ``model`` once
    (``compat.all_gather_grad``, whose backward reduce-scatters their
    gradients) and runs ``blockwise_attention`` with its rows' offset
    ``axis_index("model") * S/tp``.  Differentiable; returns a ``DTensor``
    laid out as q's spec."""
    from repro_torch.parallel import compat

    B, S, _, _ = q.shape
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index("model"))
    if S % tp:
        raise ValueError(f"seq {S} does not split over model = {tp}")
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    b_ok = batch_axes and B % math.prod(
        mesh.size(names.index(a)) for a in batch_axes) == 0
    bspec = ((batch_axes if len(batch_axes) > 1 else batch_axes[0])
             if b_ok else None)
    spec = (bspec, "model", None, None)
    qb = min(q_block, S // tp)

    def body(q_l, k_l, v_l):
        k_f = compat.all_gather_grad(k_l, "model", 1)
        v_f = compat.all_gather_grad(v_l, "model", 1)
        off = compat.axis_index("model") * (S // tp)
        return blockwise_attention(
            q_l, k_f, v_f, causal=causal, window=window, q_block=qb,
            kv_block=kv_block, softcap=softcap, compute_dtype=compute_dtype,
            row_offset=off)

    return compat.shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-position attention against a cache.

    q: (B, 1, H, D); k/v_cache: (B, Smax, KH, D); cache_len: the number of
    valid cache positions including the current token.  Scaled in float32,
    with no rounding of q (unlike the prefill).  On ``DTensor``s each rank
    attends with its batch rows and heads (``_heads_on_mesh``).
    """
    if rules.is_dtensor(q):
        return _heads_on_mesh(lambda ql, kl, vl: decode_attention(
            ql, kl, vl, cache_len, window=window), q, k_cache, v_cache)
    B, _, H, D = q.shape
    _, Smax, KH, _ = k_cache.shape
    G = H // KH
    qg = q.reshape(B, KH, G, D).float() * (D ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    k_pos = torch.arange(Smax, device=q.device)
    valid = k_pos < cache_len
    if window is not None:
        valid &= k_pos > (cache_len - 1 - window)
    s = s.masked_fill(~valid, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def cached_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, slot: int, cache_len: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One decode step's attention: the new token's k, v (B, 1, KH, D)
    written at ``slot`` of copies of the caches (B, size, KH, D), then q
    (B, 1, H, D) attends to their first ``cache_len`` slots
    (``decode_attention``).  Returns (out, k_cache', v_cache'); the given
    caches are left unmodified.  On ``DTensor``s: ``_cached_on_mesh``."""
    if rules.is_dtensor(k_cache):
        return _cached_on_mesh(q, k, v, k_cache, v_cache, slot, cache_len)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    return (decode_attention(q, k_cache, v_cache, cache_len), k_cache,
            v_cache)


def _cached_on_mesh(q, k, v, k_cache, v_cache, slot: int, cache_len: int):
    """``cached_decode_attention`` on ``DTensor``s, one ``local_map`` body
    laid out as the caches are (batch over the data axes; over ``model``
    their sequence, their kv heads, or nothing).

    Sequence-sharded: q, k and v are whole over ``model``; the rank that
    owns ``slot`` writes it and the others pass their blocks through.
    Each rank scores its own slots, masked by their global positions
    against ``cache_len``, and the ranks combine one float32 softmax over
    ``model``: the row max by an all-reduce, then the sums of exp(s - max)
    and of its v-weighted slots by one all-reduce.  A rank whose slots all
    lie past ``cache_len`` adds zeros (exp(-inf - max) = 0; the max is
    finite, since slot 0 is always filled).  Otherwise every rank writes
    the slot and attends with its heads (the caches' kv heads and their
    query heads), or with all of them where the kv heads replicate."""
    from torch.distributed import ReduceOp
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel import compat

    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model") if "model" in names else None
    cpl = tuple(k_cache.placements)
    seq_split = mi is not None and cpl[mi].is_shard() and cpl[mi].dim == 1
    # q (B, 1, H, D) and k, v (B, 1, KH, D) laid out as the caches, but
    # whole along the sequence
    qpl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
                for p in cpl)
    group = mesh.get_group(mi) if seq_split and mesh.size(mi) > 1 else None

    def body(ql, kl, vl, kc, vc):
        n = kc.shape[1]
        first = mesh.get_local_rank(mi) * n if seq_split else 0
        if first <= slot < first + n:
            kc, vc = kc.clone(), vc.clone()
            kc[:, slot - first] = kl[:, 0]
            vc[:, slot - first] = vl[:, 0]
        if not seq_split:
            return decode_attention(ql, kc, vc, cache_len), kc, vc
        B, _, H, D = ql.shape
        KH = kc.shape[2]
        qg = ql.reshape(B, KH, H // KH, D).float() * (D ** -0.5)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float())
        pos = first + torch.arange(n, device=ql.device)
        s = s.masked_fill(~(pos < cache_len), -torch.inf)
        m = s.amax(-1)
        if group is not None:
            m = compat.all_reduce(m, group, ReduceOp.MAX)
        p = torch.exp(s - m[..., None])
        ol = torch.cat([torch.einsum("bhgk,bkhd->bhgd", p, vc.float()),
                        p.sum(-1)[..., None]], -1)
        if group is not None:
            ol = compat.all_reduce(ol, group)
        out = ol[..., :D] / ol[..., D:]
        return out.reshape(B, 1, H, D).to(ql.dtype), kc, vc

    return local_map(body, out_placements=(qpl, cpl, cpl),
                     in_placements=(qpl, qpl, qpl, cpl, cpl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, k_cache, v_cache)


# ---------------------------------------------------------------------------
# attention block (params + forward)
# ---------------------------------------------------------------------------

def attn_template(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """QKV/O projections, with the Q/K/V biases where ``cfg.qkv_bias``."""
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hq, hkv = f"heads[{h}]", f"heads[{kh}]"
    t = {
        "wq": ParamSpec((d, h * hd), ("embed", hq)),
        "wk": ParamSpec((d, kh * hd), ("embed", hkv)),
        "wv": ParamSpec((d, kh * hd), ("embed", hkv)),
        "wo": ParamSpec((h * hd, d), (hq, "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((h * hd,), (hq,), init="zeros")
        t["bk"] = ParamSpec((kh * hd,), (hkv,), init="zeros")
        t["bv"] = ParamSpec((kh * hd,), (hkv,), init="zeros")
    return t


def attn_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> roped q (B,S,H,hd), roped k and v (B,S,KH,hd).
    Under a rules mesh the projections are placed as their weights' heads
    are (``heads[H]``, ``heads[KH]``) before they are split into heads."""
    B, S, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = rules.gathered
    q, k, v = x @ g(p["wq"]), x @ g(p["wk"]), x @ g(p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rules.constrain(q, ("batch", "seq", f"heads[{h}]"))
    k = rules.constrain(k, ("batch", "seq", f"heads[{kh}]"))
    v = rules.constrain(v, ("batch", "seq", f"heads[{kh}]"))
    q = rope(q.reshape(B, S, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, kh, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, kh, hd)


def attn_forward(cfg: ModelConfig, rc: RunConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 window: int | None = None) -> torch.Tensor:
    q, k, v = attn_qkv(cfg, p, x, positions)
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              q_block=rc.q_block, kv_block=rc.kv_block,
                              softcap=cfg.attn_logit_softcap,
                              compute_dtype=rc.attn_dtype)
    B, S, _ = x.shape
    return out.reshape(B, S, -1) @ p["wo"]


def attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Mapping[str, torch.Tensor], cache_index: int, *,
                window: int | None = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B, 1, d); cache: k, v (B, Smax, KH, hd), left unmodified.
    Returns (out, new cache) with this token's k/v at ``cache_index``."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = attn_qkv(cfg, p, x, positions)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[:, cache_index] = k[:, 0]
    v_cache[:, cache_index] = v[:, 0]
    out = decode_attention(q, k_cache, v_cache, cache_index + 1,
                           window=window)
    return out.reshape(B, 1, -1) @ p["wo"], {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------

def mlp_template(cfg: ModelConfig, ff: int | None = None
                 ) -> dict[str, ParamSpec]:
    d = cfg.d_model
    ff = ff or cfg.d_ff
    if cfg.act == "silu":
        return {"w1": ParamSpec((d, ff), ("embed", "ffn")),
                "w3": ParamSpec((d, ff), ("embed", "ffn")),
                "w2": ParamSpec((ff, d), ("ffn", "embed"))}
    return {"w1": ParamSpec((d, ff), ("embed", "ffn")),
            "w2": ParamSpec((ff, d), ("ffn", "embed"))}


def mlp_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    g = rules.gathered
    if cfg.act == "silu":
        return swiglu(x, g(p["w1"]), g(p["w3"]), g(p["w2"]))
    return gelu_mlp(x, g(p["w1"]), g(p["w2"]))
