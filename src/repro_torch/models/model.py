"""Model assembly; mirrors ``repro/models/model.py``.

A model is a sequence of SEGMENTS from ``ModelConfig.block_pattern``, each
a list of homogeneous blocks.  The reference scans a segment over stacked
layer parameters; here every layer is its own module, and a Python loop
walks them.  Kinds:

  dense         attn + mlp                       (llama/mistral/qwen family)
  dense_global  dense with full attention even when cfg.sliding_window is set
  moe           attn + MoE (+ the parallel dense residual of arctic)
  mamba         mamba-1 block                    (falcon-mamba)
  hybrid        parallel attn ∥ mamba heads + mlp (hymba); SWA by default
  hybrid_global hybrid with full attention       (hymba's few global layers)
  enc / dec     whisper's encoder (non-causal self-attention + mlp) and
                decoder (causal self-attention, cross-attention to the
                encoder output, mlp) blocks

An encoder-decoder model also has the reference's ``enc`` segment
(``num_encoder_layers`` blocks of kind ``enc``) and ``enc_norm``: the
stub frames (``batch["enc_embeds"]``) go through them (``encode``), and
every ``dec`` block reads the result.  Forward modes: ``backbone`` /
``prefill`` (returns the decode cache), ``decode_step`` (one token,
cache update; the encoder output comes in as ``batch["enc_out"]``) and
``loss_fn`` (``backbone`` then ``chunked_loss``, for training).
Parameters are created without gradients, so serving builds no graph; a
trainer turns them on with ``model.requires_grad_(True)``.  With
``RunConfig.remat == "block"`` and gradients enabled each block runs
under ``torch.utils.checkpoint`` (its activations recomputed in the
backward), as the reference checkpoints each block.

On a device mesh (``place_on_mesh``: every parameter a ``DTensor`` laid
out by the logical-axis rules, ``param_specs``) the same forwards run on
``DTensor``s under ``parallel.rules.use_rules_mesh``: the activations are
placed where the reference places them (``constrain``), attention whose
head count does not divide the model axis takes the reference's
context-parallel branch, and the embedding lookup, the loss's softmax
over a vocab sharded over ``model`` and the MoE layer (``moe.py``:
``_moe_on_mesh``) are ``local_map`` bodies.  Every kind is placed: the
encoder's frames as the tokens are, and a ``dec`` block's cross-attention
with its heads over ``model`` where they divide it (never sequence-sharded,
as in the reference).

Serving runs on a mesh too.  ``init_cache(..., mesh=)`` places every
cache leaf as ``configs/registry.input_specs`` does (``CACHE_LOGICAL``:
the k/v sequence over ``model`` where it divides, else the kv heads; the
mamba conv window and state by ``inner``; batch over the data axes).
``prefill`` copies each rank's own slots out of the backbone's k and v,
``decode_step`` writes the new token's slot on the rank that holds it and
combines attention over ``model`` (``layers.cached_decode_attention``),
and the mamba step, the MoE layer and the cross-attention step run on
their ``DTensor`` paths; the cache stays placed from prefill to the last
step.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import layers, mamba, moe
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import rules

_ATTN = ("dense", "moe", "hybrid", "enc", "dec")  # kinds with self-attention
_SSM = ("mamba", "hybrid")                        # kinds with a mamba mixer
# the decode cache's logical axes (the reference's ``input_specs``): k and
# v (count, B, size, KH, hd), conv (count, B, cw-1, di), ssm (count, B, di, n)
CACHE_LOGICAL = {
    "k": (None, "batch", "kv_seq", "kv_heads", None),
    "v": (None, "batch", "kv_seq", "kv_heads", None),
    "conv": (None, "batch", None, "inner"),
    "ssm": (None, "batch", "inner", None),
}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), init="ones")


def block_template(cfg: ModelConfig, kind: str) -> dict[str, Any]:
    """One layer's leaves by the reference's names."""
    base = kind.replace("_global", "")
    t: dict[str, Any] = {}
    if base in _ATTN:
        t["norm1"] = _norm(cfg)
        t["attn"] = layers.attn_template(cfg)
        t["norm2"] = _norm(cfg)
        if base == "moe":
            t["moe"] = moe.moe_template(cfg)
        else:
            t["mlp"] = layers.mlp_template(cfg)
    if base == "mamba":
        t["norm1"] = _norm(cfg)
        t["mamba"] = mamba.mamba_template(cfg)
    if base == "hybrid":
        t["norm_m"] = _norm(cfg)
        t["mamba"] = mamba.mamba_template(cfg)
    if base == "dec":
        t["norm_x"] = _norm(cfg)
        t["xattn"] = layers.attn_template(cfg)
    return t


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


class Block(nn.Module):
    """One layer: ``block_template(cfg, kind)`` made into parameters, under
    the reference's names (``norm1``, ``attn``, ``norm2``, ``mlp`` or
    ``moe``, ``norm_m``, ``mamba``, ``norm_x``, ``xattn``; the sub-dicts
    as ``ParameterDict``s)."""

    def __init__(self, cfg: ModelConfig, kind: str, init: _Init):
        super().__init__()
        for name, leaf in block_template(cfg, kind).items():
            setattr(self, name, init(leaf) if isinstance(leaf, ParamSpec) else
                    nn.ParameterDict({k: init(s) for k, s in leaf.items()}))


class Model(nn.Module):
    """Embedding, segments of blocks, final norm and LM head; for an
    encoder-decoder model also the encoder blocks and their norm.  On the
    card unless ``device`` says otherwise (``device.resolve``).

    Parameter names follow the reference's pytree: ``embed``,
    ``final_norm``, ``lm_head``, ``segments[si][layer]`` for
    ``seg{si}/params`` at that layer, ``enc[layer]`` for ``enc/params``
    at that layer and ``enc_norm``.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str | None = None,
                 seed: int | None = 0):
        super().__init__()
        init = _Init(dtype, _device.resolve(device), seed)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = init(ParamSpec((v, d), ("vocab", "embed")))
        self.final_norm = init(_norm(cfg))
        self.lm_head = (None if cfg.tie_embeddings else
                        init(ParamSpec((d, v), ("embed", "vocab"))))
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, kind, init) for _ in range(count))
            for kind, count in cfg.block_pattern)
        if cfg.is_encoder_decoder:
            self.enc = nn.ModuleList(Block(cfg, "enc", init)
                                     for _ in range(cfg.num_encoder_layers))
            self.enc_norm = init(_norm(cfg))


def param_leaves(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Every parameter's template leaf, by the port's parameter name
    (``Model.named_parameters``): one entry a layer, where the reference
    stacks a segment's layers on a leading dim."""
    out = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                              ("vocab", "embed")),
           "final_norm": _norm(cfg)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    blocks = [(f"segments.{si}.{li}.", kind)
              for si, (kind, count) in enumerate(cfg.block_pattern)
              for li in range(count)]
    if cfg.is_encoder_decoder:
        blocks += [(f"enc.{li}.", "enc")
                   for li in range(cfg.num_encoder_layers)]
        out["enc_norm"] = _norm(cfg)
    for prefix, kind in blocks:
        for name, leaf in block_template(cfg, kind).items():
            if isinstance(leaf, ParamSpec):
                out[prefix + name] = leaf
            else:
                out.update({f"{prefix}{name}.{k}": v for k, v in leaf.items()})
    return out


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
                    ) -> Model:
    """The model on the meta device: every parameter's shape and dtype, and
    nothing allocated (the reference's ``abstract_params``, whose stacked
    layer dim is one parameter a layer here, as ``param_leaves`` names
    them).  ``place_on_mesh`` lays it out on a mesh, still unallocated."""
    return Model(cfg, dtype, device="meta", seed=None)


def param_specs(cfg: ModelConfig, mesh, seq_parallel: bool = False
                ) -> dict[str, tuple]:
    """Each parameter's spec on ``mesh`` (the reference's ``param_specs``,
    without its stacked layer dim)."""
    return {k: rules.spec_for(mesh, leaf.shape, leaf.logical, seq_parallel)
            for k, leaf in param_leaves(cfg).items()}


def place_on_mesh(cfg: ModelConfig, model: Model, mesh,
                  seq_parallel: bool = False) -> Model:
    """Turn every parameter of ``model`` into a ``DTensor`` on ``mesh``
    laid out by ``rules.sharding_for``, in place: each rank keeps its own
    block of the full tensor it holds (every rank built the same seeded
    parameters), so nothing is sent.  ``requires_grad`` is kept."""
    from torch.distributed.tensor import DTensor

    leaves = param_leaves(cfg)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is already placed")
        pl = rules.sharding_for(mesh, leaves[name], seq_parallel=seq_parallel)
        module_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(module_name)
        placed = nn.Parameter(rules.distribute(p.detach(), mesh, pl),
                              requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[attr] = placed
        else:
            setattr(owner, attr, placed)
    return model


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig, kind: str) -> int | None:
    if kind.endswith("_global"):
        return None
    return cfg.sliding_window


def _conv_tail(x_in: torch.Tensor, cw: int) -> torch.Tensor:
    """The last cw-1 pre-conv inputs (zeros before the sequence start), as
    a copy, so the cache does not keep the whole projection alive.  On a
    mesh each rank takes its own channels (the conv cache's placement)."""
    if rules.is_dtensor(x_in):
        from torch.distributed.tensor.experimental import local_map

        xpl = rules.act_placements(x_in.device_mesh, x_in.shape,
                                   ("batch", None, "inner"))
        return local_map(lambda xl: _conv_tail(xl, cw),
                         out_placements=list(xpl), in_placements=(xpl,),
                         device_mesh=x_in.device_mesh,
                         redistribute_inputs=True)(x_in)
    S = x_in.shape[1]
    if S < cw - 1:
        x_in = F.pad(x_in, (0, 0, cw - 1 - S, 0))
    return x_in[:, x_in.shape[1] - (cw - 1):].clone()


def _mamba_branch(cfg: ModelConfig, rc: RunConfig, p, h: torch.Tensor,
                  cache: dict | None) -> torch.Tensor:
    """The mamba mixer on the normed input h: (ym * silu(z)) @ out_proj.
    Puts the conv tail and the last state into ``cache`` when given.  On a
    mesh the projection's columns, [x_in | z], shard over ``model`` as one
    dim: they are gathered before the split, so that each half can be
    laid out over its own ``inner`` dim."""
    xz = rules.constrain(h @ rules.gathered(p["in_proj"]),
                         ("batch", "seq", None))
    x_in, z = xz.chunk(2, dim=-1)
    ym, h_last = mamba.mamba_mix(cfg, rc, p, x_in)
    if cache is not None:
        cache["conv"] = _conv_tail(x_in, cfg.conv_width)
        cache["ssm"] = h_last
    return (ym * layers.silu(z)) @ rules.gathered(p["out_proj"])


def block_forward(cfg: ModelConfig, rc: RunConfig, kind: str, block: Block,
                  x: torch.Tensor, positions: torch.Tensor,
                  enc_out: torch.Tensor | None = None,
                  collect_cache: bool = False):
    """One block; ``enc_out`` (B, Se, d) is what a ``dec`` block's
    cross-attention reads.  Returns (x, cache_entry_or_None).

    Under a rules mesh, attention whose head count does not divide the
    model axis runs sequence-sharded (``context_parallel_attention``)
    where the sequence splits over it, as in the reference; the residual
    stream is placed as ("batch", "seq", None) after each half."""
    base = kind.replace("_global", "")
    mesh = rules.rules_mesh()
    cache: dict | None = {} if collect_cache else None
    if base in _ATTN:
        h = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
        q, k, v = layers.attn_qkv(cfg, block.attn, h, positions)
        if cache is not None:
            cache["k"], cache["v"] = k, v
        kw = dict(causal=base != "enc", window=_window(cfg, kind),
                  q_block=rc.q_block, kv_block=rc.kv_block,
                  softcap=cfg.attn_logit_softcap, compute_dtype=rc.attn_dtype)
        if _context_parallel(cfg, mesh, q):
            # rows back on every model rank: the residual stream's seq
            # is not sharded
            attn_out = rules.constrain(
                layers.context_parallel_attention(mesh, q, k, v, **kw),
                ("batch", "seq", None, None))
        else:
            attn_out = layers.blockwise_attention(q, k, v, **kw)
        B, S, _ = x.shape
        attn_out = attn_out.reshape(B, S, -1) @ rules.gathered(
            block.attn["wo"])
        if base == "hybrid":
            # parallel heads: both branches read the same x
            hm = layers.rmsnorm(x, block.norm_m, cfg.norm_eps)
            x = x + attn_out + _mamba_branch(cfg, rc, block.mamba, hm, cache)
        else:
            x = x + attn_out
        x = rules.constrain(x, ("batch", "seq", None))
        if base == "dec":
            x = rules.constrain(x + _cross_attn(cfg, rc, block, x, enc_out),
                                ("batch", "seq", None))
        x = x + _ffn(cfg, rc, base, block, x)
    elif base == "mamba":
        h = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
        x = x + _mamba_branch(cfg, rc, block.mamba, h, cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return rules.constrain(x, ("batch", "seq", None)), cache


def _context_parallel(cfg: ModelConfig, mesh, q) -> bool:
    """The reference's condition for the context-parallel branch: a
    model axis that the head count does not divide and the sequence
    does, outside decode."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    S = q.shape[1]
    return cfg.num_heads % tp != 0 and S % tp == 0 and S > 1


def _run_block(cfg: ModelConfig, rc: RunConfig, kind: str, block: Block,
               x: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor | None = None,
               collect_cache: bool = False):
    """``block_forward``, under ``torch.utils.checkpoint`` when
    ``rc.remat == "block"`` and gradients are on (the reference's
    ``jax.checkpoint`` of each block)."""
    if rc.remat == "block" and torch.is_grad_enabled():
        return checkpoint(block_forward, cfg, rc, kind, block, x, positions,
                          enc_out, collect_cache, use_reentrant=False)
    return block_forward(cfg, rc, kind, block, x, positions, enc_out,
                         collect_cache)


def _cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's k and v (B, Se, KH, hd) from the encoder output:
    no rope and no bias, recomputed at every call (not cached).  On a mesh
    placed as ``layers.attn_qkv`` places them, by their heads."""
    B, Se, _ = enc_out.shape
    kh = cfg.num_kv_heads
    shape = (B, Se, kh, cfg.head_dim)
    k, v = (rules.constrain(enc_out @ rules.gathered(p[n]),
                            ("batch", "seq", f"heads[{kh}]"))
            for n in ("wk", "wv"))
    return k.reshape(shape), v.reshape(shape)


def _cross_attn(cfg: ModelConfig, rc: RunConfig, block: Block,
                x: torch.Tensor, enc_out: torch.Tensor,
                step: bool = False) -> torch.Tensor:
    """A ``dec`` block's cross-attention on norm_x(x): q from the decoder,
    k and v from ``enc_out``, non-causal, with no rope, bias or softcap,
    at the default float32 compute dtype whatever ``rc.attn_dtype`` says
    (as in the reference).  ``step``: one decode token, k and v recomputed
    from ``enc_out`` every step, as in the reference, and single-position
    attention over all Se frames (``layers.decode_attention``).  On a mesh
    each rank attends with its batch rows and its heads (the attention's
    ``DTensor`` path, the query rows against all Se frames), never
    sequence-sharded."""
    B, S, _ = x.shape
    h = cfg.num_heads
    p = block.xattn
    hx = layers.rmsnorm(x, block.norm_x, cfg.norm_eps)
    q = rules.constrain(hx @ rules.gathered(p["wq"]),
                        ("batch", "seq", f"heads[{h}]"))
    q = q.reshape(B, S, h, cfg.head_dim)
    k, v = _cross_kv(cfg, p, enc_out)
    if step:
        xo = layers.decode_attention(q, k, v, enc_out.shape[1])
    else:
        xo = layers.blockwise_attention(q, k, v, causal=False,
                                        q_block=rc.q_block,
                                        kv_block=rc.kv_block)
    return xo.reshape(B, S, -1) @ rules.gathered(p["wo"])


def _ffn(cfg: ModelConfig, rc: RunConfig, base: str, block: Block,
         x: torch.Tensor) -> torch.Tensor:
    """The block's second half on norm2(x): the MoE layer or the MLP."""
    h2 = layers.rmsnorm(x, block.norm2, cfg.norm_eps)
    if base == "moe":
        return moe.moe_forward(cfg, rc, block.moe, h2)
    return layers.mlp_forward(cfg, block.mlp, h2)


def _shifted(placements: tuple, by: int) -> tuple:
    from torch.distributed.tensor import Shard

    return tuple(Shard(p.dim + by) if p.is_shard() else p
                 for p in placements)


def _stack(entries: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Per-layer cache entries -> one (count, ...) tensor per name.  Each
    name's ``DTensor``s (one placement for all the layers) stack on their
    ranks' blocks: the layer dim is whole on every rank."""
    out = {}
    for k in entries[0]:
        ts = [e[k] for e in entries]
        if not rules.is_dtensor(ts[0]):
            out[k] = torch.stack(ts)
            continue
        from torch.distributed.tensor import DTensor

        out[k] = DTensor.from_local(
            torch.stack([t.to_local() for t in ts]), ts[0].device_mesh,
            _shifted(ts[0].placements, 1), run_check=False)
    return out


def _layer(t: torch.Tensor, li: int) -> torch.Tensor:
    """Layer ``li`` of a stacked cache leaf (``_stack``'s inverse)."""
    if not rules.is_dtensor(t):
        return t[li]
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local()[li], t.device_mesh,
                              _shifted(t.placements, -1), run_check=False)


def embed_input(cfg: ModelConfig, model: Model, batch: dict) -> torch.Tensor:
    if "embeds" in batch:                 # stubbed modality frontend
        return batch["embeds"].to(model.embed.dtype)
    if rules.is_dtensor(model.embed):
        return _embed_on_mesh(model.embed, batch["tokens"])
    return F.embedding(batch["tokens"], model.embed)


def _embed_on_mesh(w, tokens):
    """The lookup on a mesh, a ``local_map`` body: the table gathered over
    the data axes (its ``embed`` dim), each ``model`` rank looking up the
    tokens of its own vocab rows (zeros elsewhere, summed over ``model``
    by the constraint after it) when the vocab shards."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    tpl = rules.act_placements(mesh, tokens.shape, ("batch", "seq"))
    wpl = tuple(p if n == "model" else Replicate()
                for n, p in zip(names, w.placements))
    mi = names.index("model") if "model" in names else None
    vocab_split = mi is not None and wpl[mi].is_shard()
    out = tuple(Partial() if vocab_split and i == mi else p
                for i, p in enumerate(tpl))

    def body(t, wl):
        if not vocab_split:
            return F.embedding(t, wl)
        rows = wl.shape[0]
        first = mesh.get_local_rank(mi) * rows
        mine = (t >= first) & (t < first + rows)
        e = F.embedding((t - first).clamp(0, rows - 1), wl)
        return e * mine[..., None].to(e.dtype)

    x = local_map(body, out_placements=list(out), in_placements=(tpl, wpl),
                  in_grad_placements=(tpl, layers.grad_placements(wpl, tpl)),
                  device_mesh=mesh, redistribute_inputs=True)(tokens, w)
    return rules.constrain(x, ("batch", "seq", None))


def _positions(x: torch.Tensor) -> torch.Tensor:
    """Rope positions (B, S) for the activations x (B, S, ...): 0..S-1 a
    row, laid out as the tokens on a mesh."""
    B, S = x.shape[:2]
    dev = rules.local(x).device
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    if not rules.is_dtensor(x):
        return pos
    mesh = x.device_mesh
    return rules.distribute(pos, mesh, rules.act_placements(
        mesh, (B, S), ("batch", "seq")))


def encode(cfg: ModelConfig, rc: RunConfig, model: Model,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder half of an encoder-decoder model: the stub frame
    embeddings (B, Se, d), cast to the parameter dtype, through the ``enc``
    blocks (rope positions over the frames) and ``enc_norm``.  Returns
    enc_out (B, Se, d), what every ``dec`` block reads.  On a mesh the
    frames come in placed as ("batch", "seq", None), the reference's input
    spec, and so do their positions and enc_out."""
    e = rules.constrain(enc_embeds.to(model.embed.dtype),
                        ("batch", "seq", None))
    positions = _positions(e)
    for block in model.enc:
        e, _ = _run_block(cfg, rc, "enc", block, e, positions)
    return rules.constrain(layers.rmsnorm(e, model.enc_norm, cfg.norm_eps),
                           ("batch", "seq", None))


def backbone(cfg: ModelConfig, rc: RunConfig, model: Model, batch: dict,
             collect_cache: bool = False):
    """Runs embedding + all segments.  Returns (hidden, caches).

    An encoder-decoder model encodes ``batch["enc_embeds"]`` first
    (``encode``), unless the caller hands over the encoder output as
    ``batch["enc_out"]``, as ``serve.greedy_decode`` does to run the
    encoder once."""
    x = embed_input(cfg, model, batch)
    positions = _positions(x)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = (batch["enc_out"] if "enc_out" in batch else
                   encode(cfg, rc, model, batch["enc_embeds"]))
    caches = {}
    for si, ((kind, _), seg) in enumerate(zip(cfg.block_pattern,
                                              model.segments)):
        entries = []
        for block in seg:
            x, cache = _run_block(cfg, rc, kind, block, x, positions,
                                  enc_out, collect_cache)
            entries.append(cache)
        if collect_cache:
            caches[f"seg{si}"] = _stack(entries)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return x, caches


def _head_weight(cfg: ModelConfig, model: Model) -> torch.Tensor:
    """The LM head's (d, V) weight (the embedding's transpose when tied),
    as a product reads it (``rules.gathered``)."""
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    return rules.gathered(w)


def lm_head(cfg: ModelConfig, model: Model, h: torch.Tensor) -> torch.Tensor:
    return h @ _head_weight(cfg, model)


def _chunk_ce(w: torch.Tensor, hx: torch.Tensor, lx: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (sum of -log p(label), count of labels >= 0) under the
    head weight w: float32 logits, logsumexp minus the gold logit, padding
    labels (-1) masked."""
    logits = hx @ w
    if rules.is_dtensor(logits):
        return _ce_on_mesh(logits, lx)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lx.clamp(min=0)[..., None].long())[..., 0]
    valid = (lx >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


class _SumOverGroup(torch.autograd.Function):
    """The sum of every rank's x over ``group``, for a result that every
    rank then uses alike: each rank's gradient is the result's own."""

    @staticmethod
    def forward(ctx, x, group):
        from repro_torch.parallel import compat
        return compat.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ce_on_mesh(logits, labels):
    """``_chunk_ce`` on a mesh, a ``local_map`` body on each rank's rows
    and, where the vocab shards over ``model``, its vocab columns: the
    row max and the sum of exponentials are reduced over ``model``
    (max, then sum), and so is the gold logit, found on the rank that
    holds its column.  The sums come out split over the data axes."""
    from torch.distributed import ReduceOp
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel import compat

    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    B, C, V = logits.shape
    lpl = rules.act_placements(mesh, (B, C, V), ("batch", None, "vocab"))
    ypl = rules.act_placements(mesh, (B, C), ("batch",))
    mi = names.index("model") if "model" in names else None
    vocab_split = mi is not None and lpl[mi].is_shard()
    group = mesh.get_group(mi) if vocab_split else None
    out = tuple(Partial() if p.is_shard() else Replicate() for p in ypl)

    def body(l, y):
        l = l.float()
        cols = l.shape[-1]
        first = mesh.get_local_rank(mi) * cols if vocab_split else 0
        m = l.amax(-1).detach()
        if vocab_split:
            m = compat.all_reduce(m, group, ReduceOp.MAX)
        se = torch.exp(l - m[..., None]).sum(-1)
        mine = (y >= first) & (y < first + cols)
        gold = l.gather(-1, (y - first).clamp(0, cols - 1)[..., None]
                        .long())[..., 0] * mine
        if vocab_split:
            se = _SumOverGroup.apply(se, group)
            gold = _SumOverGroup.apply(gold, group)
        valid = (y >= 0).float()
        return ((m + torch.log(se) - gold) * valid).sum(), valid.sum()

    return local_map(body, out_placements=(out, out),
                     in_placements=(lpl, ypl), in_grad_placements=(lpl, ypl),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 labels)


def chunked_loss(cfg: ModelConfig, rc: RunConfig, model: Model,
                 h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy: the (B, S, V) logits never
    exist at once.  S is padded to a multiple of ``min(rc.loss_chunk, S)``
    with label -1; each chunk runs under ``torch.utils.checkpoint`` when
    gradients are on (its logits recomputed in the backward), as the
    reference checkpoints ``chunk_ce``.  Mean over the valid labels.  On a
    mesh the head weight is gathered once for all the chunks."""
    B, S, _ = h.shape
    chunk = min(rc.loss_chunk, S)
    nch = -(-S // chunk)
    if nch * chunk != S:
        h = F.pad(h, (0, 0, 0, nch * chunk - S))
        labels = F.pad(labels, (0, nch * chunk - S), value=-1)
    w = _head_weight(cfg, model)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c in range(nch):
        hx, lx = h[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:
                                                         (c + 1) * chunk]
        if torch.is_grad_enabled():
            l, n = checkpoint(_chunk_ce, w, hx, lx, use_reentrant=False)
        else:
            l, n = _chunk_ce(w, hx, lx)
        tot, cnt = tot + l, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, rc: RunConfig, model: Model, batch: dict
            ) -> torch.Tensor:
    """The training loss: ``backbone`` (whisper's encoder on
    ``batch["enc_embeds"]`` first) then ``chunked_loss`` on
    ``batch["labels"]``."""
    h, _ = backbone(cfg, rc, model, batch)
    return chunked_loss(cfg, rc, model, h, batch["labels"])


def prefill(cfg: ModelConfig, rc: RunConfig, model: Model, batch: dict,
            cache_len: int, return_hidden: bool = False):
    """Prefill: returns (last-position logits, decode cache).

    ``return_hidden=True`` appends the last-position post-final-norm
    hidden state (B, 1, D), the input the Lagrange-coded head
    (``core/coded_linear``) projects instead of ``lm_head``.
    """
    h, caches = backbone(cfg, rc, model, batch, collect_cache=True)
    S = h.shape[1]
    last = _last_position(h)
    logits = lm_head(cfg, model, last)
    cache: dict[str, Any] = {"index": S}
    for si, (kind, _) in enumerate(cfg.block_pattern):
        src, dst = caches[f"seg{si}"], {}
        if "k" in src:
            size = _cache_size(cfg, kind, cache_len)
            for name in ("k", "v"):
                dst[name] = _cache_slots(src[name], S, size, name)
        if "ssm" in src:
            dst["ssm"] = src["ssm"].float()
            dst["conv"] = src["conv"]
        cache[f"seg{si}"] = dst
    if return_hidden:
        return logits, cache, last
    return logits, cache


def _last_position(h: torch.Tensor) -> torch.Tensor:
    """h[:, -1:] (B, 1, D); on a mesh from each rank's rows (the residual
    stream's sequence is whole on every rank)."""
    if not rules.is_dtensor(h):
        return h[:, -1:]
    from torch.distributed.tensor import DTensor

    if any(p.is_shard() and p.dim == 1 for p in h.placements):
        raise ValueError(f"the sequence of h is sharded ({h.placements})")
    return DTensor.from_local(h.to_local()[:, -1:], h.device_mesh,
                              h.placements, run_check=False)


def _cache_slots(src: torch.Tensor, S: int, size: int, name: str
                 ) -> torch.Tensor:
    """The decode cache's ``size`` slots of one k or v leaf from the
    prefill's (count, B, S, KH, hd): slot j holds token j for j < S (zeros
    after), and in a ring (S >= size) the token t with t = j mod size,
    S - size <= t < S.  On a mesh a ``local_map`` body gives each rank its
    own slots, placed by ``CACHE_LOGICAL`` (the source gathered along
    whatever the cache does not shard)."""
    def slots(t: torch.Tensor, first: int, n: int) -> torch.Tensor:
        j = first + torch.arange(n, device=t.device)
        if S >= size:
            return t.index_select(2, S - size + (j - S) % size)
        got = t.index_select(2, j.clamp(max=S - 1))
        return torch.where((j < S)[:, None, None], got, got.new_zeros(()))

    if not rules.is_dtensor(src):
        return slots(src, 0, size)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = src.device_mesh
    shape = (*src.shape[:2], size, *src.shape[3:])
    dpl = rules.act_placements(mesh, shape, CACHE_LOGICAL[name])
    spl = tuple(Replicate() if p.is_shard() and p.dim == 2 else p
                for p in dpl)
    seq = [i for i, p in enumerate(dpl) if p.is_shard() and p.dim == 2]

    def body(t):
        n = size
        first = 0
        for i in seq:
            n //= mesh.size(i)
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        return slots(t, first * n, n)

    return local_map(body, out_placements=list(dpl), in_placements=(spl,),
                     device_mesh=mesh, redistribute_inputs=True)(src)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def _cache_size(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """A segment's k/v slots: the window for sliding-window attention (a
    ring buffer), ``max_len`` for full attention."""
    window = _window(cfg, kind)
    return min(max_len, window) if window else max_len


def init_cache(cfg: ModelConfig, rc: RunConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None,
               mesh=None) -> dict[str, Any]:
    """Decode cache: attention segments get k/v (count, B, size, KH, hd) in
    ``dtype``, with size the window for sliding-window segments (a ring
    buffer) and ``max_len`` for full attention; mamba state is O(1): conv
    (count, B, cw-1, di) in ``dtype`` and ssm (count, B, di, n) float32.
    ``index`` is the number of tokens seen (a Python int).  On the card
    unless ``device`` says otherwise (``device.resolve``; ``meta`` gives
    the shapes alone).  On ``mesh`` every leaf is a ``DTensor`` placed by
    ``CACHE_LOGICAL`` (``configs/registry.input_specs``' placements),
    each rank allocating its own block."""
    device = _device.resolve(device)
    cache: dict[str, Any] = {"index": 0}
    kh, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, dt, name):
        if mesh is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return rules.zeros(shape, dt, mesh, rules.act_placements(
            mesh, shape, CACHE_LOGICAL[name]), device)

    for si, (kind, count) in enumerate(cfg.block_pattern):
        base = kind.replace("_global", "")
        seg: dict[str, torch.Tensor] = {}
        if base in _ATTN:
            size = _cache_size(cfg, kind, max_len)
            for name in ("k", "v"):
                seg[name] = zeros((count, batch, size, kh, hd), dtype, name)
        if base in _SSM:
            seg["conv"] = zeros((count, batch, cfg.conv_width - 1,
                                 cfg.d_inner), dtype, "conv")
            seg["ssm"] = zeros((count, batch, cfg.d_inner, cfg.ssm_state),
                               torch.float32, "ssm")
        cache[f"seg{si}"] = seg
    return cache


def _decode_attn(cfg: ModelConfig, p, x: torch.Tensor,
                 cache_layer: dict[str, torch.Tensor], index: int,
                 window: int | None, positions: torch.Tensor):
    """One layer's cached attention at decode time (a ring buffer for a
    sliding window: the buffer is the window, so the attention itself is
    called without one).  The given k/v are left unmodified.  On a mesh
    the output comes back by its query heads, as ``wo``'s rows are."""
    B = x.shape[0]
    q, k, v = layers.attn_qkv(cfg, p, x, positions)
    size = cache_layer["k"].shape[1]
    slot = index % size if window else index
    out, kc, vc = layers.cached_decode_attention(
        q, k, v, cache_layer["k"], cache_layer["v"], slot,
        min(index + 1, size))
    out = rules.constrain(out, ("batch", "seq", f"heads[{cfg.num_heads}]",
                                None))
    return (out.reshape(B, 1, -1) @ rules.gathered(p["wo"]),
            {"k": kc, "v": vc})


def _decode_positions(x: torch.Tensor, index: int) -> torch.Tensor:
    """Rope positions (B, 1) of the token at ``index``, laid out as the
    tokens on a mesh."""
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32,
                     device=rules.local(x).device)
    if not rules.is_dtensor(x):
        return pos
    mesh = x.device_mesh
    return rules.distribute(pos, mesh, rules.act_placements(
        mesh, (B, 1), ("batch", "seq")))


def decode_block(cfg: ModelConfig, rc: RunConfig, kind: str, block: Block,
                 x: torch.Tensor, cache_layer: dict[str, torch.Tensor],
                 index: int, enc_out: torch.Tensor | None = None):
    """One block's single-token step at position ``index``; a ``dec``
    block's cross-attention reads ``enc_out`` (B, Se, d), its k and v
    recomputed from it.  Returns (x, new cache entry); ``cache_layer`` is
    left unmodified.  Under a rules mesh the residual stream is placed
    as ("batch", "seq", None) after each half, as in ``block_forward``."""
    base = kind.replace("_global", "")
    new_cache: dict[str, torch.Tensor] = {}
    if base in _ATTN:
        positions = _decode_positions(x, index)
        hnorm = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
        attn_out, kv = _decode_attn(cfg, block.attn, hnorm, cache_layer,
                                    index, _window(cfg, kind), positions)
        new_cache.update(kv)
        if base == "hybrid":
            hm = layers.rmsnorm(x, block.norm_m, cfg.norm_eps)
            x = x + attn_out + _mamba_step(cfg, block.mamba, hm, cache_layer,
                                           new_cache)
        else:
            x = x + attn_out
        x = rules.constrain(x, ("batch", "seq", None))
        if base == "dec":
            x = rules.constrain(
                x + _cross_attn(cfg, rc, block, x, enc_out, step=True),
                ("batch", "seq", None))
        x = x + _ffn(cfg, rc, base, block, x)
    elif base == "mamba":
        hnorm = layers.rmsnorm(x, block.norm1, cfg.norm_eps)
        x = x + _mamba_step(cfg, block.mamba, hnorm, cache_layer, new_cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return rules.constrain(x, ("batch", "seq", None)), new_cache


def _mamba_step(cfg: ModelConfig, p, h: torch.Tensor,
                cache_layer: dict[str, torch.Tensor],
                new_cache: dict[str, torch.Tensor]) -> torch.Tensor:
    """The mamba mixer's single-token step on the normed input h; puts the
    new conv window and state into ``new_cache``.  On a mesh the
    projection is gathered before the split, as in ``_mamba_branch``."""
    xz = rules.constrain(h @ rules.gathered(p["in_proj"]),
                         ("batch", "seq", None))
    x_in, z = xz.chunk(2, dim=-1)
    ym, mcache = mamba.mamba_decode_core(
        cfg, p, x_in, {"conv": cache_layer["conv"], "ssm": cache_layer["ssm"]})
    new_cache.update(mcache)
    return (ym * layers.silu(z)) @ rules.gathered(p["out_proj"])


def decode_step(cfg: ModelConfig, rc: RunConfig, model: Model, cache: dict,
                batch: dict, return_hidden: bool = False):
    """One decode step: batch {'tokens': (B,1)} -> (logits (B,1,V), cache);
    an encoder-decoder model also takes {'enc_out': (B, Se, d)}.

    ``return_hidden=True`` appends the post-final-norm hidden state
    (B, 1, D), mirroring ``prefill``.  The given cache is not modified:
    the new one is built whole, so a step copies every layer's cache
    (each attention layer's k/v twice: the slot write's copy, then the
    stack).  On a mesh (a placed model, the tokens and ``enc_out`` placed
    as ``registry.input_specs`` says, under ``rules.use_rules_mesh``) the
    cache keeps its placement, and a sequence-sharded layer copies only
    the slot owner's block for the write.
    """
    x = embed_input(cfg, model, batch)
    index = cache["index"]
    enc_out = batch.get("enc_out")
    new_cache: dict[str, Any] = {"index": index + 1}
    for si, ((kind, _), seg) in enumerate(zip(cfg.block_pattern,
                                              model.segments)):
        seg_cache = cache[f"seg{si}"]
        entries = []
        for li, block in enumerate(seg):
            x, nc = decode_block(cfg, rc, kind, block, x,
                                 {k: _layer(v, li)
                                  for k, v in seg_cache.items()},
                                 index, enc_out)
            entries.append(nc)
        new_cache[f"seg{si}"] = _stack(entries)
    x = layers.rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = lm_head(cfg, model, x)
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache
