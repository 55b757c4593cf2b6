"""The port's dense, MoE and hybrid models against the reference's
``repro/models/model.py``, at each architecture's reduced config (d 64,
4 query and 2 kv heads, vocab 256, window 32 where the architecture has
one; hymba 3 layers with its first, global, layer; phi3.5-moe and arctic
4 experts of 64, top-2, arctic with its dense residual) with the
reference's parameters carried across by ``convert``.

Tolerances are ``tests/test_torch_models.py``'s: float32 within 1e-3, and
bfloat16 within 32 · 2^-9 of the largest magnitude compared (bf16 rounds
with a relative error up to 2^-9; a value passes through up to about 32
bf16 roundings in sequence over two layers and three decode steps).  The
same bound holds hymba's three layers: the port's ``silu`` and
``softplus`` round each step in bf16 as the reference's do, so the two
runs round alike (its reduced bf16 backbone lies 1.5% of the largest
magnitude from the reference's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_models import (F32_ATOL, JRC, RC, carried, close,  # noqa: E402
                               tokens)

ARCHS = ["tinyllama-1.1b", "h2o-danube-3-4b", "qwen2-72b",
         "mistral-large-123b", "qwen2-vl-7b", "hymba-1.5b",
         "phi3.5-moe-42b-a6.6b", "arctic-480b"]
DTYPES = ["f32", "bf16"]


def cache_leaves(cache):
    return {f"{seg}/{name}": t for seg, c in cache.items() if seg != "index"
            for name, t in c.items()}


def close_cache(got, want, dtype):
    g, w = cache_leaves(got), cache_leaves(want)
    assert sorted(g) == sorted(w)
    assert got["index"] == int(want["index"])
    for k in g:
        close(g[k], w[k], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_templates_and_parameters_match_reference(arch):
    jcfg, tcfg, params, model = carried("bf16", arch)
    flat = dict(model.named_parameters())
    for si, (kind, count) in enumerate(tcfg.block_pattern):
        tmpl = jax.tree.map(lambda s: tuple(s.shape),
                            JM.block_template(jcfg, kind),
                            is_leaf=lambda s: hasattr(s, "logical"))
        ours = jax.tree.map(lambda s: tuple(s.shape),
                            TM.block_template(tcfg, kind),
                            is_leaf=lambda s: hasattr(s, "logical"))
        assert ours == tmpl
        for li in range(count):
            ref = jax.tree.map(lambda t: t if count == 1 else t[li],
                               params[f"seg{si}"]["params"])
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
                name = ".".join(p.key for p in path)
                got = flat[f"segments.{si}.{li}.{name}"]
                assert np.array_equal(got.float().numpy(),
                                      np.asarray(leaf.astype(jnp.float32)))
    n = sum(p.numel() for p in model.parameters())
    # the reference's analytic count leaves out conv_b (d_inner a layer),
    # and counts d_model more a layer for a dense residual than its leaves
    # hold
    mamba_layers = sum(c for k, c in tcfg.block_pattern if "hybrid" in k)
    residual_layers = (tcfg.num_layers if tcfg.dense_residual_d_ff else 0)
    assert n == (tcfg.param_count() + mamba_layers * tcfg.d_inner
                 - residual_layers * tcfg.d_model)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_block_matches_reference(arch, dtype):
    """Layer by layer: every block on the same input (the port's output of
    the block before), output and cache entry."""
    jcfg, tcfg, params, model = carried(dtype, arch)
    B, S = 2, 40                                   # past the window of 32
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    x = TM.embed_input(tcfg, model, {"tokens": torch.as_tensor(
        tokens(B, S, seed=3))})
    pos_t = torch.arange(S, dtype=torch.int32).expand(B, S)
    pos_j = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    for si, (kind, count) in enumerate(tcfg.block_pattern):
        for li in range(count):
            p = jax.tree.map(lambda t: t if count == 1 else t[li],
                             params[f"seg{si}"]["params"])
            xj = jnp.asarray(x.float().numpy(), jdt)
            yj, cj = JM.block_forward(jcfg, JRC, kind, p, xj, pos_j,
                                      collect_cache=True)
            x, ct = TM.block_forward(tcfg, RC, kind, model.segments[si][li],
                                     x, pos_t, collect_cache=True)
            close(x, yj, dtype)
            assert sorted(ct) == sorted(cj)
            for name in ct:
                close(ct[name], cj[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_matches_reference(arch, dtype):
    jcfg, tcfg, params, model = carried(dtype, arch)
    toks = tokens(2, 24, seed=1)
    hj, _ = JM.backbone(jcfg, JRC, params, {"tokens": jnp.asarray(toks)})
    ht, _ = TM.backbone(tcfg, RC, model, {"tokens": torch.as_tensor(toks)})
    assert ht.dtype == model.embed.dtype
    close(ht, hj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and every cache leaf, then three decode steps."""
    jcfg, tcfg, params, model = carried(dtype, arch)
    B, S, EXTRA = 2, 16, 3
    toks = tokens(B, S + EXTRA, seed=2)
    lj, cj = JM.prefill(jcfg, JRC, params, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=S + EXTRA)
    lt, ct = TM.prefill(tcfg, RC, model, {"tokens": torch.as_tensor(toks[:, :S])},
                        cache_len=S + EXTRA)
    for t in range(EXTRA + 1):
        close(lt, lj, dtype)
        close_cache(ct, cj, dtype)
        if t < EXTRA:
            tok = toks[:, S + t: S + t + 1]
            lj, cj = JM.decode_step(jcfg, JRC, params, cj,
                                    {"tokens": jnp.asarray(tok)})
            before = {k: v.clone() for k, v in cache_leaves(ct).items()}
            lt, nt = TM.decode_step(tcfg, RC, model, ct,
                                    {"tokens": torch.as_tensor(tok)})
            assert all(torch.equal(v, before[k])          # input unmodified
                       for k, v in cache_leaves(ct).items())
            ct = nt


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's test_decode_matches_full_forward, on the port, at
    its capacity factor of 8 (no token of an MoE prefill dropped)."""
    _, tcfg, _, model = carried("f32", arch)
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    B, S, EXTRA = 2, 16, 3
    toks = torch.as_tensor(tokens(B, S + EXTRA, seed=5))
    h, _ = TM.backbone(tcfg, RC, model, {"tokens": toks})
    want = TM.lm_head(tcfg, model, h[:, -1:])
    logits, cache = TM.prefill(tcfg, RC, model, {"tokens": toks[:, :S]},
                               cache_len=S + EXTRA)
    for t in range(EXTRA):
        logits, cache, hid = TM.decode_step(
            tcfg, RC, model, cache, {"tokens": toks[:, S + t: S + t + 1]},
            return_hidden=True)
    assert float((logits - want).abs().max()) < F32_ATOL
    assert float((hid - h[:, -1:]).abs().max()) < F32_ATOL


@pytest.mark.parametrize("arch,S,extra", [("h2o-danube-3-4b", 40, 4),
                                          ("hymba-1.5b", 45, 5)])
def test_decode_past_the_window(arch, S, extra):
    """The reference's test_swa_ring_buffer_decode (danube: window 32, a
    40-token prefill, 4 more tokens) and hymba past its window, where
    global (full) and windowed (ring) attention caches sit in one cache:
    the ring cache against the full-context forward, and prefill and
    decode against the reference's."""
    jcfg, tcfg, params, model = carried("f32", arch)
    assert tcfg.sliding_window == 32 < S
    toks = tokens(1, S + extra, seed=6)
    h, _ = TM.backbone(tcfg, RC, model, {"tokens": torch.as_tensor(toks)})
    want = TM.lm_head(tcfg, model, h[:, -1:])
    lt, ct = TM.prefill(tcfg, RC, model, {"tokens": torch.as_tensor(toks[:, :S])},
                        cache_len=S + extra)
    lj, cj = JM.prefill(jcfg, JRC, params, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=S + extra)
    sizes = {k: v.shape[2] for k, v in cache_leaves(ct).items()
             if k.endswith("/k")}
    assert min(sizes.values()) == 32
    if arch == "hymba-1.5b":
        assert sizes["seg0/k"] == S + extra          # the global layer
    for t in range(extra):
        close(lt, lj, "f32")
        close_cache(ct, cj, "f32")
        tok = toks[:, S + t: S + t + 1]
        lt, ct = TM.decode_step(tcfg, RC, model, ct,
                                {"tokens": torch.as_tensor(tok)})
        lj, cj = JM.decode_step(jcfg, JRC, params, cj,
                                {"tokens": jnp.asarray(tok)})
    close(lt, lj, "f32")
    assert float((lt - want).abs().max()) < F32_ATOL


def test_prefill_ring_alignment_places_token_t_at_slot_t_mod_size():
    _, tcfg, _, model = carried("f32", "h2o-danube-3-4b")
    S = 45
    toks = torch.as_tensor(tokens(1, S, seed=7))
    _, caches = TM.backbone(tcfg, RC, model, {"tokens": toks},
                            collect_cache=True)
    _, cache = TM.prefill(tcfg, RC, model, {"tokens": toks}, cache_len=S + 2)
    k_all, ring = caches["seg0"]["k"], cache["seg0"]["k"]
    for t in range(S - 32, S):
        assert torch.equal(ring[:, :, t % 32], k_all[:, :, t])


def test_unported_kinds_still_raise_naming_their_item():
    """The encoder/decoder kinds, refused until they were ported, now
    build: whisper's reduced model has the reference's enc and dec block
    templates, its encoder blocks and enc_norm, and a k/v cache for each
    decoder layer (cross-attention keeps none)."""
    jcfg, tcfg, _, model = carried("bf16", "whisper-tiny")
    for kind in ("enc", "dec"):
        shapes = [jax.tree.map(lambda s: tuple(s.shape), m.block_template(c, kind),
                               is_leaf=lambda s: hasattr(s, "logical"))
                  for m, c in ((JM, jcfg), (TM, tcfg))]
        assert shapes[0] == shapes[1]
    assert len(model.enc) == tcfg.num_encoder_layers == 2
    assert model.enc_norm.shape == (tcfg.d_model,)
    # the reference's analytic count leaves out enc_norm
    n = sum(p.numel() for p in model.parameters())
    assert n == tcfg.param_count() + tcfg.d_model
    cache = TM.init_cache(tcfg, RC, 2, 8, device="cpu")
    assert sorted(cache["seg0"]) == ["k", "v"]
    assert cache["seg0"]["k"].shape == (2, 2, 8, tcfg.num_kv_heads,
                                        tcfg.head_dim)
