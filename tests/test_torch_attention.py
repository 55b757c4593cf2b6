"""The port's attention, rope, activations and MLP layers against the
reference's ``repro/models/layers.py`` (and ``jax.nn``) on the same numpy
inputs.  ``silu`` and ``softplus`` on bf16 inputs are held bit for bit.

Tolerances: float32 at the reference tests' own 2e-5 (the same float32
arithmetic summed in another order).  With ``compute_dtype="bf16"`` both
sides round the matmul inputs to bf16, the probabilities included, and an
exp that differs in its last float32 bit can round a probability to the
next bf16 value: one step is 2^-8 of it, so the outputs agree within
2^-8 of the largest |v| (the values are N(0, 1)); bf16 inputs to ``rope``
within one bf16 step (2^-8) of the largest output.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 2e-5
BF16_STEP = 2.0 ** -8


def qkv(S, H=4, KH=2, D=8, B=2, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32))


def both(fn_j, fn_t, *arrays, **kw):
    """(reference output as numpy, port output as numpy) on the same input."""
    got = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return (np.asarray(jnp.asarray(want, jnp.float32)),
            got.float().numpy())


def err(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("causal,window,S", [
    (True, None, 64), (True, 16, 64), (False, None, 48), (True, 24, 50),
])
def test_blockwise_attention_matches_reference(causal, window, S):
    want, got = both(JL.blockwise_attention, TL.blockwise_attention,
                     *qkv(S), causal=causal, window=window, q_block=16,
                     kv_block=16)
    assert err(got, want) < ATOL


@pytest.mark.parametrize("qb,kb", [(8, 8), (16, 32), (60, 60), (13, 7)])
def test_blockwise_attention_block_invariance(qb, kb):
    """The reference test's shapes: each block size against the reference
    at that size and against the port at (8, 8)."""
    arrays = qkv(60, H=2, KH=1, B=1, seed=1)
    want, got = both(JL.blockwise_attention, TL.blockwise_attention, *arrays,
                     q_block=qb, kv_block=kb)
    assert err(got, want) < ATOL
    base = TL.blockwise_attention(*(torch.as_tensor(a) for a in arrays),
                                  q_block=8, kv_block=8)
    assert err(got, base.numpy()) < ATOL


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
def test_blockwise_attention_bf16_compute(window, in_dtype):
    q, k, v = qkv(50, seed=2)
    tq = lambda a: (torch.as_tensor(a) if in_dtype == "f32"  # noqa: E731
                    else torch.as_tensor(a).bfloat16())
    jq = lambda a: (jnp.asarray(a) if in_dtype == "f32"  # noqa: E731
                    else jnp.asarray(a, jnp.bfloat16))
    kw = dict(window=window, q_block=16, kv_block=16, compute_dtype="bf16")
    got = TL.blockwise_attention(tq(q), tq(k), tq(v), **kw)
    want = JL.blockwise_attention(jq(q), jq(k), jq(v), **kw)
    assert got.dtype == (torch.float32 if in_dtype == "f32"
                         else torch.bfloat16)
    tol = BF16_STEP * float(np.abs(v).max())
    assert err(got.float().numpy(),
               np.asarray(want.astype(jnp.float32))) < tol


def test_blockwise_attention_softcap():
    want, got = both(JL.blockwise_attention, TL.blockwise_attention,
                     *qkv(48, seed=3), window=20, q_block=16, kv_block=16,
                     softcap=2.5)
    assert err(got, want) < ATOL
    plain = TL.blockwise_attention(*(torch.as_tensor(a) for a in qkv(48, seed=3)),
                                   window=20, q_block=16, kv_block=16)
    assert err(got, plain.numpy()) > 1e-3        # the cap changed the scores


@pytest.mark.parametrize("window", [None, 12])
def test_blockwise_attention_row_offset(window):
    """Query rows 16..31 of a 48-token sequence (the context-parallel shard's
    call): every tile live and masked, equal to those rows of the whole."""
    q, k, v = qkv(48, seed=4)
    kw = dict(window=window, q_block=8, kv_block=16)
    want, got = both(JL.blockwise_attention, TL.blockwise_attention,
                     q[:, 16:32], k, v, row_offset=16, **kw)
    assert err(got, want) < ATOL
    whole = TL.blockwise_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                   **kw)
    assert err(got, whole[:, 16:32].numpy()) < ATOL


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("cache_len", [33, 20])
def test_decode_attention_matches_reference(window, cache_len):
    q, k, v = qkv(33, seed=5)
    want, got = both(JL.decode_attention, TL.decode_attention,
                     q[:, -1:], k, v, cache_len=cache_len, window=window)
    assert err(got, want) < ATOL
    if window is None and cache_len == 33:
        # the last row of causal attention over the whole sequence
        full = TL.blockwise_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                      q_block=16, kv_block=16)
        assert err(got[:, 0], full[:, -1].numpy()) < ATOL


@pytest.mark.parametrize("theta", [10000.0, 1e6])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_reference(theta, dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 140, dtype=np.int32), (2, 40))
    if dtype == "f32":
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos.copy()), theta)
        tol = ATOL
    else:
        want = JL.rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta)
        got = TL.rope(torch.as_tensor(x).bfloat16(),
                      torch.as_tensor(pos.copy()), theta)
        assert got.dtype == torch.bfloat16
        tol = BF16_STEP * float(np.abs(x).max())
    assert err(got.float().numpy(),
               np.asarray(want.astype(jnp.float32))) < tol


ACTIVATIONS = {"silu": (jax.nn.silu, TL.silu),
               "softplus": (jax.nn.softplus, TL.softplus)}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_bf16_activation_is_bit_equal_to_reference(name):
    """2^16 bf16 inputs from N(0, 16): every output bit for bit (the fused
    F.silu and F.softplus differ in about 37% and 15% of them)."""
    fn_j, fn_t = ACTIVATIONS[name]
    x = (np.random.default_rng(11).standard_normal(1 << 16) * 4
         ).astype(np.float32)
    want = np.asarray(fn_j(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = fn_t(torch.as_tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_f32_activation_matches_reference(name):
    fn_j, fn_t = ACTIVATIONS[name]
    x = (np.random.default_rng(12).standard_normal(1 << 16) * 4
         ).astype(np.float32)
    want, got = both(fn_j, fn_t, x)
    assert err(got, want) < ATOL


def test_swiglu_and_mlp_forward_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w1, w3 = (rng.standard_normal((16, 32)).astype(np.float32) / 4
              for _ in range(2))
    w2 = rng.standard_normal((32, 16)).astype(np.float32) / 6
    want, got = both(JL.swiglu, TL.swiglu, x, w1, w3, w2)
    assert err(got, want) < ATOL
    cfg = treg.reduced_config(treg.get_config("tinyllama-1.1b"))
    assert {k: s.shape for k, s in TL.mlp_template(cfg).items()} == {
        k: s.shape for k, s in JL.mlp_template(
            jreg.reduced_config(jreg.get_config("tinyllama-1.1b"))).items()}
    p = {"w1": w1, "w3": w3, "w2": w2}
    got = TL.mlp_forward(dataclasses.replace(cfg, d_model=16, d_ff=32),
                         {k: torch.as_tensor(a) for k, a in p.items()},
                         torch.as_tensor(x))
    assert err(got.numpy(), want) < ATOL


def attn_params(arch, seed=8):
    """The reduced config's attention leaves (reference template shapes),
    biases included and non-zero, in float32."""
    jcfg = jreg.reduced_config(jreg.get_config(arch))
    tcfg = treg.reduced_config(treg.get_config(arch))
    rng = np.random.default_rng(seed)
    tmpl = JL.attn_template(jcfg)
    assert {k: s.shape for k, s in TL.attn_template(tcfg).items()} == {
        k: s.shape for k, s in tmpl.items()}
    p = {k: (rng.standard_normal(s.shape) * s.shape[0] ** -0.5
             ).astype(np.float32) for k, s in tmpl.items()}
    return jcfg, tcfg, p


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-72b"])
def test_attn_qkv_forward_and_decode_match_reference(arch):
    """Without (tinyllama) and with (qwen2, theta 1e6) the QKV bias."""
    jcfg, tcfg, p = attn_params(arch)
    assert ("bq" in p) == (arch == "qwen2-72b")
    pj = {k: jnp.asarray(a) for k, a in p.items()}
    pt = {k: torch.as_tensor(a) for k, a in p.items()}
    rng = np.random.default_rng(9)
    B, S = 2, 24
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for a, b in zip(TL.attn_qkv(tcfg, pt, torch.as_tensor(x),
                                torch.as_tensor(pos)),
                    JL.attn_qkv(jcfg, pj, jnp.asarray(x), jnp.asarray(pos))):
        assert err(a.numpy(), np.asarray(b)) < ATOL
    from repro.configs.base import RunConfig as JRunConfig
    from repro_torch.configs.base import RunConfig as TRunConfig
    jrc, trc = JRunConfig(q_block=8, kv_block=16), TRunConfig(q_block=8,
                                                              kv_block=16)
    got = TL.attn_forward(tcfg, trc, pt, torch.as_tensor(x),
                          torch.as_tensor(pos), window=10)
    want = JL.attn_forward(jcfg, jrc, pj, jnp.asarray(x), jnp.asarray(pos),
                           window=10)
    assert err(got.numpy(), np.asarray(want)) < ATOL
    hd, kh = tcfg.head_dim, tcfg.num_kv_heads
    cache = {n: rng.standard_normal((B, 32, kh, hd)).astype(np.float32)
             for n in ("k", "v")}
    tc = {n: torch.as_tensor(a) for n, a in cache.items()}
    got, gc = TL.attn_decode(tcfg, pt, torch.as_tensor(x[:, :1]), tc, 20)
    want, wc = JL.attn_decode(jcfg, pj, jnp.asarray(x[:, :1]),
                              {n: jnp.asarray(a) for n, a in cache.items()},
                              jnp.int32(20))
    assert err(got.numpy(), np.asarray(want)) < ATOL
    for n in ("k", "v"):
        assert err(gc[n].numpy(), np.asarray(wc[n])) < ATOL
        assert np.array_equal(tc[n].numpy(), cache[n])   # input unmodified
