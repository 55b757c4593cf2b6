"""The port's encoder/decoder model (whisper-tiny) and its gelu against the
reference's ``repro/models/model.py`` and ``jax.nn.gelu``, with the
reference's parameters carried across by ``convert``.  The reduced config
is the reference's (d 64, 4 query and 2 kv heads, 2 encoder and 2 decoder
layers, 16 frames, vocab 256); the full-width case is whisper-tiny's
published config (d 384, 6 heads of 64, d_ff 1536, vocab 51865, 1500
frames) at batch 1.

The reference takes the stub frames as ``batch["enc_embeds"]`` and, at
decode, the encoder output as ``batch["enc_out"]``
(``tests/test_models.py``'s ``test_decode_matches_full_forward``); the
reference's encoder output here is computed as that test computes it.

Tolerances are ``tests/test_torch_models.py``'s: float32 within 1e-3 (the
acceptance asks 1e-4 of the reduced float32 logits, which these runs meet
too), bfloat16 within 32 · 2^-9 of the largest magnitude compared.
``gelu`` on bf16 inputs is held bit for bit; on float32 inputs to
4 · 2^-23 · |x|, the cdf factor x * cdf within 4 float32 ulps of 1: XLA's
float32 tanh is its own approximation, which differs from torch's in the
last bits of about 59% of outputs, and 1 + tanh cancels where tanh is
near -1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_dense import cache_leaves, close_cache  # noqa: E402
from test_torch_models import (DTYPES, F32_ATOL, JRC, RC, carried,  # noqa: E402
                               close, tokens)

ARCH = "whisper-tiny"
REDUCED_F32_ATOL = 1e-4


def frames(B, Se, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, Se, d)).astype(
        np.float32)


def ref_enc_out(jcfg, jrc, params, e):
    """The reference's encoder output, as its decode test computes it."""
    B, Se = e.shape[:2]
    epos = jnp.broadcast_to(jnp.arange(Se, dtype=jnp.int32), (B, Se))
    eh, _ = JM._segment_forward(jcfg, jrc, "enc", jcfg.num_encoder_layers,
                                params["enc"]["params"], e, epos)
    return JL.rmsnorm(eh, params["enc_norm"], jcfg.norm_eps)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_gelu_matches_reference(dtype):
    """2^16 inputs from N(0, 16): bf16 outputs bit for bit
    (``F.gelu(approximate="tanh")`` differs in about 43% of them), float32
    within 4 · 2^-23 · |x|."""
    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(13).standard_normal(1 << 16) * 4
         ).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    want = np.asarray(jax.jit(jax.nn.gelu)(xj).astype(jnp.float32))
    got = TL.gelu(torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bf16":
        assert np.array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 4 * 2.0 ** -23 * np.abs(x)).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_enc_and_dec_blocks_match_reference(dtype):
    """The first encoder block on random frames, then the first decoder
    block on embedded tokens reading a random encoder output: outputs and
    the decoder's self-attention cache entry."""
    jcfg, tcfg, params, model = carried(dtype, ARCH)
    jdt, tdt = DTYPES[dtype]
    B, S, Se, d = 2, 12, tcfg.encoder_seq_len, tcfg.d_model
    e = frames(B, Se, d, seed=1)
    enc_out = frames(B, Se, d, seed=2)
    pos = np.broadcast_to(np.arange(Se, dtype=np.int32), (B, Se))
    pj = jax.tree.map(lambda t: t[0], params["enc"]["params"])
    yj, _ = JM.block_forward(jcfg, JRC, "enc", pj, jnp.asarray(e, jdt),
                             jnp.asarray(pos))
    yt, _ = TM.block_forward(tcfg, RC, "enc", model.enc[0],
                             torch.as_tensor(e).to(tdt), torch.as_tensor(pos))
    close(yt, yj, dtype)
    x = TM.embed_input(tcfg, model, {"tokens": torch.as_tensor(
        tokens(B, S, seed=3))})
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pj = jax.tree.map(lambda t: t[0], params["seg0"]["params"])
    yj, cj = JM.block_forward(jcfg, JRC, "dec", pj,
                              jnp.asarray(x.float().numpy(), jdt),
                              jnp.asarray(pos), enc_out=jnp.asarray(enc_out, jdt),
                              collect_cache=True)
    yt, ct = TM.block_forward(tcfg, RC, "dec", model.segments[0][0], x,
                              torch.as_tensor(pos),
                              torch.as_tensor(enc_out).to(tdt),
                              collect_cache=True)
    close(yt, yj, dtype)
    assert sorted(ct) == sorted(cj) == ["k", "v"]
    for name in ct:
        close(ct[name], cj[name], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backbone_prefill_and_decode_match_reference(dtype):
    """``encode``, ``backbone``, ``prefill`` (logits and the decoder's k/v
    cache) and 3 ``decode_step``s reading the encoder output."""
    jcfg, tcfg, params, model = carried(dtype, ARCH)
    jdt, tdt = DTYPES[dtype]
    B, S, EXTRA = 2, 16, 3
    toks = tokens(B, S + EXTRA, seed=4)
    e = frames(B, tcfg.encoder_seq_len, tcfg.d_model, seed=5)
    ej, et = jnp.asarray(e, jdt), torch.as_tensor(e).to(tdt)
    enc_j = ref_enc_out(jcfg, JRC, params, ej)
    enc_t = TM.encode(tcfg, RC, model, et)
    close(enc_t, enc_j, dtype)
    hj, _ = JM.backbone(jcfg, JRC, params, {"tokens": jnp.asarray(toks),
                                            "enc_embeds": ej})
    ht, _ = TM.backbone(tcfg, RC, model, {"tokens": torch.as_tensor(toks),
                                          "enc_embeds": et})
    assert ht.dtype == tdt
    close(ht, hj, dtype)
    lj, cj = JM.prefill(jcfg, JRC, params, {"tokens": jnp.asarray(toks[:, :S]),
                                            "enc_embeds": ej},
                        cache_len=S + EXTRA)
    lt, ct = TM.prefill(tcfg, RC, model, {"tokens": torch.as_tensor(toks[:, :S]),
                                          "enc_embeds": et},
                        cache_len=S + EXTRA)
    for t in range(EXTRA + 1):
        close(lt, lj, dtype)
        if dtype == "f32":
            assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) < \
                REDUCED_F32_ATOL
        close_cache(ct, cj, dtype)
        if t < EXTRA:
            tok = toks[:, S + t: S + t + 1]
            lj, cj = JM.decode_step(jcfg, JRC, params, cj,
                                    {"tokens": jnp.asarray(tok),
                                     "enc_out": enc_j})
            before = {k: v.clone() for k, v in cache_leaves(ct).items()}
            lt, nt = TM.decode_step(tcfg, RC, model, ct,
                                    {"tokens": torch.as_tensor(tok),
                                     "enc_out": enc_t})
            assert all(torch.equal(v, before[k])          # input unmodified
                       for k, v in cache_leaves(ct).items())
            ct = nt


def test_backbone_takes_the_encoder_output_in_place_of_frames():
    """``backbone`` given ``enc_out`` (what ``greedy_decode`` hands it, to
    run the encoder once) equals ``backbone`` given the frames."""
    _, tcfg, _, model = carried("f32", ARCH)
    toks = torch.as_tensor(tokens(2, 8, seed=6))
    e = torch.as_tensor(frames(2, tcfg.encoder_seq_len, tcfg.d_model, seed=7))
    h1, _ = TM.backbone(tcfg, RC, model, {"tokens": toks, "enc_embeds": e})
    h2, _ = TM.backbone(tcfg, RC, model, {"tokens": toks,
                                          "enc_out": TM.encode(tcfg, RC,
                                                               model, e)})
    assert torch.equal(h1, h2)


def test_decode_matches_full_forward():
    """The reference's test_decode_matches_full_forward[whisper-tiny], on
    the port: prefill 16 tokens, 3 decode steps reading the encoder
    output, against the full forward over 19."""
    _, tcfg, _, model = carried("f32", ARCH)
    B, S, EXTRA = 2, 16, 3
    toks = torch.as_tensor(tokens(B, S + EXTRA, seed=8))
    e = torch.as_tensor(frames(B, tcfg.encoder_seq_len, tcfg.d_model, seed=9))
    h, _ = TM.backbone(tcfg, RC, model, {"tokens": toks, "enc_embeds": e})
    want = TM.lm_head(tcfg, model, h[:, -1:])
    logits, cache = TM.prefill(tcfg, RC, model, {"tokens": toks[:, :S],
                                                 "enc_embeds": e},
                               cache_len=S + EXTRA)
    enc_out = TM.encode(tcfg, RC, model, e)
    for t in range(EXTRA):
        logits, cache, hid = TM.decode_step(
            tcfg, RC, model, cache, {"tokens": toks[:, S + t: S + t + 1],
                                     "enc_out": enc_out}, return_hidden=True)
    assert float((logits - want).abs().max()) < F32_ATOL
    assert float((hid - h[:, -1:]).abs().max()) < F32_ATOL


def test_greedy_tokens_equal_reference_model_api():
    """``serve.greedy_decode(..., enc_embeds=...)`` against greedy decoding
    through the reference's model API (its serve driver passes tokens
    only, so it cannot serve whisper): the same 6 tokens."""
    jcfg, tcfg, params, model = carried("f32", ARCH)
    B, S, steps = 2, 4, 6
    prompt = tokens(B, S, seed=10)
    e = frames(B, tcfg.encoder_seq_len, tcfg.d_model, seed=11)
    enc_j = ref_enc_out(jcfg, JRC, params, jnp.asarray(e))
    logits, cache = JM.prefill(jcfg, JRC, params,
                               {"tokens": jnp.asarray(prompt),
                                "enc_embeds": jnp.asarray(e)},
                               cache_len=S + steps)
    want = []
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = JM.decode_step(jcfg, JRC, params, cache,
                                       {"tokens": tok, "enc_out": enc_j})
    stats = {}
    got = tserve.greedy_decode(tcfg, RC, model, torch.as_tensor(prompt),
                               steps, stats=stats,
                               enc_embeds=torch.as_tensor(e))
    assert np.array_equal(got.numpy(), np.concatenate(want, axis=1))
    assert stats["encode_s"] > 0 and stats["prefill_s"] > 0
    assert stats["logits_finite"]


def test_make_frames_is_seeded_bf16_at_the_encoder_length():
    cfg = treg.get_config(ARCH)
    a = tserve.make_frames(cfg, 2, 0, torch.device("cpu"))
    assert a.shape == (2, 1500, 384) and a.dtype == torch.bfloat16
    assert torch.equal(a, tserve.make_frames(cfg, 2, 0, torch.device("cpu")))
    assert not torch.equal(a, tserve.make_frames(cfg, 2, 1,
                                                 torch.device("cpu")))


def test_full_width_float32_matches_reference():
    """whisper-tiny at its published width, 4 encoder and 4 decoder
    layers, 1500 frames, float32, batch 1: prefill of 4 tokens and 2
    decode steps within 1e-3, the attention blocks at ``RunConfig()``'s
    512 and 1024."""
    jcfg, tcfg = jreg.get_config(ARCH), treg.get_config(ARCH)
    jrc = jbase.RunConfig()
    rc = convert.run_config_from_reference(dataclasses.asdict(jrc))
    rng = np.random.default_rng(0)

    def draw(t):                          # N(0, 1/fan_in); ones kept
        if (np.asarray(t) == 1).all():
            return t.astype(jnp.float32)
        return jnp.asarray(rng.standard_normal(t.shape, np.float32)
                           * np.float32(t.shape[-2] ** -0.5))

    params = jax.tree.map(draw, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(tcfg, jax.tree.map(np.asarray,
                                                             params))
    B, S, EXTRA = 1, 4, 2
    toks = tokens(B, S + EXTRA, seed=12) * 200       # ids across the vocab
    e = frames(B, tcfg.encoder_seq_len, tcfg.d_model, seed=13)
    enc_j = ref_enc_out(jcfg, jrc, params, jnp.asarray(e))
    lj, cj = JM.prefill(jcfg, jrc, params, {"tokens": jnp.asarray(toks[:, :S]),
                                            "enc_embeds": jnp.asarray(e)},
                        cache_len=S + EXTRA)
    lt, ct = TM.prefill(tcfg, rc, model, {"tokens": torch.as_tensor(toks[:, :S]),
                                          "enc_embeds": torch.as_tensor(e)},
                        cache_len=S + EXTRA)
    enc_t = TM.encode(tcfg, rc, model, torch.as_tensor(e))
    close(enc_t, enc_j, "f32")
    for t in range(EXTRA + 1):
        close(lt, lj, "f32")
        if t < EXTRA:
            tok = toks[:, S + t: S + t + 1]
            lj, cj = JM.decode_step(jcfg, jrc, params, cj,
                                    {"tokens": jnp.asarray(tok),
                                     "enc_out": enc_j})
            lt, ct = TM.decode_step(tcfg, rc, model, ct,
                                    {"tokens": torch.as_tensor(tok),
                                     "enc_out": enc_t})


def test_ssm_dtype_bf16_rounds_as_the_reference():
    """``RunConfig.ssm_dtype="bf16"``: the port's ``mamba_mix`` lies at
    least 2x closer to the reference's bf16 a/b scan than the reference's
    own float32 scan does, in y and h_last, with S = 21 not a multiple of
    ``scan_chunk`` = 8 and a non-zero h0 (float32 parameters, so the a/b
    mode is the only difference).  Closeness is the RMS over all outputs:
    the port combines a chunk sequentially and the reference as a tree, so
    single outputs take a bf16 rounding one way or the other, and the
    largest single difference says which rounding, not which result the
    port tracks.  Each output also lies within the bf16 bound."""
    jcfg, tcfg, params, model = carried("f32", "falcon-mamba-7b")
    rng = np.random.default_rng(14)
    B, S = 2, 21
    x = (rng.standard_normal((B, S, tcfg.d_inner)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, tcfg.d_inner, tcfg.ssm_state)) * 0.5
          ).astype(np.float32)
    assert S % JRC.scan_chunk != 0
    jbf = dataclasses.replace(JRC, ssm_dtype="bf16")
    p = jax.tree.map(lambda t: t[0], params["seg0"]["params"]["mamba"])
    want = jmamba.mamba_mix(jcfg, jbf, p, jnp.asarray(x), jnp.asarray(h0))
    f32 = jmamba.mamba_mix(jcfg, JRC, p, jnp.asarray(x), jnp.asarray(h0))
    got = tmamba.mamba_mix(tcfg, dataclasses.replace(RC, ssm_dtype="bf16"),
                           model.segments[0][0].mamba, torch.as_tensor(x),
                           torch.as_tensor(h0))
    for g, w, f in zip(got, want, f32):
        close(g, w, "bf16")
        g, w, f = g.numpy(), np.asarray(w), np.asarray(f)
        port_rms = float(np.sqrt(((g - w) ** 2).mean()))
        f32_rms = float(np.sqrt(((f - w) ** 2).mean()))
        assert f32_rms > 0
        assert 2 * port_rms <= f32_rms, (port_rms, f32_rms)
