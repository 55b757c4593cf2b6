"""The port's configs and mamba model against the reference's, at the
reference's reduced falcon-mamba config (d 64, d_inner 128, 2 layers,
vocab 256) with the reference's parameters carried across by ``convert``.

Tolerances: float32 parameters at the reference tests' own 1e-3 (the same
float32 arithmetic summed in another order).  bfloat16 parameters at
32 · 2^-9 (6.25%) of the largest magnitude compared: bf16 rounds with a
relative error up to 2^-9, a value passes through up to about 32 bf16
roundings in sequence over two layers and three decode steps
(projections, conv, silu, gate, residual, norm), and XLA may keep float32
between fused elementwise steps where PyTorch rounds each one.

The reference's ``init_params`` seeds each leaf with Python's ``hash``,
which is salted per process; so the normal-initialised leaves are redrawn
here from a numpy seed, in the reference's dtypes and distributions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

JRC = jbase.RunConfig(q_block=16, kv_block=16, loss_chunk=16, scan_chunk=8)
RC = convert.run_config_from_reference(dataclasses.asdict(JRC))
ARCH = "falcon-mamba-7b"
F32_ATOL = 1e-3
BF16_REL = 32 * 2.0 ** -9
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                        torch.bfloat16)}


def close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = F32_ATOL if dtype == "f32" else BF16_REL * float(np.abs(want).max())
    assert err < tol, (err, tol)


def cfgs(arch=ARCH):
    return (jreg.reduced_config(jreg.get_config(arch)),
            treg.reduced_config(treg.get_config(arch)))


def carried(dtype, arch=ARCH):
    """Reference parameters of ``arch``'s reduced config in ``dtype`` (A_log
    and D stay float32 in bf16, as ``init_params`` makes them) and the
    port's model made from them."""
    jcfg, tcfg = cfgs(arch)
    rng = np.random.default_rng(0)

    def redraw(t):                        # N(0, 1/fan_in); ones/zeros kept
        a = np.asarray(t.astype(jnp.float32))
        if (a == a.flat[0]).all():
            return t
        std = t.shape[-2] ** -0.5         # fan_in (the layer axis is first)
        return jnp.asarray(rng.standard_normal(t.shape) * std, t.dtype)

    params = jax.tree.map(redraw, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if dtype == "f32":
        params = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    model = convert.params_from_reference(tcfg, jax.tree.map(np.asarray,
                                                             params))
    return jcfg, tcfg, params, model


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_configs_and_param_count_match_reference(arch):
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert (dataclasses.asdict(treg.reduced_config(t))
            == dataclasses.asdict(jreg.reduced_config(j)))
    for name, shape in jbase.SHAPES.items():
        assert (treg.applicable(t, tbase.SHAPES[name])
                == jreg.applicable(j, shape))
    assert dataclasses.asdict(tbase.RunConfig()) == dataclasses.asdict(
        jbase.RunConfig())


def test_falcon_mamba_full_size():
    cfg = treg.get_config(ARCH)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
            cfg.conv_width, cfg.vocab_size, cfg.num_layers) == (
        4096, 8192, 16, 256, 4, 65024, 64)
    assert cfg.param_count() == 7_272_140_800
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_rmsnorm_matches_reference():
    from repro.models import layers as jlayers
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    got = tlayers.rmsnorm(torch.as_tensor(x), torch.as_tensor(s), 1e-5)
    close(got, want, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_mix_matches_reference(dtype):
    jcfg, tcfg, params, model = carried(dtype)
    B, S = 2, 24
    x = (np.random.default_rng(1).standard_normal((B, S, tcfg.d_inner))
         * 0.5).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    p = jax.tree.map(lambda t: t[0], params["seg0"]["params"]["mamba"])
    y_j, h_j = jmamba.mamba_mix(jcfg, JRC, p, jnp.asarray(x, jdt))
    y_t, h_t = tmamba.mamba_mix(tcfg, RC, model.segments[0][0].mamba,
                                torch.as_tensor(x).to(tdt))
    assert y_t.dtype == tdt and h_t.dtype == torch.float32
    close(y_t, y_j, dtype)
    close(h_t, h_j, dtype)


def test_mamba_forward_and_decode_match_reference():
    jcfg, tcfg, params, model = carried("f32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, tcfg.conv_width - 1, tcfg.d_inner))
    ssm = rng.standard_normal((2, tcfg.d_inner, tcfg.ssm_state))
    p_j = jax.tree.map(lambda t: t[1], params["seg0"]["params"]["mamba"])
    p_t = model.segments[0][1].mamba
    close(tmamba.mamba_forward(tcfg, RC, p_t, torch.as_tensor(x)),
          jmamba.mamba_forward(jcfg, JRC, p_j, jnp.asarray(x)), "f32")
    cache = {"conv": conv.astype(np.float32), "ssm": ssm.astype(np.float32)}
    y_j, c_j = jmamba.mamba_decode(jcfg, p_j, jnp.asarray(x[:, :1]),
                                   {k: jnp.asarray(v) for k, v in cache.items()})
    y_t, c_t = tmamba.mamba_decode(tcfg, p_t, torch.as_tensor(x[:, :1]),
                                   {k: torch.as_tensor(v)
                                    for k, v in cache.items()})
    close(y_t, y_j, "f32")
    for k in ("conv", "ssm"):
        close(c_t[k], c_j[k], "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg, params, model = carried(dtype)
    B, S, EXTRA = 2, 16, 3
    toks = tokens(B, S + EXTRA)
    lj, cj = JM.prefill(jcfg, JRC, params, {"tokens": jnp.asarray(toks[:, :S])},
                        cache_len=S + EXTRA)
    lt, ct = TM.prefill(tcfg, RC, model, {"tokens": torch.as_tensor(toks[:, :S])},
                        cache_len=S + EXTRA)
    for t in range(EXTRA + 1):
        close(lt, lj, dtype)
        assert ct["index"] == int(cj["index"])
        for name in ("conv", "ssm"):
            assert ct["seg0"][name].dtype == {
                "conv": DTYPES[dtype][1], "ssm": torch.float32}[name]
            close(ct["seg0"][name], cj["seg0"][name], dtype)
        if t < EXTRA:
            tok = toks[:, S + t: S + t + 1]
            lj, cj = JM.decode_step(jcfg, JRC, params, cj,
                                    {"tokens": jnp.asarray(tok)})
            lt, ct = TM.decode_step(tcfg, RC, model, ct,
                                    {"tokens": torch.as_tensor(tok)})


def test_decode_matches_full_forward():
    """The port's own decode parity (tests/test_models.py's
    test_decode_matches_full_forward for falcon-mamba)."""
    _, tcfg, _, model = carried("f32")
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


def test_short_prompt_conv_cache_is_zero_padded():
    """A prompt shorter than the conv window decodes like the full forward:
    the conv cache holds zeros before the sequence start."""
    _, tcfg, _, model = carried("f32")
    toks = torch.as_tensor(tokens(1, 4, seed=9))
    h, _ = TM.backbone(tcfg, RC, model, {"tokens": toks})
    logits, cache = TM.prefill(tcfg, RC, model, {"tokens": toks[:, :1]},
                               cache_len=4)
    for t in range(1, 4):
        logits, cache = TM.decode_step(tcfg, RC, model, cache,
                                       {"tokens": toks[:, t: t + 1]})
    want = TM.lm_head(tcfg, model, h[:, -1:])
    assert float((logits - want).abs().max()) < F32_ATOL


def test_params_from_reference_unstacks_and_keeps_dtypes():
    _, tcfg, params, model = carried("bf16")
    assert model.embed.dtype == torch.bfloat16
    blk = model.segments[0][1]
    assert blk.mamba["A_log"].dtype == torch.float32
    assert blk.mamba["in_proj"].dtype == torch.bfloat16
    want = np.asarray(params["seg0"]["params"]["mamba"]["in_proj"][1]
                      .astype(jnp.float32))
    assert np.array_equal(blk.mamba["in_proj"].float().numpy(), want)
    assert not any(p.requires_grad for p in model.parameters())
    # The reference's analytic count leaves out conv_b (d_inner per layer).
    n = sum(p.numel() for p in model.parameters())
    assert n == tcfg.param_count() + tcfg.num_layers * tcfg.d_inner


def test_init_is_deterministic_per_seed_with_reference_distributions():
    cfg = treg.reduced_config(treg.get_config(ARCH))
    a, b = (TM.Model(cfg, device="cpu", seed=3),
            TM.Model(cfg, device="cpu", seed=3))
    c = TM.Model(cfg, device="cpu", seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert a.embed.dtype == torch.bfloat16
    assert a.segments[0][0].mamba["D"].dtype == torch.float32
    mm = a.segments[0][0].mamba
    assert torch.equal(mm["A_log"], torch.ones_like(mm["A_log"]))
    assert torch.equal(mm["conv_b"], torch.zeros_like(mm["conv_b"]))
    std = float(a.lm_head.float().std())        # fan_in = d_model = 64
    assert abs(std - 64 ** -0.5) < 0.01


def test_unported_kinds_and_options_raise():
    """What was refused now runs: whisper's model and decode cache build,
    and ``ssm_dtype="bf16"`` runs the scan's bf16 a/b mode (close to the
    float32 scan, not equal to it); an unknown ``ssm_dtype`` raises."""
    cfg = treg.reduced_config(treg.get_config("whisper-tiny"))
    model = TM.Model(cfg, device="cpu")
    assert len(model.enc) == cfg.num_encoder_layers
    assert "k" in TM.init_cache(cfg, RC, 1, 8, device="cpu")["seg0"]
    _, tcfg, _, model = carried("f32")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (1, 12, tcfg.d_inner)).astype(np.float32))
    p = model.segments[0][0].mamba
    y32, h32 = tmamba.mamba_mix(tcfg, RC, p, x)
    y16, h16 = tmamba.mamba_mix(tcfg, dataclasses.replace(RC, ssm_dtype="bf16"),
                                p, x)
    assert not torch.equal(y16, y32)
    close(y16, y32.numpy(), "bf16")
    close(h16, h32.numpy(), "bf16")
    with pytest.raises(ValueError, match="ssm_dtype"):
        tmamba.mamba_mix(tcfg, dataclasses.replace(RC, ssm_dtype="fp8"), p, x)