"""The port's MoE layer against the reference's ``repro/models/moe.py`` on
the same numpy inputs, at the reduced phi3.5-moe and arctic configs (d 64,
4 experts of 64, top-2; arctic with its dense residual of 64).

Tolerances are ``tests/test_torch_models.py``'s: float32 within 1e-3 (the
same float32 products summed in another order), bfloat16 within 32 · 2^-9
of the largest magnitude compared.  Routing is compared exactly: a token
sent to another expert, or dropped where the reference keeps it, moves
its output by the size of an expert's output, far past either bound, and
the gating indices themselves are held equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from test_torch_models import close  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def cfgs(arch, **kw):
    j = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)), **kw)
    t = dataclasses.replace(treg.reduced_config(treg.get_config(arch)), **kw)
    return j, t


def run_configs(**kw):
    j = dataclasses.replace(jbase.RunConfig(), **kw)
    return j, convert.run_config_from_reference(dataclasses.asdict(j))


def params(jcfg, dtype, seed=0, scale=None, router=None):
    """The template's leaves drawn N(0, 1/fan_in) from a numpy seed (or all
    ``scale``), in the template's dtypes (the router float32) or all float32
    for ``dtype="f32"``; ``router`` overrides the router's value.  Returns
    (reference dict of jax arrays, port dict of tensors)."""
    rng = np.random.default_rng(seed)
    jdt, _ = DTYPES[dtype]
    pj, pt = {}, {}
    for name, spec in JMOE.moe_template(jcfg).items():
        if scale is not None:
            a = np.full(spec.shape, scale, np.float32)
        else:
            a = rng.standard_normal(spec.shape) * spec.shape[-2] ** -0.5
        if name == "router" and router is not None:
            a = np.full(spec.shape, router, np.float32)
        leaf_dt = jnp.float32 if dtype == "f32" else spec.dtype
        pj[name] = jnp.asarray(a, leaf_dt)
        pt[name] = convert._tensor(np.asarray(pj[name]), "cpu")
    return pj, pt


def inputs(shape, dtype, seed=1, scale=1.0):
    jdt, _ = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    * scale, jdt)
    return x, convert._tensor(np.asarray(x), "cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_template_matches_reference(arch, dtype):
    jcfg, tcfg = cfgs(arch)
    jt, tt = JMOE.moe_template(jcfg), TMOE.moe_template(tcfg)
    assert list(tt) == list(jt)
    assert ("res_w1" in tt) == (arch == "arctic-480b")
    for name, spec in jt.items():
        assert tt[name].shape == spec.shape
        assert tt[name].logical == spec.logical
        assert str(tt[name].dtype).split(".")[-1] == np.dtype(spec.dtype).name
    assert tt["router"].dtype == torch.float32
    # carried across, the leaves keep the reference's dtypes
    pj, pt = params(jcfg, dtype)
    for name in jt:
        assert np.array_equal(pt[name].float().numpy(),
                              np.asarray(pj[name].astype(jnp.float32)))
        assert str(pt[name].dtype).split(".")[-1] == pj[name].dtype.name


def gating_logits():
    """Random rows, all-tied rows, and rows where 2-3 of the top values
    tie (the tie on the k-th place decides which expert is chosen)."""
    rng = np.random.default_rng(4)
    rand = rng.standard_normal((6, 16)).astype(np.float32)
    tied = np.zeros((3, 16), np.float32)
    part = rng.standard_normal((4, 16)).astype(np.float32) - 3
    part[0, [3, 9]] = 1.0
    part[1, [2, 7, 11]] = 1.0
    part[2, [5]], part[2, [1, 14]] = 2.0, 1.0
    part[3, [0, 15]] = 0.5
    return np.concatenate([rand, tied, part]).reshape(13, 16)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_gating_matches_reference_ties_included(k):
    jcfg, tcfg = cfgs("phi3.5-moe-42b-a6.6b", num_experts=16,
                      experts_per_token=k)
    logits = gating_logits()
    wj, ij = JMOE._top_k_gating(jcfg, jnp.asarray(logits))
    wt, it = TMOE._top_k_gating(tcfg, torch.as_tensor(logits))
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert wt.dtype == torch.float32
    close(wt, wj, "f32")
    # all-tied rows go to the lowest indices, as jax.lax.top_k sends them
    assert (it[6:9].numpy() == np.arange(k)).all()


# (moe_impl, capacity_factor, moe_group_size, moe_combine_dtype); the sort
# path has no groups and no combine dtype
CASES = ([("einsum", cf, gs, cd) for cf in (8.0, 1.25, 0.25)
          for gs in (0, 8) for cd in ("f32", "bf16")]
         + [("sort", cf, 0, "f32") for cf in (8.0, 1.25, 0.25)])


@pytest.mark.parametrize("impl,cf,group,combine", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, dtype, impl, cf, group, combine):
    """Both dispatch paths, with drops at capacity factors 1.25 and 0.25
    (C = 4 of the 2·24·2/4 = 24 choices an expert gets on average) and
    none at 8.0; groups of 8 tokens split the 2 x 24 batch into 6."""
    jcfg, tcfg = cfgs(arch, capacity_factor=cf)
    jrc, trc = run_configs(moe_impl=impl, moe_group_size=group,
                           moe_combine_dtype=combine)
    pj, pt = params(jcfg, dtype)
    xj, xt = inputs((2, 24, jcfg.d_model), dtype)
    want = JMOE.moe_forward(jcfg, jrc, pj, xj)
    got = TMOE.moe_forward(tcfg, trc, pt, xt)
    assert got.dtype == xt.dtype
    close(got, want, dtype)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_tied_router_routes_as_reference(arch, impl):
    """A constant router ties every logit: every token goes to experts 0
    and 1, and with C = 4 of 32 the same four tokens are kept; the experts
    differ, so routing to any other pair shows in the output."""
    jcfg, tcfg = cfgs(arch, capacity_factor=0.25)
    jrc, trc = run_configs(moe_impl=impl)
    pj, pt = params(jcfg, "f32", router=0.05)
    xj, xt = inputs((1, 32, jcfg.d_model), "f32", seed=2)
    want = np.asarray(JMOE.moe_forward(jcfg, jrc, pj, xj))
    got = TMOE.moe_forward(tcfg, trc, pt, xt).numpy()
    close(got, want, "f32")
    res = TMOE._dense_residual(pt, xt).numpy() if jcfg.dense_residual_d_ff else 0
    kept = np.abs((got - res)[0]).max(-1) > 0
    assert kept.tolist() == [True] * 4 + [False] * 28


def test_moe_sort_equals_einsum_no_drops():
    """tests/test_models.py's case on the port: at capacity factor 8 no
    token is dropped, so both dispatch paths compute the same sum."""
    jcfg, tcfg = cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=8.0)
    _, pt = params(jcfg, "f32", seed=5)
    pt = {k: v * 0.2 * v.shape[-2] ** 0.5 for k, v in pt.items()}
    _, xt = inputs((2, 16, tcfg.d_model), "f32", seed=6, scale=0.5)
    _, rce = run_configs(moe_impl="einsum")
    _, rcs = run_configs(moe_impl="sort")
    ye = TMOE.moe_forward(tcfg, rce, pt, xt)
    ys = TMOE.moe_forward(tcfg, rcs, pt, xt)
    err = float((ye - ys).abs().max() / (ye.abs().max() + 1e-9))
    assert err < 2e-2, err


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_capacity_drops_tokens(impl):
    """tests/test_models.py's case on the port, held against the reference:
    every parameter 0.05, so every router logit ties; capacity factor 0.25
    drops all but 4 tokens an expert; the output is finite and equal to
    the reference's, dropped tokens included."""
    jcfg, tcfg = cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=0.25)
    jrc, trc = run_configs(moe_impl=impl)
    pj, pt = params(jcfg, "f32", scale=0.05)
    xj, xt = inputs((1, 32, jcfg.d_model), "f32", seed=7)
    want = np.asarray(JMOE.moe_forward(jcfg, jrc, pj, xj))
    got = TMOE.moe_forward(tcfg, trc, pt, xt)
    assert torch.isfinite(got).all()
    close(got, want, "f32")
    dropped = np.abs(got.numpy()[0]).max(-1) == 0
    assert dropped.tolist() == (np.abs(want[0]).max(-1) == 0).tolist()
    assert dropped.sum() == 28


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_shape_matches_reference(arch):
    """At decode (one token a row, g = 1) C = min(4, 1) = 1: each token
    keeps both its experts."""
    jcfg, tcfg = cfgs(arch)
    jrc, trc = run_configs()
    pj, pt = params(jcfg, "bf16", seed=8)
    xj, xt = inputs((4, 1, jcfg.d_model), "bf16", seed=9)
    close(TMOE.moe_forward(tcfg, trc, pt, xt),
          JMOE.moe_forward(jcfg, jrc, pj, xj), "bf16")
