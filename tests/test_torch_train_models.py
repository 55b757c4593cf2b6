"""The port's training loss and gradients against the reference's, on the
CPU: ``models/model.py::loss_fn`` (backbone, block remat, the chunked
loss) and every gradient leaf against ``jax.value_and_grad`` of
``repro/models/model.py::loss_fn``, for the reduced configs of the dense,
hybrid, mamba, MoE and encoder-decoder families, in float32, from the
same parameters (``convert.params_from_reference``) and the same batch;
then three AdamW steps of the port's ``train_step_fn`` against the
reference's jitted one on the same loader batches.

Tolerances.  Loss within 1e-5 relative: the same float32 function summed
in another order.  Each gradient leaf within 1e-4 of that leaf's largest
|g|: float32 summation order again, and on the mamba layers the port's
sequential scan (and its explicit reverse recurrence) against the
reference's chunked associative scan, which multiply the decays in
another order.  Over the three steps: losses within 1e-4 relative; the
float32 moments, which follow the gradients smoothly, each leaf's mu within
1e-4 of its largest |mu| and nu (a square) within 2e-4 of its largest
|nu|; and the parameters within 1e-5 but for at most 1 in 10^4 elements,
every one within 2 lr a step taken.  AdamW's normalised update m/√v is
about ±1 an element whatever the gradient's size (exactly ±1 at the first
step), so where a gradient element is near 0 the two runs' float noise can
give it opposite signs, and that element moves up to 2 lr apart that
step: only the moments and the share of elements that agree hold the
trajectory."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import loader as jloader  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from test_torch_models import JRC, RC, carried  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
PARAM_OUTLIERS = 1e-4   # share of elements allowed beyond PARAM_ATOL
ARCHS = ["tinyllama-1.1b", "hymba-1.5b", "falcon-mamba-7b",
         "phi3.5-moe-42b-a6.6b", "whisper-tiny"]
B, S = 2, 24   # S not a multiple of the loss chunk (16): padded with -1


def batch_for(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                     # masked labels count for nothing
    b = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return b


def reference_grads(jcfg, tcfg, params, batch):
    loss, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, JRC, p, {k: jnp.asarray(v)
                                            for k, v in batch.items()}))(
        params)
    # the gradient pytree has the parameters' structure: carried across
    # as a model, it names each leaf as the port does
    g = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, grads))
    return float(loss), dict(g.named_parameters())


def port_grads(tcfg, rc, model, batch):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss = TM.loss_fn(tcfg, rc, model, {k: torch.as_tensor(v)
                                        for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: p.grad
                                  for k, p in model.named_parameters()}


def check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g is not None and g.shape == w.shape and g.dtype == w.dtype, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg, params, model = carried("f32", arch)
    batch = batch_for(tcfg)
    jloss, jg = reference_grads(jcfg, tcfg, params, batch)
    tloss, tg = port_grads(tcfg, RC, model, batch)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    check_grads(tg, jg)


# The scan's bf16 a/b mode (RunConfig(ssm_dtype="bf16")): the port's CPU
# gradient is the plain backward of that mode (what the backward kernel
# computes), the reference's jax.grad through its bf16 tree combines with
# its cotangents rounded to bf16.  The two round a_t, b_t, A_c and B_c in
# other places, so each leaf is held by its RMS: within AB16_GRAD_RMS of
# the reference leaf's RMS (falcon-mamba's first layer comes nearest), and
# the loss within AB16_LOSS_RTOL.
AB16_GRAD_RMS = 3e-2
AB16_LOSS_RTOL = 2e-3


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_ab16_loss_and_every_gradient_track_the_reference(arch):
    """scan_chunk 8 at S = 24: three chunks a sequence; float32 parameters,
    so the a/b mode is the only rounding to bf16."""
    jcfg, tcfg, params, model = carried("f32", arch)
    batch = batch_for(tcfg)
    jrc = dataclasses.replace(JRC, ssm_dtype="bf16")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, jrc, p, {k: jnp.asarray(v)
                                            for k, v in batch.items()})))(
        params)
    want = dict(convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, jgrads)).named_parameters())
    tloss, got = port_grads(tcfg, dataclasses.replace(RC, ssm_dtype="bf16"),
                            model, batch)
    assert abs(tloss - float(jloss)) <= AB16_LOSS_RTOL * abs(float(jloss))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().double()
        w = w.detach().double()
        rms = float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        assert rms <= AB16_GRAD_RMS, (k, rms)


def test_remat_and_loss_chunk_change_nothing():
    """Block remat recomputes the same forward, and the chunked loss is the
    full softmax cross-entropy: the port's gradients with remat="none" and
    one loss chunk equal those with remat="block" and chunks of 16."""
    _, tcfg, _, model = carried("f32", "hymba-1.5b")
    batch = batch_for(tcfg, seed=1)
    l1, g1 = port_grads(tcfg, RC, model, batch)
    rc = dataclasses.replace(RC, remat="none", loss_chunk=S)
    l2, g2 = port_grads(tcfg, rc, model, batch)
    assert l1 == pytest.approx(l2, rel=1e-6)
    for k in g1:
        assert torch.allclose(g1[k], g2[k], rtol=0, atol=1e-6), k


def test_chunked_loss_is_the_mean_over_valid_labels():
    _, tcfg, _, model = carried("f32", "tinyllama-1.1b")
    h = torch.randn((B, S, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    labels = torch.as_tensor(batch_for(tcfg)["labels"]).long()
    with torch.no_grad():
        got = TM.chunked_loss(tcfg, RC, model, h, labels)
        logits = TM.lm_head(tcfg, model, h).float()
        valid = labels >= 0
        want = torch.nn.functional.cross_entropy(logits[valid], labels[valid])
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_three_adamw_steps_track_the_reference(arch):
    jcfg, tcfg, params, model = carried("f32", arch)
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
    jo, to = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstep = jax.jit(jtrain.train_step_fn(jcfg, JRC, jo))
    tstep = ttrain.train_step_fn(tcfg, RC, to, model)
    model.requires_grad_(True)
    tp = dict(model.named_parameters())
    js, ts = jopt.init_state(jo, params), topt.init_state(to, tp)
    jp = params
    with jloader.LMBatchLoader(None, B, S, tcfg.vocab_size) as jl, \
            tloader.LMBatchLoader("cpu", B, S, tcfg.vocab_size) as tl:
        for step in range(1, 4):
            jp, js, jm = jstep(jp, js, next(jl))
            tp, ts, tm = tstep(tp, ts, next(tl))
            jl_, tl_ = float(jm["loss"]), float(tm["loss"])
            assert abs(tl_ - jl_) <= STEP_LOSS_RTOL * abs(jl_), (step, tl_,
                                                                 jl_)
            want = as_port(tcfg, jp)
            bound = 2 * kw["learning_rate"] * step
            outliers = total = 0
            for k, p in tp.items():
                diff = (p.detach() - want[k]).abs()
                assert float(diff.max()) <= bound, (step, k, bound)
                outliers += int((diff > PARAM_ATOL).sum())
                total += diff.numel()
            assert outliers <= PARAM_OUTLIERS * total, (step, outliers, total)
            for name, rel in (("mu", GRAD_REL), ("nu", 2 * GRAD_REL)):
                ref_m = as_port(tcfg, js[name])
                for k, m in ts[name].items():
                    assert m.dtype == torch.float32, (name, k)
                    err = float((m - ref_m[k]).abs().max())
                    scale = float(ref_m[k].abs().max())
                    assert err <= rel * scale, (step, name, k, err, scale)


def as_port(tcfg, tree):
    """A reference parameter-shaped pytree as the port's named leaves."""
    return dict(convert.params_from_reference(
        tcfg, jax.tree.map(np.asarray, tree)).named_parameters())


def test_attention_gradient_is_finite_where_a_window_row_starts_masked():
    """A sliding-window row whose first live kv tile is wholly masked (row
    63 at window 32, kv tiles of 32: keys 32..63 are in its window, tile 0
    holds 0..31) leaves the online softmax's running max at -inf.  The
    reference zeroes exp(-inf - -inf) with a where, whose gradient is nan
    (so its training gradients are nan at such shapes, hymba's full-width
    training shape among them); the port subtracts 0 there instead.  Its
    output and gradients equal a dense masked softmax's within 1e-5."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    B, S, H, KH, D, W = 1, 64, 4, 2, 16, 32
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kw = dict(window=W, q_block=16, kv_block=32)
    jg = jax.grad(lambda *a: (jlayers.blockwise_attention(*a, **kw)
                              * dout).sum(), argnums=(0, 1, 2))(q, k, v)
    assert np.isnan(np.asarray(jg[0])).any()      # the reference's dq
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tlayers.blockwise_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))
    nq, nk, nv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    rep = H // KH
    s = torch.einsum("bqhd,bkhd->bhqk", nq * D ** -0.5,
                     nk.repeat_interleave(rep, 2))
    pos = torch.arange(S)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    p = torch.softmax(s.masked_fill(~live, -torch.inf), -1)
    want_out = torch.einsum("bhqk,bkhd->bqhd", p, nv.repeat_interleave(rep, 2))
    want = torch.autograd.grad(want_out, (nq, nk, nv), torch.tensor(dout))
    assert torch.allclose(out, want_out, rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.allclose(g, w, rtol=0, atol=1e-5)
