"""The port's training substrate against the reference's, on the CPU:
``optim/optimizers.py`` (the schedule, clipping, AdamW and SGD-momentum),
``optim/compress.py`` (with the reference's uniforms), ``data/loader.py``
(the reference's tokens bit for bit), ``data/synthetic.py``'s
``lm_batch`` and ``feature_probe_data`` (from the reference's draws), and
the train driver's cases of ``tests/test_system.py`` with ``--device cpu``.

Tolerance 1e-6 (relative for the learning rate, absolute for parameters
and moments of magnitude ~1): the same float32 operations, summed in
another order in the global norm.  Quantized gradients are integers and
must be bit-equal."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import loader as jloader  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import compress as tcomp  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ATOL = 1e-6
SHAPES = {"embed": (9, 6), "segments.0.0.attn.wq": (6, 4),
          "final_norm": (6,), "segments.0.0.mamba.A_log": (4, 3)}
OCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6)


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def to_torch(t):
    return {k: torch.tensor(v) for k, v in t.items()}


def close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= atol, err


def test_optimizer_config_matches_reference():
    assert (dataclasses.asdict(topt.OptimizerConfig())
            == dataclasses.asdict(jopt.OptimizerConfig()))


def test_lr_schedule_matches_reference():
    for kw in (OCFG, dict(learning_rate=3e-4, warmup_steps=100,
                          total_steps=10000)):
        jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
        steps = sorted({0, 1, 2, 3, kw["warmup_steps"], kw["total_steps"] // 2,
                        kw["total_steps"] - 1, kw["total_steps"],
                        2 * kw["total_steps"]})
        for s in steps:
            want = float(jopt.lr_at(jc, jnp.int32(s)))
            got = float(topt.lr_at(tc, torch.tensor(s, dtype=torch.int32)))
            assert abs(got - want) <= ATOL * want, (s, got, want)


@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = tree(1, scale)
    want, wnorm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    got, norm = topt.clip_by_global_norm(to_torch(g), 1.0)
    assert abs(float(norm) - float(wnorm)) <= ATOL * float(wnorm)
    assert abs(float(topt.global_norm(to_torch(g))) - float(wnorm)) <= (
        ATOL * float(wnorm))
    for k in g:
        close(got[k], want[k])


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_apply_updates_matches_reference_over_steps(name):
    jc = jopt.OptimizerConfig(name=name, **OCFG)
    tc = topt.OptimizerConfig(name=name, **OCFG)
    jp = jax.tree.map(jnp.asarray, tree(0))
    tp = to_torch(tree(0))
    js, ts = jopt.init_state(jc, jp), topt.init_state(tc, tp)
    for step in range(4):
        # large gradients are clipped, small ones not
        g = tree(10 + step, scale=(5.0 if step % 2 else 0.05))
        jp, js, jm = jopt.apply_updates(jc, jp, jax.tree.map(jnp.asarray, g),
                                        js)
        tp, ts, tm = topt.apply_updates(tc, tp, to_torch(g), ts)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= (
            ATOL * float(jm["lr"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            ATOL * float(jm["grad_norm"]))
        for k in SHAPES:
            close(tp[k], jp[k])
            for moment in (("mu", "nu") if name == "adamw" else ("mom",)):
                assert ts[moment][k].dtype == torch.float32
                close(ts[moment][k], js[moment][k])


def test_apply_updates_keeps_dtypes_and_takes_missing_grads_as_zero():
    tc = topt.OptimizerConfig(**OCFG)
    p = {"w": torch.ones((3, 2), dtype=torch.bfloat16),
         "b": torch.zeros(2, dtype=torch.float32)}
    s = topt.init_state(tc, p)
    assert s["mu"]["w"].dtype == torch.float32
    w = p["w"]
    p, s, m = topt.apply_updates(tc, p, {"w": torch.ones((3, 2)), "b": None},
                                 s)
    assert p["w"] is w and w.dtype == torch.bfloat16    # updated in place
    assert float(s["mu"]["b"].abs().max()) == 0.0
    assert float(m["grad_norm"]) == pytest.approx(6 ** 0.5)


def reference_uniforms(key, grads):
    """The uniforms ``repro/optim/compress.py::compress_tree`` draws: one
    key per leaf in the pytree's (sorted) leaf order."""
    leaves, treedef = jax.tree.flatten(grads)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [
        np.asarray(jax.random.uniform(k, g.shape))
        for k, g in zip(keys, leaves)])


@pytest.mark.parametrize("bits", [4, 8])
def test_compress_matches_reference_with_its_uniforms(bits):
    g = tree(3, scale=0.7)
    jg = jax.tree.map(jnp.asarray, g)
    key = jax.random.PRNGKey(bits)
    jq, js = jcomp.compress_tree(key, jg, bits)
    u = {k: torch.tensor(v) for k, v in reference_uniforms(key, jg).items()}
    tq, tsc = tcomp.compress_tree(to_torch(g), bits, u=u)
    for k in g:
        assert tq[k].dtype == torch.int32
        assert np.array_equal(tq[k].numpy(), np.asarray(jq[k])), k
        assert float(tsc[k]) == float(js[k])
    jd, td = jcomp.decompress_tree(jq, js), tcomp.decompress_tree(tq, tsc)
    for k in g:
        close(td[k], jd[k])
    # one leaf through quantize_grad / dequantize_grad directly
    kq = jax.random.PRNGKey(7)
    q, s = jcomp.quantize_grad(kq, jg["embed"], bits)
    q2, s2 = tcomp.quantize_grad(torch.tensor(g["embed"]), bits,
                                 u=torch.tensor(np.asarray(jax.random.uniform(
                                     kq, g["embed"].shape))))
    assert np.array_equal(q2.numpy(), np.asarray(q)) and float(s2) == float(s)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_edge_widths_within_one_level(bits):
    """``tests/test_compress.py``'s width edges, on the port with a
    generator: in range, within one level of the input, the scale
    max|g| / levels; the all-zero gradient comes back as exact zeros."""
    g = torch.tensor(tree(5)["embed"])
    q, scale = tcomp.quantize_grad(g, bits, gen=torch.Generator()
                                   .manual_seed(bits))
    levels = (1 << (bits - 1)) - 1
    assert q.dtype == torch.int32 and int(q.abs().max()) <= levels
    err = (tcomp.dequantize_grad(q, scale) - g).abs().max()
    assert float(err) <= float(scale) * (1 + 1e-6)
    assert float(scale) == pytest.approx(float(g.abs().max()) / levels,
                                         rel=1e-6)
    q0, s0 = tcomp.quantize_grad(torch.zeros((5, 3)), bits,
                                 gen=torch.Generator().manual_seed(0))
    assert np.isfinite(float(s0)) and int(q0.abs().max()) == 0
    assert float(tcomp.dequantize_grad(q0, s0).abs().max()) == 0.0


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizers_minimise_a_quadratic(name):
    """``tests/test_substrate.py``'s convergence cases on the port: AdamW
    (no weight decay) reaches the quadratic's minimum within 0.15 in 150
    steps, SGD-momentum brings 4 to within 0.2 of 0 in 100."""
    if name == "adamw":
        target = torch.tensor([1.0, -2.0, 3.0])
        cfg = topt.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                                   total_steps=200, weight_decay=0.0)
        p, steps = {"w": torch.zeros(3)}, 150
    else:
        target = torch.zeros(1)
        cfg = topt.OptimizerConfig(name="sgd", learning_rate=0.05,
                                   warmup_steps=0, momentum=0.9,
                                   grad_clip=100.0)
        p, steps = {"w": torch.tensor([4.0])}, 100
    state = topt.init_state(cfg, p)
    for _ in range(steps):
        p, state, _ = topt.apply_updates(cfg, p, {"w": p["w"] - target},
                                         state)
    assert float((p["w"] - target).abs().max()) < (0.15 if name == "adamw"
                                                   else 0.2)


def test_compress_with_a_generator_is_unbiased_and_in_range():
    g = torch.tensor(tree(4)["embed"])
    gen = torch.Generator().manual_seed(0)
    deq = torch.stack([tcomp.dequantize_grad(*tcomp.quantize_grad(g, 8,
                                                                  gen=gen))
                       for _ in range(400)])
    q, _ = tcomp.quantize_grad(g, 8, gen=gen)
    assert int(q.abs().max()) <= 127
    assert float((deq.mean(0) - g).abs().max()) < 0.01 * float(g.abs().max())


@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 4, 32, 256),
                                                  (3, 2, 17, 32001)])
def test_loader_tokens_bit_equal_to_reference(seed, batch, seq, vocab):
    with jloader.LMBatchLoader(None, batch, seq, vocab, seed=seed) as jl, \
            tloader.LMBatchLoader("cpu", batch, seq, vocab, seed=seed) as tl:
        for _ in range(4):
            want, got = next(jl), next(tl)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int64
                assert got[k].shape == (batch, seq)
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert not tl._thread.is_alive()


def test_loader_close_joins_and_is_idempotent():
    tl = tloader.LMBatchLoader("cpu", 2, 8, 50, prefetch=1,
                               dtype=torch.int32)
    assert next(tl)["tokens"].dtype == torch.int32
    tl.close()
    assert not tl._thread.is_alive()
    tl.close()


def test_lm_batch_from_reference_draws():
    key = jax.random.PRNGKey(5)
    want = jsyn.lm_batch(key, 3, 11, 97)
    toks = np.asarray(jax.random.randint(key, (3, 12), 0, 97,
                                         dtype=jnp.int32))
    got = tsyn.lm_batch(3, 11, 97, tokens=torch.tensor(toks))
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    drawn = tsyn.lm_batch(3, 11, 97, gen=torch.Generator().manual_seed(0))
    assert drawn["tokens"].shape == (3, 11) and drawn["tokens"].dtype == (
        torch.int32)
    assert torch.equal(drawn["tokens"][:, 1:], drawn["labels"][:, :-1])
    with pytest.raises(ValueError):
        tsyn.lm_batch(3, 10, 97, tokens=torch.tensor(toks))


def test_feature_probe_data_from_reference_draws():
    m, d = 300, 24
    key = jax.random.PRNGKey(2)
    wx, wy = jsyn.feature_probe_data(key, m, d)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = tuple(torch.tensor(np.asarray(a)) for a in (
        jax.random.normal(k1, (m, d)), jax.random.normal(k2, (d,)),
        jax.random.uniform(k3, (m,))))
    x, y = tsyn.feature_probe_data(m, d, draws=draws)
    close(x, wx)
    assert np.array_equal(y.numpy(), np.asarray(wy))
    x2, y2 = tsyn.feature_probe_data(m, d,
                                     gen=torch.Generator().manual_seed(1))
    assert x2.shape == (m, d) and float(x2.min()) >= 0 and float(x2.max()) <= 1
    assert set(y2.unique().tolist()) <= {0.0, 1.0}


def test_train_driver_reduced(tmp_path, capsys):
    rc = ttrain.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "8",
                      "--batch", "4", "--seq", "32", "--log-every", "100",
                      "--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 8 and summary["device"] == "cpu"
    assert summary["peak_gb"] is None and summary["tokens_per_s"] > 0
    assert all(np.isfinite(summary["losses"]))


def test_train_driver_resume(tmp_path, capsys):
    ttrain.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "6",
                 "--batch", "2", "--seq", "32", "--checkpoint-every", "3",
                 "--checkpoint-dir", str(tmp_path), "--log-every", "100",
                 "--device", "cpu"])
    rc = ttrain.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "3",
                      "--batch", "2", "--seq", "32", "--resume",
                      "--checkpoint-dir", str(tmp_path), "--log-every", "100",
                      "--device", "cpu"])
    assert rc == 0
    assert "resumed from step 6" in capsys.readouterr().out


def test_train_driver_hybrid_through_the_scan(tmp_path, capsys):
    rc = ttrain.main(["--arch", "hymba-1.5b", "--reduced", "--steps", "3",
                      "--batch", "2", "--seq", "24", "--log-every", "1",
                      "--checkpoint-dir", str(tmp_path), "--device", "cpu",
                      "--json-out", str(tmp_path / "t.json")])
    assert rc == 0
    summary = json.loads((tmp_path / "t.json").read_text())
    assert summary["steps"] == 3 and all(np.isfinite(summary["losses"]))


@pytest.mark.parametrize("argv,message", [
    (["--arch", "whisper-tiny", "--device", "cpu"], "frame embeddings"),
    # the production mesh needs a world of 256 ranks (the case keeps its
    # id, which named the queue item of the refusal it used to be)
    pytest.param(["--production-mesh", "--device", "cpu"],
                 "needs a world of 256 ranks", id="argv1-list 1b item 7"),
])
def test_train_driver_refusals_exit_2(argv, message, capsys):
    assert ttrain.main(["--reduced", *argv]) == 2
    assert message in capsys.readouterr().err


def test_train_driver_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    assert ttrain.main(["--reduced", "--steps", "1"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_train_driver_checkpoints_inside_the_checkout_by_default():
    """Two checkouts never share a default checkpoint directory: it is the
    git-ignored build/train_ckpt of the checkout the driver runs from."""
    root = Path(ttrain.__file__).resolve().parents[3]
    default = Path(ttrain.build_parser().parse_args([]).checkpoint_dir)
    assert default == root / "build" / "train_ckpt"
    assert "build/" in (root / ".gitignore").read_text().split()
