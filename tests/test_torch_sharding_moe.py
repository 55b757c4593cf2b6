"""The MoE and encoder-decoder blocks over a mesh of ranks on the CPU:
``models/moe.py``'s ``local_map`` body (both dispatch paths, arctic's dense
residual, experts over ``model`` or replicated), whisper's encoder and
decoder blocks (frames placed as the tokens, cross-attention by heads,
the context-parallel branch where 6 heads do not divide the model axis)
and the train driver over ranks for an MoE arch, against the reference
and the one-process port.

One group of 4 gloo ranks (``torch_moe_ranks.moe_rank``) runs every
sharded case once, on meshes (1, 4), (2, 2) and (4, 1) of its world; the
tests read what its ranks returned.

Tolerances are ``test_torch_sharding.py``'s: the sharded train steps'
losses within 1e-4 relative and parameters within 1e-5 but for 1 element
in 10^4, each within 2 lr a step, of the reference's; the moments within
1e-4 (mu) and 2e-4 (nu) of each leaf's largest of the one-process port's
from the same parameters and batches.  The gradient cases (token drops,
groups across ranks, replicated experts) hold the loss to 1e-5 relative,
the backbone output to 1e-5 of its largest and every gradient leaf to
1e-4 of its largest of the one-process port's and of ``jax.value_and_grad``
of the reference's loss from the same parameters and batch
(``test_torch_train_models.py``'s, float32 sums in another order).  Routing is exact: every rank's
expert indices and kept mask equal the reference's on its logits."""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_moe_ranks as ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.parallel import rules as trules  # noqa: E402
from test_torch_models import JRC, RC  # noqa: E402
from test_torch_sharding import (OPT, DuckMesh,  # noqa: E402
                                 reference_params)
from test_torch_train_models import (GRAD_REL, LOSS_RTOL,  # noqa: E402
                                     PARAM_ATOL, PARAM_OUTLIERS,
                                     STEP_LOSS_RTOL, as_port)
from torch_lm_ranks import MESHES, float32_run_config  # noqa: E402

WORLD = 4
MOE, ARCTIC, WHISPER = "phi3.5-moe-42b-a6.6b", "arctic-480b", "whisper-tiny"
TRAIN_CASES = [(MOE, "2x2"), (MOE, "1x4"), (ARCTIC, "2x2"), (WHISPER, "2x2"),
               (WHISPER, "1x4")]
B, S, STEPS = 2, 24, 2
# at capacity factor 0.25 every expert takes C = 6 of a group's 48
# (token, choice) pairs: tokens drop; a group of 48 tokens is both data
# ranks' rows on (2, 2)
DROP_CF = 0.25
GRAD_CASES = {
    "sort": dict(arch=MOE, mesh="2x2", rc=dict(moe_impl="sort"),
                 cfg=dict(capacity_factor=DROP_CF)),
    "group_across_ranks": dict(arch=MOE, mesh="2x2",
                               rc=dict(moe_group_size=B * S),
                               cfg=dict(capacity_factor=DROP_CF)),
    "experts_replicated": dict(arch=MOE, mesh="2x2", rc={},
                               cfg=dict(num_experts=3)),
    "einsum_2x2": dict(arch=MOE, mesh="2x2", rc={}, cfg={}),
    "einsum_1x4": dict(arch=MOE, mesh="1x4", rc={}, cfg={}),
    "arctic_sort_1x4": dict(arch=ARCTIC, mesh="1x4",
                            rc=dict(moe_impl="sort"),
                            cfg=dict(capacity_factor=DROP_CF)),
}
GRAD_SEED = 5
DRIVER = ["--arch", MOE, "--reduced", "--steps", "3", "--batch", "4",
          "--seq", "32", "--device", "cpu", "--log-every", "1"]


def jax_config(arch):
    cfg = jreg.reduced_config(jreg.get_config(arch))
    if arch == WHISPER:
        cfg = dataclasses.replace(cfg, **ranks.WHISPER)
    return cfg


def frames(cfg):
    """Each step's stub frame embeddings (B, Se, d), from a numpy seed."""
    rng = np.random.default_rng(11)
    return [rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))
            .astype(np.float32) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group's results, and the reference's and the one-process
    port's steps beside them."""
    tmp = tmp_path_factory.mktemp("sharding_moe")
    archs = sorted({a for a, _ in TRAIN_CASES})
    params = {a: reference_params(jax_config(a)) for a in archs}
    job = {
        "rules": archs,
        "train": dict(params={a: jax.tree.map(np.asarray, p)
                              for a, p in params.items()},
                      cases=TRAIN_CASES, B=B, S=S, steps=STEPS, opt=OPT,
                      rc=dataclasses.asdict(JRC),
                      frames=frames(ranks.config(WHISPER))),
        "grads": dict(cases=GRAD_CASES, B=B, S=S, seed=GRAD_SEED),
        "driver": dict(argv=DRIVER, dir=str(tmp / "driver_ckpt"),
                       json=str(tmp / "driver.json")),
    }
    box: dict = {}

    def ranks_run():
        try:
            box["run"] = tmesh.run_ranks(ranks.moe_rank, WORLD, (job,),
                                         device="cpu", timeout=600)
        except BaseException as e:
            box["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    try:
        want = {a: list(zip(reference_steps(a, p),
                            port_steps(a, job["train"]["params"][a])))
                for a, p in params.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["run"], want, tmp


def _batches(jl, cfg):
    for f in frames(cfg):
        b = next(jl)
        if cfg.is_encoder_decoder:
            b = {**b, "enc_embeds": f}
        yield b


def reference_steps(arch, params):
    """STEPS of the reference's jitted AdamW step from ``params`` on its
    loader's batches (and the frames for whisper)."""
    jcfg = jax_config(arch)
    jo = jopt.OptimizerConfig(**OPT)
    jstep = jax.jit(jtrain.train_step_fn(jcfg, JRC, jo))
    js = jopt.init_state(jo, params)
    out = []
    with jloader.LMBatchLoader(None, B, S, jcfg.vocab_size) as jl:
        for batch in _batches(jl, jcfg):
            params, js, m = jstep(params, js, batch)
            out.append((float(m["loss"]), params))
    return out


def port_steps(arch, tree):
    """STEPS of the one-process port's ``train_step_fn`` from the same
    parameters and batches: each step's float32 moments."""
    tcfg = ranks.config(arch)
    model = convert.params_from_reference(tcfg, tree)
    model.requires_grad_(True)
    to = topt.OptimizerConfig(**OPT)
    step = ttrain.train_step_fn(tcfg, RC, to, model)
    tp = dict(model.named_parameters())
    ts = topt.init_state(to, tp)
    out = []
    with tloader.LMBatchLoader("cpu", B, S, tcfg.vocab_size) as tl:
        for batch in _batches(tl, tcfg):
            if "enc_embeds" in batch:
                batch["enc_embeds"] = torch.from_numpy(batch["enc_embeds"])
            tp, ts, _ = step(tp, ts, batch)
            out.append({n: {k: m.clone() for k, m in ts[n].items()}
                        for n in ("mu", "nu")})
    return out


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_sharded_train_steps_track_the_reference(group, arch, mesh):
    run, want, _ = group
    steps = run.results[0]["train"][(arch, mesh)]
    tcfg = ranks.config(arch)
    for step, (got, ((jl, jp), port)) in enumerate(zip(steps, want[arch]),
                                                   1):
        assert abs(got["loss"] - jl) <= STEP_LOSS_RTOL * abs(jl), (step,
                                                                   got, jl)
        ref = as_port(tcfg, jp)
        bound = 2 * OPT["learning_rate"] * step
        outliers = total = 0
        for k, p in got["params"].items():
            diff = np.abs(p - ref[k].numpy())
            assert float(diff.max()) <= bound, (step, k)
            outliers += int((diff > PARAM_ATOL).sum())
            total += diff.size
        assert outliers <= PARAM_OUTLIERS * total, (step, outliers, total)
        for name, rel in (("mu", GRAD_REL), ("nu", 2 * GRAD_REL)):
            for k, m in got["moments"][name].items():
                ref_m = port[name][k].numpy()
                err = float(np.abs(m - ref_m).max())
                assert err <= rel * float(np.abs(ref_m).max()), (step, name,
                                                                 k)
        # every rank holds the same full parameters, bit for bit
        assert len({r["train"][(arch, mesh)][step - 1]["sha"]
                    for r in run.results}) == 1


@pytest.mark.parametrize("arch,mesh", TRAIN_CASES)
def test_sharded_parameters_are_placed_by_the_rules(group, arch, mesh):
    run, _, _ = group
    d, m = MESHES[mesh]
    duck = DuckMesh({"data": d, "model": m})
    leaves = TM.param_leaves(ranks.config(arch))
    for r in run.results:
        got = r["train"][(arch, mesh)][-1]["placements"]
        assert got == {k: [repr(p) for p in trules.sharding_for(duck, leaf)]
                       for k, leaf in leaves.items()}


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_whisper_takes_the_context_parallel_branch_where_heads_do_not_divide(
        group, mesh):
    """6 heads over a model axis of 4: every encoder (non-causal) and
    decoder (causal) block's self-attention is sequence-sharded, twice a
    step under block remat; cross-attention never is.  Over 2 they divide
    and no block takes the branch."""
    run, _, _ = group
    cfg = ranks.config(WHISPER)
    blocks = cfg.num_encoder_layers + cfg.num_layers
    per_step = 2 * blocks if cfg.num_heads % MESHES[mesh][1] else 0
    for r in run.results:
        got = [s["cp_calls"] for s in r["train"][(WHISPER, mesh)]]
        assert got == [per_step * i for i in range(1, STEPS + 1)]


def test_arctic_dense_residual_and_experts_share_the_model_axis(group):
    run, _, _ = group
    pl = run.results[0]["train"][(ARCTIC, "2x2")][-1]["placements"]
    layer = "segments.0.0.moe."
    assert pl[layer + "w1"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert pl[layer + "res_w1"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert pl[layer + "router"] == ["Shard(dim=0)", "Replicate()"]


# ---------------------------------------------------------------------------
# token drops, groups across ranks, replicated experts: the one-process port
# and the reference
# ---------------------------------------------------------------------------

def _one_process(name):
    case = GRAD_CASES[name]
    cfg = ranks.config(case["arch"], **case["cfg"])
    rc = dataclasses.replace(ttrain.run_config(S, B), **case["rc"])
    return ranks.grads_case(cfg, rc, None,
                            ranks.drop_batch(cfg, B, S, GRAD_SEED), GRAD_SEED)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_sharded_output_and_gradients_equal_one_process(group, name):
    run, _, _ = group
    got = run.results[0]["grads"][name]
    want = _one_process(name)
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert all(r["grads"][name]["loss"] == got["loss"] for r in run.results)
    h = np.abs(want["h"]).max()
    assert np.abs(got["h"] - want["h"]).max() <= 1e-5 * h
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        err = float(np.abs(got["grads"][k] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (k, err)


def reference_tree(jcfg, model):
    """The port's parameters as the reference's ``init_params`` pytree,
    float32 (``convert.params_from_reference`` inverted: each segment's
    layers stacked on a leading axis where it has more than one)."""
    own = {k: t.detach().numpy() for k, t in model.state_dict().items()}
    counts = {f"seg{si}": count
              for si, (_, count) in enumerate(jcfg.block_pattern)}
    counts["enc"] = jcfg.num_encoder_layers

    def leaf(path, _):
        keys = [k.key for k in path]
        if keys[0] not in counts:
            return jnp.asarray(own[".".join(keys)], jnp.float32)
        prefix = ("enc." if keys[0] == "enc" else
                  f"segments.{keys[0][3:]}.")
        rest = ".".join(keys[2:])
        layers = [own[f"{prefix}{li}.{rest}"]
                  for li in range(counts[keys[0]])]
        a = np.stack(layers) if len(layers) > 1 else layers[0]
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, JM.abstract_params(jcfg, jnp.float32))


def _reference(name):
    """The reference's backbone output, loss and every gradient leaf (as
    the port names them) from the seeded parameters and batch of
    ``_one_process``."""
    case = GRAD_CASES[name]
    tcfg = ranks.config(case["arch"], **case["cfg"])
    jcfg = dataclasses.replace(jax_config(case["arch"]), **case["cfg"])
    rc = dataclasses.replace(ttrain.run_config(S, B), **case["rc"])
    jrc = jbase.RunConfig(**dataclasses.asdict(rc))
    model = TM.Model(tcfg, dtype=torch.float32, device="cpu",
                     seed=GRAD_SEED)
    params = reference_tree(jcfg, model)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in ranks.drop_batch(tcfg, B, S, GRAD_SEED).items()}

    def loss_fn(p):
        h, _ = JM.backbone(jcfg, jrc, p, batch)
        return JM.chunked_loss(jcfg, jrc, p, h, batch["labels"]), h

    (loss, h), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    g = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, grads))
    return {"loss": float(loss), "h": np.asarray(h),
            "grads": {k: t.detach().numpy()
                      for k, t in g.named_parameters()}}


def test_reference_tree_inverts_params_from_reference():
    cfg = ranks.config(MOE)
    model = TM.Model(cfg, dtype=torch.float32, device="cpu", seed=GRAD_SEED)
    back = convert.params_from_reference(
        cfg, jax.tree.map(np.asarray, reference_tree(jax_config(MOE),
                                                     model)))
    want = model.state_dict()
    for k, t in back.state_dict().items():
        assert torch.equal(t, want[k]), k


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_sharded_output_and_gradients_equal_the_reference(group, name):
    run, _, _ = group
    got = run.results[0]["grads"][name]
    want = _reference(name)
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    h = np.abs(want["h"]).max()
    assert np.abs(got["h"] - want["h"]).max() <= 1e-5 * h
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        err = float(np.abs(got["grads"][k] - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("name", ["sort", "group_across_ranks",
                                  "arctic_sort_1x4"])
def test_tokens_drop_in_the_capacity_cases(group, name):
    run, _, _ = group
    for r in run.results:
        kept = np.concatenate([c["kept"].ravel()
                               for c in r["grads"][name]["routing"]])
        assert 0 < kept.mean() < 1, (name, kept.mean())


def test_experts_replicate_where_their_count_does_not_divide_model(group):
    run, _, _ = group
    case = GRAD_CASES["experts_replicated"]
    cfg = ranks.config(case["arch"], **case["cfg"])
    assert cfg.num_experts % MESHES[case["mesh"]][1]
    for r in run.results:
        pl = r["grads"]["experts_replicated"]["placements"]
        assert pl["segments.0.0.moe.w1"] == ["Shard(dim=1)", "Replicate()"]
        assert pl["segments.0.0.moe.w2"] == ["Shard(dim=2)", "Replicate()"]


# ---------------------------------------------------------------------------
# routing: alike on every model rank, and the reference's
# ---------------------------------------------------------------------------

def _reference_routing(jcfg, call):
    """The reference's expert indices and kept mask for one call's logits:
    its ``_top_k_gating``, then its capacity rule in its dispatch order."""
    logits = jnp.asarray(call["logits"])
    _, idx = jmoe._top_k_gating(jcfg, logits)
    E, C = jcfg.num_experts, call["C"]
    if call["impl"] == "einsum":
        G, g, k = idx.shape
        onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
        flat = onehot.reshape(G, g * k, E)
        pos = (jnp.cumsum(flat, axis=1) - flat).reshape(G, g, k, E)
        kept = ((pos < C) & (onehot > 0)).any(-1)
    else:
        flat_e = idx.reshape(-1)
        order = jnp.argsort(flat_e)
        sorted_e = flat_e[order]
        same = jnp.cumsum(jnp.ones_like(sorted_e), 0) - 1
        pos = same - jnp.searchsorted(sorted_e, jnp.arange(E))[sorted_e]
        kept = jnp.zeros_like(pos < C).at[order].set(pos < C).reshape(idx.shape)
    return np.asarray(idx), np.asarray(kept)


def _smallest_gap(logits, k):
    """The smallest gap between adjacent logits among each token's k + 1
    largest: where a choice or its order could flip."""
    top = -np.sort(-logits.reshape(-1, logits.shape[-1]), axis=-1)[:, :k + 1]
    return float(np.diff(-top, axis=-1).min())


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_every_model_rank_routes_alike_and_as_the_reference(group, name):
    run, _, _ = group
    case = GRAD_CASES[name]
    jcfg = dataclasses.replace(jax_config(case["arch"]), **case["cfg"])
    by_rows: dict = {}
    gaps = []
    for r in run.results:
        calls = r["grads"][name]["routing"]
        assert calls and all(c["impl"] == (case["rc"].get("moe_impl")
                                           or "einsum") for c in calls)
        for c in calls:
            idx, kept = _reference_routing(jcfg, c)
            assert np.array_equal(c["idx"], idx), (name, r["rank"])
            assert np.array_equal(c["kept"], kept), (name, r["rank"])
            gaps.append(_smallest_gap(c["logits"], jcfg.experts_per_token))
        # the ranks of one data coordinate hold the same rows
        by_rows.setdefault(r["coords"][case["mesh"]][0], []).append(calls)
    for calls in by_rows.values():
        for other in calls[1:]:
            for a, b in zip(calls[0], other):
                assert np.array_equal(a["logits"], b["logits"])
                assert np.array_equal(a["idx"], b["idx"])
                assert np.array_equal(a["kept"], b["kept"])
    print(f"{name}: smallest logit gap among the choices {min(gaps):.3e}")
    assert min(gaps) > 0


# ---------------------------------------------------------------------------
# rules on a DeviceMesh, the driver over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", [ARCTIC, MOE, WHISPER])
def test_sharding_for_on_a_device_mesh_is_the_duck_meshs(group, arch, mesh):
    run, _, _ = group
    d, m = MESHES[mesh]
    duck = DuckMesh({"data": d, "model": m})
    leaves = TM.param_leaves(ranks.config(arch))
    for r in run.results:
        assert r["rules"][(mesh, arch)] == {
            k: [repr(p) for p in trules.sharding_for(duck, leaf)]
            for k, leaf in leaves.items()}


def test_train_driver_over_ranks_tracks_one_process_for_moe(
        group, tmp_path, monkeypatch):
    """Both runs with float32 parameters (``run_config`` patched, here and
    in the ranks)."""
    run, _, tmp = group
    monkeypatch.setattr(ttrain, "run_config", float32_run_config)
    assert [r["driver"]["rc"] for r in run.results] == [0] * WORLD
    sharded = json.loads((tmp / "driver.json").read_text())
    assert sharded["mesh"] == {"data": WORLD, "model": 1}
    assert ttrain.main([*DRIVER, "--checkpoint-dir", str(tmp_path / "c"),
                        "--json-out", str(tmp_path / "one.json")]) == 0
    one = json.loads((tmp_path / "one.json").read_text())
    assert one["mesh"] == {"data": 1, "model": 1}
    assert len(sharded["losses"]) == len(one["losses"]) == 3
    for a, b in zip(sharded["losses"], one["losses"]):
        assert abs(a - b) <= STEP_LOSS_RTOL * abs(b), (sharded["losses"],
                                                       one["losses"])


def test_ranks_are_gone(group):
    assert not torch.multiprocessing.active_children()
