"""The LM over a mesh of ranks on the CPU: the port's placement
(``parallel/rules.py``: ``sharding_for``, ``use_rules_mesh``,
``constrain``), ``context_parallel_attention``, the model's
context-parallel branch and sharding hints, the loader's ``mesh=``,
``restore(shardings=)`` and the train driver over an initialised world,
against the reference.

One group of 4 gloo ranks (``torch_lm_ranks.lm_rank``) runs every
sharded case once, on meshes (1, 4), (2, 2) and (4, 1) of its world; the
tests read what its ranks returned.

Tolerances.  Context-parallel attention: the forward within 1e-5 of the
reference's ``blockwise_attention`` and of its own
``context_parallel_attention`` (float32, the same online softmax over
another tiling of the rows), the q, k and v gradients within 1e-5 of the
port's one-process autograd.  The sharded train steps with the
tolerances ``test_torch_train_models.py`` holds the one-process port to
the reference with: losses within 1e-4 relative and parameters within
1e-5 but for 1 element in 10^4, each within 2 lr a step, of the
reference's; the moments within 1e-4 (mu) and 2e-4 (nu) of each leaf's
largest of the one-process port's from the same parameters and batches
(a sharded product sums its partial products in another order).  The
moments are held to the port's and not to the reference's because the
one-process port's own A_log moment lies 1.1e-4 (falcon-mamba) and
1.5e-4 (this hymba) of its largest from the reference's at the second
step: the sequential and the chunked scans multiply the decays in other
orders, and these two configs are not among those
``test_torch_train_models.py`` steps.  The scan's ``A_log`` moments at
1e-3 (``A_LOG_REL``): its gradient sums products of small decays over
every position, and float32 summation order moves its second step's
moments by up to 2e-4 of their largest between any two of the reference,
the one-process port and the sharded port.  Every rank's full parameters
are bit-equal: replicated leaves are updated from the same all-reduced
gradients."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_ranks as ranks  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.parallel import rules as jrules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.parallel import rules as trules  # noqa: E402
from test_torch_models import JRC, RC  # noqa: E402
from test_torch_train_models import (GRAD_REL, PARAM_ATOL,  # noqa: E402
                                     PARAM_OUTLIERS, STEP_LOSS_RTOL, as_port)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
WORLD = 4
ARCHS = ["tinyllama-1.1b", "falcon-mamba-7b", "hymba-1.5b"]
TRAIN_MESHES = ["2x2", "1x4"]
B, S, STEPS = 2, 24, 2
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10)
CP = dict(B=2, S=64, H=6, KH=2, D=16, windows=(None, 16),
          blocks=dict(q_block=16, kv_block=16))
A_LOG_REL = 1e-3
DRIVER = ["--arch", "hymba-1.5b", "--reduced", "--steps", "3", "--batch",
          "4", "--seq", "32", "--device", "cpu", "--log-every", "1"]


class DuckMesh:
    def __init__(self, shape: dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def jax_config(arch):
    cfg = jreg.reduced_config(jreg.get_config(arch))
    if arch.startswith("hymba"):
        cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1,
                                  head_dim=16)
    return cfg


def reference_params(jcfg):
    """The reference's float32 parameters, normal leaves redrawn from a
    numpy seed (``test_torch_models.carried``: its ``init_params`` seeds
    by Python's salted ``hash``)."""
    rng = np.random.default_rng(0)

    def redraw(t):
        a = np.asarray(t.astype(jnp.float32))
        if (a == a.flat[0]).all():
            return t.astype(jnp.float32)
        return jnp.asarray(rng.standard_normal(t.shape) * t.shape[-2] ** -0.5,
                           jnp.float32)

    return jax.tree.map(redraw, JM.init_params(jcfg, jax.random.PRNGKey(0)))


def cp_inputs():
    rng = np.random.default_rng(7)
    c = CP
    q = rng.standard_normal((c["B"], c["S"], c["H"], c["D"]), np.float32)
    k, v = (rng.standard_normal((c["B"], c["S"], c["KH"], c["D"]), np.float32)
            for _ in range(2))
    dout = rng.standard_normal(q.shape, np.float32)
    return q, k, v, dout


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group's results, and the reference's steps beside them."""
    tmp = tmp_path_factory.mktemp("sharding")
    q, k, v, dout = cp_inputs()
    params = {arch: reference_params(jax_config(arch)) for arch in ARCHS}
    job = {
        "cp": dict(q=q, k=k, v=v, dout=dout, meshes=("1x4", "2x2"),
                   windows=CP["windows"], blocks=CP["blocks"]),
        "train": dict(params={a: jax.tree.map(np.asarray, p)
                              for a, p in params.items()},
                      meshes=TRAIN_MESHES, B=B, S=S,
                      steps=STEPS, opt=OPT, rc=dataclasses.asdict(JRC)),
        "loader": dict(batches=(4, 3), S=16, vocab=256),
        "checkpoint": dict(dir=str(tmp / "ckpt"), rc=dataclasses.asdict(JRC)),
        "driver": dict(argv=DRIVER, dir=str(tmp / "driver_ckpt"),
                       json=str(tmp / "driver.json")),
    }
    # the ranks run while this process computes the unsharded steps
    box: dict = {}

    def ranks_run():
        try:
            box["run"] = tmesh.run_ranks(ranks.lm_rank, WORLD, (job,),
                                         device="cpu", timeout=600)
        except BaseException as e:
            box["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    try:
        want = {arch: list(zip(reference_steps(jax_config(arch), p),
                               port_steps(arch, job["train"]["params"][arch])))
                for arch, p in params.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["run"], want, tmp


def reference_steps(jcfg, params):
    """STEPS of the reference's jitted AdamW step from ``params``, on its
    loader's batches."""
    jo = jopt.OptimizerConfig(**OPT)
    jstep = jax.jit(jtrain.train_step_fn(jcfg, JRC, jo))
    js = jopt.init_state(jo, params)
    out = []
    with jloader.LMBatchLoader(None, B, S, jcfg.vocab_size) as jl:
        for _ in range(STEPS):
            params, js, m = jstep(params, js, next(jl))
            out.append((float(m["loss"]), params, js))
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
        for _ in range(STEPS):
            tp, ts, _ = step(tp, ts, next(tl))
            out.append({n: {k: m.clone() for k, m in ts[n].items()}
                        for n in ("mu", "nu")})
    return out


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

def _reference_placements(mesh, spec):
    """The reference's PartitionSpec, mapped to DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        for axis in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.axis_names.index(axis)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("shape", ["1x4", "2x2", "4x1"])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_sharding_for_is_the_references_on_every_leaf(arch, shape):
    d, m = ranks.MESHES[shape]
    mesh = DuckMesh({"data": d, "model": m})
    cfg = jreg.get_config(arch)
    n = 0
    for path, leaf in JM._iter_leaves(JM.model_template(cfg)):
        for stacked in (False, True):
            want = _reference_placements(
                mesh, jrules.spec_for(mesh, ((1,) + leaf.shape) if stacked
                                      else leaf.shape,
                                      ((None,) + leaf.logical) if stacked
                                      else leaf.logical))
            assert trules.sharding_for(mesh, leaf, stacked) == want, path
            n += 1
    assert n > 8


def test_sharding_for_on_a_device_mesh_is_the_duck_meshs(group):
    """The ranks' DeviceMeshes give every leaf the placements a mesh of
    the same names and sizes gives."""
    run, _, _ = group
    for (name, arch), got in run.results[0]["rules"].items():
        d, m = ranks.MESHES[name]
        duck = DuckMesh({"data": d, "model": m})
        leaves = TM.param_leaves(ranks.config(arch))
        assert got == {k: [repr(p) for p in trules.sharding_for(duck, leaf)]
                       for k, leaf in leaves.items()}
    assert all(r["rules"] == run.results[0]["rules"] for r in run.results)


def test_param_leaves_are_the_models_parameters():
    for arch in sorted(treg.ARCHS):
        cfg = treg.reduced_config(treg.get_config(arch))
        model = TM.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
        leaves = TM.param_leaves(cfg)
        got = {k: tuple(p.shape) for k, p in model.named_parameters()}
        assert got == {k: leaf.shape for k, leaf in leaves.items()}, arch


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(2, 3)
    assert trules.constrain(x, ("batch", None)) is x
    assert trules.rules_mesh() is None


def test_constrain_places_by_the_rules_under_a_mesh(group):
    """The placements of the reference's activation spec (``act_spec``),
    and the values unchanged."""
    run, _, _ = group
    for r in run.results:
        for name, got in r["constrain"].items():
            d, m = ranks.MESHES[name]
            duck = DuckMesh({"data": d, "model": m})
            for key, logical in (("batch", ("batch", "seq", None)),
                                 ("heads", (None, None, "heads[6]"))):
                want = _reference_placements(
                    duck, jrules.act_spec(duck, (4, 8, 6), logical))
                assert got[key] == [repr(p) for p in want], (name, key)
            assert got["equal"]


def test_ranks_run_over_gloo_and_none_is_left(group):
    run, _, _ = group
    assert run.backend == "gloo" and [r["backend"] for r in run.results] == [
        "gloo"] * WORLD
    assert not torch.multiprocessing.active_children()


# ---------------------------------------------------------------------------
# context-parallel attention
# ---------------------------------------------------------------------------

def _cp_reference(window):
    q, k, v, _ = cp_inputs()
    return np.asarray(jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, **CP["blocks"]))


def _cp_port_grads(window):
    q, k, v, dout = cp_inputs()
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tlayers.blockwise_attention(tq, tk, tv, causal=True, window=window,
                                      **CP["blocks"])
    return torch.autograd.grad(out, (tq, tk, tv), torch.tensor(dout))


@pytest.mark.parametrize("window", CP["windows"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_context_parallel_attention_forward_and_gradients(group, mesh,
                                                          window):
    run, _, _ = group
    res = run.results[0]["cp"][(mesh, window)]
    assert len({r["cp"][(mesh, window)]["sha"] for r in run.results}) == 1
    assert res["placements"][1] == "Shard(dim=1)"     # seq over model
    out, dq, dk, dv = res["arrays"]
    assert np.abs(out - _cp_reference(window)).max() <= 1e-5
    for got, want in zip((dq, dk, dv), _cp_port_grads(window)):
        assert np.abs(got - want.numpy()).max() <= 1e-5


def test_context_parallel_attention_is_the_references_own(group, tmp_path):
    """The reference's ``context_parallel_attention`` on a (1, 4) mesh of
    forced host devices, in a subprocess, against the port's on (1, 4)."""
    q, k, v, _ = cp_inputs()
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v)
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.models import layers
z = np.load({str(tmp_path / "in.npz")!r})
mesh = jax.make_mesh((1, 4), ("data", "model"))
out = jax.jit(lambda q, k, v: layers.context_parallel_attention(
    mesh, q, k, v, causal=True, window=16, q_block=16, kv_block=16))(
    *(jnp.asarray(z[n]) for n in ("q", "k", "v")))
np.save({str(tmp_path / "out.npy")!r}, np.asarray(out))
print("CP_OK")
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "CP_OK" in res.stdout, res.stdout + res.stderr
    want = np.load(tmp_path / "out.npy")
    got = group[0].results[0]["cp"][("1x4", 16)]["arrays"][0]
    assert np.abs(got - want).max() <= 1e-5


# ---------------------------------------------------------------------------
# the model: sharded train steps against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_track_the_reference(group, arch, mesh):
    run, want, _ = group
    steps = run.results[0]["train"][(arch, mesh)]
    tcfg = ranks.config(arch)
    for step, (got, ((jl, jp, _), port)) in enumerate(zip(steps, want[arch]),
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
                tol = A_LOG_REL if k.endswith("A_log") else rel
                assert err <= tol * float(np.abs(ref_m).max()), (step, name,
                                                                 k)
        # every rank holds the same full parameters, bit for bit
        assert len({r["train"][(arch, mesh)][step - 1]["sha"]
                    for r in run.results}) == 1


@pytest.mark.parametrize("mesh", TRAIN_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_parameters_are_placed_by_the_rules(group, arch, mesh):
    run, _, _ = group
    d, m = ranks.MESHES[mesh]
    duck = DuckMesh({"data": d, "model": m})
    leaves = TM.param_leaves(ranks.config(arch))
    got = run.results[0]["train"][(arch, mesh)][-1]["placements"]
    assert got == {k: [repr(p) for p in trules.sharding_for(duck, leaf)]
                   for k, leaf in leaves.items()}


def test_context_parallel_branch_condition():
    """The reference's condition: the head count does not divide the
    model axis, the sequence does, and it is not decode."""
    from types import SimpleNamespace

    def mesh(tp):
        return SimpleNamespace(mesh_dim_names=("data", "model"),
                               size=lambda i: (1, tp)[i])

    cfg = ranks.config("hymba-1.5b")
    q = torch.zeros(2, 24, 3, 16)
    assert TM._context_parallel(cfg, mesh(2), q)
    assert not TM._context_parallel(cfg, mesh(3), q)       # 3 heads divide 3
    assert not TM._context_parallel(cfg, mesh(2), q[:, :1])   # decode
    assert not TM._context_parallel(cfg, mesh(5), q)       # 24 % 5
    assert not TM._context_parallel(cfg, None, q)
    assert not TM._context_parallel(ranks.config("tinyllama-1.1b"), mesh(2),
                                    torch.zeros(2, 24, 4, 16))


# ---------------------------------------------------------------------------
# loader, checkpoint, driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [4, 3])
def test_loader_places_the_references_batch(group, batch, monkeypatch):
    run, _, _ = group
    monkeypatch.setattr(jloader, "NamedSharding", lambda mesh, spec: spec)
    with jloader.LMBatchLoader(DuckMesh({"data": 2, "model": 2}), batch, 16,
                               256) as jl:
        spec = jl._sharding()
    with jloader.LMBatchLoader(None, batch, 16, 256) as jl:
        want = next(jl)
    mesh = DuckMesh({"data": 2, "model": 2})
    for r in run.results:
        got = r["loader"][batch]
        assert got["placements"] == [repr(p) for p in
                                     _reference_placements(mesh, spec)]
        assert np.array_equal(got["tokens"], np.asarray(want["tokens"]))
        assert np.array_equal(got["labels"], np.asarray(want["labels"]))


def test_checkpoint_restores_bit_equal_onto_any_mesh(group):
    run, _, _ = group
    assert [r["checkpoint"]["writes"] for r in run.results] == [2, 0, 0, 0]
    for r in run.results:
        for name, got in r["checkpoint"]["restored"].items():
            assert got == {"step": 5, "equal": True,
                           "placements_as_rules": True}, name


def test_train_driver_over_ranks_tracks_one_process(group, tmp_path, capsys,
                                                    monkeypatch):
    """Both runs with float32 parameters (``run_config`` patched, here and
    in the ranks), where the step-loss tolerance means what it means in
    ``test_torch_train_models.py``; in bf16 a sharded product rounds each
    rank's partial sum."""
    run, _, tmp = group
    monkeypatch.setattr(ttrain, "run_config", ranks.float32_run_config)
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
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
