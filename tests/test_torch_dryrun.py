"""The port's dry run (``launch/dryrun.py``) against the reference's
(``repro/launch/dryrun.py``) on the CPU: ``model_flops_per_step``,
``active_param_count`` and ``default_rc`` for every arch and shape;
``abstract_params``' leaves; each arch's per-device parameter and AdamW
bytes on the 16x16 production mesh against the reference's
``param_specs`` worked out by hand; ``make_production_mesh`` in fake
worlds of 256 and 512 ranks and its refusal on 16;
``train --production-mesh`` off a 256-rank world and
``build_sharded_state`` on the fake mesh; one cell at full width,
whisper-tiny ``train_4k``.  The 40-cell sweep's invariants are in
``tests/test_torch_dryrun_sweep.py``."""
import contextlib
import math
import os

import jax
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.parallel import rules  # noqa: E402


def _reference_dryrun():
    """The reference's module without its side effect: importing it sets
    XLA_FLAGS for 512 host devices, which this process and the processes
    it starts must not inherit."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


JD = _reference_dryrun()


class DuckMesh:
    def __init__(self, shape: dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _init_fake(n: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@pytest.fixture(scope="module")
def world():
    """A fake world of 256 ranks for this file, destroyed at its end."""
    _init_fake(256)
    yield
    dist.destroy_process_group()
    dryrun.forget_meshes()


@contextlib.contextmanager
def other_world(n: int | None):
    """The module's world swapped for a fake one of ``n`` ranks (None: no
    world) for a block, then put back."""
    dist.destroy_process_group()
    dryrun.forget_meshes()
    try:
        if n is None:
            yield
        else:
            with dryrun.fake_world(n):
                yield
    finally:
        _init_fake(256)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_model_flops_and_run_config_are_the_references(arch, shape):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    assert dryrun.active_param_count(cfg) == JD.active_param_count(jcfg)
    assert dryrun.model_flops_per_step(cfg, sh) == \
        JD.model_flops_per_step(jcfg, jsh)
    rc, jrc = dryrun.default_rc(cfg, sh), JD.default_rc(jcfg, jsh)
    for f in ("seq_len", "global_batch", "q_block", "kv_block", "loss_chunk",
              "scan_chunk", "remat", "seq_parallel", "param_dtype"):
        assert getattr(rc, f) == getattr(jrc, f), f


def _ref_leaves(arch):
    """(port name, reference leaf, reference spec on 16x16, stacked) for
    every parameter: a segment's stacked layers one port name each."""
    jcfg = jreg.get_config(arch)
    tree = JM.abstract_params(jcfg)
    specs = JM.param_specs(jcfg, DuckMesh({"data": 16, "model": 16}))
    out = {}

    def walk(t, s, prefix, count):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, s[k], f"{prefix}{k}.", count)
            elif count > 1:
                for li in range(count):
                    out[prefix.format(li=li) + k] = (v, s[k], True)
            else:
                out[prefix.format(li=0) + k] = (v, s[k], False)

    for k in ("embed", "final_norm", "lm_head", "enc_norm"):
        if k in tree:
            out[k] = (tree[k], specs[k], False)
    for si, (_, count) in enumerate(jcfg.block_pattern):
        walk(tree[f"seg{si}"]["params"], specs[f"seg{si}"]["params"],
             f"segments.{si}.{{li}}.", count)
    if jcfg.is_encoder_decoder:
        walk(tree["enc"]["params"], specs["enc"]["params"], "enc.{li}.",
             jcfg.num_encoder_layers)
    return out


def _jdtype(torch_dtype):
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[torch_dtype]


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_abstract_params_are_the_references_leaves(arch):
    model = M.abstract_params(registry.get_config(arch))
    got = dict(model.named_parameters())
    want = _ref_leaves(arch)
    assert set(got) == set(want)
    for name, p in got.items():
        leaf, _, stacked = want[name]
        assert p.is_meta
        assert tuple(p.shape) == (tuple(leaf.shape[1:]) if stacked
                                  else tuple(leaf.shape)), name
        assert _jdtype(p.dtype) == str(leaf.dtype), name


def _local_elems(shape, spec, mesh: dict[str, int]) -> int:
    """Elements of one device's block of ``shape`` under the reference's
    ``spec``: each dim divided by the product of its axes' sizes."""
    n = 1
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        div = math.prod(mesh[a] for a in axes)
        assert d % div == 0
        n *= d // div
    return n


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_per_device_param_and_adamw_bytes_are_the_references(arch, world):
    mesh16 = {"data": 16, "model": 16}
    want_p = want_o = 0
    for leaf, spec, _ in {id(v[0]): v for v in _ref_leaves(arch).values()
                          }.values():
        n = _local_elems(leaf.shape, tuple(spec), mesh16)
        want_p += n * leaf.dtype.itemsize
        want_o += 2 * n * 4              # AdamW's mu and nu, float32
    cfg = registry.get_config(arch)
    rc = dryrun.default_rc(cfg, SHAPES["train_4k"])
    mesh = make_production_mesh()
    with rules.use_rules_mesh(mesh):
        _, params, state, shardings = dryrun.abstract_train_inputs(
            cfg, rc, opt.OptimizerConfig(), mesh)
    assert all(rules.local(p).is_meta for p in params.values())
    assert dryrun._local_bytes(params) == want_p
    assert dryrun._local_bytes({k: state[k] for k in ("mu", "nu")}) == want_o
    assert set(shardings["opt_state"]) == {"mu", "nu"}


def test_production_meshes_in_fake_worlds(world):
    mesh = make_production_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.mesh.shape) == (16, 16) and mesh.device_type == "cuda"
    with other_world(512):
        pod = make_production_mesh(multi_pod=True)
        assert pod.mesh_dim_names == ("pod", "data", "model")
        assert tuple(pod.mesh.shape) == (2, 16, 16)
        with pytest.raises(ValueError, match="256 ranks; this one has 512"):
            make_production_mesh()
    with other_world(16):
        with pytest.raises(ValueError, match="this one has 16"):
            make_production_mesh()
        with pytest.raises(ValueError, match="512 ranks"):
            make_production_mesh(multi_pod=True)


def test_train_production_mesh_needs_256_ranks(world, capsys):
    argv = ["--reduced", "--device", "cpu", "--production-mesh"]
    with other_world(None):
        assert ttrain.main(argv) == 2
        assert "needs a world of 256 ranks" in capsys.readouterr().err
    with other_world(16):
        assert ttrain.main(argv) == 2
        assert "this one has 16" in capsys.readouterr().err


def test_build_sharded_state_on_the_fake_mesh_is_meta(world):
    cfg = registry.reduced_config(registry.get_config("tinyllama-1.1b"))
    rc = dryrun.default_rc(cfg, SHAPES["train_4k"])
    mesh = make_production_mesh()
    model = M.abstract_params(cfg)
    model.requires_grad_(True)
    params, state, shardings = ttrain.build_sharded_state(
        cfg, rc, opt.OptimizerConfig(), mesh, model)
    for k, p in params.items():
        assert rules.is_dtensor(p) and p.device_mesh is mesh
        assert rules.local(p).is_meta and p.requires_grad
        assert rules.local(state["mu"][k]).is_meta
        assert shardings["params"][k] == (mesh, tuple(p.placements))


def test_whisper_train_at_full_width(world):
    cell = dryrun.run_cell("whisper-tiny", "train_4k", False, verbose=False)
    assert cell["status"] == "ok" and cell["chips"] == 256
    for term in ("compute_s", "memory_s", "collective_s"):
        assert cell["roofline_terms_s"][term] > 0
    assert cell["dominant"] == max(cell["roofline_terms_s"],
                                   key=cell["roofline_terms_s"].get)
    assert cell["model_flops_global"] == JD.model_flops_per_step(
        jreg.get_config("whisper-tiny"), JSHAPES["train_4k"])
    assert 0 < cell["useful_ratio"] < 2
    mem = cell["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert cell["fits"] and cell["peak_bytes_per_device"] == \
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert cell["collective_bytes_per_device"]["all-gather"] > 0
