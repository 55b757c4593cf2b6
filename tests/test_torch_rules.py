"""The port's placement policy (parallel/rules.py, launch/mesh.py) against
the reference's (repro/parallel/rules.py) on the CPU: ``spec_for`` for every
leaf of every ``configs/*.py`` architecture's parameter template, plain and
stacked (a leading layer dim, as ``param_specs`` stacks segments), and for
activation shapes, on duck-typed meshes of shapes (1, 1), (4, 2), (16, 16)
and (2, 16, 16) with a pod axis, with ``seq_parallel`` off and on: the same
spec, entry for entry.  Also ``tests/test_substrate.py``'s cases of the
policy, the local mesh over the devices torch sees, and the multi-card
meshes' refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import rules as jrules  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import rules as trules  # noqa: E402


class DuckMesh:
    def __init__(self, shape: dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {
    "1x1": DuckMesh({"data": 1, "model": 1}),
    "4x2": DuckMesh({"data": 4, "model": 2}),
    "16x16": DuckMesh({"data": 16, "model": 16}),
    "pod_2x16x16": DuckMesh({"pod": 2, "data": 16, "model": 16}),
}


def leaves(arch):
    cfg = jreg.get_config(arch)
    for path, leaf in JM._iter_leaves(JM.model_template(cfg)):
        yield path, leaf.shape, leaf.logical
        yield path + ("stacked",), (1, *leaf.shape), (None, *leaf.logical)


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_spec_for_is_the_references_on_every_template_leaf(arch, mesh,
                                                           seq_parallel):
    m = MESHES[mesh]
    n = 0
    for path, shape, logical in leaves(arch):
        want = jrules.spec_for(m, shape, logical, seq_parallel)
        got = trules.spec_for(m, shape, logical, seq_parallel)
        assert isinstance(got, tuple) and got == tuple(want), (path, got, want)
        n += 1
    assert n > 4


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_spec_is_the_references(mesh, seq_parallel):
    m = MESHES[mesh]
    for shape, logical in (((256, 4096, 2048), ("batch", "seq", "embed")),
                           ((1, 4096, 2048), ("batch", "seq", "embed")),
                           ((8, 1000, 25, 64), ("batch", "seq", "heads",
                                                None)),
                           ((8, 32, 128), ("batch", "heads[8]", None)),
                           ((8, 32, 128), ("batch", "heads[25]", None)),
                           ((4, 4096, 8, 128), ("batch", "kv_seq",
                                                "kv_heads", None))):
        assert trules.act_spec(m, shape, logical, seq_parallel) == tuple(
            jrules.act_spec(m, shape, logical, seq_parallel)), (shape,
                                                                logical)


def test_divisible_or_replicate():
    """tests/test_substrate.py's cases of the policy, on the port."""
    m = MESHES["16x16"]
    assert trules.spec_for(m, (2048, 4096), ("embed", "heads")) == (
        "data", "model")
    assert trules.spec_for(m, (25, 64), ("heads", None)) == ()
    assert trules.spec_for(m, (32001, 1600), ("vocab", "embed")) == (
        None, "data")
    pod = MESHES["pod_2x16x16"]
    assert trules.spec_for(pod, (256, 4096), ("batch", "seq")) == (
        ("pod", "data"),)
    assert trules.spec_for(pod, (1, 4096), ("batch", "seq")) == ()


def test_local_mesh_over_the_devices_torch_sees():
    n = len(tmesh.local_devices())
    assert n == (torch.cuda.device_count() if torch.cuda.is_available()
                 else 1)
    for model in (1, 2, 4):
        mesh = tmesh.make_local_mesh(model=model)
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape["model"] == min(model, n)
        assert mesh.shape["data"] * mesh.shape["model"] == tmesh.mesh_chips(
            mesh) <= n
        # the policy reads a LocalMesh as the reference's reads a jax Mesh
        assert trules.spec_for(mesh, (22, 3), ("inner", None)) == tuple(
            jrules.spec_for(DuckMesh(mesh.shape), (22, 3), ("inner", None)))
    assert int(np.prod(list(tmesh.make_local_mesh().shape.values()))) == n


# the production meshes are built now, over a world of 256 or 512 ranks
# (tests/test_torch_dryrun.py builds them in fake worlds); outside one each
# refuses, naming the world it needs (the cases keep their ids, which
# named the queue items of the refusals they used to be)
@pytest.mark.parametrize("call,item", [
    pytest.param(lambda: tmesh.make_production_mesh(), "256 ranks",
                 id="<lambda>-list 1b item 7"),
    pytest.param(lambda: tmesh.make_production_mesh(multi_pod=True),
                 "512 ranks", id="<lambda>-queue 1 item 12"),
])
def test_multi_card_meshes_refuse_naming_their_items(call, item):
    with pytest.raises(ValueError, match=item) as e:
        call()
    assert "this one has none" in str(e.value)


def test_compat_make_mesh_needs_a_world():
    """Outside the ranks of ``run_ranks`` there is no world to mesh."""
    with pytest.raises(RuntimeError, match="run_ranks"):
        tmesh.compat_make_mesh((16, 16), ("data", "model"))
