"""The dry run's 40 cells (``launch/dryrun.py: run_cell``) on the 16x16
production mesh of a fake world of 256 ranks, each arch's reduced config
at a small shape of its kind, held to ``tests/test_dryrun_results.py``'s
invariants: every (arch x shape) cell present, skips exactly where
``registry.applicable`` says (33 ok, 7 skipped, no error), and each ok
record complete: three roofline terms >= 0, a ``dominant`` among them,
flops > 0, ``model_flops_global`` > 0 and 0 < ``useful_ratio`` < 2.  The
mamba and hybrid cells run the scan through its op's fake."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

# (seq_len, global_batch) of each shape's small stand-in: a batch the data
# axis divides, and long_500k's batch of one
SMALL = {"train_4k": (64, 32), "prefill_32k": (64, 32),
         "decode_32k": (64, 32), "long_500k": (128, 1)}
TERMS = ("compute_s", "memory_s", "collective_s")


@pytest.fixture(scope="module")
def cells():
    """Every cell's record, from one fake world of 256 ranks."""
    out = {}
    with dryrun.fake_world(256):
        for arch in registry.ARCHS:
            cfg = registry.reduced_config(registry.get_config(arch))
            for name, shape in SHAPES.items():
                S, B = SMALL[name]
                counter = hlo_analysis.Counter()
                with counter:
                    cell = dryrun.run_cell(
                        arch, name, False, verbose=False, cfg=cfg,
                        shape=ShapeConfig(name, S, B, shape.kind))
                cell["op_counts"] = counter.summary()["op_counts"]
                out[(arch, name)] = cell
    return out


def test_all_cells_present(cells):
    assert set(cells) == {(a, s) for a in registry.ARCHS for s in SHAPES}
    assert len(cells) == 40


def test_no_errors_and_correct_skips(cells):
    for (arch, shape), c in cells.items():
        assert c["status"] in ("ok", "skipped"), (arch, shape, c.get("error"))
        ok, _ = registry.applicable(registry.get_config(arch), SHAPES[shape])
        assert (c["status"] == "ok") == ok, (arch, shape)
    n_ok = sum(c["status"] == "ok" for c in cells.values())
    assert (n_ok, len(cells) - n_ok) == (33, 7)


def test_roofline_records_complete(cells):
    for (arch, shape), c in cells.items():
        if c["status"] != "ok":
            continue
        assert c["chips"] == 256 and c["mesh"] == "16x16"
        t = c["roofline_terms_s"]
        assert all(t[term] >= 0 for term in TERMS), (arch, shape, t)
        assert c["dominant"] in TERMS and t[c["dominant"]] == max(t.values())
        assert c["step_time_bound_s"] == max(t.values())
        assert c["hlo_flops_per_device"] > 0, (arch, shape)
        assert c["model_flops_global"] > 0
        assert 0 < c["useful_ratio"] < 2.0, (arch, shape, c["useful_ratio"])
        mem = c["memory"]
        assert min(mem.values()) >= 0 and mem["argument_size_in_bytes"] > 0


def test_mamba_cells_run_the_scan_through_its_fake(cells):
    """Every ok cell of an arch with a mamba mixer dispatches the scan op
    (and a train cell its backward op) on meta tensors, and launches
    nothing."""
    from repro_torch.kernels import LAUNCHES

    for (arch, shape), c in cells.items():
        cfg = registry.get_config(arch)
        if c["status"] != "ok" or not cfg.ssm_state:
            continue
        ops = c["op_counts"]
        if SHAPES[shape].kind != "decode":
            assert ops.get("repro_torch.selective_scan", 0) > 0, (arch, shape)
        if SHAPES[shape].kind == "train":
            assert ops.get("repro_torch.selective_scan_bwd", 0) > 0, arch
    assert LAUNCHES["selective_scan"] == LAUNCHES["selective_scan_bwd"] == 0
