"""The port's checkpoint manager (repro_torch.checkpoint.manager): the
checkpoint cases of tests/test_substrate.py on torch trees, bf16 leaves,
the reference's file layout, and the refused mesh restore."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt_state": {"step": torch.tensor(7, dtype=torch.int32)}}
    mgr.save(7, state)
    out = mgr.restore()
    assert out["step"] == 7
    assert torch.equal(out["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert out["opt_state"]["step"].dtype == torch.int32
    assert int(out["opt_state"]["step"]) == 7


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"w": torch.ones(1) * s}})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert float(mgr.restore()["params"]["w"][0]) == 4.0
    assert float(mgr.restore(3)["params"]["w"][0]) == 3.0


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    w = torch.zeros(4)
    mgr.save(1, {"params": {"w": w}})
    w += 1                      # the snapshot was taken at save()
    mgr.wait()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore()["params"]["w"], torch.zeros(4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32,
                                   torch.bfloat16, torch.int64])
def test_checkpoint_roundtrips_dtypes_bit_for_bit(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    leaf = (torch.randn(3, 5, generator=g) * 100).to(dtype)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"train": {"a": {"b": leaf}, "scalar": np.float32(1.5)}})
    out = mgr.restore()["train"]
    assert out["a"]["b"].dtype == dtype
    assert torch.equal(out["a"]["b"], leaf)
    assert float(out["scalar"]) == 1.5


def test_checkpoint_layout_is_the_references(tmp_path):
    """npz groups beside a manifest, a bf16 leaf under the ``::bf16`` tag."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, {"params": {"w": torch.ones(2, dtype=torch.bfloat16)}},
             extra={"run": "x"})
    path = tmp_path / "step_00000003"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 3 and manifest["groups"] == ["params"]
    assert manifest["run"] == "x"
    with np.load(path / "params.npz") as z:
        assert z.files == ["params/w::bf16"]
        assert z["params/w::bf16"].dtype == np.uint16
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_places_leaves_on_a_device_and_refuses_shardings(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(2, {"params": {"w": torch.ones(4, 4)}})
    out = mgr.restore(device="cpu")
    assert out["params"]["w"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="list 1b item 7"):
        mgr.restore(shardings={"params": {"w": object()}})
    with pytest.raises(AssertionError):
        CheckpointManager(str(tmp_path / "empty")).restore()
