"""The harness finds cells, mixes, limits and metrics by name, and a new
one is new files and entries alone."""
import json
import shutil
import time

import pytest
import torch

from perfbench import cells, run
from perfbench.tests.helpers import tiny_cell


def test_finds_each_cell_by_name():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for wl in bench["workloads"]:
        cell = cells.load_cell(run.ROOT, wl["name"])
        assert cell.traffic["name"] == wl["traffic"]
        assert cell.config["name"] == wl["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"round_ms", "setup_s"}
        assert cell.per_layer, "every cell reports a per-layer metric"
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
        assert cell.limits["field_mismatch"] == 0
        assert cells.reference(cell.config).__name__.endswith(
            cell.config["reference"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell(run.ROOT, "no_such_cell")


def test_contract_shapes():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in bench["end_to_end"]}
    assert names == {"round_ms", "round_ms_p95", "setup_s"}
    assert {m["moves"] for m in bench["per_layer"]} == {"round_ms"}
    for c in bench["configs"]:
        conf = json.loads((run.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and c["reduced"] == conf["reduced"]


def test_new_cell_mix_and_metric_from_files_alone(tmp_path):
    """A later change adds a mix, a cell, its limits and a metric as new
    files and entries, and the harness runs the cell as it stands."""
    here = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(cells.HERE / sub, here / sub)
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (here / "configs" / "tiny.json").write_text(json.dumps(
        {**tiny_cell().config, "name": "tiny"}))
    bench["configs"].append({"name": "tiny", "source": "x",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "x"})
    (here / "traffic" / "ova2_sparse.json").write_text(json.dumps(
        {**tiny_cell().traffic, "name": "ova2_sparse", "classes": 2,
         "sparsity": 0.9}))
    (here / "limits" / "tiny_sparse.json").write_text(json.dumps(
        tiny_cell().limits))
    (here / "metrics" / "rounds_seen.py").write_text(
        "def read(r):\n    return float(len(r.round_s)) or None\n")
    bench["workloads"].append({"name": "tiny_sparse", "config": "tiny",
                               "traffic": "ova2_sparse", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "round_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell(tmp_path, "tiny_sparse", here=here)
    assert cell.traffic["classes"] == 2
    assert [m["name"] for m in cell.per_layer] == ["rounds_seen"]
    res = run.run_cell(cell, 3, 0.05, True, torch.device("cpu"),
                       time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["rounds_seen"]["value"] >= 1
    assert cells.load_cell(tmp_path, "case1_c10", here=here).name == "case1_c10"


def test_trace_run_reports_host_metrics_on_cpu():
    bench = cells.load_cell(run.ROOT, "case1_c10")
    res = run.run_cell(tiny_cell(per_layer=bench.per_layer), 5, 0.05, True,
                       torch.device("cpu"), time.perf_counter())
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # device readings are left out where nothing was traced on a card
    assert {"round_host_ms", "draws_ms", "worker_ms", "round_mfu"} <= set(got)
    assert not {"modmatmul_ms", "coded_grad_roofline", "device_idle"} & set(got)
    assert list(res["checks"]) == ["field_mismatch", "wbar_mismatch",
                                   "mask_bin_gap", "loss_gap", "grad_gap",
                                   "change_gap"]
