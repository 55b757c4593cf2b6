"""Find a cell's pieces by the names in ``BENCHMARK.json``.

  configs:   the file the entry names (``perfbench/configs/<name>.json``),
             whose ``reference`` names the plain reference
             ``perfbench/references/<reference>.py``
  traffic:   ``perfbench/traffic/<traffic>.json``
  limits:    ``perfbench/limits/<cell>.json``, the comparison's limits
  per-layer: ``perfbench/metrics/<metric>.py``, a module with
             ``read(readings) -> float | None``

A new cell, mix or metric is new files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    here: Path = HERE               # the folder its files came from


def _one(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def load_cell(root: Path, name: str, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``here`` (the benchmark's folder)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = _one(bench["workloads"], name, "workloads")
    entry = _one(bench["configs"], wl["config"], "configs")
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m)
                 and ("workloads" in m or m["moves"] in e2e_names)]
    return Cell(name, int(wl["chips"]), config, traffic, limits, e2e,
                per_layer, here)


def reference(config: dict) -> ModuleType:
    """The plain reference the configuration names."""
    return importlib.import_module(f"perfbench.references.{config['reference']}")


def metric_reader(name: str, here: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
