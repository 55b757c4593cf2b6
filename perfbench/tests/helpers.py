"""A tiny cell for the CPU: the round of the benchmark's cells at a size
the plain CPU path runs in well under a second."""
from __future__ import annotations

import json

from perfbench import cells

TINY_CONFIG = {"reference": "cpml_round", "N": 7, "K": 2, "T": 1, "r": 1,
               "lx": 2, "lw": 4, "lc": 6, "p": 15485863, "m": 61, "d": 12}
TINY_TRAFFIC = {"classes": 3, "sparsity": 0.5, "margin": 6.0}


def tiny_cell(traffic: dict | None = None, config: dict | None = None,
              per_layer: list | None = None) -> cells.Cell:
    """The tiny cell, held to case1_c10's limits, but for the masks' bin
    gap: a tiny round draws 36 masks, 2.25 a bin, where a uniform draw's
    gap reaches 3; every mask in one bin still reads 15."""
    limits = json.loads((cells.HERE / "limits" / "case1_c10.json").read_text())
    limits["mask_bin_gap"] = 8.0
    e2e = [{"name": n, "unit": u} for n, u in
           (("round_ms", "ms"), ("round_ms_p95", "ms"), ("setup_s", "s"))]
    return cells.Cell("tiny", 1, {**TINY_CONFIG, **(config or {})},
                      {**TINY_TRAFFIC, **(traffic or {})}, limits, e2e,
                      per_layer or [])
