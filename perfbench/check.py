"""Readings that set a cell's limits (``limits/<cell>.json``): the
comparison's numbers for sound runs of the program, for the control and for
each planted fault, at the cell's own sizes, one process for all seeds.

    python3 perfbench/check.py --workload case1_c10 --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--accuracy-rounds 25]

Each reading is one JSON line on standard output.  The benchmark's own runs
never run this: it needs no measured window, since a training's readings
come from its first rounds.  ``--accuracy-rounds`` also trains the cell for
that many rounds and scores it against the cleartext baseline, with the
configuration's worst-case headroom (``CPMLConfig.headroom_bits``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed: int, device, kind: str) -> dict:
    """One reading: ``program``, ``control`` or a fault's name."""
    import torch

    from perfbench import cells, dataset, faults, judge
    from perfbench.run import checked_rounds, code_of, compare, prepare

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    conf, tr = cell.config, cell.traffic
    if kind == "control":
        ref = cells.reference(conf)
        code = code_of(ref, conf, tr)
        x, y = dataset.make(seed, conf["m"], conf["d"], tr["classes"],
                            tr["sparsity"], tr["margin"], device)
        out = judge.control_outputs(ref, code, x, y, seed, torch.bfloat16)
    elif kind == "program":
        prog = prepare(cell, seed, device)
        out = checked_rounds(prog, sync)
        x, y = prog.x, prog.y
        del prog
    else:
        with faults.planted(kind):
            prog = prepare(cell, seed, device)
            out = checked_rounds(prog, sync)
        x, y = prog.x, prog.y
        del prog
    numbers = compare(cell, x, y, out)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": cell.name, "kind": kind, "seed": seed,
            "correct": judge.verdict(numbers, cell.limits),
            "seconds": time.perf_counter() - t0, **numbers}


def accuracy(cell, seed: int, rounds: int, device) -> dict:
    """Coded training against the cleartext baseline after ``rounds``."""
    from perfbench import dataset
    from perfbench.run import config_of
    from repro_torch.core.protocol import engine
    from repro_torch.core.protocol.draws import TorchDraws

    conf, tr = cell.config, cell.traffic
    cfg = config_of(cell)
    x, y = dataset.make(seed, conf["m"], conf["d"], tr["classes"],
                        tr["sparsity"], tr["margin"], device)
    w, _ = engine.train(cfg, x, y, rounds, draws=TorchDraws(seed, device),
                        device=device)
    wc, xq = engine.cleartext_baseline(cfg, x, y, rounds)
    score = (engine.loss_and_accuracy if cfg.c == 1
             else engine.multiclass_loss_and_accuracy)
    return {"workload": cell.name, "kind": "accuracy", "seed": seed,
            "rounds": rounds, "acc_coded": float(score(w, xq, y)[1]),
            "acc_cleartext": float(score(wc, xq, y)[1]),
            "headroom_bits": cfg.headroom_bits(float(x.max()), x.shape[0])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--accuracy-rounds", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import cells, faults
    cell = cells.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("check.py: no CUDA device", file=sys.stderr)
        return 2
    jobs = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, f) for f in faults.NAMES for s in args.fault_seeds])
    for seed, kind in jobs:
        print(json.dumps(readings(cell, seed, device, kind)), flush=True)
    if args.accuracy_rounds:
        seed = (args.seeds or [0])[0]
        print(json.dumps(accuracy(cell, seed, args.accuracy_rounds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    run._paths()
    sys.exit(main())
