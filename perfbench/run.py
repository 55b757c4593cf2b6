"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start): import torch, load
the port's ``coded_grad`` and ``modmatmul`` kernels from their build cache
inside the checkout, make the dataset on the card from the seed, run
``engine.setup`` (quantize, dataset masks, encode), ``engine.lipschitz_eta``
and ``engine.make_schedule``, then the first rounds through the window's own
call: the three that the reference checks, and one more.

The window drives ``engine.round_fn``'s ``run`` for ``--seconds``: one
training, its rounds back to back, each ended by a synchronise and timed
on the host clock.  With ``--trace 0`` the line holds the end-to-end
metrics; with ``--trace 1`` the per-layer ones (``metrics/*.py``), read
from spans around the program's calls (the round's call, the draws behind
the ``draws=`` seam, ``compute.TIMES``) and from ``torch.profiler`` over a
short steady run of rounds after the window.

After the window: the peak memory, then the comparison with the plain
reference (``judge.py``), each number printed beside its limit on standard
error and in the line's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM = 1              # rounds after the checked ones, before the window
PROFILED = 200        # rounds under the profiler in a traced run


def _paths() -> None:
    """Import the benchmark as ``perfbench`` and the port from ``src``,
    never a module of the benchmark's folder by its bare name."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(OUT / "cache" / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Readings:
    """What a traced run hands the per-layer metrics' readers."""
    code: object                  # the reference's Code (shapes)
    d: int                        # features
    rows: int                     # rows a share the worker step reads
    round_s: list[float]          # each round, synchronised (host clock)
    host_ms: list[float]          # the call of run to its return
    draws_ms: list[float]         # inside TorchDraws.round, a round
    worker_ms: list[float]        # compute.TIMES marks, a round
    window_s: float               # the instrumented window
    device: object | None         # devtrace.DeviceTrace of the profiled rounds


class DrawsTimer:
    """The program's draws behind the ``draws=`` seam, with the host ms
    spent inside each ``round`` call."""

    def __init__(self, inner):
        self.inner = inner
        self.ms: list[float] = []

    def round(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.inner.round(*args, **kwargs)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Capture:
    """Copies of what the program's round produced, while entered: the
    weight shares and worker results (``compute.all_worker_results``) and
    the decoded parts (``decode.decode_parts``)."""

    def __init__(self):
        from repro_torch.core.protocol import compute, decode
        self.compute, self.decode = compute, decode
        self.rounds: list[dict] = []

    def __enter__(self):
        awr, dp = self.compute.all_worker_results, self.decode.decode_parts
        self._orig = (awr, dp)

        def workers(cfg, cbar, x, w):
            res = awr(cfg, cbar, x, w)
            self.rounds.append({"w_shares": w.clone(), "results": res.clone()})
            return res

        def parts(cfg, results, dmat):
            out = dp(cfg, results, dmat)
            self.rounds[-1]["parts"] = out.clone()
            return out

        self.compute.all_worker_results = workers
        self.decode.decode_parts = parts
        return self

    def __exit__(self, *exc):
        self.compute.all_worker_results, self.decode.decode_parts = self._orig


@dataclasses.dataclass
class Program:
    """One training of the port, set up for a cell."""
    cfg: object
    state: object
    run: object
    draws: object
    dmat: object
    order: object
    w2: object
    t: int
    x: object
    y: object

    def step(self) -> None:
        self.w2 = self.run(self.t, self.w2, self.dmat, self.order)
        self.t += 1


def config_of(cell):
    """The program's ``CPMLConfig`` for a cell."""
    from repro_torch.core.protocol.config import CPMLConfig
    conf, tr = cell.config, cell.traffic
    return CPMLConfig(N=conf["N"], K=conf["K"], T=conf["T"], r=conf["r"],
                      c=tr["classes"], lx=conf["lx"], lw=conf["lw"],
                      lc=conf["lc"], p=conf["p"])


def code_of(ref, config: dict, traffic: dict):
    return ref.Code(N=config["N"], K=config["K"], T=config["T"],
                    r=config["r"], c=traffic["classes"], lx=config["lx"],
                    lw=config["lw"], lc=config["lc"], p=config["p"])


def prepare(cell, seed: int, device, timed_draws: bool = False,
            marks: list | None = None) -> Program:
    """Dataset, ``engine.setup``, step size and schedule: the program's
    set-up for this cell, before any round.  ``marks`` gets (stage, host
    clock) after each stage, the device synchronised."""
    import torch

    from perfbench import dataset
    from repro_torch.core.protocol import engine
    from repro_torch.core.protocol.draws import TorchDraws

    conf, tr = cell.config, cell.traffic
    cfg = config_of(cell)

    def mark(stage: str) -> None:
        if marks is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append((stage, time.perf_counter()))

    x, y = dataset.make(seed, conf["m"], conf["d"], tr["classes"],
                        tr["sparsity"], tr["margin"], device)
    mark("dataset")
    draws = TorchDraws(seed, device)
    if timed_draws:
        draws = DrawsTimer(draws)
    state = engine.setup(cfg, x, y, draws=draws)
    mark("engine.setup")
    eta = engine.lipschitz_eta(state.xq_real)
    mark("lipschitz_eta")
    sched = engine.make_schedule(cfg, draws, 1, state.mk, None, device)
    mark("make_schedule")
    w2 = state.w if state.w.ndim == 2 else state.w[:, None]
    return Program(cfg, state, engine.round_fn(cfg, state, eta, draws), draws,
                   sched.decode_mats[0], sched.orders[0], w2, 0, x, y)


def checked_rounds(prog: Program, sync) -> object:
    """The first rounds, through the window's own call, with copies of
    what each produced for the comparison."""
    from perfbench import judge
    weights = [prog.w2.clone()]
    with Capture() as cap:
        for _ in range(judge.CHECKED):
            prog.step()
            weights.append(prog.w2.clone())
    sync()
    return judge.ProgramOutputs(prog.state.x_shares, cap.rounds, weights)


def compare(cell, x, y, outputs) -> dict[str, float]:
    """The comparison's numbers for one run's outputs."""
    from perfbench import cells, judge
    ref = cells.reference(cell.config)
    return judge.judge(ref, code_of(ref, cell.config, cell.traffic), x, y,
                       outputs)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set up, warm, measure and check one run; the result line's fields
    (without ``device``'s name and count)."""
    import numpy as np
    import torch

    from perfbench import cells, devtrace, judge
    from repro_torch.core.protocol import compute
    from repro_torch.kernels import build

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.cuda.init()
        marks.append(("cuda init", time.perf_counter()))
        build.library("coded_grad")
        build.library("modmatmul")
        marks.append(("kernels", time.perf_counter()))
    prog = prepare(cell, seed, device, timed_draws=trace, marks=marks)
    outputs = checked_rounds(prog, sync)
    marks.append(("checked rounds", time.perf_counter()))
    for _ in range(WARM):
        prog.step()
    if trace and on_card:           # start the profiler's tracing once
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            prog.step()
            sync()
    sync()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm", setup_s + t_start))
    stages = [(name, b - a) for (name, b), (_, a)
              in zip(marks, [("start", t_start)] + marks)]
    print("setup stages s: " + ", ".join(f"{n} {s:.3f}" for n, s in stages),
          file=sys.stderr)

    round_s, host_ms = [], []
    if trace:
        prog.draws.ms.clear()
        compute.TIMES = worker_marks = []
    try:
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            prog.step()
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            round_s.append(t2 - t0)
            host_ms.append((t1 - t0) * 1e3)
            if t2 - start >= seconds:
                break
        window_s = t2 - start
    finally:
        compute.TIMES = None
    rounds = len(round_s)
    result: dict = {"attempted": judge.CHECKED + WARM + rounds}
    if trace:
        draws_ms = list(prog.draws.ms)
        worker = [compute.marks_ms(m)[0] for m in worker_marks]
        dtrace = None
        if on_card:
            OUT.mkdir(parents=True, exist_ok=True)
            dtrace = devtrace.profile_rounds(
                prog.step, PROFILED,
                OUT / f"{cell.name}.{seed}.trace.json", sync)
            result["attempted"] += PROFILED
        ref = cells.reference(cell.config)
        readings = Readings(code_of(ref, cell.config, cell.traffic),
                            cell.config["d"], int(prog.state.mk), round_s,
                            host_ms, draws_ms, worker, window_s, dtrace)
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], cell.here)(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if dtrace is not None:
            result["busy_s"] = dtrace.busy_s
            result["window_s"] = dtrace.window_s
            result["breakdown"] = devtrace.breakdown(dtrace)
    else:
        e2e = {"round_ms": window_s / rounds * 1e3,
               "round_ms_p95": float(np.percentile(round_s, 95)) * 1e3,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{cell.name}.{seed}.t{int(trace)}.rounds.json").write_text(
        json.dumps({"round_ms": [s * 1e3 for s in round_s],
                    "host_ms": host_ms}))
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if on_card else 0)

    # the program's state goes; what it produced stays to be judged
    x, y = prog.x, prog.y
    del prog
    if on_card:
        torch.cuda.empty_cache()
    numbers = compare(cell, x, y, outputs)
    correct = judge.verdict(numbers, cell.limits)
    result["correct"] = correct
    result["failed"] = 0 if correct else judge.CHECKED
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in judge.NUMBERS}
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    _caches()
    from perfbench import cells
    cell = cells.load_cell(ROOT, args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        print(f"perfbench: the port repro_torch is not under {ROOT / 'src'}",
              file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = res["busy_s"]
        dev["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": dev}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
