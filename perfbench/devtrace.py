"""Profile a few steady rounds with ``torch.profiler`` and reduce the
trace: device busy time, device time by kernel, and the idle gaps by what
the host was doing.

The rounds run inside a ``perfbench.window`` range, each in a
``perfbench.round`` range.  The chrome trace (device and host events on
one clock, in microseconds) is written to a file and read back.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "perfbench.window"


@dataclasses.dataclass
class DeviceTrace:
    rounds: int
    window_s: float                      # the window range's length
    busy_s: float                        # union of device activity in it
    op_s: dict[str, float]               # device seconds by short name
    gap_s: dict[str, float]              # idle seconds by the host's event

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the ops whose name holds ``pattern``."""
        return sum(s for name, s in self.op_s.items() if pattern in name)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:120] if not name.startswith("Mem") else name


def profile_rounds(step: Callable[[], None], rounds: int, path: Path,
                   sync: Callable[[], None]) -> DeviceTrace:
    """Run ``step`` ``rounds`` times under the profiler; reduce its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(rounds):
                with record_function("perfbench.round"):
                    step()
            sync()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return reduce(json.loads(path.read_text()), rounds)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(trace: dict, rounds: int) -> DeviceTrace:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError("the trace has no perfbench.window range")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev, op_s = [], collections.Counter()
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
                op_s[short_name(e["name"])] += (b - a) * 1e-6
    busy = _union(dev)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    gap_s = collections.Counter()
    edges = [w0] + [x for span in busy for x in span] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [h for h in host if h[0] <= mid <= h[1]]
        what = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host"
        gap_s[what] += (b - a) * 1e-6
    return DeviceTrace(rounds, (w1 - w0) * 1e-6,
                       sum(b - a for a, b in busy) * 1e-6, dict(op_s),
                       dict(gap_s))


def breakdown(tr: DeviceTrace) -> dict[str, list]:
    """The ten device ops that took most time and the ten largest idle
    shares by the host's event, in seconds over the traced window."""
    def top(d: dict[str, float]) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(tr.op_s), "idle_gaps": top(tr.gap_s)}
