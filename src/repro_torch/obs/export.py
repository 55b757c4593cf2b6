"""Trace exporters: Perfetto/Chrome JSON, terminal waterfall, straggler
attribution, and the trace-event schema validator CI runs.

Chrome trace-event mapping (DESIGN.md §11): one pid per PROCESS (pid 0 is
the master; each worker process that shipped spans over the TRACE wire
field gets its own pid), one tid per TRACK within a process (the master's
own timeline, one flight lane per worker, the prefetch thread).  Because
every process stamps spans on its OWN monotonic clock, each pid's
timestamps are normalized to that process's first event — orderings are
meaningful within a pid and never across pids (the master's flight spans,
stamped on the master clock, are the cross-worker comparison surface).
"""
from __future__ import annotations

import json
import math

from repro_torch.obs.trace import MASTER_PROCESS, PH_INSTANT, PH_SPAN, Recorder

_US = 1e6                             # trace-event timestamps are in µs


def to_chrome_trace(rec: Recorder) -> dict:
    """Recorder -> Perfetto-loadable trace-event JSON object."""
    spans = [s for s in rec.spans if not (s.ph == PH_SPAN and s.open)]
    procs: list[str] = []
    tracks: dict[str, list[str]] = {}
    for s in spans:
        if s.process not in procs:
            procs.append(s.process)
        tl = tracks.setdefault(s.process, [])
        if s.track not in tl:
            tl.append(s.track)
    # stable ids: master first, then the rest by name (worker pids line up
    # with worker indices regardless of whose trace landed first)
    procs.sort(key=lambda p: (p != MASTER_PROCESS, p))
    pid_of = {p: i for i, p in enumerate(procs)}
    tid_of = {(p, t): i for p in procs
              for i, t in enumerate(sorted(tracks[p]))}
    t0 = {p: min((s.start for s in spans if s.process == p),
                 default=0.0) for p in procs}

    events: list[dict] = []
    for p in procs:
        events.append({"name": "process_name", "ph": "M", "pid": pid_of[p],
                       "tid": 0, "args": {"name": p}})
        for t in sorted(tracks[p]):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid_of[p], "tid": tid_of[(p, t)],
                           "args": {"name": t}})
    body = []
    for s in spans:
        ev = {"name": s.name, "cat": "cpml", "ph": s.ph,
              "ts": (s.start - t0[s.process]) * _US,
              "pid": pid_of[s.process], "tid": tid_of[(s.process, s.track)],
              "args": {k: _jsonable(v) for k, v in s.args.items()}}
        if s.ph == PH_SPAN:
            ev["dur"] = max(0.0, s.duration) * _US
        else:
            ev["s"] = "t"            # instant scoped to its thread
        body.append(ev)
    body.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    return {"traceEvents": events + body, "displayTimeUnit": "ms",
            "otherData": {"clock_note":
                          "per-pid monotonic clocks, normalized per process;"
                          " timestamps are comparable within a pid only"}}


def write_chrome_trace(rec: Recorder, path: str) -> dict:
    obj = to_chrome_trace(rec)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Schema check for the trace-event JSON (the CI gate): names present,
    known phases, numeric non-negative ts/dur, ts monotone per (pid, tid).
    Returns a list of problems — empty means valid."""
    errors: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a traceEvents list"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not ev.get("name"):
            errors.append(f"{where}: empty name")
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"{where}: missing pid/tid")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0 or math.isnan(ts):
            errors.append(f"{where}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0 \
                    or not math.isfinite(dur):
                errors.append(f"{where}: bad dur {dur!r}")
        key = (ev["pid"], ev["tid"])
        if ts < last_ts.get(key, -math.inf):
            errors.append(f"{where}: ts {ts} not monotone on pid/tid {key}")
        last_ts[key] = ts
    return errors


# ---------------------------------------------------------------------------
# Terminal views
# ---------------------------------------------------------------------------

def round_summaries(rec: Recorder) -> list[dict]:
    """Per-round master-side components read back from the spans: the
    reconciliation surface wait_stats is checked against (tests + the
    bench trace gate)."""
    rounds: dict[int, dict] = {}
    for s in rec.spans:
        if s.process != MASTER_PROCESS or "round" not in s.args:
            continue
        t = s.args["round"]
        if not isinstance(t, int) or t < 0:
            continue
        r = rounds.setdefault(t, {"round": t})
        if s.name in ("encode", "wait", "decode") and not s.open:
            r[s.name] = s.duration
    out = []
    for t in sorted(rounds):
        r = rounds[t]
        r.setdefault("encode", 0.0)
        r.setdefault("wait", 0.0)
        r.setdefault("decode", 0.0)
        r["critical_path"] = r["encode"] + r["wait"] + r["decode"]
        out.append(r)
    return out


def waterfall(rec: Recorder, width: int = 48, max_rounds: int = 20) -> str:
    """Fixed-width per-round waterfall: encode (#) | wait (.) | decode (%),
    scaled to the slowest round."""
    rows = round_summaries(rec)
    if not rows:
        return "(no round spans recorded)"
    shown = rows[:max_rounds]
    peak = max(r["critical_path"] for r in shown) or 1.0
    lines = [f"round  {'encode':>9} {'wait':>9} {'decode':>9}  "
             f"critical path (scaled to {peak:.3f}s)"]
    for r in shown:
        cells = ""
        for key, ch in (("encode", "#"), ("wait", "."), ("decode", "%")):
            cells += ch * max(1 if r[key] > 0 else 0,
                              round(r[key] / peak * width))
        lines.append(f"{r['round']:>5}  {r['encode']:>8.3f}s {r['wait']:>8.3f}s "
                     f"{r['decode']:>8.3f}s  |{cells}")
    if len(rows) > max_rounds:
        lines.append(f"  ... {len(rows) - max_rounds} more round(s)")
    return "\n".join(lines)


def straggler_report(traces: dict, threshold: int) -> tuple[str, dict]:
    """Post-run straggler attribution from the observed RoundTraces: per
    worker, how often it was dispatched but missed the decode set, how
    often it was excluded from dispatch outright, and the marginal wait
    attributable to it (for rounds where it WAS the threshold-th arrival:
    the gap it added over the (threshold-1)-th).
    """
    stats: dict[int, dict] = {}
    all_workers: set[int] = set()
    finite_rounds = 0
    for tr in traces.values():
        all_workers.update(int(w) for w in tr.dispatched)
    for tr in sorted(traces.values(), key=lambda r: r.round):
        # RoundTrace stamps the threshold-th arrival as t_first_R; the MPC
        # trace calls the analogous (2T+1)-th final share t_done
        t_thresh = getattr(tr, "t_first_R", None)
        if t_thresh is None:
            t_thresh = tr.t_done
        if not math.isfinite(t_thresh):
            continue
        finite_rounds += 1
        dispatched = {int(w) for w in tr.dispatched}
        order = [int(w) for w in tr.responders]
        decoded = set(order[:threshold])
        for w in sorted(all_workers):
            s = stats.setdefault(w, {"dispatched": 0, "missed_decode": 0,
                                     "excluded": 0, "marginal_wait_s": 0.0,
                                     "decisive": 0})
            if w in dispatched:
                s["dispatched"] += 1
                if w not in decoded:
                    s["missed_decode"] += 1
            else:
                s["excluded"] += 1
        if len(order) >= threshold:
            last = order[threshold - 1]
            prev_t = (tr.arrivals[order[threshold - 2]] if threshold >= 2
                      else tr.t_start)
            gap = tr.arrivals[last] - prev_t
            stats[last]["decisive"] += 1
            stats[last]["marginal_wait_s"] += max(0.0, gap)
    if not stats:
        return "(no completed rounds to attribute)", {}
    lines = [f"straggler attribution over {finite_rounds} round(s) "
             f"(threshold {threshold}):",
             f"{'worker':>6} {'dispatched':>10} {'missed-T':>9} "
             f"{'excluded':>9} {'decisive':>9} {'wait attributed':>16}"]
    for w in sorted(stats):
        s = stats[w]
        lines.append(f"{w:>6} {s['dispatched']:>10} {s['missed_decode']:>9} "
                     f"{s['excluded']:>9} {s['decisive']:>9} "
                     f"{s['marginal_wait_s']:>15.3f}s")
    worst = max(stats, key=lambda w: (stats[w]["marginal_wait_s"]
                                      + stats[w]["missed_decode"]))
    s = stats[worst]
    lines.append(f"slowest: worker {worst} — missed the decode set "
                 f"{s['missed_decode']}/{s['dispatched']} dispatched rounds, "
                 f"added {s['marginal_wait_s']:.3f}s of decisive wait")
    return "\n".join(lines), stats


def _jsonable(v):
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    return str(v)
