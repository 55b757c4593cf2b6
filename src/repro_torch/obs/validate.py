"""Trace-event schema validator CLI (the CI gate for --trace-out output).

    python -m repro_torch.obs.validate run.trace.json

Exit 0 when the file parses as trace-event JSON and passes
``export.validate_chrome_trace`` (names present, known phases, numeric
timestamps, ts monotone per (pid, tid)); exit 1 with the problems printed
otherwise.
"""
from __future__ import annotations

import json
import sys

from repro_torch.obs.export import validate_chrome_trace


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.validate <trace.json>",
              file=sys.stderr)
        return 2
    try:
        with open(argv[0]) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"{argv[0]}: not readable trace JSON: {e}", file=sys.stderr)
        return 1
    errors = validate_chrome_trace(obj)
    if errors:
        for e in errors:
            print(f"{argv[0]}: {e}", file=sys.stderr)
        return 1
    n = len(obj["traceEvents"])
    pids = {e.get("pid") for e in obj["traceEvents"]}
    print(f"{argv[0]}: OK — {n} events across {len(pids)} process(es)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
