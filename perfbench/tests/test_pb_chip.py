"""On the card: each cell's result line as the contract reads it, from a
short run of ``run.py`` (``python3 -m pytest -q perfbench/tests``)."""
import json
import subprocess
import sys

import pytest

from perfbench import run

pytestmark = pytest.mark.perfbench_chip


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", ["case1_c10", "case2_c10"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(card, workload, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          workload, "--seed", "2147483711", "--seconds", "1",
                          "--trace", str(trace)], capture_output=True,
                         text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0
        assert 0 < line["metrics"]["coded_grad_roofline"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"round_ms", "round_ms_p95", "setup_s"}
