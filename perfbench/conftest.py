"""Pytest settings of the benchmark's own tests (``perfbench/tests``).

``perfbench_chip`` marks a test that needs the CUDA card; it skips, with
its reason, where there is none (decided inside the test, never while a
module is imported).  Run them on the card with
``python3 -m pytest -q perfbench/tests``.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "perfbench_chip: needs the CUDA card; skipped without one")
