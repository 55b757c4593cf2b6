"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names."""
import ast
import json
import os
import shutil
import subprocess
import sys

from perfbench import cells, run

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_source_imports_a_banned_name():
    for path in cells.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)


def test_modules_loaded_by_a_run_are_clean():
    code = ("import sys, torch; sys.path[:0] = [%r, %r];"
            "from perfbench import run;"
            "from perfbench.tests.helpers import tiny_cell;"
            "r = run.run_cell(tiny_cell(), 1, 0.05, True, torch.device('cpu'),"
            " 0.0); assert r['correct'];"
            "print(sys.modules.keys() and run.forbidden_modules())"
            % (str(run.ROOT / "src"), str(run.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules["repro_torch_lookalike_for_test"] = sys
    try:
        assert "repro_torch_lookalike_for_test" not in run.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike_for_test"]


def test_alone_with_its_own_files_it_fails_and_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, the run finds no port and stops before any result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "case1_c10", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    assert out.stdout.strip() == ""


def test_without_a_card_it_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "case1_c10", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=run.ROOT, env=env)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"printed a result: {line}")
