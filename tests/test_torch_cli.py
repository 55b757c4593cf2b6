"""The port's CLI and its import hygiene, in subprocesses."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_cpml_train_cpu_smoke(tmp_path):
    out = tmp_path / "m.json"
    res = run(["-m", "repro_torch.launch.cpml_train", "--device", "cpu",
               "--classes", "3", "--m", "150", "--d", "12", "--iters", "4",
               "--eval-every", "2", "--batch-rows", "16", "--drop-workers", "1",
               "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "accuracy: coded" in res.stdout and "cleartext baseline" in res.stdout
    assert out.exists()


def test_cpml_train_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    res = run(["-m", "repro_torch.launch.cpml_train", "--m", "40", "--d", "4",
               "--iters", "1"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_cpml_train_refuses_shard_backend():
    res = run(["-m", "repro_torch.launch.cpml_train", "--device", "cpu",
               "--backend", "shard"])
    assert res.returncode != 0 and "not ported" in res.stderr


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch.'))\n"
        "print('modules', n)\n")
    res = run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    res = run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
