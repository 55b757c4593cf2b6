"""The port's CLI and its import hygiene, in subprocesses."""
import json
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
        "for m in ('cluster.runner', 'cluster.socket_transport',\n"
        "          'launch.cpml_worker', 'launch.cpml_cluster',\n"
        "          'obs.export', 'runtime.resilience', 'cluster.serve',\n"
        "          'cluster.alcc_mlp', 'core.alcc',\n"
        "          'core.protocol.alcc_engine', 'launch.cpml_serve'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "n = sum(1 for k in sys.modules if k.startswith('repro_torch.'))\n"
        "print('modules', n)\n")
    res = run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 68


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    res = run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


CLUSTER_SMALL = ["--device", "cpu", "--m", "200", "--d", "12", "--iters", "4"]


@pytest.mark.parametrize("flags,item", [
    (["--engine", "alcc", "--pipeline", "full"], "exact-engine only"),
    (["--model", "mlp"], "needs --engine alcc"),
])
def test_cpml_cluster_refuses_unported_flags(flags, item):
    """``--engine alcc`` and ``--model mlp`` refuse what the reference
    refuses, in its words."""
    res = run(["-m", "repro_torch.launch.cpml_cluster", *CLUSTER_SMALL,
               *flags])
    assert res.returncode == 2
    assert item in res.stderr
    assert "not ported" not in res.stderr


@pytest.mark.parametrize("transport", ["inprocess", "socket"])
def test_cpml_cluster_sharded_masters_cpu_smoke(tmp_path, transport):
    """``--masters 2``: bit-identical to train_reference over the observed
    responder trace, the group's line printed and its stats in the JSON."""
    out = tmp_path / "m.json"
    res = run(["-m", "repro_torch.launch.cpml_cluster", *CLUSTER_SMALL,
               "--masters", "2", "--pipeline", "full", "--transport",
               transport, "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert ("bit-identical to train_reference over the observed "
            "responder trace: True") in res.stdout
    assert "sharded masters x2: per-master critical path" in res.stdout
    got = json.loads(out.read_text())
    assert got["config"]["masters"] == 2 and got["bit_identical"] is True
    g = got["wait_stats"]["masters"]
    assert g["size"] == 2 and g["critical_path_s"] > 0


@pytest.mark.parametrize("flags", [
    ["--engine", "alcc", "--latency", "lognormal"],
    ["--engine", "alcc", "--model", "mlp", "--classes", "4", "--hidden", "8"],
])
def test_cpml_cluster_alcc_cpu_smoke(tmp_path, flags):
    """In process on the CPU: bit-identical to the port's replay, the
    decode's conditioning printed, the JSON on the CPU."""
    out = tmp_path / "a.json"
    res = run(["-m", "repro_torch.launch.cpml_cluster", *CLUSTER_SMALL,
               *flags, "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "bit-identical to train_reference over the observed " \
           "responder trace: True" in res.stdout
    assert "alcc decode: cond p95" in res.stdout
    got = json.loads(out.read_text())
    assert got["bit_identical"] is True and got["device"] == "cpu"
    assert got["config"]["engine"] == "alcc"
    assert got["launches_run"] == {"modmatmul": 0, "coded_grad": 0,
                                   "selective_scan": 0,
                                   "selective_scan_bwd": 0}


def test_cpml_serve_cpu_smoke(tmp_path):
    """In process on the CPU, open loop: every flush bit-identical to the
    oracle, latencies under both policies, the JSON on the CPU."""
    out = tmp_path / "s.json"
    res = run(["-m", "repro_torch.launch.cpml_serve", "--device", "cpu",
               "--d", "16", "--queries", "24", "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "bit-identical to the uncoded plaintext oracle: True" in res.stdout
    assert "latency wait-for-all" in res.stdout
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["stats"]["queries"] == 24
    assert got["stats"]["oracle"]["checked"] == got["stats"]["rounds"] > 0


def test_cpml_cluster_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for module, extra in (
            ("repro_torch.launch.cpml_cluster", []),
            ("repro_torch.launch.cpml_cluster", ["--protocol", "mpc"]),
            ("repro_torch.launch.cpml_cluster", ["--resilient"]),
            ("repro_torch.launch.cpml_cluster", ["--engine", "alcc"]),
            ("repro_torch.launch.cpml_cluster", ["--engine", "alcc",
                                                 "--model", "mlp"]),
            ("repro_torch.launch.cpml_serve", []),
            ("repro_torch.launch.cpml_worker", ["--port", "1", "--worker",
                                                "0"])):
        res = run(["-m", module, *extra])
        assert res.returncode == 2, (module, res.stderr)
        assert "CUDA is not available" in res.stderr


@pytest.mark.parametrize("latency,pipeline", [("lognormal", "full"),
                                              ("dead", "off")])
def test_cpml_cluster_inprocess_cpu_smoke(tmp_path, latency, pipeline):
    out = tmp_path / "c.json"
    res = run(["-m", "repro_torch.launch.cpml_cluster", *CLUSTER_SMALL,
               "--latency", latency, "--pipeline", pipeline,
               "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "bit-identical to train_reference over the observed " \
           "responder trace: True" in res.stdout
    res_json = json.loads(out.read_text())
    assert res_json["bit_identical"] is True
    assert res_json["device"] == "cpu"


@pytest.mark.slow
def test_cpml_cluster_socket_cpu_smoke(tmp_path):
    """N=5 worker processes on the CPU, worker 4 killed at round 2 and
    worker 1 straggling: every live worker reports the CPU and the rounds
    it answered, and the run is bit-identical to train_reference."""
    out = tmp_path / "s.json"
    res = run(["-m", "repro_torch.launch.cpml_cluster", *CLUSTER_SMALL,
               "-N", "5", "-K", "1", "--transport", "socket",
               "--pipeline", "full", "--kill-worker", "4",
               "--kill-at-round", "2", "--straggle-worker", "1",
               "--straggle-sleep", "0.05", "--json-out", str(out)])
    assert res.returncode == 0, res.stderr
    got = json.loads(out.read_text())
    assert got["bit_identical"] is True
    reports = {r["worker"]: r for r in got["worker_reports"]}
    assert sorted(reports) == list(range(5))
    assert reports[4]["exit"] == "die_at_round 2"
    for w in range(4):
        assert reports[w]["device"] == "cpu"
        assert reports[w]["exit"] in ("shutdown", "hangup")
        assert reports[w]["rounds"] >= 1
        # the plain version on the CPU: no kernel launch, warm-up or round
        for counts in (reports[w]["launches"], reports[w]["warmup_launches"]):
            assert set(counts) == {"coded_grad", "modmatmul",
                                   "selective_scan", "selective_scan_bwd"}
            assert set(counts.values()) == {0}

