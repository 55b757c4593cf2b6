"""The port's serving driver: greedy tokens against the reference's
``greedy_decode`` from the same parameters and prompt, and the CLI on the
CPU (the full-width run on the card is chip_smoke.py's serve phase)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from test_torch_models import JRC, RC, carried, tokens  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_greedy_tokens_equal_reference():
    jcfg, tcfg, params, model = carried("f32")
    prompt = tokens(2, 16, seed=3)
    want = np.asarray(jserve.greedy_decode(jcfg, JRC, params,
                                           jnp.asarray(prompt), 6))
    stats = {}
    got = tserve.greedy_decode(tcfg, RC, model, torch.as_tensor(prompt), 6,
                               stats=stats)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_dense_and_hybrid_greedy_tokens_equal_reference(arch):
    """A 40-token prompt: past hymba's reduced window of 32."""
    jcfg, tcfg, params, model = carried("f32", arch)
    prompt = tokens(2, 40, seed=4)
    want = np.asarray(jserve.greedy_decode(jcfg, JRC, params,
                                           jnp.asarray(prompt), 6))
    got = tserve.greedy_decode(tcfg, RC, model, torch.as_tensor(prompt), 6)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("coded", [False, True])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_cli_serves_dense_and_hybrid_on_the_cpu(arch, coded, tmp_path):
    out = tmp_path / "serve.json"
    args = ["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
            "--prompt-len", "40", "--gen", "4", "--json-out", str(out)]
    if coded:
        args += ["--coded-head", "--kill-shard", "1"]
    res = run(args)
    assert res.returncode == 0, res.stderr
    assert "generated (2, 4)" in res.stdout
    res_json = json.loads(out.read_text())
    toks = np.asarray(res_json["tokens"])
    assert toks.shape == (2, 4) and (0 <= toks).all() and (toks < 256).all()
    assert res_json["logits_finite"]
    if coded:
        assert "killed shard 1; decoding from 5 survivors" in res.stdout
        assert res_json["coded_head"]["rel_err"] < 0.1


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_moe_greedy_tokens_equal_reference(arch):
    """The reference's default einsum dispatch at capacity factor 1.25:
    the 16-token prefill's groups drop tokens, decode's never do."""
    jcfg, tcfg, params, model = carried("f32", arch)
    prompt = tokens(2, 16, seed=8)
    want = np.asarray(jserve.greedy_decode(jcfg, JRC, params,
                                           jnp.asarray(prompt), 6))
    got = tserve.greedy_decode(tcfg, RC, model, torch.as_tensor(prompt), 6)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("coded", [False, True])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_cli_serves_moe_on_the_cpu(arch, coded, tmp_path):
    out = tmp_path / "serve.json"
    args = ["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
            "--prompt-len", "24", "--gen", "4", "--json-out", str(out)]
    if coded:
        args += ["--coded-head", "--kill-shard", "2"]
    res = run(args)
    assert res.returncode == 0, res.stderr
    assert "generated (2, 4)" in res.stdout
    res_json = json.loads(out.read_text())
    toks = np.asarray(res_json["tokens"])
    assert toks.shape == (2, 4) and (0 <= toks).all() and (toks < 256).all()
    assert res_json["logits_finite"]
    if coded:
        assert "killed shard 2; decoding from 5 survivors" in res.stdout
        assert res_json["coded_head"]["rel_err"] < 0.1


@pytest.mark.parametrize("coded", [False, True])
def test_cli_on_the_cpu(coded, tmp_path):
    out = tmp_path / "serve.json"
    args = ["--device", "cpu", "--arch", "falcon-mamba-7b", "--reduced",
            "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--json-out", str(out)]
    if coded:
        args += ["--coded-head", "--kill-shard", "1"]
    res = run(args)
    assert res.returncode == 0, res.stderr
    assert "generated (2, 4)" in res.stdout
    res_json = json.loads(out.read_text())
    toks = np.asarray(res_json["tokens"])
    assert toks.shape == (2, 4) and (0 <= toks).all() and (toks < 256).all()
    if coded:
        assert "killed shard 1; decoding from 5 survivors" in res.stdout
        assert "coded head: rel err" in res.stdout
        assert res_json["coded_head"]["rel_err"] < 0.1


def test_needs_cuda_unless_cpu_is_asked_for(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    assert tserve.main(["--arch", "falcon-mamba-7b", "--reduced"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_unported_arch_exits_2_naming_its_roadmap_item(capsys):
    """whisper is ported, but like the reference's driver the CLI serves
    tokens only: it exits 2 saying that whisper needs frame embeddings
    (``greedy_decode(..., enc_embeds=...)`` serves it)."""
    assert tserve.main(["--arch", "whisper-tiny", "--reduced",
                        "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "frame embeddings" in err and "greedy_decode" in err
    assert "not ported" not in err and "ROADMAP" not in err
