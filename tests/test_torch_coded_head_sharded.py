"""``coded_head_apply_sharded``: one share of the coded LM head a rank, 6
gloo ranks on the CPU at N = 6, K = 4, T = 1 (d = 32, vocab 64, batch 4).

The reference's shares and quantized h go to the ranks as numpy arrays.
On every rank, with and without a killed shard, the decoded field values
are bit-equal to the reference's ``coded_head_apply`` pieces and the logits
to its ``coded_head_apply`` and to the port's one-process head.  The group
ends with one rank raising, which the launcher must turn into the run's
failure; rank 0 saved what every rank computed before that.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro.core import coded_linear as jcl  # noqa: E402
from repro.core import lagrange as jlag  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

N, K, T = 6, 4, 1
D, V, M = 32, 64, 4
SURVIVORS = {"all": None, "shard2_killed": (0, 1, 3, 4, 5)}
FAIL_RANK = 3


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    cfg = dict(N=N, K=K, T=T, lh=7, lw=7)
    jcfg = jcl.CodedLinearConfig(**cfg)
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((D, V)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((M, D)) * 0.5).astype(np.float32)
    shares = np.asarray(jcl.encode_weights(jcfg, jax.random.PRNGKey(3),
                                           jnp.asarray(w)))
    want = {}
    hq = jq.quantize_data(jnp.asarray(h), jcfg.lh, jcfg.p)
    for name, surv in SURVIVORS.items():
        s = np.arange(N) if surv is None else np.asarray(surv)
        used = s[: jcfg.threshold]
        res = jax.vmap(lambda ws: jcl.worker_matmul(jcfg, hq, ws))(
            jnp.asarray(shares)[jnp.asarray(used)])
        dec = np.asarray(jlag.decode(jcfg.scheme, res, used, deg_f=1,
                                     p=jcfg.p))
        want[name] = dict(
            used=used, field=dec.transpose(1, 0, 2).reshape(M, -1),
            logits=np.asarray(jcl.coded_head_apply(
                jcfg, jnp.asarray(h), jnp.asarray(shares), survivors=s)))
    out = tmp_path_factory.mktemp("head") / "ranks.pkl"
    job = dict(cfg=cfg, h=h, shares=shares, survivors=SURVIVORS,
               out=str(out), fail_rank=FAIL_RANK)
    with pytest.raises(tmesh.RankFailure) as failure:
        tmesh.run_ranks(ranks.head_rank, N, (job,), device="cpu",
                        timeout=300)
    with open(out, "rb") as f:
        got = pickle.load(f)
    return got, want, failure.value


@pytest.mark.parametrize("case", list(SURVIVORS))
def test_field_values_bit_equal_to_reference(group, case):
    got, want, _ = group
    assert len(got) == N
    for every in got:
        g = every[case]
        assert np.array_equal(g["used"], want[case]["used"])
        assert g["field"].dtype == np.int32
        assert np.array_equal(g["field"], want[case]["field"])
        assert np.array_equal(g["logits"], want[case]["logits"])


@pytest.mark.parametrize("case", list(SURVIVORS))
def test_logits_equal_the_one_process_head(group, case):
    got, _, _ = group
    for every in got:
        assert np.array_equal(every[case]["logits"],
                              every[case]["one_process"])
        # the plain version on CPU tensors: no kernel launched
        assert set(every[case]["launches"].values()) == {0}


def test_launcher_fails_the_run_when_one_rank_raises(group):
    *_, failure = group
    assert f"rank {FAIL_RANK} of {N} failed" in str(failure)
    assert "fails on purpose" in str(failure)
