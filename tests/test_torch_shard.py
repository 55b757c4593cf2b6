"""The shard backend (``CPMLConfig(backend="shard")``): one coded share a
rank over ``torch.distributed``, 8 gloo ranks on the CPU.

One 8-rank group (``torch_shard_ranks.protocol_rank``) runs every case
once; the tests read what its ranks returned.

  * port against port: at N = 8 the shard backend's weights are bit-equal
    to the vmap backend's (run in the same rank) and on every rank, for c
    = 1, c = 3 with ``batch_rows``, r = 2 (K = 1: threshold 6) and a
    dropped worker a round, through ``train`` and ``train_reference``
    (the reference's ``tests/test_system.py`` shard test);
  * port against the reference: with the reference's draws recorded here
    and replayed in the ranks, every round's shares, gathered worker
    results and decoded parts are bit-equal to the reference's vmap
    backend, and free-running weights within ``W_ATOL_TRAIN``;
  * the SPMD seam (``parallel/compat.py``) and ``compat_make_mesh`` on the
    ranks, and the launcher's backend rule.
"""
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro.core import field as jf  # noqa: E402
from repro.core import protocol as jp  # noqa: E402
from repro.core.protocol import compute as jcompute  # noqa: E402
from repro.core.protocol import decode as jdecode  # noqa: E402
from repro.core.protocol import encode as jencode  # noqa: E402
from repro.core.protocol import engine as je  # noqa: E402
from repro_torch.core import protocol as tp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import compat  # noqa: E402
from test_torch_protocol import (W_ATOL_TRAIN, JaxDraws, configs,  # noqa: E402
                                 rolled)

WORLD = 8
ITERS = 3
PORT_CASES = {
    "c1_full": dict(cfg=dict(N=8, K=2, T=1), m=200, d=16, drop=0),
    "c3_batch_rows": dict(cfg=dict(N=8, K=2, T=1, c=3, batch_rows=24),
                          m=240, d=24, drop=0),
    "r2_k1": dict(cfg=dict(N=8, K=1, T=1, r=2, p=jf.P30), m=150, d=12,
                  drop=0),
    "c1_drop1": dict(cfg=dict(N=8, K=2, T=1), m=200, d=16, drop=1),
}
REFERENCE_CASES = {
    "binary": dict(cfg=dict(N=8, K=2, T=1), m=131, d=12, drop=0),
    "multiclass_batch_drop": dict(cfg=dict(N=8, K=2, T=1, c=3,
                                           batch_rows=16),
                                  m=131, d=12, drop=1),
}
ETA = 1.5


def data(c, m, d):
    if c == 1:
        return tsyn.mnist_like(2, m, d, margin=12.0)
    return tsyn.multiclass_mnist_like(2, m, d, c)


def _reference_round(cj, key_t, w2, x_shares, xq_parts, y_parts, xty, m,
                     cbar, order, dmat, bidx):
    """One round of the reference's vmap backend, piece by piece."""
    shares = jencode.encode_weights(cj, key_t, w2)
    xb = x_shares if bidx is None else jnp.take(x_shares, bidx, axis=1)
    results = jcompute.all_worker_results(cj, cbar, xb, shares)
    fastest = jnp.take(results, order, axis=0)
    parts = jdecode.decode_parts(cj, fastest, dmat)
    w2 = je._round_update(cj, w2, fastest, xq_parts, y_parts, xty, dmat,
                          bidx, jnp.float32(ETA), m)
    return shares, results, parts, w2


_reference_round_jit = jax.jit(_reference_round, static_argnums=0)


def reference_rounds(cj, draws, state, sfn):
    """ITERS reference rounds: each round's (w2 in, order, decode matrix,
    batch) and (shares, results, parts), and the weights after the last:
    the reference's ``train_reference``, its round composed of the same
    pieces."""
    w2 = je._w_internal(cj, state.w)
    cbar = jnp.asarray(je.poly_coeffs(cj))
    inputs, outputs = [], []
    for t in range(ITERS):
        dmat, order = je.survivor_round(cj, None if sfn is None else sfn(t))
        bidx = None
        if cj.batch_rows is not None:
            bidx = je.draw_batch(cj, draws.kloop, ITERS, state.mk, t)
        inputs.append((np.array(w2), np.asarray(order), np.asarray(dmat),
                       None if bidx is None else np.array(bidx)))
        *out, w2 = _reference_round_jit(
            cj, je.round_key(draws.kloop, t), w2, state.x_shares,
            state.xq_parts, state.y_parts, je._w_internal(cj, state.xty),
            jnp.int32(state.m), cbar, jnp.asarray(order), jnp.asarray(dmat),
            bidx)
        outputs.append(tuple(np.array(a) for a in out))
    return inputs, outputs, np.array(je._w_public(cj, w2))


@pytest.fixture(scope="module")
def group():
    """Build every case's inputs (the reference's here, with JAX), run the
    8 ranks once, and hand the tests the ranks' results and the
    references."""
    port = {}
    for name, spec in PORT_CASES.items():
        x, y = data(spec["cfg"].get("c", 1), spec["m"], spec["d"])
        port[name] = dict(cfg=spec["cfg"], x=x, y=y, iters=ITERS, eta=ETA,
                          drop=spec["drop"], seed=11)
    reference, want = {}, {}
    for name, spec in REFERENCE_CASES.items():
        cj, ct = configs(**spec["cfg"])
        x, y = data(ct.c, spec["m"], spec["d"])
        jd = JaxDraws(cj, jax.random.PRNGKey(7), ITERS)
        state = jp.setup(cj, jd.ksetup, jnp.asarray(x), jnp.asarray(y))
        sfn = rolled(ct.N, spec["drop"]) if spec["drop"] else None
        inputs, outputs, w_free = reference_rounds(cj, jd, state, sfn)
        cfg_kw = {k: v for k, v in dataclasses.asdict(ct).items()
                  if k not in ("backend", "mesh_axis")}
        reference[name] = dict(
            cfg=cfg_kw, x=x, y=y, iters=ITERS, eta=ETA, drop=spec["drop"],
            rounds=inputs,
            draws=ranks.RecordedDraws(jd, ct.T, state.mk, spec["d"], ct.p,
                                      (spec["d"], ct.c, ct.r), ITERS,
                                      ct.batch_rows))
        want[name] = dict(x_shares=np.array(state.x_shares), rounds=outputs,
                          w=w_free)
    job = dict(port=port, reference=reference,
               draws=dict(seed=3, cfg_kw=dict(N=8, K=2, T=1, c=3), mk=20,
                          d=6))
    run = tmesh.run_ranks(ranks.protocol_rank, WORLD, (job,), device="cpu",
                          timeout=300)
    return run, want


def test_ranks_run_over_gloo_on_the_cpu(group):
    run, _ = group
    assert run.backend == "gloo" and len(run.results) == WORLD
    assert run.startup_s > 0


def test_draws_are_identical_on_every_rank(group):
    run, _ = group
    assert len({r["draws_sha"] for r in run.results}) == 1


@pytest.mark.parametrize("case", list(PORT_CASES))
@pytest.mark.parametrize("driver", ["train", "train_reference"])
def test_shard_weights_bit_equal_to_vmap_on_every_rank(group, case, driver):
    run, _ = group
    w_vmap, hist_vmap = run.results[0]["port"][case][f"vmap_{driver}"]
    for r in run.results:
        w, hist = r["port"][case][f"shard_{driver}"]
        assert np.array_equal(w, w_vmap), r
        assert hist == hist_vmap
    # train (the loop over _round) == train_reference (the round_fn hook)
    w_other, _ = run.results[0]["port"][case]["shard_train_reference"
                                              if driver == "train"
                                              else "shard_train"]
    assert np.array_equal(w_vmap, w_other)


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_rounds_bit_equal_to_reference_vmap_backend(group, case):
    """Shares, all N gathered worker results and the decoded parts of
    every round, on every rank, from the reference's draws and w2."""
    run, want = group
    for r in run.results:
        got = r["reference"][case]
        assert np.array_equal(got["x_shares"], want[case]["x_shares"])
        for t, (g, w) in enumerate(zip(got["rounds"], want[case]["rounds"])):
            for name, a, b in zip(("shares", "results", "parts"), g, w):
                assert np.array_equal(a, b), (t, name)


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_free_running_weights_match_reference(group, case):
    run, want = group
    w0 = run.results[0]["reference"][case]["w"]
    np.testing.assert_allclose(w0, want[case]["w"], rtol=0, atol=W_ATOL_TRAIN)
    for r in run.results:
        assert np.array_equal(r["reference"][case]["w"], w0)


def test_shard_map_blocks_and_axis_index(group):
    run, _ = group
    x = np.arange(2 * WORLD * 3).reshape(2 * WORLD, 3)
    for rank, r in enumerate(run.results):
        u = r["compat"]
        assert u["index"] == rank
        assert np.array_equal(u["rows"], x[2 * rank: 2 * rank + 2])
        assert np.array_equal(u["cols"], x.T[:, 2 * rank: 2 * rank + 2])
        assert np.array_equal(u["full"], x)
        assert np.array_equal(u["returned"], x[2 * rank: 2 * rank + 2])
        assert u["index2"] == (rank // 4, rank % 4)


@pytest.mark.parametrize("tiled", [False, True])
def test_all_gather_stacked_and_tiled(group, tiled):
    run, _ = group
    rows = np.array([[k, 10 * k] for k in range(WORLD)])
    for rank, r in enumerate(run.results):
        u = r["compat"]
        if tiled:                                    # (1, 2) -> (1, 16)
            assert np.array_equal(u["tiled"], rows.reshape(1, -1))
        else:                                        # (1, 2) -> (8, 1, 2)
            assert np.array_equal(u["stacked"], rows[:, None, :])
        row = rank // 4                              # the 2 x 4 mesh
        assert np.array_equal(u["gather2"],                # stacked (4, 1)
                              np.arange(4 * row, 4 * row + 4)[:, None])


@pytest.mark.parametrize("refusal,match", [
    ("mesh_size", "the world has 8"),
    ("axis_not_n", "size N=8, got 4"),
    ("uneven", "does not split into 8 blocks"),
])
def test_refusals_on_the_ranks(group, refusal, match):
    run, _ = group
    for r in run.results:
        assert match in r["compat"]["errors"][refusal]


def test_shard_map_refuses_a_sharded_output():
    with pytest.raises(ValueError, match="replicated"):
        compat.shard_map(lambda a: a, None, (("workers",),), ("workers",))


def test_ambient_mesh_raises_without_a_mesh():
    with pytest.raises(RuntimeError, match="no active mesh"):
        compat.ambient_mesh()
    cfg = tp.CPMLConfig(N=8, K=2, T=1, backend="shard")
    with pytest.raises(RuntimeError, match="no active mesh"):
        tp.all_worker_results(cfg, torch.zeros(2, dtype=torch.int32),
                              torch.zeros((8, 2, 3), dtype=torch.int32),
                              torch.zeros((8, 3, 1, 1), dtype=torch.int32))


@pytest.mark.parametrize("world,cards,device,want", [
    (8, 0, "cpu", "gloo"),
    # ranks share the one card: gloo for host tensors, the host-staged
    # backend for CUDA ones (the case keeps its id)
    pytest.param(8, 1, "cuda", "cpu:gloo,cuda:staged", id="8-1-cuda-gloo"),
    (1, 1, "cuda", "nccl"),
    (4, 4, "cuda", "nccl"),
    (4, 4, "cpu", "gloo"),
])
def test_backend_rule(monkeypatch, world, cards, device, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tmesh.backend_for(world, device) == want


def test_plain_tensor_path_never_imports_dtensor():
    """The shard backend's path on plain tensors (the mesh, ``shard_map``,
    the gather, ``rules.is_dtensor``, the optimizer's norm) never imports
    ``torch.distributed.tensor``: that import takes seconds a process where
    ranks share the host's cores, and it had made each rank's first round
    the slowest.  Checked in a fresh one-rank process."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import os, sys, tempfile
        import torch
        import torch.distributed as dist
        from repro_torch.launch import mesh as tmesh
        from repro_torch.optim import optimizers
        from repro_torch.parallel import compat, rules

        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
        m = tmesh.compat_make_mesh((1,), ("workers",))
        x = torch.arange(6.0).reshape(2, 3)
        f = compat.shard_map(
            lambda b: compat.all_gather(b, "workers", tiled=True), m,
            (("workers", None),), ())
        assert torch.equal(f(x), x)
        assert not rules.is_dtensor(x)
        optimizers.global_norm({"w": x})
        before = "torch.distributed.tensor" in sys.modules
        from torch.distributed.tensor import distribute_tensor, Replicate
        d = distribute_tensor(x, m, [Replicate()])
        print(before, rules.is_dtensor(d), rules.is_dtensor(x))
        dist.destroy_process_group()
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True", "False"]
