"""Prefill and decode over a mesh of ranks on the CPU, and the cell inputs
that place them (``configs/registry.py: input_specs``), against the
reference and the one-process port.

``input_specs`` is held leaf by leaf (shape, dtype, spec) against the
reference's on ``jax.sharding.AbstractMesh``, for every arch of the
registry, each shape kind and meshes (2, 2), (1, 4) and (4, 1).

One group of 4 gloo ranks (``torch_serve_ranks.serve_rank``) runs every
serving case once: a float32 prefill into a placed cache, 3 decode steps
teacher-forced on the case's tokens, a step from a fresh placed cache
(``init_cache(mesh=)``, where every rank but slot 0's holds only empty
slots) and, where the case says, ``serve.greedy_decode``.  The cases
cover every block kind (dense, sliding-window ring, hybrid, mamba, MoE
einsum and sort, whisper's ``dec``) on the three meshes, with cache
lengths that split over the model axis (the sequence-sharded layout) and
ones that do not (the kv heads over ``model``, or replicated).

Tolerances: every logit and cache leaf within 1e-5 of its largest of the
one-process port's (float32, sums split over ranks in another order) and
within ``F32_ATOL`` (1e-3) of the reference's ``prefill`` and
``decode_step`` from the same parameters (``reference_tree``)."""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch_serve_ranks as ranks  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import rules as trules  # noqa: E402
from test_torch_models import F32_ATOL, JRC, RC  # noqa: E402
from test_torch_sharding import DuckMesh  # noqa: E402
from test_torch_sharding_moe import reference_tree  # noqa: E402
from test_torch_whisper import ref_enc_out  # noqa: E402
from torch_lm_ranks import MESHES  # noqa: E402

WORLD = 4
SHARDED_REL = 1e-5
B, STEPS, SEED = 4, 3, 3


def _case(arch, mesh, prompt, cache_len, **kw):
    return dict(arch=arch, mesh=mesh, prompt=prompt, cache_len=cache_len,
                batch=B, steps=STEPS, seed=SEED, **kw)


# cache lengths: 32, 48 and 16 split over every model axis (the sequence
# sharded); 27 over neither 2 nor 4 (tinyllama's 2 kv heads over model 2),
# 46 over 2 only (hymba's 1 kv head: replicated over 4), 30 (arctic's 2 kv
# heads over 4: replicated), 17 (whisper's 6 kv heads over model 2).  At
# 32 slots over 4 ranks a rank holds 8, and tinyllama's prompt of 8 and 3
# steps leave ranks 2 and 3 empty; danube's window of 32 is a ring of 8
# slots a rank that its prompt of 40 has wrapped; the (4, 1) mesh places
# falcon-mamba's conv and ssm state by batch alone
CASES = {
    "dense_1x4_seq": _case("tinyllama-1.1b", "1x4", 8, 32, greedy=True),
    "dense_2x2_heads": _case("tinyllama-1.1b", "2x2", 8, 27),
    "ring_1x4_seq": _case("h2o-danube-3-4b", "1x4", 40, 48),
    "hybrid_2x2_seq": _case("hymba-1.5b", "2x2", 40, 48),
    "hybrid_1x4_replicated": _case("hymba-1.5b", "1x4", 40, 46),
    "mamba_1x4": _case("falcon-mamba-7b", "1x4", 8, 16),
    "mamba_4x1": _case("falcon-mamba-7b", "4x1", 8, 16),
    "moe_einsum_2x2_seq": _case("phi3.5-moe-42b-a6.6b", "2x2", 8, 16),
    "moe_sort_1x4_replicated": _case("arctic-480b", "1x4", 8, 30,
                                     rc=dict(moe_impl="sort")),
    "whisper_1x4_seq": _case("whisper-tiny", "1x4", 8, 16, greedy=True),
    "whisper_2x2_heads": _case("whisper-tiny", "2x2", 8, 17),
}


def jax_config(case):
    cfg = jreg.reduced_config(jreg.get_config(case["arch"]))
    tcfg = ranks.config(case["arch"], **case.get("cfg", {}))
    keep = ("num_heads", "num_kv_heads", "head_dim", "d_model", "vocab_size")
    return dataclasses.replace(cfg, **{k: getattr(tcfg, k) for k in keep})


def run_configs(case):
    rc = dataclasses.replace(RC, **case.get("rc", {}))
    return rc, jbase.RunConfig(**dataclasses.asdict(rc))


@pytest.fixture(scope="module")
def group():
    """The 4-rank group's results, and the one-process port's and the
    reference's runs of every case beside them."""
    job = {"rc": dataclasses.asdict(JRC), "cases": CASES}
    box: dict = {}

    def ranks_run():
        try:
            box["run"] = tmesh.run_ranks(ranks.serve_rank, WORLD, (job,),
                                         device="cpu", timeout=300)
        except BaseException as e:
            box["error"] = e

    thread = threading.Thread(target=ranks_run)
    thread.start()
    try:
        one = {name: ranks.serve_case(case, run_configs(case)[0])
               for name, case in CASES.items()}
        ref = {name: reference_case(case) for name, case in CASES.items()}
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["run"], one, ref


@functools.lru_cache(maxsize=None)
def _prefill(jcfg, jrc, cache_len):
    return jax.jit(lambda p, b: JM.prefill(jcfg, jrc, p, b, cache_len))


@functools.lru_cache(maxsize=None)
def _decode_step(jcfg, jrc):
    return jax.jit(lambda p, c, b: JM.decode_step(jcfg, jrc, p, c, b))


def reference_case(case):
    """The reference's prefill and teacher-forced decode steps from the
    same seeded parameters and inputs: each call's logits and cache."""
    tcfg = ranks.config(case["arch"], **case.get("cfg", {}))
    jcfg = jax_config(case)
    _, jrc = run_configs(case)
    model = TM.Model(tcfg, dtype=torch.float32, device="cpu",
                     seed=case["seed"])
    params = reference_tree(jcfg, model)
    ins = ranks.case_inputs(tcfg, case)
    S = case["prompt"]
    toks = jnp.asarray(ins["tokens"])
    batch, enc = {"tokens": toks[:, :S]}, {}
    if "frames" in ins:
        e = jnp.asarray(ins["frames"])
        batch["enc_embeds"] = e
        enc["enc_out"] = ref_enc_out(jcfg, jrc, params, e)
    logits, cache = _prefill(jcfg, jrc, case["cache_len"])(params, batch)
    out = {"logits": [], "cache": []}

    def record():
        out["logits"].append(np.asarray(logits))
        out["cache"].append({f"{seg}.{k}": np.asarray(v)
                             for seg, leaves in cache.items()
                             if seg != "index" for k, v in leaves.items()})

    record()
    for t in range(case["steps"]):
        logits, cache = _decode_step(jcfg, jrc)(
            params, cache, {"tokens": toks[:, S + t: S + t + 1], **enc})
        record()
    return out


def _calls(got):
    return list(zip(got["logits"], got["cache"]))


# ---------------------------------------------------------------------------
# input_specs against the reference's
# ---------------------------------------------------------------------------

def _spec(p) -> tuple:
    """A reference PartitionSpec as the port's tuple: trailing Nones
    dropped, one-axis tuples as the axis name."""
    parts = [tuple(x) if isinstance(x, (tuple, list)) and len(x) > 1 else
             (x[0] if isinstance(x, (tuple, list)) else x) for x in p]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# the registry's shape kinds, and two decode and prefill cells whose batch
# and cache length split over neither axis of 4
SPEC_SHAPES = {**{k: jbase.SHAPES[k]
                  for k in ("train_4k", "prefill_32k", "decode_32k")},
               "decode_odd": jbase.ShapeConfig("decode_odd", 30, 6, "decode"),
               "prefill_odd": jbase.ShapeConfig("prefill_odd", 30, 6,
                                                "prefill")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SPEC_SHAPES))
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_input_specs_are_the_references(arch, shape, mesh):
    d, m = MESHES[mesh]
    jshape = SPEC_SHAPES[shape]
    want = dict(_flat(jreg.input_specs(
        jreg.get_config(arch), jshape,
        AbstractMesh((d, m), ("data", "model")))))
    duck = DuckMesh({"data": d, "model": m})
    got = dict(_flat(treg.input_specs(
        treg.get_config(arch), tbase.ShapeConfig(**dataclasses.asdict(
            jshape)), duck)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        assert g.spec == _spec(w.sharding.spec), (k, g.spec,
                                                  w.sharding.spec)
        assert g.placements == trules.placements(duck, g.spec), k


def test_input_specs_shard_the_decode_cache_on_its_sequence():
    """The reference's long-context decode rule: hymba's cache sequence
    over ``model``, its conv and ssm by ``inner``, the index replicated."""
    spec = treg.input_specs(treg.get_config("hymba-1.5b"),
                            tbase.SHAPES["decode_32k"],
                            DuckMesh({"data": 2, "model": 2}))
    seg = spec["cache"]["seg0"]
    assert seg["k"].spec == seg["v"].spec == (None, "data", "model")
    assert seg["conv"].spec == (None, "data", None, "model")
    assert seg["ssm"].spec == (None, "data", "model")
    assert spec["cache"]["index"].spec == ()
    assert spec["tokens"].spec == ("data",)


# ---------------------------------------------------------------------------
# serving on the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_serving_equals_one_process(group, name):
    run, one, _ = group
    got = run.results[0]["cases"][name]
    assert len(got["logits"]) == len(one[name]["logits"]) == STEPS + 2
    for call, ((lg, cg), (lw, cw)) in enumerate(zip(_calls(got),
                                                    _calls(one[name]))):
        err = float(np.abs(lg - lw).max())
        assert err <= SHARDED_REL * float(np.abs(lw).max()), (call, err)
        assert sorted(cg) == sorted(cw)
        for k, w in cw.items():
            err = float(np.abs(cg[k] - w).max())
            assert err <= SHARDED_REL * float(np.abs(w).max()), (call, k,
                                                                 err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_serving_tracks_the_reference(group, name):
    run, _, ref = group
    got = run.results[0]["cases"][name]
    # the reference's calls: the prefill and the teacher-forced steps
    calls = _calls(got)[:STEPS + 1]
    for call, ((lg, cg), (lw, cw)) in enumerate(zip(calls,
                                                    _calls(ref[name]))):
        assert float(np.abs(lg - lw).max()) < F32_ATOL, call
        assert sorted(cg) == sorted(cw)
        for k, w in cw.items():
            assert float(np.abs(cg[k] - w).max()) < F32_ATOL, (call, k)


def _block_shape(shape, placements, sizes):
    out = list(shape)
    for p, n in zip(placements, sizes):
        if p.startswith("Shard"):
            out[int(p.split("=")[1].rstrip(")"))] //= n
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_cache_stays_placed_by_input_specs(group, name):
    """After the prefill, each decode step and the step from a fresh
    cache, every rank's block of every cache leaf has the placements and
    the shape of ``input_specs``' spec on its DeviceMesh, and that spec
    is the reference's."""
    run, _, _ = group
    case = CASES[name]
    d, m = MESHES[case["mesh"]]
    jcfg = jax_config(case)
    ref = dict(_flat(jreg.input_specs(
        jcfg, jbase.ShapeConfig("d", case["cache_len"], B, "decode"),
        AbstractMesh((d, m), ("data", "model")))["cache"]))
    for r in run.results:
        got = r["cases"][name]
        want = got["want_blocks"]
        assert sorted(want) == sorted(k for k in ref if k != "index")
        for k, (shape, spec, pl) in want.items():
            assert tuple(spec) == _spec(ref[k].sharding.spec), k
            assert shape == list(ref[k].shape)
        assert len(got["blocks"]) == STEPS + 2
        for blocks in got["blocks"]:
            assert sorted(blocks) == sorted(want)
            for k, (local, pl) in blocks.items():
                assert pl == want[k][2], (k, pl)
                assert local == _block_shape(want[k][0], pl, (d, m)), k
        assert got["index"] == [case["prompt"] + t
                                for t in range(STEPS + 1)] + [1]


def _layout(k_spec: tuple) -> str:
    if len(k_spec) > 2 and k_spec[2] == "model":
        return "seq"
    if len(k_spec) > 3 and k_spec[3] == "model":
        return "heads"
    return "replicated"


def test_the_cases_cover_every_layout_and_an_empty_rank():
    """Cache lengths that split over the model axis shard the sequence,
    and ones that do not shard the kv heads or replicate; in
    dense_1x4_seq the last two ranks hold no filled slot at any step (and
    at the step from a fresh cache, no rank but slot 0's does)."""
    layouts = set()
    for case in CASES.values():
        d, m = MESHES[case["mesh"]]
        if m == 1:
            continue
        spec = treg.input_specs(
            ranks.config(case["arch"]),
            tbase.ShapeConfig("d", case["cache_len"], B, "decode"),
            DuckMesh({"data": d, "model": m}))["cache"]
        layouts |= {_layout(seg["k"].spec) for key, seg in spec.items()
                    if key != "index" and "k" in seg}
    assert layouts == {"seq", "heads", "replicated"}
    case = CASES["dense_1x4_seq"]
    per_rank = case["cache_len"] // MESHES[case["mesh"]][1]
    assert case["prompt"] + STEPS <= 2 * per_rank


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_rank_holds_nan(group, name):
    run, _, _ = group
    assert not any(r["cases"][name]["nan"] for r in run.results)


GREEDY = sorted(k for k, c in CASES.items() if c.get("greedy"))


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_tokens_are_equal_on_every_rank_and_one_process(group, name):
    run, one, _ = group
    want = one[name]["greedy"]
    assert want.shape == (B, STEPS)
    for r in run.results:
        assert np.array_equal(r["cases"][name]["greedy"], want), r["rank"]


def test_ranks_are_gone(group):
    assert not torch.multiprocessing.active_children()
