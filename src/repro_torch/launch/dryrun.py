"""Production dry run: count every (arch x shape) cell on the 256- or
512-chip mesh, with nothing allocated and no card.  Mirrors
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's jitted step for 512 forced
host devices and reads the compiled artifact.  Here ``main`` starts a fake
world of 256 or 512 ranks in its own process (``fake_world``: the
``fake`` process-group backend over a ``FakeStore``; a collective sends
nothing), builds the production mesh on it (``launch/mesh.py:
make_production_mesh``, a ``cuda`` ``DeviceMesh``, so that the
collectives ``DTensor`` picks are NCCL's), and runs the cell's step once,
eagerly, on a meta-device model placed on that mesh as rank 0 holds it:

  train     ``loss_fn``, ``backward()``, AdamW ``apply_updates``
  prefill   ``prefill(..., shape.seq_len)``
  decode    ``decode_step`` on the cache ``registry.input_specs`` places
            (``init_cache(..., mesh=)``), at its last slot

Each cell's record (into ``build/dryrun/dryrun_<arch>__<shape>__<mesh>.json``):

  * ``memory``: per-device ``argument_size_in_bytes`` (the local shards of
    parameters, optimizer state, inputs and cache), ``output_size_in_bytes``
    (the step's outputs) and ``temp_size_in_bytes`` (the peak that
    ``torch.distributed._tools.mem_tracker.MemTracker`` sees, held to the
    local shards by ``LocalMemTracker``, less the arguments); ``fits``
    against the card's memory
  * per-device flops, bytes and collective bytes by kind
    (``launch/hlo_analysis.py``, from the ops the run dispatches)
  * the three roofline terms in seconds, the H100's (``PEAK_FLOPS``,
    ``HBM_BW``, ``LINK_BW``), the dominant one, ``model_flops_global``,
    ``useful_ratio`` and ``step_time_bound_s``: bounds from datasheet
    figures, not times on a card
  * ``trace_s`` (the step's eager run on meta under the counters) and
    ``analyze_s`` (the counters' own share of it), in place of the
    reference's ``lower_s`` and ``compile_s``

Keys with no counterpart are left out: ``xla_cost_*`` (XLA's own cost
analysis) and ``generated_code_size_in_bytes`` (no code is generated).
``--save-hlo`` writes each cell's op list, gzipped, in place of its HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--all] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import gzip
import json
import os
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.launch import hlo_analysis
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import PRODUCTION_CHIPS, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import rules

# NVIDIA H100 SXM5 (80 GB) datasheet, per GPU: the roofline's denominators
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = 80e9             # device memory, for ``fits``
# One 400 Gb/s NDR InfiniBand port a GPU, as in a DGX H100.  On the 16x16
# and 2x16x16 meshes every group of ranks a collective runs over (16
# consecutive ranks on ``model``, a stride of 16 on ``data``, 256 on
# ``pod``) spans more than one node of 8 GPUs, so the network link, not
# NVLink's 450 GB/s a direction, bounds every one.
LINK_BW = 50e9               # bytes/s a GPU

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


class LocalMemTracker(MemTracker):
    """``MemTracker`` held to the local shards: it tracks no ``FakeTensor``.
    ``DTensor``'s sharding propagation makes those, at global shapes; torch
    2.13's ``MemTracker`` skips them itself, 2.11's counts them (a 16x16
    tinyllama-1.1b train_4k step: 51.3 GB of temp against 14.0)."""

    def _track(self, reftype, t: torch.Tensor) -> None:
        if not isinstance(t, FakeTensor):
            super()._track(reftype, t)


@contextlib.contextmanager
def fake_world(world: int):
    """A ``torch.distributed`` world of ``world`` ranks in this process, as
    rank 0, over the ``fake`` backend: collectives return at once and move
    nothing.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        forget_meshes()


def forget_meshes() -> None:
    """Clear ``DTensor``'s caches of sharding plans.  They hold meshes, and
    a mesh compares equal to any mesh of the same shape and names: a world
    started later in this process would reach this one's destroyed groups
    through them.  (Each cache is cleared where this torch has it.)"""
    if "torch.distributed.tensor" not in sys.modules:
        return
    from torch.distributed.tensor import _redistribute, debug

    for clear in (getattr(debug, "_clear_sharding_prop_cache", None),
                  getattr(_redistribute, "clear_redistribute_planner_cache",
                          None),
                  getattr(getattr(_redistribute, "_gen_transform_infos",
                                  None), "cache_clear", None)):
        if clear is not None:
            clear()


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     ocfg: opt.OptimizerConfig, model: M.Model):
    """``step(params, opt_state, batch)``: the loss, ``backward()``, then
    AdamW's ``apply_updates`` (``launch/train.py: train_step_fn``)."""
    return train_lib.train_step_fn(cfg, rc, ocfg, model)


def build_prefill_step(cfg: ModelConfig, rc: RunConfig, model: M.Model,
                       cache_len: int):
    def prefill_step(batch):
        return M.prefill(cfg, rc, model, batch, cache_len)
    return prefill_step


def build_serve_step(cfg: ModelConfig, rc: RunConfig, model: M.Model):
    def serve_step(cache, batch):
        return M.decode_step(cfg, rc, model, cache, batch)
    return serve_step


def _abstract(spec: registry.InputSpec, mesh) -> torch.Tensor:
    """A meta ``DTensor`` of one input leaf, placed as ``spec`` says."""
    return rules.zeros(spec.shape, spec.dtype, mesh, spec.placements, "meta")


def abstract_train_inputs(cfg: ModelConfig, rc: RunConfig,
                          ocfg: opt.OptimizerConfig, mesh):
    """The meta model placed on ``mesh`` with gradients on, its parameters,
    the AdamW state laid out as they are, and the shardings of both
    (``launch/train.py: build_sharded_state``)."""
    model = M.abstract_params(cfg, getattr(torch, rc.param_dtype))
    model.requires_grad_(True)
    params, opt_state, shardings = train_lib.build_sharded_state(
        cfg, rc, ocfg, mesh, model)
    return model, params, opt_state, shardings


def _placed_model(cfg: ModelConfig, rc: RunConfig, mesh) -> M.Model:
    model = M.abstract_params(cfg, getattr(torch, rc.param_dtype))
    return M.place_on_mesh(cfg, model, mesh, rc.seq_parallel)


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor in ``tree``."""
    return sum(hlo_analysis.sig_bytes(t.shape, t.dtype) for t in
               map(rules.local, hlo_analysis.tensors(tree)))


# ---------------------------------------------------------------------------
# the cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rc: RunConfig | None = None, verbose: bool = True,
             save_hlo: str | None = None, cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None) -> dict:
    """One cell on the production mesh of the initialised world
    (``fake_world``).  ``cfg`` and ``shape`` replace the registry's
    (a reduced config, a smaller shape) for a cheaper run of the same
    path."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = registry.applicable(cfg, shape)
    cell = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        cell.update(status="skipped", reason=reason)
        return cell
    rc = rc or default_rc(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    ocfg = opt.OptimizerConfig()
    t0 = time.time()
    with rules.use_rules_mesh(mesh, rc.seq_parallel):
        specs = registry.input_specs(cfg, shape, mesh, rc)
        specs.pop("cache", None)
        batch = {k: _abstract(s, mesh) for k, s in specs.items()}
        if shape.kind == "train":
            model, params, opt_state, _ = abstract_train_inputs(
                cfg, rc, ocfg, mesh)
            fn = build_train_step(cfg, rc, ocfg, model)
            args = (params, opt_state, batch)
            state = [opt_state]
        elif shape.kind == "prefill":
            model = _placed_model(cfg, rc, mesh)
            fn = build_prefill_step(cfg, rc, model, shape.seq_len)
            args = (batch,)
            state = []
        else:  # decode: a full cache, the new token at its last slot
            model = _placed_model(cfg, rc, mesh)
            cache = M.init_cache(cfg, rc, shape.global_batch, shape.seq_len,
                                 device="meta", mesh=mesh)
            cache["index"] = shape.seq_len - 1
            fn = build_serve_step(cfg, rc, model)
            args = (cache, batch)
            state = [cache]
        setup_s = time.time() - t0
        arg_bytes = (_local_bytes(dict(model.named_parameters()))
                     + _local_bytes(state) + _local_bytes(batch))
        tracker = LocalMemTracker()
        tracker.track_external(model, *hlo_analysis.tensors((state, batch)))
        counter = hlo_analysis.Counter(keep_ops=save_hlo is not None)
        t0 = time.time()
        with tracker, counter:
            out = fn(*args)
        trace_s = time.time() - t0
    peak = max(sum(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values()), arg_bytes)
    out_bytes = _local_bytes(out)
    del out, args, state, batch, model
    if save_hlo:
        with gzip.open(save_hlo, "wt") as f:
            f.write("\n".join(counter.ops))
    hlo = counter.summary()
    flops = float(hlo["flops"])              # per device
    bytes_acc = float(hlo["bytes"])
    coll = {k: float(v) for k, v in hlo["collectives"].items()}
    coll_total = float(hlo["collective_total"])
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll_total / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    model_flops = model_flops_per_step(cfg, shape)
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": peak - arg_bytes}
    cell.update(
        status="ok",
        chips=chips,
        setup_s=round(setup_s, 2), trace_s=round(trace_s, 2),
        analyze_s=round(counter.count_s, 2),
        memory=memory,
        peak_bytes_per_device=peak,
        fits=peak <= HBM_BYTES,
        hlo_flops_per_device=flops,
        hlo_bytes_per_device=bytes_acc,
        collective_bytes_per_device=coll,
        collective_total_per_device=coll_total,
        ops_dispatched=sum(hlo["op_counts"].values()),
        roofline_terms_s=terms,
        dominant=dominant,
        model_flops_global=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else None,
        step_time_bound_s=max(terms.values()),
    )
    if verbose:
        print(json.dumps(cell, indent=2), flush=True)
    return cell


def model_flops_per_step(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) per optimizer step;
    for prefill 2*N*D (fwd only); decode: per generated token."""
    n = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * tokens


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k experts only)."""
    total = cfg.param_count()
    if cfg.num_experts:
        e, k = cfg.num_experts, cfg.experts_per_token
        expert_params = sum(
            count * e * (3 if cfg.act == "silu" else 2)
            * cfg.d_model * cfg.moe_d_ff
            for kind, count in cfg.block_pattern if kind == "moe")
        total = total - expert_params + expert_params * k // e
    return total


def default_rc(cfg: ModelConfig, shape: ShapeConfig) -> RunConfig:
    rc = RunConfig(seq_len=shape.seq_len, global_batch=shape.global_batch)
    if shape.seq_len >= 32768 and shape.kind != "decode":
        rc = dataclasses.replace(rc, q_block=1024, kv_block=1024)
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) for the chosen mesh")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="default: build/dryrun in this checkout")
    ap.add_argument("--save-hlo", action="store_true",
                    help="save each cell's gzipped op list")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    cells = ([(a, s) for a in registry.ARCHS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    results = []
    with fake_world(PRODUCTION_CHIPS[args.multi_pod]):
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{mesh_tag}"
            print(f"=== {tag} ===", flush=True)
            try:
                hlo_path = (os.path.join(args.out, f"ops_{tag}.txt.gz")
                            if args.save_hlo else None)
                cell = run_cell(arch, shape, args.multi_pod,
                                save_hlo=hlo_path)
            except Exception as e:
                cell = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                        "status": "error", "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:]}
                print(cell["error"], flush=True)
            gc.collect()
            results.append(cell)
            with open(os.path.join(args.out, f"dryrun_{tag}.json"), "w") as f:
                json.dump(cell, f, indent=2)
    n_ok = sum(c["status"] == "ok" for c in results)
    n_skip = sum(c["status"] == "skipped" for c in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\nDRYRUN SUMMARY [{mesh_tag}]: ok={n_ok} skipped={n_skip} "
          f"errors={n_err}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
