"""Training driver on the GPU: ``python -m repro_torch.launch.train --arch
hymba-1.5b ...``; mirrors ``repro/launch/train.py``.

Config -> model (random weights from seed 0, gradients on) -> AdamW
state -> synthetic batches (``data/loader``, the reference's tokens bit
for bit) -> train step (``loss_fn``, ``backward()``, ``apply_updates``) ->
checkpointed resilient loop.  Every mamba layer's forward and backward run
through the CUDA scan kernels (``kernels/mamba_scan.py``:
``SelectiveScanFn``).  Runs on CUDA unless ``--device cpu``; ``--reduced``
runs the same path on a CPU-sized model of the family.  Like the
reference's driver it feeds tokens only, so the encoder-decoder
whisper-tiny exits 2.

Over ranks: where a ``torch.distributed`` world is initialised (by
``launch/mesh.py: run_ranks``, or started here from ``torchrun``'s
environment) the driver builds the reference's local mesh over it, data =
world and model = 1 (``compat_make_mesh``), places the parameters and the
optimizer state on it as ``DTensor``s (``build_sharded_state``), feeds
each rank its rows of the global batch, restores onto the mesh and runs
every step under ``parallel.rules.use_rules_mesh``.  Every tokens-only
arch trains there, the MoE archs among them (their experts laid out over
``model``, which is 1 here, and dispatched in ``models/moe.py``'s mesh
body).  Rank 0 prints and writes ``--json-out``.  With
``--production-mesh`` the mesh is the reference's production one,
``make_production_mesh()`` (16, 16) over a world of 256 ranks (``torchrun``
over NCCL, a card a rank); on any other world, or with none, the driver
exits 2.  It starts no fake world: the dry run (``launch/dryrun.py``)
counts a production step without cards.

The last line of standard output is one JSON object: the steps run, the
tokens a second over the steps after the first (the first compiles and
allocates), the first and last loss, each step's seconds and the peak
device memory (the CUDA allocator's, this rank's; null on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.data.loader import LMBatchLoader
from repro_torch.models import model as M
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import optimizers as opt
from repro_torch.parallel import rules
from repro_torch.runtime.resilience import ResilientLoop

# inside the checkout (``build/`` is git-ignored), so that two checkouts
# never restore each other's checkpoints
CHECKPOINT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"
# the profiler range around the optimizer's update in ``train_step_fn``
OPTIMIZER_RANGE = "train_step.apply_updates"


def run_config(seq: int, batch: int) -> RunConfig:
    """The reference driver's run configuration for ``batch`` sequences of
    ``seq`` tokens: attention, loss and scan blocks no longer than one."""
    return RunConfig(seq_len=seq, global_batch=batch, q_block=min(512, seq),
                     kv_block=min(1024, seq), loss_chunk=min(512, seq),
                     scan_chunk=min(128, seq))


def train_step_fn(cfg, rc, ocfg, model: M.Model):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss, its gradients by ``backward()``, then ``apply_updates``, the
    reference's ``value_and_grad`` step.  ``params`` is
    ``dict(model.named_parameters())``, updated in place; the gradients
    are freed after the update.  The update runs inside the profiler range
    ``OPTIMIZER_RANGE`` (a no-op unless a profiler is recording).  On a
    mesh the caller runs it under ``rules.use_rules_mesh``; the metrics
    come back as plain tensors, the same on every rank."""
    def step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        loss = M.loss_fn(cfg, rc, model, batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            params, opt_state, metrics = opt.apply_updates(ocfg, params,
                                                           grads, opt_state)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss.detach(), **metrics}
        return params, opt_state, {k: rules.full(v)
                                   for k, v in metrics.items()}
    return step


def build_sharded_state(cfg, rc, ocfg, mesh, model: M.Model):
    """The reference's ``build_sharded_state``: ``model``'s parameters
    placed on ``mesh`` (``M.place_on_mesh``), the optimizer state laid out
    as they are, and the shardings of both for a restore onto the mesh
    ({group: {leaf: (mesh, placements)}}; the step counter stays plain)."""
    M.place_on_mesh(cfg, model, mesh, rc.seq_parallel)
    params = dict(model.named_parameters())
    opt_state = opt.init_state(ocfg, params)
    pshard = {k: (mesh, tuple(p.placements)) for k, p in params.items()}
    shardings = {"params": pshard,
                 "opt_state": {k: pshard for k in opt_state if k != "step"}}
    return params, opt_state, shardings


@contextlib.contextmanager
def _world(dev: torch.device):
    """The initialised world, if any: one already there (``run_ranks``),
    or one started here from ``torchrun``'s environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over ``backend_for``'s route and
    ended on exit.  Yields (rank, world size), or None outside a world.
    (Under ``torchrun`` on one card nothing builds the staged backend
    before the ranks start, so the first run builds it in every rank.)"""
    if dist.is_initialized():
        yield dist.get_rank(), dist.get_world_size()
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        yield None
        return
    world = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    backend = mesh_lib.backend_for(world, dev)
    mesh_lib.init_backend(backend)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=600))
    try:
        yield dist.get_rank(), world
    finally:
        dist.destroy_process_group()


def _to(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree if rules.is_dtensor(tree) else tree.to(dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LM training (PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh; needs a world of 256 "
                         "ranks (torchrun), else exits 2")
    ap.add_argument("--checkpoint-dir", default=str(CHECKPOINT_DIR),
                    help="default: build/train_ckpt in this checkout")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json-out", type=str, default=None,
                    help="write the final JSON line here too")
    return ap


def main(argv: list[str] | None = None, config_override=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_override or registry.get_config(args.arch)
    if args.reduced:
        cfg = registry.reduced_config(cfg)
    if cfg.is_encoder_decoder:
        print(f"error: {cfg.name} needs frame embeddings (batch['enc_embeds'])"
              ", which this driver's loader does not make: like the "
              "reference's (repro/launch/train.py), it feeds tokens only; "
              "call models.model.loss_fn with enc_embeds", file=sys.stderr)
        return 2
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with _world(dev) as world:
        mesh = None
        if args.production_mesh:
            try:
                mesh = mesh_lib.make_production_mesh()
            except ValueError as e:
                print(f"error: --production-mesh: {e}", file=sys.stderr)
                return 2
        return _train(args, cfg, dev, world, mesh)


def _train(args, cfg, dev: torch.device, world, mesh=None) -> int:
    rc = run_config(args.seq, args.batch)
    ocfg = opt.OptimizerConfig(learning_rate=args.lr,
                               warmup_steps=max(2, args.steps // 10),
                               total_steps=max(args.steps, 10))
    if world is None:
        mesh, lead, shape = None, True, mesh_lib.make_local_mesh().shape
    else:
        if mesh is None:
            mesh = mesh_lib.compat_make_mesh((world[1], 1),
                                             ("data", "model"))
        lead = world[0] == 0
        shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    say(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
        f"device={dev} mesh={shape}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    model = M.Model(cfg, dtype=getattr(torch, rc.param_dtype), device=dev,
                    seed=0)
    model.requires_grad_(True)
    if mesh is None:
        params = dict(model.named_parameters())
        opt_state = opt.init_state(ocfg, params)
        shardings = None
    else:
        params, opt_state, shardings = build_sharded_state(cfg, rc, ocfg,
                                                           mesh, model)
    step_fn = train_step_fn(cfg, rc, ocfg, model)
    on_mesh = (contextlib.nullcontext if mesh is None else
               lambda: rules.use_rules_mesh(mesh, rc.seq_parallel))

    ckpt = CheckpointManager(args.checkpoint_dir)
    start = 0
    state = {"params": params, "opt_state": opt_state}
    if args.resume and ckpt.latest_step() is not None:
        restored = ckpt.restore(shardings=shardings, device=dev)
        start = restored.pop("step")
        state = restored
        say(f"resumed from step {start}")

    loop = ResilientLoop(ckpt, checkpoint_every=args.checkpoint_every)
    losses: list[float] = []
    step_s: list[float] = []

    # context manager: the prefetch thread is joined even when a step fails
    with LMBatchLoader(dev, args.batch, args.seq, cfg.vocab_size,
                       mesh=mesh) as loader:
        it = iter(loader)

        def one_step(state, step):
            if state["params"] is not params:   # restored from a checkpoint
                with torch.no_grad():
                    for k, t in state["params"].items():
                        params[k].copy_(t)
            batch = next(it)
            t0 = time.perf_counter()
            with on_mesh():
                p, o, metrics = step_fn(params, _to(state["opt_state"], dev),
                                        batch)
            loss = float(metrics["loss"])     # waits for the step's kernels
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"gnorm {float(metrics['grad_norm']):8.3f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"dt {step_s[-1]:6.2f}s", flush=True)
            return {"params": p, "opt_state": o}

        state = loop.run(state, one_step, start, args.steps, shardings)
    if args.checkpoint_every and ckpt.latest_step() != start + args.steps:
        # (the reference saves again a step the loop has just saved, and
        # its writer thread then fails to publish over the existing one)
        ckpt.save(start + args.steps, state)
        ckpt.wait()
    say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    timed = step_s[1:] or step_s
    summary = {
        "arch": cfg.name, "device": str(dev), "mesh": shape,
        "steps": len(losses), "batch": args.batch, "seq": args.seq,
        "tokens_per_s": args.batch * args.seq * len(timed) / sum(timed),
        "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
        "step_s": step_s, "restarts": loop.restarts,
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None)}
    if args.json_out and lead:
        with open(args.json_out, "w") as f:
            json.dump(summary, f)
    say(json.dumps(summary), flush=True)
    if not math.isfinite(losses[-1]):
        return 1
    # loss should not be diverging; short runs are noisy, so allow 5% slack
    return 0 if (losses[-1] < losses[0] * 1.05 or args.steps < 20) else 1


if __name__ == "__main__":
    raise SystemExit(main())
