"""CodedPrivateML training driver on the GPU (the port's main entry point).

    python -m repro_torch.launch.cpml_train -N 40 -K 13 -T 1 --m 12396 --d 1568

Mirrors ``repro/launch/cpml_train.py``: builds a synthetic classification
task, runs the coded engine (multi-class one-vs-all, optional mini-batch
SGD and straggler schedule) and reports accuracy against the cleartext
quantized baseline.  Runs on CUDA unless ``--device cpu``.
``--backend shard`` starts N ranks (``launch/mesh.py``: ``run_ranks``)
where the reference forces N host devices in one process: an SPMD
simulation, as in the reference.  Every rank replicates the master's
encode and decode and computes only its own share's worker step; privacy
is not enforced between ranks (each holds the cleartext data and all N
shares).  The ranks train the same weights.  Rank 0's metrics are
reported, with every rank's launches, weight hash and per-round timings
in ``--json-out``.  Each round is synchronised and timed (``round_ms``),
with the worker step (``coded_grad_ms``) and, for shard, the results'
all_gather (``all_gather_ms``) from the compute stage's marks: CUDA
events on the card.  The reference's ``--kernel`` flag has no
counterpart: on CUDA the kernels always run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CodedPrivateML coded training "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--workers", "-N", type=int, default=8)
    ap.add_argument("--parallel", "-K", type=int, default=2)
    ap.add_argument("--privacy", "-T", type=int, default=1)
    ap.add_argument("--degree", "-r", type=int, default=1)
    ap.add_argument("--classes", "-c", type=int, default=1,
                    help="1 = binary logistic regression (the paper's task)")
    ap.add_argument("--m", type=int, default=2000, help="samples")
    ap.add_argument("--d", type=int, default=128, help="features")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--eta", type=float, default=None,
                    help="step size (default: 1/L via power iteration)")
    ap.add_argument("--batch-rows", type=int, default=None,
                    help="mini-batch rows per part per round (default: full)")
    ap.add_argument("--backend", choices=("vmap", "shard"), default="vmap")
    ap.add_argument("--p30", action="store_true",
                    help="use the 30-bit extended prime (more headroom)")
    ap.add_argument("--drop-workers", type=int, default=0,
                    help="simulate this many stragglers every round")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json-out", type=str, default=None,
                    help="write the final metrics to this path")
    return ap


def _config(args, backend: str):
    from repro_torch.core import field, protocol
    return protocol.CPMLConfig(
        N=args.workers, K=args.parallel, T=args.privacy, r=args.degree,
        c=args.classes, p=field.P30 if args.p30 else field.P,
        backend=backend, batch_rows=args.batch_rows)


def _run(args, cfg, dev) -> dict:
    """Make the task, train, and score against the cleartext baseline."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import protocol
    from repro_torch.core.protocol import compute
    from repro_torch.data import synthetic

    if cfg.c == 1:
        x_np, y_np = synthetic.mnist_like(1, m=args.m, d=args.d, margin=12.0)
    else:
        x_np, y_np = synthetic.multiclass_mnist_like(1, m=args.m, d=args.d,
                                                     c=cfg.c)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)

    survivor_fn = None
    if args.drop_workers:
        keep = cfg.N - args.drop_workers
        survivor_fn = lambda t: np.roll(np.arange(cfg.N), t)[:keep]

    draws = protocol.TorchDraws(args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    round_ms: list[float] = []
    compute.TIMES = marks = []
    try:
        w, hist = protocol.train(cfg, x, y, iters=args.iters, eta=args.eta,
                                 survivor_fn=survivor_fn,
                                 eval_every=args.eval_every, draws=draws,
                                 device=dev, round_ms=round_ms)
    finally:
        compute.TIMES = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = [compute.marks_ms(m) for m in marks]
    timing = {"round_ms": round_ms,
              "coded_grad_ms": [s[0] for s in steps]}
    if cfg.backend == "shard":
        timing["all_gather_ms"] = [s[1] for s in steps]

    # cleartext quantized baseline: same X̄, true sigmoid, same step count
    wc, xq = protocol.cleartext_baseline(cfg, x, y, args.iters, eta=args.eta)
    score = (protocol.loss_and_accuracy if cfg.c == 1
             else protocol.multiclass_loss_and_accuracy)
    _, acc_ref = score(wc, xq, y)
    _, acc = score(w, xq, y)
    return {"seconds": dt, "history": hist, "acc_coded": float(acc),
            "acc_cleartext": float(acc_ref),
            "w_sha256": hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest(),
            **timing}


def _shard_rank(rank: int, world: int, args) -> dict:
    """One rank of ``--backend shard``: share ``rank`` of the coded
    dataset and the weights, on the rank's card (``mesh.run_ranks``)."""
    from repro_torch import device as _device
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.parallel import compat

    cfg = _config(args, "shard")
    dev = _device.resolve(args.device)
    with compat.use_mesh(mesh.compat_make_mesh((world,), (cfg.mesh_axis,))):
        out = _run(args, cfg, dev)
    return {**out, "rank": rank, "device": str(dev),
            "launches": dict(ops.LAUNCHES)}


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from repro_torch import device as _device

    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    cfg = _config(args, args.backend)
    drop = args.drop_workers
    if cfg.N - drop < cfg.threshold:
        ap.error(f"dropping {drop} of N={cfg.N} leaves fewer than the "
                 f"recovery threshold {cfg.threshold}")
    print(f"CPML: N={cfg.N} K={cfg.K} T={cfg.T} r={cfg.r} c={cfg.c} "
          f"threshold={cfg.threshold} backend={cfg.backend} device={dev} "
          f"batch_rows={cfg.batch_rows}", flush=True)

    extra = {}
    if cfg.backend == "shard":
        from repro_torch.launch import mesh

        run = mesh.run_ranks(_shard_rank, cfg.N, (args,), device=dev)
        res = run.results[0]
        same = len({r["w_sha256"] for r in run.results}) == 1
        print(f"{cfg.N} ranks over {run.backend}: start-up "
              f"{run.startup_s:.2f}s, weights bit-identical on every rank: "
              f"{same}")
        extra = {"rank_backend": run.backend, "startup_s": run.startup_s,
                 "ranks": [{k: r[k] for k in (
                     "rank", "device", "seconds", "launches", "w_sha256",
                     "round_ms", "coded_grad_ms", "all_gather_ms")}
                     for r in run.results]}
        if not same:
            print("error: the ranks' weights differ", file=sys.stderr)
            return 1
    else:
        res = _run(args, cfg, dev)

    for h in res["history"]:
        print(f"  iter {h['iter']:4d}  loss {h['loss']:.4f}  "
              f"acc {h['acc']:.2%}")
    dt = res["seconds"]
    print(f"trained {args.iters} private iterations in {dt:.2f}s "
          f"({dt / args.iters:.4f} s/iteration, setup included, {dev})")
    print(f"accuracy: coded {res['acc_coded']:.2%} vs cleartext baseline "
          f"{res['acc_cleartext']:.2%}")
    med = {k: statistics.median(res[k][1:] or res[k])
           for k in ("round_ms", "coded_grad_ms", "all_gather_ms") if k in res}
    print("median after round 1: " + ", ".join(
        f"{k[:-3]} {v:.3f} ms" for k, v in med.items()))

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": {"N": cfg.N, "K": cfg.K, "T": cfg.T,
                                  "r": cfg.r, "c": cfg.c, "p": cfg.p,
                                  "backend": cfg.backend,
                                  "batch_rows": cfg.batch_rows,
                                  "m": args.m, "d": args.d},
                       "device": str(dev), "iters": args.iters,
                       **res, **extra}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
