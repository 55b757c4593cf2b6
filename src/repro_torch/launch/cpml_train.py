"""CodedPrivateML training driver on the GPU (the port's main entry point).

    python -m repro_torch.launch.cpml_train -N 40 -K 13 -T 1 --m 12396 --d 1568

Mirrors ``repro/launch/cpml_train.py``: builds a synthetic classification
task, runs the coded engine (multi-class one-vs-all, optional mini-batch
SGD and straggler schedule) and reports accuracy against the cleartext
quantized baseline.  Runs on CUDA unless ``--device cpu``; ``--backend
shard`` is not ported yet.  The reference's ``--kernel`` flag has no
counterpart: on CUDA the kernels always run.
"""
from __future__ import annotations

import argparse
import json
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


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.backend == "shard":
        ap.error("--backend shard (one share per GPU) is not ported yet "
                 "(ROADMAP.md queue 1 item 4)")

    import numpy as np
    import torch

    from repro_torch import device as _device
    from repro_torch.core import field, protocol
    from repro_torch.data import synthetic

    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    cfg = protocol.CPMLConfig(
        N=args.workers, K=args.parallel, T=args.privacy, r=args.degree,
        c=args.classes, p=field.P30 if args.p30 else field.P,
        batch_rows=args.batch_rows)
    drop = args.drop_workers
    if cfg.N - drop < cfg.threshold:
        ap.error(f"dropping {drop} of N={cfg.N} leaves fewer than the "
                 f"recovery threshold {cfg.threshold}")
    print(f"CPML: N={cfg.N} K={cfg.K} T={cfg.T} r={cfg.r} c={cfg.c} "
          f"threshold={cfg.threshold} device={dev} "
          f"batch_rows={cfg.batch_rows}")

    if cfg.c == 1:
        x_np, y_np = synthetic.mnist_like(1, m=args.m, d=args.d, margin=12.0)
    else:
        x_np, y_np = synthetic.multiclass_mnist_like(1, m=args.m, d=args.d,
                                                     c=cfg.c)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)

    survivor_fn = None
    if drop:
        survivor_fn = lambda t: np.roll(np.arange(cfg.N), t)[: cfg.N - drop]

    draws = protocol.TorchDraws(args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, hist = protocol.train(cfg, x, y, iters=args.iters, eta=args.eta,
                             survivor_fn=survivor_fn,
                             eval_every=args.eval_every, draws=draws,
                             device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for h in hist:
        print(f"  iter {h['iter']:4d}  loss {h['loss']:.4f}  "
              f"acc {h['acc']:.2%}")
    print(f"trained {args.iters} private iterations in {dt:.2f}s "
          f"({dt / args.iters:.4f} s/iteration, setup included, {dev})")

    # cleartext quantized baseline: same X̄, true sigmoid, same step count
    wc, xq = protocol.cleartext_baseline(cfg, x, y, args.iters, eta=args.eta)
    if cfg.c == 1:
        _, acc_ref = protocol.loss_and_accuracy(wc, xq, y)
        _, acc = protocol.loss_and_accuracy(w, xq, y)
    else:
        _, acc_ref = protocol.multiclass_loss_and_accuracy(wc, xq, y)
        _, acc = protocol.multiclass_loss_and_accuracy(w, xq, y)
    print(f"accuracy: coded {float(acc):.2%} vs cleartext baseline "
          f"{float(acc_ref):.2%}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": {"N": cfg.N, "K": cfg.K, "T": cfg.T,
                                  "r": cfg.r, "c": cfg.c, "p": cfg.p,
                                  "batch_rows": cfg.batch_rows,
                                  "m": args.m, "d": args.d},
                       "device": str(dev), "iters": args.iters,
                       "seconds": dt, "history": hist,
                       "acc_coded": float(acc),
                       "acc_cleartext": float(acc_ref)}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
