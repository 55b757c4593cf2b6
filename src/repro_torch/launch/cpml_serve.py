"""Coded prediction service on torch: simulated or real multi-process.

    python -m repro_torch.launch.cpml_serve --queries 64 --rate 200
    python -m repro_torch.launch.cpml_serve --mode closed --queries 32
    python -m repro_torch.launch.cpml_serve --straggle-worker 7 \\
        --straggle-sleep 0.5 --collect-all
    python -m repro_torch.launch.cpml_serve --transport socket --queries 32
    python -m repro_torch.launch.cpml_serve --transport socket \\
        --kill-worker 5 --kill-at-round 3
    python -m repro_torch.launch.cpml_serve --device cpu --d 16

Mirrors ``repro/launch/cpml_serve.py``: the privacy-preserving prediction
plane (cluster/serve.py).  The model is Lagrange-encoded once and
provisioned to N workers; an open-loop (Poisson arrivals at ``--rate``
qps) or closed-loop (``--mode closed``) client load is admitted into the
bounded request queue, flushed under the max-batch / max-wait policy and
decoded at the first 2(K+T-1)+1 responders.  It reports queries/s and
latency p50/p99 under both wait policies (first-threshold, and the
wait-for-all counterfactual from the same traces) and checks every served
prediction bit for bit against the uncoded plaintext oracle.

``--transport inprocess`` (default) simulates the workers under
``--latency``; ``--transport socket`` spawns N
``repro_torch.launch.cpml_worker`` processes (each on ``--device``) and
``--kill-worker`` crashes one mid-service.  ``--straggle-worker i`` adds
``--straggle-sleep`` seconds to worker i on either backend.  Runs on CUDA
unless ``--device cpu``; without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="CodedPrivateML prediction serving (PyTorch/CUDA)")
    ap.add_argument("--workers", "-N", type=int, default=8)
    ap.add_argument("--parallel", "-K", type=int, default=2)
    ap.add_argument("--privacy", "-T", type=int, default=1)
    ap.add_argument("--d", type=int, default=32, help="feature dimension")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=32,
                    help="rows per coded flush (K must divide it)")
    ap.add_argument("--max-wait", type=float, default=0.02,
                    help="seconds the oldest admitted query may wait "
                         "before a partial flush")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="admitted-but-unflushed query bound (a full "
                         "queue rejects at submission)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--rows", type=int, default=4,
                    help="feature rows per query (open loop)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="open-loop arrival rate, queries/s (Poisson)")
    ap.add_argument("--mode", choices=("open", "closed"), default="open",
                    help="open = scheduled arrivals through the batching "
                         "policy; closed = one full-batch query in flight "
                         "at a time (throughput ceiling)")
    ap.add_argument("--transport", choices=("inprocess", "socket"),
                    default="inprocess")
    ap.add_argument("--latency", choices=("deterministic", "lognormal",
                                          "bursty"),
                    default="lognormal",
                    help="per-worker latency profile (inprocess only)")
    ap.add_argument("--latency-seed", type=int, default=0)
    ap.add_argument("--latency-base", type=float, default=0.01,
                    help="latency model base seconds (inprocess only)")
    ap.add_argument("--straggle-worker", type=int, default=None,
                    help="add --straggle-sleep seconds to this worker "
                         "(both backends)")
    ap.add_argument("--straggle-sleep", type=float, default=0.25)
    ap.add_argument("--kill-worker", type=int, default=None,
                    help="crash this worker index mid-service (socket only)")
    ap.add_argument("--kill-at-round", type=int, default=2,
                    help="flush index at which --kill-worker crashes")
    ap.add_argument("--collect-all", action="store_true",
                    help="keep each flush open until every dispatched "
                         "worker responds, so the wait-for-all "
                         "counterfactual is measured (do not combine "
                         "with --kill-worker)")
    ap.add_argument("--round-timeout", type=float, default=math.inf)
    ap.add_argument("--heartbeat-timeout", type=float, default=math.inf)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--wire", choices=("v1", "v2"), default="v2")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the per-flush bit-identity check against "
                         "the uncoded plaintext oracle")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the stand-in model, the masks and the "
                         "queries")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the master's device and every spawned worker's")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome trace with per-query "
                         "queue/batch/dispatch/decode spans here")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the serve_* metrics registry here "
                         "(*.json = snapshot, else Prometheus text)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch import device as _device
    from repro_torch.cluster.latency import (SleepyStragglerLatency,
                                             make_latency)
    from repro_torch.cluster.runner import wait_summary
    from repro_torch.cluster.serve import (
        PredictionServer, ServeConfig, open_loop_queries)
    from repro_torch.core.protocol.draws import TorchServeDraws
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.cpml_cluster import (
        _json_finite, _recorder_for, local_socket_cluster)

    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = ServeConfig(N=args.workers, K=args.parallel, T=args.privacy,
                      max_batch=args.max_batch, max_wait_s=args.max_wait,
                      queue_cap=args.queue_cap)
    mode = (args.latency if args.transport == "inprocess"
            else f"socket x{cfg.N} procs")
    print(f"CPML serve: N={cfg.N} K={cfg.K} T={cfg.T} "
          f"threshold={cfg.threshold} max_batch={cfg.max_batch} "
          f"max_wait={cfg.max_wait_s * 1e3:.0f}ms [{mode}, {args.mode} loop] "
          f"device={dev}")

    # stand-in for a trained model head; any (d, classes) weights serve
    draws = TorchServeDraws(args.seed, dev)
    w = 0.5 * draws.model_weights((args.d, args.classes))
    rows = cfg.max_batch if args.mode == "closed" else args.rows
    rate = 0.0 if args.mode == "closed" else args.rate
    queries = open_loop_queries(args.queries, rows=rows, d=args.d,
                                rate_qps=rate, seed=args.seed + 2)
    kw = dict(draws=draws, device=dev, round_timeout_s=args.round_timeout,
              heartbeat_timeout_s=args.heartbeat_timeout,
              collect_all=args.collect_all, verify=not args.no_verify,
              recorder=_recorder_for(args))
    out: dict = {}

    def serve(srv) -> None:
        """The client loop, timed on the host clock (synchronised), and
        the kernel launches it made in this process."""
        before = dict(LAUNCHES)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if args.mode == "closed":
            srv.run_closed_loop(queries)
        else:
            srv.run(queries)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["run_s"] = time.perf_counter() - t0
        out["launches_run"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    if args.transport == "socket":
        die = ({args.kill_worker: args.kill_at_round}
               if args.kill_worker is not None else None)
        sleep = ({args.straggle_worker: args.straggle_sleep}
                 if args.straggle_worker is not None else None)
        reports: list[dict] = []
        with local_socket_cluster(cfg.N, port=args.port, die_at_round=die,
                                  sleep_s=sleep,
                                  wire_version=int(args.wire[1:]),
                                  device=dev.type, reports=reports) as tr:
            print(f"{cfg.N} worker processes connected in "
                  f"{tr.startup_s:.1f}s")
            srv = PredictionServer(cfg, w, transport=tr, **kw)
            t0 = time.perf_counter()
            srv.provision(timeout_s=300.0)
            out["provision_s"] = time.perf_counter() - t0
            print(f"provisioned in {out['provision_s']:.1f}s (model shares "
                  f"shipped, every worker's warm-up product done)")
            wire0 = tr.wire_totals()
            serve(srv)
            wire1 = tr.wire_totals()
            srv.shutdown_workers()
        out.update(startup_s=tr.startup_s,
                   wire_run={k: wire1[k] - wire0[k] for k in wire0},
                   worker_reports=sorted(reports, key=lambda r: r["worker"]))
        print(f"socket service: {len(srv.results)} queries over TCP "
              f"in {out['run_s']:.2f}s")
        devices = sorted({r["device"] for r in reports})
        print(f"worker reports: {len(reports)}, devices {devices}, modmatmul "
              f"launches {[r['launches']['modmatmul'] for r in out['worker_reports']]}")
        if die:
            print(f"killed worker {args.kill_worker} at flush "
                  f"{args.kill_at_round}: first-threshold decode rode "
                  f"through")
    else:
        latency = make_latency(args.latency, seed=args.latency_seed,
                               base=args.latency_base)
        if args.straggle_worker is not None:
            latency = SleepyStragglerLatency(
                latency, {args.straggle_worker: args.straggle_sleep})
        srv = PredictionServer(cfg, w, latency=latency, **kw)
        serve(srv)

    stats = srv.stats()
    first, allw = stats["latency_first"], stats["latency_all"]
    word = "wall" if args.transport == "socket" else "simulated"
    print(f"served {stats['queries']}/{args.queries} queries "
          f"({stats['rejected']} rejected) in {stats['rounds']} flushes: "
          f"{stats['queries_per_s']:.1f} queries/s, "
          f"{stats['rows_per_s']:.0f} rows/s ({word})")
    print(f"latency first-threshold: p50 {first['p50'] * 1e3:.1f}ms  "
          f"p99 {first['p99'] * 1e3:.1f}ms")
    if allw["n"]:
        print(f"latency wait-for-all:    p50 {allw['p50'] * 1e3:.1f}ms  "
              f"p99 {allw['p99'] * 1e3:.1f}ms "
              f"({allw['unobserved']} unobserved)")
    elif allw["unobserved"]:
        print("(wait-for-all unobserved on every flush: rerun with "
              "--collect-all to measure the counterfactual)")
    print(f"master run: {out['run_s']:.3f}s on the host clock, kernel "
          f"launches {out['launches_run']}")

    rc = 0
    if not args.no_verify:
        ok = stats["oracle"]["bit_identical"] and stats["oracle"]["checked"]
        print(f"served predictions bit-identical to the uncoded plaintext "
              f"oracle: {bool(ok)} ({stats['oracle']['checked']} flushes)")
        if not ok:
            rc = 1

    if args.trace_out:
        from repro_torch.obs.export import (straggler_report, waterfall,
                                            write_chrome_trace)
        obj = write_chrome_trace(srv.obs, args.trace_out)
        pids = {e.get("pid") for e in obj["traceEvents"]}
        print(f"trace: {len(obj['traceEvents'])} events / {len(pids)} "
              f"process(es) -> {args.trace_out}")
        print(waterfall(srv.obs))
        text, _ = straggler_report(srv.traces, cfg.threshold)
        print(text)
    if args.metrics_out:
        srv.metrics.write(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(_json_finite(
                {"config": {"N": cfg.N, "K": cfg.K, "T": cfg.T,
                            "threshold": cfg.threshold,
                            "d": args.d, "classes": args.classes,
                            "max_batch": cfg.max_batch,
                            "max_wait_s": cfg.max_wait_s,
                            "queue_cap": cfg.queue_cap,
                            "transport": args.transport,
                            "mode": args.mode,
                            "latency": (args.latency
                                        if args.transport == "inprocess"
                                        else None)},
                 "device": str(dev),
                 "stats": stats,
                 # per flush: dispatch to the threshold-th reply, and the
                 # master's encode and decode (measured on sockets only)
                 "flush_s": {k: wait_summary([getattr(tr_, k) for tr_ in
                                              srv.traces.values()])
                             for k in ("coded_wait_s", "encode_s",
                                       "decode_s")},
                 "responders": {int(t): [int(w) for w in tr_.responders]
                                for t, tr_ in sorted(srv.traces.items())},
                 **out}), f, indent=2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
