"""Coded cluster driver on torch: simulated or real multi-process run.

    python -m repro_torch.launch.cpml_cluster --latency lognormal --iters 25
    python -m repro_torch.launch.cpml_cluster --latency dead --round-timeout 60
    python -m repro_torch.launch.cpml_cluster --latency dead --resilient
    python -m repro_torch.launch.cpml_cluster --pipeline full
    python -m repro_torch.launch.cpml_cluster --transport socket --iters 10
    python -m repro_torch.launch.cpml_cluster --transport socket \\
        --kill-worker 5 --kill-at-round 4 --straggle-worker 3
    python -m repro_torch.launch.cpml_cluster --transport socket --resilient \\
        --kill-worker 0 1 --kill-at-round 4 --round-timeout 10
    python -m repro_torch.launch.cpml_cluster --transport socket --masters 2 \\
        --spares 1 --kill-worker 2 --kill-at-round 3 \\
        --heartbeat-timeout 3 --join-at-round 5
    python -m repro_torch.launch.cpml_cluster --protocol mpc --latency lognormal
    python -m repro_torch.launch.cpml_cluster --protocol mpc --transport socket \\
        --workers 5 --privacy 2 --straggle-worker 4
    python -m repro_torch.launch.cpml_cluster --engine alcc --iters 10
    python -m repro_torch.launch.cpml_cluster --engine alcc --model mlp \
        --classes 10 --hidden 32 --transport socket
    python -m repro_torch.launch.cpml_cluster --device cpu --m 300 --d 24

Mirrors ``repro/launch/cpml_cluster.py``: CodedPrivateML training
through the cluster runtime (repro_torch.cluster),
per-round dispatch to N workers, decode at the fastest ``threshold``
responders, and what the wait-for-fastest-T policy saved over
wait-for-all.

``--transport inprocess`` (default) is the event-driven simulation under a
``--latency`` profile, the whole round computed on the master's device;
``--resilient`` adds checkpoint/restore recovery from mid-run worker death
(pair it with ``--latency dead``, which then kills one worker more than
the code tolerates).  ``--transport socket`` spawns N worker processes
(``repro_torch.launch.cpml_worker``, each on ``--device``) on localhost,
ships coded shares as wire frames over TCP, and decodes from the bytes the
fastest responders sent; with ``--resilient`` a starved round restores
the last checkpoint, spawns a fresh worker process for each dead slot,
reprovisions it and replays.  On CUDA the kernels are built once before
any worker starts.  ``--kill-worker`` takes one or more worker indices
(the reference takes one), all crashing at ``--kill-at-round``.

Either way the run ends by checking that the weights are bit-identical to
``train_reference`` replaying the observed responder trace with the same
draws, on the same device.  Runs on CUDA unless ``--device cpu``.

``--protocol mpc`` runs the BGW baseline over the same runtime: one
all-to-all reshare barrier per degree reduction (the workers exchange
SubShares through the master's relay over sockets), reconstruction at the
first 2T+1 final shares, and a closing bit-identity check against the
port's single-host ``mpc_baseline.train`` with the same draws.

``--engine alcc`` swaps in the ALCC float engine (real-valued Lagrange
coding, Gaussian masks of std ``--sigma``, least-squares decode): an
in-process run ends bit-identical to ``alcc_engine.train_reference`` over
its trace, a socket run within ``ALCC_SOCKET_TOL`` of it, and both print
the decode's condition number and error budget and the accuracy of the
uncoded ``float_oracle``.  ``--model mlp`` (ALCC only) trains the gelu MLP
as two coded phases a step (cluster/alcc_mlp.py), its final loss within
``ALCC_MLP_LOSS_TOL`` of the plaintext ``mlp_oracle``.  The reference's
cross-flag refusals are kept, in its words (exit 2).

``--masters S`` splits the master's coding over a group of S logical
masters, each owning a contiguous d-slice (cluster/master_group.py): the
dataset encode, and over sockets each round's weight encode and streaming
decode; the run stays bit-identical to one master and prints the group's
per-master critical path.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))

# The reference's ALCC tolerances (its cpml_cluster.py): a socket run
# replays through train_reference within ALCC_SOCKET_TOL in max|Δw| (the
# workers' float32 products sum in another order than the replay's), and
# an MLP run's final full-data loss lands within ALCC_MLP_LOSS_TOL of the
# plaintext oracle's.
ALCC_SOCKET_TOL = 1e-3
ALCC_MLP_LOSS_TOL = 0.05


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CodedPrivateML cluster driver "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--protocol", choices=("cpml", "mpc"), default="cpml",
                    help="cpml = coded training (first-T decode); mpc = the "
                         "BGW secret-sharing baseline over the same runtime "
                         "(reshare barriers, no straggler tolerance)")
    ap.add_argument("--engine", choices=("exact", "alcc"), default="exact",
                    help="coded-arithmetic backend: exact = quantized "
                         "Lagrange coding over F_p, bit-identical decode; "
                         "alcc = real-valued Lagrange coding with Gaussian "
                         "masks and a least-squares decode whose condition "
                         "number and error budget are tracked per round")
    ap.add_argument("--model", choices=("logreg", "mlp"), default="logreg",
                    help="logreg = the paper's logistic regression; mlp = "
                         "the two-layer gelu MLP as two bilinear coded "
                         "phases a step (ALCC only)")
    ap.add_argument("--sigma", type=float, default=1.0,
                    help="ALCC Gaussian mask std, the analog privacy knob "
                         "(--engine alcc only)")
    ap.add_argument("--hidden", type=int, default=32,
                    help="MLP hidden width (--model mlp)")
    ap.add_argument("--eta", type=float, default=0.1,
                    help="MLP step size for both layers (--model mlp; "
                         "logreg keeps the Lipschitz step)")
    ap.add_argument("--workers", "-N", type=int, default=8)
    ap.add_argument("--parallel", "-K", type=int, default=2)
    ap.add_argument("--privacy", "-T", type=int, default=1)
    ap.add_argument("--degree", "-r", type=int, default=1)
    ap.add_argument("--classes", "-c", type=int, default=1)
    ap.add_argument("--m", type=int, default=2000, help="samples")
    ap.add_argument("--d", type=int, default=128, help="features")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--batch-rows", type=int, default=None)
    ap.add_argument("--transport", choices=("inprocess", "socket"),
                    default="inprocess",
                    help="inprocess = event-driven simulation; socket = "
                         "spawn N real worker processes on localhost")
    ap.add_argument("--pipeline", choices=("off", "prefetch", "streaming",
                                           "full"),
                    default="off",
                    help="overlap master-side coding with in-flight worker "
                         "compute: prefetch = next round's draws, mask "
                         "shares, batch and decode plan built during the "
                         "wait; streaming = fold results into the decode as "
                         "they arrive; full = both.  Bit-identical to off")
    ap.add_argument("--encode-cost-s", type=float, default=0.0,
                    help="modeled master encode seconds per round charged "
                         "to the simulated clock (inprocess only)")
    ap.add_argument("--decode-cost-s", type=float, default=0.0,
                    help="modeled master decode seconds per round "
                         "(inprocess only)")
    ap.add_argument("--latency", choices=("deterministic", "lognormal",
                                          "bursty", "dead"),
                    default="lognormal",
                    help="per-worker latency profile (inprocess only)")
    ap.add_argument("--latency-seed", type=int, default=0)
    ap.add_argument("--round-timeout", type=float, default=math.inf,
                    help="seconds before a round is declared starved "
                         "(60 simulated seconds for --latency dead, 120 wall "
                         "seconds for --transport socket unless given)")
    ap.add_argument("--resilient", action="store_true",
                    help="checkpoint/restore recovery on starved rounds "
                         "(socket: a respawned replacement process is "
                         "reprovisioned over the wire before the replay)")
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--masters", type=int, default=1,
                    help="shard the master role over this many d-slices: "
                         "each master of the group encodes and "
                         "stream-decodes a contiguous 1/S slice of the model "
                         "dimension, bit-identical to one master")
    ap.add_argument("--spares", type=int, default=0,
                    help="pre-encode this many spare Lagrange evaluation "
                         "points beyond N for elastic joins")
    ap.add_argument("--join-at-round", type=int, default=None,
                    help="admit one extra worker at this round's fence "
                         "(socket: a real late-joiner process; inprocess: a "
                         "scheduled join); implies --spares 1")
    ap.add_argument("--port", type=int, default=0,
                    help="master TCP port (0 = ephemeral)")
    ap.add_argument("--kill-worker", type=int, nargs="+", default=None,
                    help="crash these worker indices mid-run (socket only)")
    ap.add_argument("--kill-at-round", type=int, default=4,
                    help="round at which the --kill-worker workers crash")
    ap.add_argument("--straggle-worker", type=int, default=None,
                    help="make this worker sleep before every reply "
                         "(socket only)")
    ap.add_argument("--straggle-sleep", type=float, default=0.25)
    ap.add_argument("--collect-all", action="store_true",
                    help="keep each round open until every dispatched "
                         "worker responds, so wait-for-all is measured on "
                         "the real clock (socket only)")
    ap.add_argument("--heartbeat-timeout", type=float, default=math.inf,
                    help="wall seconds of heartbeat silence before a worker "
                         "drops from the dispatch set (socket only)")
    ap.add_argument("--wire", choices=("v1", "v2"), default="v2",
                    help="wire protocol version of the master and the "
                         "spawned workers")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-identity check against "
                         "train_reference")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the protocol's draws (masks, uniforms, "
                         "batches)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the master's device and every spawned worker's")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--trace-out", type=str, default=None,
                    help="record a flight trace and write Chrome trace-event "
                         "JSON here; also prints a terminal waterfall and "
                         "the straggler attribution")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write the metrics registry here (*.json: JSON "
                         "snapshot, else the Prometheus textfile format)")
    return ap


def _worker_env() -> dict[str, str]:
    """Environment of a spawned worker: this tree on PYTHONPATH, and one
    host thread each, since the N workers share one host."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def spawn_worker(port: int, w: int, *, env: dict[str, str] | None = None,
                 wire_version: int = 2, die_at_round: int | None = None,
                 sleep_s: float | None = None,
                 join_at_round: int | None = None,
                 device: str = "cuda",
                 stdout=None) -> subprocess.Popen:
    """Start one ``repro_torch.launch.cpml_worker`` process for slot ``w``
    against the master listening on ``port``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.cpml_worker",
           "--host", "127.0.0.1", "--port", str(port),
           "--worker", str(w), "--wire", str(wire_version),
           "--device", device]
    if die_at_round is not None:
        cmd += ["--die-at-round", str(die_at_round)]
    if sleep_s is not None:
        cmd += ["--sleep-s", str(sleep_s)]
    if join_at_round is not None:
        cmd += ["--join-at-round", str(join_at_round)]
    return subprocess.Popen(cmd, stdout=stdout,
                            env=env if env is not None else _worker_env())


@contextlib.contextmanager
def local_socket_cluster(n_workers: int, *, port: int = 0,
                         die_at_round: dict[int, int] | None = None,
                         sleep_s: dict[int, float] | None = None,
                         join_at_round: dict[int, int] | None = None,
                         connect_timeout_s: float = 180.0,
                         poll_interval_s: float = 0.02,
                         wire_version: int = 2,
                         device: str = "cuda",
                         reports: list | None = None):
    """Spawn N worker processes against a fresh master transport.

    Yields the master ``SocketTransport`` once every worker has connected
    (``tr.startup_s``: seconds from the first spawn to the last HELLO).  On
    CUDA the kernels are built first, once, so the workers only load them.
    On a normal exit the master keeps relaying and flushing until every
    worker has left (at most 60 s), so queued sub-shares and SHUTDOWNs
    reach them; then the transport is closed and the processes are reaped.
    With ``reports`` given, each worker's stdout is captured and its JSON
    report line appended there.  A process a
    caller appends to ``tr.procs`` (a resilient respawn, spawned with
    ``stdout=tr.worker_stdout``) is reaped and reported the same way.
    """
    from repro_torch.cluster.messages import worker_endpoint
    from repro_torch.cluster.socket_transport import SocketTransport

    if device == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    env = _worker_env()
    out = subprocess.PIPE if reports is not None else None
    tr = SocketTransport.master(port=port, poll_interval_s=poll_interval_s,
                                wire_version=wire_version)
    procs: list[subprocess.Popen] = []
    tr.procs = procs
    tr.worker_stdout = out
    try:
        t0 = time.monotonic()
        for w in range(n_workers):
            procs.append(spawn_worker(
                tr.port, w, env=env, wire_version=wire_version,
                die_at_round=(die_at_round or {}).get(w),
                sleep_s=(sleep_s or {}).get(w), device=device, stdout=out))
        for w, at_round in (join_at_round or {}).items():
            procs.append(spawn_worker(tr.port, w, env=env,
                                      wire_version=wire_version,
                                      join_at_round=at_round, device=device,
                                      stdout=out))
        expect = [*range(n_workers), *(join_at_round or {})]
        tr.wait_for_endpoints([worker_endpoint(w) for w in expect],
                              timeout_s=connect_timeout_s)
        tr.startup_s = time.monotonic() - t0
        yield tr
        # Relay and flush until every worker has left.  A straggler's last
        # reshare sub-shares and every SHUTDOWN may still sit in the
        # master's outboxes; closing now would drop them and leave a worker
        # waiting at a barrier that can no longer fill.
        deadline = time.monotonic() + 60.0
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline):
            tr.recv(tr.local, math.inf)
            tr.next_delivery(tr.local)
    finally:
        tr.close()
        deadline = time.monotonic() + 30.0
        for p in procs:
            try:
                text, _ = p.communicate(
                    timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            if reports is not None and text:
                for line in text.decode(errors="replace").splitlines():
                    if line.startswith("{"):
                        reports.append(json.loads(line))


def _recorder_for(args):
    if args.trace_out is None:
        return None
    from repro_torch.obs.trace import Recorder
    return Recorder()


def _emit_obs(args, runner, threshold: int) -> None:
    """Post-run outputs: trace file, waterfall, straggler attribution,
    metrics dump."""
    if args.trace_out:
        from repro_torch.obs.export import (straggler_report, waterfall,
                                            write_chrome_trace)
        obj = write_chrome_trace(runner.obs, args.trace_out)
        pids = {e.get("pid") for e in obj["traceEvents"]}
        print(f"trace: {len(obj['traceEvents'])} events / {len(pids)} "
              f"process(es) -> {args.trace_out}")
        print(waterfall(runner.obs))
        text, _ = straggler_report(runner.traces, threshold)
        print(text)
    if args.metrics_out:
        runner.metrics.write(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")


def _validate(args) -> str | None:
    """The refusals: the reference's cross-flag matrix in its words; None
    when the run is possible."""
    if args.engine == "alcc" and args.protocol == "mpc":
        return ("--engine alcc cannot run --protocol mpc: BGW is an exact "
                "finite-field protocol (Shamir shares, modular reshare "
                "barriers) — there is no analog/float variant of its "
                "degree reduction")
    if args.model == "mlp":
        if args.protocol == "mpc":
            return ("--model mlp is a coded-protocol feature: the BGW "
                    "baseline reproduces the paper's logistic task only")
        if args.engine != "alcc":
            return ("--model mlp needs --engine alcc: gelu and softmax are "
                    "not finite-field polynomials, so the exact engine "
                    "structurally cannot train the MLP")
        if args.resilient or args.collect_all:
            return ("--resilient/--collect-all are not wired into the MLP "
                    "plane yet — drop them or use --model logreg")
    if args.engine == "alcc":
        if args.pipeline != "off":
            return ("--pipeline modes are exact-engine only: they split the "
                    "FIELD encode/decode (prefetchable mask rows, integer "
                    "streaming folds) — the ALCC least-squares decode has "
                    "no such split")
        if args.masters > 1 or args.spares or args.join_at_round is not None:
            return ("--masters/--spares/--join-at-round are exact-engine "
                    "only: the elastic + sharded-master planes rely on "
                    "bit-identical re-encode, which a float engine cannot "
                    "promise")
        if args.transport == "socket" and args.wire == "v1":
            return ("--engine alcc needs --wire v2: float round shares and "
                    "results are wire v2 frames (like TRACE/JOIN) — a v1 "
                    "fleet has no frame for them")
    return None


def _validate_mpc(args) -> str | None:
    """--protocol mpc's refusals, in the reference's words."""
    if args.resilient:
        return ("--resilient is meaningless for MPC: BGW has no erasure "
                "tolerance — a starved round is terminal")
    if args.pipeline != "off":
        return ("--pipeline applies to the coded protocol only: every BGW "
                "reshare barrier consumes the previous phase's output, so "
                "there is no W-independent master work to overlap")
    if args.classes != 1:
        return "--protocol mpc supports the paper's binary task only"
    if args.kill_worker is not None:
        return ("--kill-worker is meaningless for MPC: a crashed worker "
                "starves the reshare barrier and ends the run (that is the "
                "paper's point) — use --straggle-worker to slow one instead")
    if args.masters > 1 or args.spares or args.join_at_round is not None:
        return ("--masters/--spares/--join-at-round are coded-protocol "
                "features: BGW bakes N into every reshare (no spare "
                "evaluation points to join on) and its master only "
                "reconstructs")
    return None


def _timed_run(runner, iters: int, dev, out: dict, resilient: bool = False,
               checkpoint_every: int = 5, respawn=None):
    """``runner.run(iters)``, or ``runner.run_resilient`` with checkpoints
    in a temporary directory: its seconds on the host clock, synchronised
    (``out["run_s"]``), and the kernel launches it made in this process
    (``out["launches_run"]``)."""
    import torch

    from repro_torch.kernels import LAUNCHES

    before = dict(LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if resilient:
        from repro_torch.checkpoint.manager import CheckpointManager
        with tempfile.TemporaryDirectory() as ckdir:
            mgr = CheckpointManager(ckdir, async_write=False)
            w = runner.run_resilient(iters, mgr,
                                     checkpoint_every=checkpoint_every,
                                     respawn=respawn)
        out["restarts"] = runner.restarts
    else:
        w = runner.run(iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["run_s"] = time.perf_counter() - t0
    out["launches_run"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    return w


def _run_socket(args, cfg, x, y, draws, dev, out: dict):
    """--transport socket: N real worker processes, wire frames, wall clock."""
    from repro_torch.cluster.runner import ClusterRunner, wait_summary

    die = ({w: args.kill_at_round for w in args.kill_worker}
           if args.kill_worker is not None else None)
    sleep = ({args.straggle_worker: args.straggle_sleep}
             if args.straggle_worker is not None else None)
    timeout = args.round_timeout
    if math.isinf(timeout):
        timeout = 120.0         # real silence must be detectable
    wv = int(args.wire[1:])
    spares = args.spares
    join = None
    if args.join_at_round is not None:
        spares = max(spares, 1)
        join = {cfg.N: args.join_at_round}      # first spare slot
    reports: list[dict] = []
    with local_socket_cluster(cfg.N, port=args.port, die_at_round=die,
                              sleep_s=sleep, join_at_round=join,
                              wire_version=wv, device=dev.type,
                              reports=reports) as tr:
        from repro_torch.cluster.messages import worker_endpoint

        print(f"{cfg.N + len(join or {})} worker processes connected in "
              f"{tr.startup_s:.1f}s")
        runner = ClusterRunner(cfg, x, y, latency=None, transport=tr,
                               draws=draws, device=dev,
                               round_timeout_s=timeout,
                               heartbeat_timeout_s=args.heartbeat_timeout,
                               collect_all=args.collect_all,
                               pipeline=args.pipeline, spares=spares,
                               masters=args.masters,
                               recorder=_recorder_for(args),
                               engine=args.engine)
        runner.provision(timeout_s=300.0)
        provision_s = runner.metrics.gauge("cpml_provision_seconds").value
        print(f"provisioned in {provision_s:.1f}s (shares shipped, every "
              f"worker's warm-up round done)")

        def respawn(worker: int, step: int) -> None:
            # a starved round's restore asks for a fresh process for each
            # dead slot; the runner reprovisions it over the wire and waits
            # for its ack before replaying
            tr.procs.append(spawn_worker(tr.port, worker, wire_version=wv,
                                         device=dev.type,
                                         stdout=tr.worker_stdout))
            tr.wait_for_endpoints([worker_endpoint(worker)], timeout_s=180.0)

        w = _timed_run(runner, args.iters, dev, out,
                       resilient=args.resilient,
                       checkpoint_every=args.checkpoint_every,
                       respawn=respawn)
        runner.shutdown_workers()
    # each result's compute_s: the worker's seconds from taking the share
    # off its queue to sending the result (a straggler's sleep included)
    compute_s = [v for tr_ in runner.traces.values()
                 for v in tr_.latencies.values() if math.isfinite(v)]
    out.update(startup_s=tr.startup_s, provision_s=provision_s,
               worker_compute_s=wait_summary(compute_s),
               worker_reports=sorted(reports, key=lambda r: r["worker"]))
    print(f"socket run: {args.iters} rounds over TCP in {out['run_s']:.2f}s "
          f"({out['run_s'] / args.iters * 1e3:.1f} ms/round)")
    if args.resilient:
        print(f"resilient socket run: {runner.restarts} restart(s), each "
              f"respawning + reprovisioning the dead slot over TCP")
    stats = runner.wait_stats()
    if "wire_totals" in stats:
        tot, per = stats["wire_totals"], stats["wire_tx_bytes"]
        print(f"wire [{args.wire}]: {tot['tx_bytes'] / 1e6:.2f} MB tx / "
              f"{tot['rx_bytes'] / 1e6:.2f} MB rx total "
              f"({per['mean'] / 1e3:.1f} kB/round tx, "
              f"{stats['wire_rx_bytes']['mean'] / 1e3:.1f} kB/round rx, "
              f"{int(tot['tx_frames'])} frames out)")
    devices = sorted({r["device"] for r in reports})
    print(f"worker reports: {len(reports)}, devices {devices}, coded_grad "
          f"launches {[r['launches']['coded_grad'] for r in out['worker_reports']]}")
    if die:
        dead = set(die)
        late = [t for t, rec in runner.records.items()
                if dead & set(map(int, rec.survivors))]
        print(f"killed worker(s) {sorted(dead)} at round "
              f"{args.kill_at_round}: last decoded in round "
              f"{max(late) if late else '-'}; first-T decode rode through")
    return runner, w


def _run_inprocess(args, cfg, x, y, draws, dev, out: dict):
    """--transport inprocess: the simulation, whole rounds on the master."""
    from repro_torch.cluster.latency import make_latency
    from repro_torch.cluster.runner import ClusterRunner

    kw = {}
    if args.latency == "dead" and args.resilient:
        # kill one worker more than the code tolerates, so the run goes
        # through a checkpoint restore (one death at N=8 is absorbed by
        # the first-T decode with no restart)
        kw["deaths"] = {w: 3 for w in range(cfg.N - cfg.threshold + 1)}
    latency = make_latency(args.latency, seed=args.latency_seed, **kw)
    timeout = args.round_timeout
    if args.latency == "dead" and math.isinf(timeout):
        timeout = 60.0          # a dead worker must be detectable
    spares = args.spares
    join_schedule = None
    if args.join_at_round is not None:
        spares = max(spares, 1)
        join_schedule = {cfg.N: args.join_at_round}  # first spare slot
    runner = ClusterRunner(cfg, x, y, latency, draws=draws, device=dev,
                           round_timeout_s=timeout,
                           heartbeat_timeout_s=args.heartbeat_timeout,
                           pipeline=args.pipeline,
                           encode_cost_s=args.encode_cost_s,
                           decode_cost_s=args.decode_cost_s,
                           spares=spares, join_schedule=join_schedule,
                           masters=args.masters,
                           recorder=_recorder_for(args), engine=args.engine)
    w = _timed_run(runner, args.iters, dev, out, resilient=args.resilient,
                   checkpoint_every=args.checkpoint_every)
    runner.close()
    print(f"in-process run: {args.iters} rounds in {out['run_s']:.3f}s "
          f"({out['run_s'] / args.iters * 1e3:.2f} ms/round, host clock, "
          f"{dev})")
    if args.resilient:
        print(f"resilient run: {runner.restarts} restart(s)")
    return runner, w


def _run_mpc(args, dev) -> int:
    """--protocol mpc: the BGW baseline head-to-head on the same runtime."""
    import torch

    from repro_torch.cluster.mpc_runner import MPCClusterRunner, mpc_phase_models
    from repro_torch.core import mpc_baseline, protocol
    from repro_torch.core.protocol.draws import TorchMPCDraws
    from repro_torch.data import synthetic

    cfg = mpc_baseline.MPCConfig(N=args.workers, T=args.privacy,
                                 r=args.degree)
    mode = (args.latency if args.transport == "inprocess"
            else f"socket x{cfg.N} procs")
    print(f"BGW MPC baseline: N={cfg.N} T={cfg.T} r={cfg.r} "
          f"collect=2T+1={2 * cfg.T + 1} [{mode}] device={dev} — every "
          f"degree reduction is an all-to-all barrier")
    x_np, y_np = synthetic.mnist_like(1, m=args.m, d=args.d, margin=12.0)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    draws = TorchMPCDraws(args.seed, dev)
    out: dict = {}
    rc = 0
    if args.transport == "socket":
        timeout = args.round_timeout
        if math.isinf(timeout):
            timeout = 120.0
        sleep = ({args.straggle_worker: args.straggle_sleep}
                 if args.straggle_worker is not None else None)
        reports: list[dict] = []
        with local_socket_cluster(cfg.N, port=args.port, sleep_s=sleep,
                                  wire_version=int(args.wire[1:]),
                                  device=dev.type, reports=reports) as tr:
            print(f"{cfg.N} worker processes connected in "
                  f"{tr.startup_s:.1f}s")
            runner = MPCClusterRunner(
                cfg, x, y, None, draws=draws, device=dev, transport=tr,
                round_timeout_s=timeout,
                heartbeat_timeout_s=args.heartbeat_timeout,
                recorder=_recorder_for(args))
            wire0 = tr.wire_totals()
            t0 = time.perf_counter()
            runner.provision(timeout_s=600.0)
            provision_s = time.perf_counter() - t0
            wire1 = tr.wire_totals()
            print(f"provisioned in {provision_s:.1f}s "
                  f"({(wire1['tx_bytes'] - wire0['tx_bytes']) / 1e6:.1f} MB "
                  f"of whole-dataset shares shipped, every worker's warm-up "
                  f"done)")
            w = _timed_run(runner, args.iters, dev, out)
            runner.shutdown_workers()
        out.update(startup_s=tr.startup_s, provision_s=provision_s,
                   provision_wire={k: wire1[k] - wire0[k] for k in wire0},
                   worker_reports=sorted(reports, key=lambda r: r["worker"]))
        print(f"socket MPC run: {args.iters} rounds over TCP in "
              f"{out['run_s']:.1f}s "
              f"({out['run_s'] / args.iters * 1e3:.0f} ms/round, "
              f"{args.degree} reshare barrier(s) each)")
        devices = sorted({r["device"] for r in reports})
        print(f"worker reports: {len(reports)}, devices {devices}, "
              f"modmatmul launches "
              f"{[r['launches']['modmatmul'] for r in out['worker_reports']]}")
    else:
        models = mpc_phase_models(args.latency, seed=args.latency_seed,
                                  r=cfg.r)
        timeout = args.round_timeout
        if args.latency == "dead" and math.isinf(timeout):
            timeout = 60.0
        runner = MPCClusterRunner(cfg, x, y, models, draws=draws, device=dev,
                                  round_timeout_s=timeout,
                                  recorder=_recorder_for(args))
        w = _timed_run(runner, args.iters, dev, out)
        print(f"in-process MPC run: {args.iters} rounds in "
              f"{out['run_s']:.3f}s "
              f"({out['run_s'] / args.iters * 1e3:.2f} ms/round, host "
              f"clock, {dev})")
    _emit_obs(args, runner, runner.collect_threshold)
    stats = runner.wait_stats()
    word = "wall" if args.transport == "socket" else "simulated"
    print(f"per-round MPC wait (dispatch -> 2T+1 reconstruct): "
          f"mean {stats['mpc']['mean']:.2f}s  p50 {stats['mpc']['p50']:.2f}s "
          f"p95 {stats['mpc']['p95']:.2f}s "
          f"({word} total {stats['mpc']['total']:.1f}s)")
    if "wire_tx_bytes" in stats:
        print(f"wire [{args.wire}]: "
              f"{stats['wire_tx_bytes']['mean'] / 1e6:.2f} MB/round tx, "
              f"{stats['wire_rx_bytes']['mean'] / 1e6:.2f} MB/round rx "
              f"(reshare relay included)")
    same = None
    if not args.no_verify:
        w_ref, _ = mpc_baseline.train(cfg, x, y, args.iters, eta=runner.eta,
                                      draws=draws, device=dev)
        same = bool(torch.equal(w, w_ref))
        print(f"bit-identical to the single-host mpc_baseline oracle: {same}")
        if not same:
            rc = 1
    _, acc = protocol.loss_and_accuracy(w, runner.state.xq_real, y)
    print(f"accuracy: mpc {float(acc):.2%}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(_json_finite(
                {"config": {"N": cfg.N, "T": cfg.T, "r": cfg.r,
                            "m": args.m, "d": args.d,
                            "protocol": "mpc",
                            "transport": args.transport,
                            "latency": (args.latency
                                        if args.transport == "inprocess"
                                        else None),
                            "iters": args.iters},
                 "device": str(dev),
                 "bit_identical": same,
                 "wait_stats": stats,
                 "acc_mpc": float(acc), **out}), f, indent=2)
    return rc


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    refusal = ((args.protocol == "mpc" and _validate_mpc(args))
               or _validate(args))
    if refusal:
        print(refusal, file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from repro_torch import device as _device
    from repro_torch.core import protocol
    from repro_torch.data import synthetic

    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.protocol == "mpc":
        return _run_mpc(args, dev)
    if args.model == "mlp":
        return _run_mlp(args, dev)

    from repro_torch.core.protocol import alcc_engine
    from repro_torch.core.protocol.draws import TorchALCCDraws

    alcc = args.engine == "alcc"
    if alcc:
        cfg = alcc_engine.ALCCConfig(N=args.workers, K=args.parallel,
                                     T=args.privacy, r=args.degree,
                                     c=args.classes, sigma=args.sigma,
                                     batch_rows=args.batch_rows)
    else:
        cfg = protocol.CPMLConfig(N=args.workers, K=args.parallel,
                                  T=args.privacy, r=args.degree,
                                  c=args.classes, batch_rows=args.batch_rows)
    mode = (args.latency if args.transport == "inprocess"
            else f"socket x{cfg.N} procs")
    print(f"CPML cluster [{args.engine}]: N={cfg.N} K={cfg.K} T={cfg.T} "
          f"r={cfg.r} c={cfg.c} threshold={cfg.threshold} [{mode}] "
          f"device={dev}")
    if cfg.c == 1:
        x_np, y_np = synthetic.mnist_like(1, m=args.m, d=args.d, margin=12.0)
    else:
        x_np, y_np = synthetic.multiclass_mnist_like(1, m=args.m, d=args.d,
                                                     c=cfg.c)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    draws = (TorchALCCDraws if alcc else protocol.TorchDraws)(args.seed, dev)

    out: dict = {}
    if args.transport == "socket":
        runner, w = _run_socket(args, cfg, x, y, draws, dev, out)
    else:
        runner, w = _run_inprocess(args, cfg, x, y, draws, dev, out)

    rc = 0
    same = None
    if not args.no_verify:
        # runner.cfg is the spare-extended config when elastic: the replay
        # runs the same N + spares scheme over the observed trace
        w_ref, _ = (alcc_engine if alcc else protocol).train_reference(
            runner.cfg, x, y, args.iters, eta=runner.eta,
            survivor_fn=runner.survivor_fn(), draws=draws, device=dev)
        if alcc and args.transport == "socket":
            # the workers' float32 products sum in another order than the
            # replay's batched product: a tolerance, as in the reference
            gap = float((w - w_ref).abs().max())
            out["replay_max_abs_diff"] = gap
            ok = gap <= ALCC_SOCKET_TOL
            print(f"train_reference replay over the observed responder "
                  f"trace: max|Δw| = {gap:.2e} "
                  f"(tolerance {ALCC_SOCKET_TOL:.0e}): "
                  f"{'OK' if ok else 'FAILED'}")
        else:
            same = ok = (_same_bits(w, w_ref) if alcc
                         else bool(torch.equal(w, w_ref)))
            print(f"bit-identical to train_reference over the observed "
                  f"responder trace: {same}")
        if not ok:
            rc = 1

    _emit_obs(args, runner, cfg.threshold)
    stats = runner.wait_stats()
    memb = stats["membership"]
    if memb["joins"] or memb["leaves"]:
        print(f"membership: epoch {int(memb['epoch'])}, "
              f"{int(memb['members'])} member(s) "
              f"({int(memb['joins'])} join(s), {int(memb['leaves'])} "
              f"leave(s), {int(memb['spares_left'])} spare(s) left)")
    if args.masters > 1:
        g = stats["masters"]
        print(f"sharded masters x{args.masters}: per-master critical path "
              f"{g['critical_path_s']:.3f}s (group totals: encode "
              f"{g['encode_total_s']:.3f}s, decode {g['decode_total_s']:.3f}s)")
    coded, allw = stats["coded_T"], stats["wait_all"]
    print(f"per-round wait  coded-T: mean {coded['mean']:.4f}s  "
          f"p50 {coded['p50']:.4f}s  p95 {coded['p95']:.4f}s")
    cp, enc, dec = stats["critical_path"], stats["encode"], stats["decode"]
    print(f"per-round critical path [{args.pipeline}]: mean {cp['mean']:.4f}s "
          f"= encode {enc['mean']:.4f}s + wait + decode {dec['mean']:.4f}s  "
          f"({int(stats['rounds']['prefetched'])} prefetched, "
          f"{int(stats['rounds']['streamed'])} streamed rounds)")
    unobserved = int(stats["rounds"]["dead_rounds"])
    if allw["total"] > 0:
        print(f"per-round wait wait-all: mean {allw['mean']:.4f}s  "
              f"p50 {allw['p50']:.4f}s  p95 {allw['p95']:.4f}s")
    if unobserved and args.transport == "socket" and not args.collect_all:
        print("(wait-for-all unobserved in first-T mode: the master moved "
              "on at the threshold-th arrival every round; rerun with "
              "--collect-all to measure it)")
    elif unobserved:
        print(f"({unobserved} round(s) had a dead worker: wait-for-all "
              f"would never complete; wait-all stats cover the "
              f"{int(stats['rounds']['n']) - unobserved} finite rounds)")
    if unobserved == 0 and allw["total"] > 0:
        word = "wall" if args.transport == "socket" else "simulated"
        print(f"{word} training time: {coded['total']:.3f}s coded-T vs "
              f"{allw['total']:.3f}s wait-all "
              f"({allw['total'] / coded['total']:.2f}x speedup)")

    metric = (protocol.loss_and_accuracy if cfg.c == 1
              else protocol.multiclass_loss_and_accuracy)
    if alcc:
        a = stats["alcc"]
        print(f"alcc decode: cond p95 {a['cond']['p95']:.1f}, error budget "
              f"p95 {a['abs_err_budget']['p95']:.2e}, "
              f"{int(a['fallbacks']['n'])} fallback(s)")
        # against the UNCODED float oracle (same surrogate, batches and
        # steps): the gap is the coding's float error alone
        w_oracle = alcc_engine.float_oracle(cfg, x, y, args.iters,
                                            eta=runner.eta, draws=draws,
                                            device=dev)
        out["oracle_max_abs_diff"] = float((w - w_oracle).abs().max())
        out["weights_finite"] = bool(torch.isfinite(w).all())
        out["alcc_decode"] = runner.alcc_info
        if not out["weights_finite"]:
            print("weights not finite: the float32 worker results overflowed "
                  "(see the error budget)")
        x_eval = runner.state.xq_real[: runner.state.m]
        _, acc = metric(w, x_eval, y)
        _, acc_ref = metric(w_oracle, x_eval, y)
        print(f"accuracy: coded {float(acc):.2%} vs uncoded float oracle "
              f"{float(acc_ref):.2%} (max|Δw| {out['oracle_max_abs_diff']:.2e})")
    else:
        # against the cleartext quantized baseline, same step count
        wc, xq = protocol.cleartext_baseline(cfg, x, y, args.iters)
        _, acc = metric(w, xq, y)
        _, acc_ref = metric(wc, xq, y)
        print(f"accuracy: coded {float(acc):.2%} vs cleartext baseline "
              f"{float(acc_ref):.2%}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(_json_finite({
                "config": {"N": cfg.N, "K": cfg.K, "T": cfg.T, "r": cfg.r,
                           "c": cfg.c, "m": args.m, "d": args.d,
                           "engine": args.engine,
                           "sigma": args.sigma if alcc else None,
                           "batch_rows": cfg.batch_rows,
                           "spares": args.spares,
                           "masters": args.masters,
                           "transport": args.transport,
                           "pipeline": args.pipeline,
                           "latency": (args.latency
                                       if args.transport == "inprocess"
                                       else None),
                           "iters": args.iters},
                "device": str(dev),
                "bit_identical": same,
                # the final weights' bytes, so that two runs (one master
                # against S) can be held bit-identical to each other
                "w_sha256": hashlib.sha256(
                    w.cpu().numpy().tobytes()).hexdigest(),
                "survivors": {int(t): np.asarray(r.survivors).tolist()
                              for t, r in sorted(runner.records.items())},
                "wait_stats": stats,
                "acc_coded": float(acc),
                "acc_baseline": float(acc_ref), **out}), f, indent=2)
    return rc


def _run_mlp(args, dev) -> int:
    """--model mlp: the two-phase coded gelu MLP under ALCC."""
    import torch

    from repro_torch.cluster.alcc_mlp import ALCCMLPRunner, train_reference
    from repro_torch.cluster.latency import make_latency
    from repro_torch.core.protocol import alcc_engine
    from repro_torch.core.protocol.draws import TorchALCCDraws
    from repro_torch.data import synthetic

    c = max(args.classes, 2)        # softmax head: binary becomes 2-class
    cfg = alcc_engine.ALCCConfig(N=args.workers, K=args.parallel,
                                 T=args.privacy, c=c, sigma=args.sigma,
                                 batch_rows=args.batch_rows)
    mode = (args.latency if args.transport == "inprocess"
            else f"socket x{cfg.N} procs")
    print(f"ALCC MLP cluster: N={cfg.N} K={cfg.K} T={cfg.T} c={c} "
          f"hidden={args.hidden} sigma={cfg.sigma} "
          f"phase-threshold={cfg.mlp_threshold} [{mode}] device={dev}")
    x_np, y_np = synthetic.multiclass_mnist_like(1, m=args.m, d=args.d, c=c)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    draws = TorchALCCDraws(args.seed, dev)
    out: dict = {}
    rc = 0
    if args.transport == "socket":
        timeout = args.round_timeout
        if math.isinf(timeout):
            timeout = 120.0
        sleep = ({args.straggle_worker: args.straggle_sleep}
                 if args.straggle_worker is not None else None)
        die = ({w: args.kill_at_round for w in args.kill_worker}
               if args.kill_worker is not None else None)
        reports: list[dict] = []
        with local_socket_cluster(cfg.N, port=args.port, sleep_s=sleep,
                                  die_at_round=die,
                                  wire_version=int(args.wire[1:]),
                                  device=dev.type, reports=reports) as tr:
            print(f"{cfg.N} worker processes connected in "
                  f"{tr.startup_s:.1f}s")
            runner = ALCCMLPRunner(cfg, x, y, args.hidden, latency=None,
                                   draws=draws, device=dev, transport=tr,
                                   eta=args.eta, round_timeout_s=timeout,
                                   recorder=_recorder_for(args))
            runner.provision(timeout_s=300.0)
            provision_s = runner.metrics.gauge("cpml_provision_seconds").value
            print(f"provisioned in {provision_s:.1f}s")
            w1, w2 = _timed_run(runner, args.iters, dev, out)
            runner.shutdown_workers()
        out.update(startup_s=tr.startup_s, provision_s=provision_s,
                   worker_reports=sorted(reports, key=lambda r: r["worker"]))
        print(f"socket MLP run: {args.iters} steps (2 coded phases each) "
              f"over TCP in {out['run_s']:.2f}s "
              f"({out['run_s'] / args.iters * 1e3:.1f} ms/step)")
        print(f"worker reports: {len(reports)}, devices "
              f"{sorted({r['device'] for r in reports})}")
    else:
        latency = make_latency(args.latency, seed=args.latency_seed)
        runner = ALCCMLPRunner(cfg, x, y, args.hidden, latency,
                               draws=draws, device=dev, eta=args.eta,
                               round_timeout_s=args.round_timeout,
                               recorder=_recorder_for(args))
        w1, w2 = _timed_run(runner, args.iters, dev, out)
        print(f"in-process MLP run: {args.iters} steps in "
              f"{out['run_s']:.3f}s "
              f"({out['run_s'] / args.iters * 1e3:.2f} ms/step, host "
              f"clock, {dev})")
    if args.trace_out or args.metrics_out:
        _emit_obs(args, runner, cfg.mlp_threshold)
    stats = runner.wait_stats()
    a = stats["alcc"]
    print(f"alcc decode: cond p95 {a['cond']['p95']:.1f}, error budget "
          f"p95 {a['abs_err_budget']['p95']:.2e}, "
          f"{int(a['fallbacks']['n'])} fallback(s)")
    coded = stats["coded_T"]
    print(f"per-phase wait  coded-T: mean {coded['mean']:.4f}s  "
          f"p50 {coded['p50']:.4f}s  p95 {coded['p95']:.4f}s")
    out["alcc_decode"] = runner.alcc_info
    loss, acc = runner.metrics_now()
    ow1, ow2 = alcc_engine.mlp_oracle(cfg, x, y, args.hidden, args.iters,
                                      args.eta, draws=draws, device=dev)
    oloss, oacc = alcc_engine.mlp_metrics(runner.state, ow1, ow2)
    print(f"MLP loss {loss:.4f} / acc {acc:.2%} vs plaintext autograd "
          f"oracle {oloss:.4f} / {oacc:.2%} "
          f"(|Δloss| = {abs(loss - oloss):.2e}, "
          f"tolerance {ALCC_MLP_LOSS_TOL})")
    if abs(loss - oloss) > ALCC_MLP_LOSS_TOL:
        rc = 1
    same = None
    if not args.no_verify:
        w1r, w2r, _ = train_reference(cfg, x, y, args.hidden, args.iters,
                                      args.eta,
                                      survivor_fn=runner.survivor_fn(),
                                      draws=draws, device=dev)
        gap = max(float((w1 - w1r).abs().max()),
                  float((w2 - w2r).abs().max()))
        out["replay_max_abs_diff"] = gap
        if args.transport == "socket":
            ok = gap <= ALCC_SOCKET_TOL
            print(f"train_reference replay: max|Δw| = {gap:.2e} "
                  f"(tolerance {ALCC_SOCKET_TOL:.0e}): "
                  f"{'OK' if ok else 'FAILED'}")
        else:
            same = ok = _same_bits(w1, w1r) and _same_bits(w2, w2r)
            print(f"bit-identical to train_reference over the observed "
                  f"responder trace: {ok}")
        if not ok:
            rc = 1
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(_json_finite(
                {"config": {"N": cfg.N, "K": cfg.K, "T": cfg.T, "c": c,
                            "m": args.m, "d": args.d,
                            "engine": "alcc", "model": "mlp",
                            "hidden": args.hidden, "sigma": cfg.sigma,
                            "eta": args.eta,
                            "transport": args.transport,
                            "iters": args.iters},
                 "device": str(dev),
                 "bit_identical": same,
                 "wait_stats": stats,
                 "loss_coded": loss, "acc_coded": acc,
                 "loss_oracle": oloss, "acc_oracle": oacc,
                 **out}), f, indent=2)
    return rc


def _same_bits(a, b) -> bool:
    """Float32 tensors equal bit for bit, NaN payloads included (a diverged
    ALCC run still replays exactly)."""
    import torch
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _json_finite(obj):
    """inf/nan -> null recursively (strict JSON has no Infinity)."""
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


if __name__ == "__main__":
    sys.exit(main())
