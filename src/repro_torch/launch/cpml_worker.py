"""CodedPrivateML worker process on torch: serves coded rounds over a socket.

    python -m repro_torch.launch.cpml_worker --port 9000 --worker 3
    python -m repro_torch.launch.cpml_worker --port 9000 --worker 3 --device cpu

Mirrors the ``"cpml"`` mode of ``repro/launch/cpml_worker.py``; it speaks
the same wire (v1 or v2), so either package's master can drive it.  One
process is one of the paper's N workers:

  1. PROVISION: an EncodeShare with ``round == PROVISION_ROUND`` carrying
     {cfg kwargs, the coded dataset share X̃_i, the coefficients c̄}.  The
     share goes to the device, then one warm-up round runs at the round's
     real shapes (kernel load, CUDA init, the sub-batch gather), and only
     then does the worker ack with a Heartbeat: round 0 is not charged for
     start-up.  The reference's ``"mpc"``, ``"serve"``, ``"alcc"`` and
     ``"alcc_mlp"`` provisions are refused (ROADMAP.md queue 1 items 7, 8
     and 9): the worker exits 2.
  2. ROUNDS: each EncodeShare(t, i, {"w_share", "batch", "next_batch"}) is
     acked with a Heartbeat, then answered with WorkerResult(t, i,
     compute_s, f(X̃_i[batch], W̃_i)), where f is ``compute.worker_fn``: one
     ``coded_grad`` launch with N = 1 on the card, its plain version on the
     CPU.  The sub-batch is an ``index_select`` on the device; a
     pipelined master's ``next_batch`` is gathered after the reply, while
     the next weight share is in flight.
  3. SHUTDOWN: ``round == SHUTDOWN_ROUND``, or the master hanging up.

On leaving its serve loop the worker prints one JSON line to stdout: its
device, rounds answered, why it stopped, start-up and warm-up seconds,
the kernel launches of its rounds (``launches``) and those of the warm-up
(``warmup_launches``), both from ``kernels.LAUNCHES``.

``--die-at-round R`` exits without replying when round R's share arrives;
``--sleep-s S`` sleeps S seconds before every reply (a real straggler);
``--join-at-round R`` announces an elastic JOIN for round R's fence.  Runs
on CUDA unless ``--device cpu``; without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import time

_T0 = time.monotonic()    # before torch is imported: start-up seconds

# the reference's other provisions and the ROADMAP items that port them
_NOT_PORTED = {"mpc": "queue 1 item 7", "serve": "queue 1 item 8",
               "alcc": "queue 1 item 9", "alcc_mlp": "queue 1 item 9"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CodedPrivateML socket worker "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker", type=int, required=True,
                    help="this worker's index i in [0, N)")
    ap.add_argument("--connect-timeout", type=float, default=30.0)
    ap.add_argument("--die-at-round", type=int, default=None,
                    help="crash (exit silently) when this round's share "
                         "arrives")
    ap.add_argument("--join-at-round", type=int, default=None,
                    help="announce this worker as an elastic late joiner "
                         "for the given round fence right after HELLO "
                         "(wire v2 only)")
    ap.add_argument("--sleep-s", type=float, default=0.0,
                    help="sleep this long before every reply: a real "
                         "injected straggler")
    ap.add_argument("--wire", type=int, choices=(1, 2), default=2,
                    help="wire protocol version this worker speaks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


class _Refused(Exception):
    """A provision this port cannot serve."""


def serve(args, dev) -> int:
    import numpy as np
    import torch

    from repro_torch.cluster.messages import (
        MASTER, PROVISION_ROUND, SHUTDOWN_ROUND, EncodeShare, Epoch,
        Heartbeat, Join, WorkerResult, worker_endpoint)
    from repro_torch.cluster.socket_transport import SocketTransport
    from repro_torch.core.protocol import compute
    from repro_torch.core.protocol.config import CPMLConfig
    from repro_torch.kernels import LAUNCHES

    def to_dev(a, dtype) -> torch.Tensor:
        # a copy (np.array): wire arrays may be read-only buffers
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    me = worker_endpoint(args.worker)
    tr = SocketTransport.connect(args.host, args.port, me,
                                 timeout_s=args.connect_timeout,
                                 wire_version=args.wire)
    report = {"worker": args.worker, "device": str(dev), "rounds": 0,
              "exit": "hangup", "startup_s": time.monotonic() - _T0}
    if args.join_at_round is not None:
        if args.wire < 2:
            raise SystemExit(f"{me}: --join-at-round needs wire v2 (a v1 "
                             f"fleet has no JOIN frame)")
        # wait for the master's HELLO2 ack: JOIN is a v2-only frame
        deadline = time.monotonic() + args.connect_timeout
        while tr.peer_version(MASTER) < 2:
            if time.monotonic() > deadline:
                raise SystemExit(f"{me}: master never acked HELLO2; cannot "
                                 f"announce an elastic JOIN to a v1 master")
            tr.next_delivery(me)
        tr.send(MASTER, Join(args.worker, args.join_at_round,
                             time.monotonic()))
    pending: collections.deque = collections.deque()
    state: dict[str, object] = {}

    def drain() -> None:
        """Pull everything off the wire: EncodeShares into the work queue
        with their arrival stamps, Epochs into the state."""
        for at, msg in tr.recv(me, math.inf):
            if isinstance(msg, Epoch):
                state["epoch"] = msg.epoch         # informational
            elif isinstance(msg, EncodeShare):
                pending.append((at, msg))

    def provision(p: dict) -> None:
        protocol = p.get("protocol", "cpml")
        if protocol in _NOT_PORTED:
            raise _Refused(
                f"{me}: the {protocol!r} worker mode is not ported yet "
                f"(ROADMAP.md {_NOT_PORTED[protocol]})")
        state["trace"] = bool(p.get("trace"))
        cfg = CPMLConfig(**p["cfg"])
        state["f"] = compute.worker_fn(cfg, to_dev(p["cbar"], np.int32))
        x_share = to_dev(p["x_share"], np.int32)
        state["x_share"] = x_share
        # warm-up: one round at the real shapes before the ack
        rows = (cfg.batch_rows if cfg.batch_rows is not None
                else x_share.shape[0])
        t_c0 = time.monotonic()
        xw = x_share.index_select(
            0, torch.zeros(rows, dtype=torch.int64, device=dev))
        ww = torch.zeros((x_share.shape[1], cfg.c, cfg.r), dtype=torch.int32,
                         device=dev)
        state["f"](xw, ww).cpu()
        report["warmup_s"] = time.monotonic() - t_c0
        # the rounds' launches are counted from here on
        report["warmup_launches"] = dict(LAUNCHES)
        if state["trace"]:
            # rides the first traced result, like the reference's
            # warm_compile span
            state["carry"] = [["warm_compile", t_c0, time.monotonic()]]

    def cpml_round(at: float, msg) -> None:
        t0 = time.monotonic()
        spans = state.pop("carry", []) if state.get("trace") else None
        if spans is not None:
            spans.append(["recv", at, t0])
        if args.sleep_s > 0:
            time.sleep(args.sleep_s)
            if spans is not None:
                spans.append(["straggle", t0, time.monotonic()])
        t1 = time.monotonic()
        w_share = to_dev(msg.payload["w_share"], np.int32)
        batch = msg.payload.get("batch")
        x_share = state["x_share"]
        cached = state.get("xb_cache")
        if batch is None:
            xb = x_share
        elif cached is not None and cached[0] == msg.round:
            xb = cached[1]            # pre-sliced from last round's next_batch
        else:
            xb = x_share.index_select(0, to_dev(batch, np.int64))
        r = state["f"](xb, w_share)
        sync()
        t2 = time.monotonic()
        if spans is not None:
            spans.append(["compute", t1, t2])
        result = r.cpu().numpy()                          # int32 (d, c)
        t3 = time.monotonic()
        if spans is not None:
            spans.append(["serialize", t2, t3])
        tr.send(MASTER,
                WorkerResult(msg.round, args.worker,
                             compute_s=time.monotonic() - t0,
                             payload=result, trace=spans))
        report["rounds"] += 1
        if spans is not None:
            state["carry"] = [["send", t3, time.monotonic()]]
        nxt = msg.payload.get("next_batch")
        state["xb_cache"] = (
            None if nxt is None
            else (msg.round + 1, x_share.index_select(0, to_dev(nxt,
                                                                np.int64))))

    try:
        while not tr.peer_closed:
            if not pending:
                if tr.next_delivery(me) is not None:
                    drain()
                continue
            at, msg = pending.popleft()
            if msg.round == SHUTDOWN_ROUND:
                report["exit"] = "shutdown"
                return 0
            if msg.round == PROVISION_ROUND:
                provision(msg.payload)
                tr.send(MASTER, Heartbeat(args.worker, time.monotonic()))
                continue
            if args.die_at_round is not None \
                    and msg.round >= args.die_at_round:
                report["exit"] = f"die_at_round {msg.round}"
                return 0                # crash: no heartbeat, no result
            tr.send(MASTER, Heartbeat(args.worker, time.monotonic()))
            if "f" not in state:
                raise RuntimeError(f"{me}: round {msg.round} share arrived "
                                   f"before provisioning")
            cpml_round(at, msg)
        return 0
    except _Refused as e:
        report["exit"] = "refused"
        print(e, file=sys.stderr)
        return 2
    finally:
        tr.close()
        base = report.get("warmup_launches", {})
        report["launches"] = {k: v - base.get(k, 0)
                              for k, v in LAUNCHES.items()}
        print(json.dumps(report), flush=True)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch import device as _device
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"cpml_worker {args.worker}: {e}", file=sys.stderr)
        return 2
    try:
        return serve(args, dev)
    except OSError as e:
        print(f"cpml_worker {args.worker}: cannot reach master at "
              f"{args.host}:{args.port}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
