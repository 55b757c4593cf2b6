"""CodedPrivateML worker process on torch: serves coded rounds over a socket.

    python -m repro_torch.launch.cpml_worker --port 9000 --worker 3
    python -m repro_torch.launch.cpml_worker --port 9000 --worker 3 --device cpu

Mirrors ``repro/launch/cpml_worker.py`` and its five modes: ``"cpml"``,
``"mpc"``, ``"serve"``, ``"alcc"`` and ``"alcc_mlp"``.  It speaks the same
wire (v1 or v2; the ALCC modes' float frames are v2), so the reference's
master drives it in every mode but ``"mpc"`` (whose reshare masks come
from seeds only the port's master ships).  One process is one of the
paper's N workers:

  1. PROVISION: an EncodeShare with ``round == PROVISION_ROUND`` carrying
     {cfg kwargs, the dataset share, the coefficients c̄}.  The share goes
     to the device, then one warm-up round runs at the round's real shapes
     (kernel load, CUDA init, the sub-batch gather), and only then does the
     worker ack with a Heartbeat: round 0 is not charged for start-up.
     ``"protocol": "mpc"`` selects the BGW baseline: the share is a Shamir
     share of the whole dataset X̄_i, kept on the device beside its
     transpose.  ``"serve"`` carries the model share W̃_i (int32, kept on
     the device for the deployment) and the flush's row count; the
     warm-up is one product at that shape.  ``"alcc"`` carries a float32
     dataset share and the real surrogate's coefficients; ``"alcc_mlp"``
     a float32 dataset share and the hidden width, and warms up both
     phases' products.
  2. ROUNDS, "cpml": each EncodeShare(t, i, {"w_share", "batch",
     "next_batch"}) is acked with a Heartbeat, then answered with
     WorkerResult(t, i, compute_s, f(X̃_i[batch], W̃_i)), where f is
     ``compute.worker_fn``: one ``coded_grad`` launch with N = 1 on the
     card, its plain version on the CPU.  The sub-batch is an
     ``index_select`` on the device; a pipelined master's ``next_batch`` is
     gathered after the reply, while the next weight share is in flight.
     ROUNDS, "mpc": each EncodeShare(t, i, {"w_share", "kred"}) runs the
     BGW phases through the core/mpc_baseline hooks: the local product
     z = X̄_i·w̄_i, then one reshare barrier per degree reduction (this
     worker draws its reshare masks from the shipped seed, sends a
     SubShare to every peer through the master's relay, and blocks until
     all N sub-shares are in), then g = X̄_iᵀ·s, answered with
     CombineResult(t, i, compute_s, g).  Two ``modmatmul`` launches a
     round on the card.
     ROUNDS, "serve": each EncodeShare(t, i, {"x_share"}) is one coded
     flush, answered with X̃_i·W̃_i mod p: one ``modmatmul`` launch.
     ROUNDS, "alcc": f(X̃_i[batch], W̃_i) = X̃ᵀ ĝ(X̃ W̃) in float32;
     "alcc_mlp": by round parity, X̃_i[batch] @ W̃1_i (even rounds) or
     X̃_i[batch]ᵀ @ δ̃1_i (odd), both float32 matmuls, no custom kernel.
  3. SHUTDOWN: ``round == SHUTDOWN_ROUND``, or the master hanging up.

On leaving its serve loop the worker prints one JSON line to stdout: its
device, rounds answered, why it stopped, start-up and warm-up seconds,
the kernel launches of its rounds (``launches``) and those of the warm-up
(``warmup_launches``), both from ``kernels.LAUNCHES``.

``--die-at-round R`` exits without replying when round R's share arrives;
``--sleep-s S`` sleeps S seconds before every reply (a real straggler; in
the "mpc" mode before every phase's sends, which stalls every peer at the
barrier); ``--barrier-timeout S`` bounds the wait at a reshare barrier,
and a master that hangs up ends it at once; ``--join-at-round R``
announces an elastic JOIN for round R's fence.  Runs on CUDA unless
``--device cpu``; without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import time

_T0 = time.monotonic()    # before torch is imported: start-up seconds


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CodedPrivateML socket worker "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker", type=int, required=True,
                    help="this worker's index i in [0, N)")
    ap.add_argument("--connect-timeout", type=float, default=30.0)
    ap.add_argument("--barrier-timeout", type=float, default=600.0,
                    help="seconds to wait at an MPC reshare barrier before "
                         "giving up (a missing peer means the round can "
                         "never complete)")
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


def serve(args, dev) -> int:
    import numpy as np
    import torch

    from repro_torch.cluster.messages import (
        MASTER, PROVISION_ROUND, SHUTDOWN_ROUND, CombineResult, EncodeShare,
        Epoch, Heartbeat, Join, SubShare, WorkerResult, worker_endpoint)
    from repro_torch.cluster.socket_transport import SocketTransport
    from repro_torch.core import field
    from repro_torch.core import mpc_baseline as mpc
    from repro_torch.core.protocol import alcc_engine, compute
    from repro_torch.core.protocol.config import CPMLConfig
    from repro_torch.core.protocol.draws import TorchMPCDraws
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
    subshares: dict[tuple[int, int], dict[int, object]] = {}

    def drain() -> None:
        """Pull everything off the wire: EncodeShares into the work queue
        with their arrival stamps, SubShares into their (round, phase)
        buffer, Epochs into the state."""
        for at, msg in tr.recv(me, math.inf):
            if isinstance(msg, SubShare):
                subshares.setdefault((msg.round, msg.phase),
                                     {})[msg.src] = msg.payload
            elif isinstance(msg, Epoch):
                state["epoch"] = msg.epoch         # informational
            elif isinstance(msg, EncodeShare):
                pending.append((at, msg))

    def warmed(t_c0: float) -> None:
        """End of a warm-up begun at ``t_c0``: its seconds and launches
        go apart from the rounds'."""
        report["warmup_s"] = time.monotonic() - t_c0
        report["warmup_launches"] = dict(LAUNCHES)
        if state["trace"]:
            # rides the first traced result, like the reference's
            # warm_compile span
            state["carry"] = [["warm_compile", t_c0, time.monotonic()]]

    def provision(p: dict) -> None:
        protocol = p.get("protocol", "cpml")
        state["trace"] = bool(p.get("trace"))
        state["protocol"] = protocol
        if protocol == "mpc":
            provision_mpc(p)
            return
        if protocol == "serve":
            provision_serve(p)
            return
        if protocol in ("alcc", "alcc_mlp"):
            provision_alcc(p)
            return
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
        warmed(t_c0)

    def provision_mpc(p: dict) -> None:
        cfg = mpc.MPCConfig(**p["cfg"])
        state["cfg"] = cfg
        state["cbar"] = to_dev(p["cbar"], np.int32)
        state["draws"] = TorchMPCDraws(0, dev)   # reshare masks: (seed, i)
        x_share = to_dev(p["x_share"], np.int32)               # (m, d)
        state["x_share"] = x_share
        state["x_share_t"] = x_share.T.contiguous()            # (d, m)
        # warm-up: both local products at the real shapes before the ack
        t_c0 = time.monotonic()
        m, d = x_share.shape
        z = mpc.worker_mul(cfg, state["x_share_t"],
                           torch.zeros((d, cfg.r), dtype=torch.int32,
                                       device=dev))
        mpc.worker_final(cfg, x_share, z[:, 0]).cpu()
        warmed(t_c0)

    def provision_serve(p: dict) -> None:
        # the model share W̃_i stays on the device for the deployment;
        # every flush is padded to the same (rows, d)
        state["p"] = int(p["p"])
        w_share = to_dev(p["w_share"], np.int32)               # (d, c)
        state["w_share"] = w_share
        t_c0 = time.monotonic()
        xw = torch.zeros((int(p["rows"]), w_share.shape[0]),
                         dtype=torch.int32, device=dev)
        field.matmul(xw, w_share, state["p"]).cpu()
        warmed(t_c0)

    def provision_alcc(p: dict) -> None:
        x_share = to_dev(p["x_share"], np.float32)             # (mk, d)
        state["x_share"] = x_share
        rows = int(p["cfg"].get("batch_rows") or x_share.shape[0])
        xw = torch.zeros((rows, x_share.shape[1]), dtype=torch.float32,
                         device=dev)
        t_c0 = time.monotonic()
        if state["protocol"] == "alcc":
            state["cbar"] = to_dev(p["cbar"], np.float32)
            alcc_engine.worker_eval(
                state["cbar"], xw,
                torch.zeros((x_share.shape[1], int(p["cfg"]["c"])),
                            dtype=torch.float32, device=dev)).cpu()
        else:
            h = int(p["hidden"])
            alcc_engine.mlp_worker_eval(0, xw, torch.zeros(
                (x_share.shape[1], h), dtype=torch.float32, device=dev)).cpu()
            alcc_engine.mlp_worker_eval(1, xw, torch.zeros(
                (rows, h), dtype=torch.float32, device=dev)).cpu()
        warmed(t_c0)

    def reshare_barrier(cfg, t: int, phase: int, seed: int, value):
        """One BGW degree reduction from this worker's seat: re-share, send
        a sub-share to every peer, then block until all N sub-shares of
        (t, phase) are in and combine them."""
        if args.sleep_s > 0:
            time.sleep(args.sleep_s)
        masks = mpc.reshare_masks(cfg, state["draws"], seed, args.worker,
                                  tuple(value.shape))
        sub = mpc.make_subshares(cfg, value, masks).cpu().numpy()
        for v in range(cfg.N):
            if v != args.worker:
                tr.send(worker_endpoint(v),
                        SubShare(t, phase, args.worker, v, sub[v]))
        got = {args.worker: sub[args.worker]}
        deadline = time.monotonic() + args.barrier_timeout
        while len(got) < cfg.N:
            for src, payload in subshares.pop((t, phase), {}).items():
                got[src] = payload
            if len(got) == cfg.N:
                break
            if tr.peer_closed:
                raise RuntimeError(f"{me}: master hung up during the reshare "
                                   f"barrier (round {t}, phase {phase})")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{me}: reshare barrier (round {t}, phase {phase}) "
                    f"starved: peers {sorted(set(range(cfg.N)) - set(got))} "
                    f"never re-shared")
            if tr.next_delivery(me) is not None:
                drain()
        gathered = to_dev(np.stack([np.asarray(got[i])
                                    for i in range(cfg.N)]), np.int32)
        return mpc.combine_subshares(cfg, gathered)

    def mpc_round(at: float, msg) -> None:
        cfg, cbar = state["cfg"], state["cbar"]
        t = msg.round
        t0 = time.monotonic()
        spans = state.pop("carry", []) if state.get("trace") else None
        if spans is not None:
            spans.append(["recv", at, t0])
        w_share = to_dev(msg.payload["w_share"], np.int32)        # (d, r)
        seeds = [int(k) for k in np.asarray(msg.payload["kred"])]
        z = mpc.worker_mul(cfg, state["x_share_t"], w_share)     # (m, r)
        t1 = time.monotonic()
        if spans is not None:
            spans.append(["compute", t0, t1])
        z = reshare_barrier(cfg, t, 0, seeds[0], z)
        if spans is not None:
            spans.append(["barrier", t1, time.monotonic()])
        prod = z[..., 0]
        s = mpc.s_init(cfg, cbar, prod)
        for i in range(2, cfg.r + 1):
            prod = field.mulmod(prod, z[..., i - 1], cfg.p)
            b0 = time.monotonic()
            prod = reshare_barrier(cfg, t, i - 1, seeds[i - 1], prod)
            if spans is not None:
                spans.append(["barrier", b0, time.monotonic()])
            s = mpc.s_accum(cfg, cbar[i], s, prod)
        if args.sleep_s > 0:
            time.sleep(args.sleep_s)
        t2 = time.monotonic()
        g = mpc.worker_final(cfg, state["x_share"], s).cpu().numpy()
        t3 = time.monotonic()
        if spans is not None:
            spans.append(["serialize", t2, t3])
        tr.send(MASTER, CombineResult(t, args.worker,
                                      time.monotonic() - t0, g,
                                      trace=spans))
        report["rounds"] += 1
        if spans is not None:
            state["carry"] = [["send", t3, time.monotonic()]]
        # reshare traffic of finished rounds can never be consumed again
        for key in [k for k in subshares if k[0] <= t]:
            del subshares[key]

    def straggle(at: float):
        """A round's start: its spans, and the injected sleep."""
        t0 = time.monotonic()
        spans = state.pop("carry", []) if state.get("trace") else None
        if spans is not None:
            spans.append(["recv", at, t0])
        if args.sleep_s > 0:
            time.sleep(args.sleep_s)
            if spans is not None:
                spans.append(["straggle", t0, time.monotonic()])
        return t0, spans

    def reply(msg, t0: float, t1: float, r, spans) -> None:
        """Time the computation begun at ``t1`` that ends with ``r``, send
        ``r`` back as the round's WorkerResult, and count the round."""
        sync()
        t2 = time.monotonic()
        if spans is not None:
            spans.append(["compute", t1, t2])
        result = r.cpu().numpy()
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

    def serve_round(at: float, msg) -> None:
        """One coded prediction flush: X̃_i arrives, X̃_i·W̃_i goes back."""
        t0, spans = straggle(at)
        t1 = time.monotonic()
        xb = to_dev(msg.payload["x_share"], np.int32)          # (rows, d)
        reply(msg, t0, t1, field.matmul(xb, state["w_share"], state["p"]),
              spans)

    def alcc_round(at: float, msg) -> None:
        """One ALCC float round; the MLP's phase is the round's parity."""
        t0, spans = straggle(at)
        t1 = time.monotonic()
        share = to_dev(msg.payload["w_share"], np.float32)
        batch = msg.payload.get("batch")
        xb = (state["x_share"] if batch is None
              else state["x_share"].index_select(0, to_dev(batch, np.int64)))
        if state["protocol"] == "alcc_mlp":
            r = alcc_engine.mlp_worker_eval(msg.round % 2, xb, share)
        else:
            r = alcc_engine.worker_eval(state["cbar"], xb, share)
        reply(msg, t0, t1, r, spans)

    def cpml_round(at: float, msg) -> None:
        t0, spans = straggle(at)
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
        reply(msg, t0, t1, state["f"](xb, w_share), spans)   # int32 (d, c)
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
            if "protocol" not in state:
                raise RuntimeError(f"{me}: round {msg.round} share arrived "
                                   f"before provisioning")
            protocol = state["protocol"]
            if protocol == "mpc":
                mpc_round(at, msg)
            elif protocol == "serve":
                serve_round(at, msg)
            elif protocol in ("alcc", "alcc_mlp"):
                alcc_round(at, msg)
            else:
                cpml_round(at, msg)
        return 0
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
