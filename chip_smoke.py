#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--phases kernels[,train,...]]

Run from the repository root on a machine with one CUDA card.  It prints
one JSON object per line, in phases, and fails (non-zero exit) if any
phase fails.  ``--phases`` runs the build and the named phases only (for
iterating on a kernel); such a partial run prints no ok line.

  build     builds the three CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels   holds each field kernel bit for bit against its plain PyTorch
            version on the card: the main path's shapes at the paper's
            Case 1 (N=40, K=13, T=1, m=12396, d=1568), both primes,
            all-(p-1) inputs, odd shapes, the accumulator-reduction
            boundary, ``modmatmul``'s row templates (M = 1, 4, 6, 17, 40),
            fold interval (K = L, L+1, 2L+1, also in one K-slice) and K-split
            edges (K = 4096, N = 1, 255, 16256), and ``modmatmul`` at the
            coded LM head's shapes (P30); ``coded_grad`` at Case 1 with
            c = 1, 10 and 33 heads, one socket worker's N = 1, c = 17 r = 2 and c = 5 r = 7 (c*r
            above 32), r = 33 with a random c̄, all-(p-1) inputs at P30
            with a thread's columns and the rows per tile at L-1, L, L+1
            (forced plans), and d = 60000 on the re-read route; the
            selective scan against its plain version within 1e-4 at the
            serve shape (x and dt bf16 as
            served, dt f32, x f32, non-zero h0), S = 1, S = 33, di = 8200,
            n in {1, 3, 4, 16} with di not a multiple of the block's
            channels (and rows not 16-byte aligned), B 1 x di 96 and
            S = 8192; ``modmatmul`` at the BGW baseline's two local
            products at Case 1 in both orientations; and times each
            main-path shape (CUDA events; the
            field kernels also replayed from a CUDA graph, the device's time
            without the host's launch cost) beside its plain version and
            its bound
  train     ``repro_torch.launch.cpml_train`` at Case 1 for 25 rounds on
            the card: both field kernels launched (launch counts reset just
            before, read just after), coded accuracy within 0.03 of the
            cleartext baseline
  train_c33 ``cpml_train --classes 33 --iters 2`` on the card (33 heads,
            N=8, K=2, T=1): exit 0 and ``coded_grad`` launched twice
  teacher   3 rounds on the card and again on the CPU (plain versions)
            from the card's weights: shares and decoded parts bit-equal,
            weights within 1e-5; then the round's stages timed on the card
  serve     ``repro_torch.launch.serve`` for falcon-mamba-7b at full width
            and all 64 layers in bf16, batch 4, prompt 2048, 32 generated
            tokens: ``selective_scan`` launched exactly once per layer,
            tokens in range, logits finite; prefill seconds, decode
            tokens/s, peak device memory
  profile   one prefill at the serve shape and 8 decode steps under
            torch.profiler: device time by kernel group, the scan's share
            of it, busy share
  consistency  falcon-mamba-7b at full width, 2 layers, float32: prefill
            on the card (kernel) against the CPU (plain version), and
            prefill + 3 decode steps against ``backbone`` over S+3 on the
            card, both within 1e-3
  coded_head   ``serve --coded-head --kill-shard 2`` at full width, then
            the decoded field values bit-equal to (h_q @ w_q) mod p from
            the plain version
  cluster   ``repro_torch.launch.cpml_cluster`` in process on the card:
            Case 1 for 25 rounds under lognormal latencies with ``--pipeline
            off`` and ``full``, and N=8, K=2, T=1 at Case 1's m and d for
            10 rounds with a worker dead from round 3; each bit-identical to
            train_reference over its responder trace, ``coded_grad``
            launched once a round; round ms on the host clock, first-T and
            wait-all waits on the simulated clock
  socket    ``cpml_cluster --transport socket`` on the card, one worker
            process per slot, each on cuda: Case 1 with all 40 workers for
            25 rounds (``--pipeline full``), the N=8 fleet for 10 rounds with
            worker 5 killed at round 4 and worker 3 sleeping 0.1 s before
            each reply, and that straggler again with ``--collect-all``;
            each bit-identical to train_reference, every live worker on
            cuda with a ``coded_grad`` launch per round it answered; start-up
            and provision seconds, median round wall time, first-T against
            wait-all, wire bytes per round, peak device memory (nvidia-smi)
  mpc       ``cpml_cluster --protocol mpc`` in process on the card at
            Case 1 (N=40, T=1) for 10 rounds: bit-identical to the
            single-host ``mpc_baseline.train``, ``modmatmul`` launched
            exactly twice per worker a round and nothing else; then one
            more runner's rounds under torch.profiler (device ms a round)
            and its peak device memory
  mpc_socket  ``cpml_cluster --protocol mpc --transport socket``: 40 worker
            processes at Case 1 for 10 rounds, then N=8 with worker 3
            sleeping 0.1 s before each phase; each bit-identical to the
            oracle, every worker on cuda with two ``modmatmul`` launches
            a round and two in its warm-up; provisioning seconds and
            bytes, median round, wire bytes a round, peak device memory,
            and ``speedup_vs_mpc`` against the socket phase's Case 1 round
  resilient ``cpml_cluster --resilient`` at N=8, K=2, T=1 with Case 1's m
            and d: in process with two workers dead from round 3, then
            over sockets with workers 0 and 1 crashing at round 4; each
            restarts at least once and is bit-identical to
            train_reference, and over sockets the respawned processes run
            on cuda
  predict   ``repro_torch.launch.cpml_serve`` in process on the card at
            the Case 1 fleet (N=40, K=13, T=1, threshold 27) serving the
            multiclass MNIST head (d=784, 10 classes), max_batch 104,
            max_wait 20 ms: 256 open-loop queries of 4 rows at 200/s, then
            32 closed-loop queries of 104 rows; every flush bit-identical
            to the uncoded oracle and ``modmatmul`` launched exactly 30
            times a flush (encode, 27 products, decode, oracle); queries/s
            and first-threshold against wait-for-all latency on the
            simulated clock; then a flush's device time under
            torch.profiler.  The kernels phase holds ``modmatmul`` at
            serving's five shapes (``kernels_predict``)
  predict_socket  ``cpml_serve --transport socket``: 40 worker processes at
            the Case 1 fleet with worker 7 sleeping 0.25 s, then N=8, K=2,
            T=1 with worker 5 killed at flush 3 and worker 3 sleeping 0.1
            s, then that straggler with ``--collect-all``; every flush
            bit-identical, every live worker on cuda with one
            ``modmatmul`` a flush; connected and provision seconds, wire
            bytes a flush, peak device memory, each worker's exit line
  alcc      ``cpml_cluster --engine alcc`` in process at Case 1's m and d
            for 25 rounds, on the N=8 fleet and on Case 1's (N=40, K=13):
            bit-identical to ``alcc_engine.train_reference``, decode
            condition number and error budget, round ms beside the cluster
            phase's exact round of the same fleet; at N=8 accuracy within
            0.01 of the uncoded float oracle (at N=40 the float32 worker
            results overflow, as in the reference)
  alcc_socket  the same over sockets at N=8, K=2, T=1 (Case 1's m and d,
            10 rounds, worker 3 sleeping 0.1 s): within 1e-3 of the replay
  alcc_mlp  ``cpml_cluster --engine alcc --model mlp`` (m=12396, d=784, 10
            classes, hidden 128, 40 steps) at N=8, K=2, T=1, in process
            (bit-identical to its replay) and over sockets (within 1e-3);
            each within 0.05 of the plaintext oracle's loss
  summary   the {"kernels": [...]} line, then the card's name and power
            limit, then {"ok": true, "device": {...}} as the last line

It exits non-zero and prints no result without CUDA, or without the rest
of the repository beside it.  It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Case 1 of the paper (benchmarks/phases.py case1(40)): binary MNIST shapes.
CASE1 = dict(N=40, K=13, T=1, m=12396, d=1568, iters=25)
# Draw seed of the train phase.  At Case 1 the accuracy after each round
# swings between ~50% and ~83% with the seed of the weight quantization
# (lw = 4; the reference does the same, PERF.md), so the accuracy check
# needs a fixed seed; with seed 1 round 25 lands at 82.43% (H100 run).
TRAIN_SEED = 1
# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the scalar
# float32 rate outside the tensor cores, the highest published rate for
# scalar arithmetic (no integer-multiply rate is published).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# 32-bit integer multiply-adds: 64 per clock per SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1.98 GHz boost clock; a 32x32 -> 64 multiply-add takes two.
IMAD_PER_S = 64 * 132 * 1.98e9
# exp on the multi-function units: 16 per clock per SM (CUDA C programming
# guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x the 1.98 GHz boost clock of the SXM part (NVIDIA data sheet).
SPECIAL_OPS_PER_S = 16 * 132 * 1.98e9
WEIGHT_ATOL = 1e-5  # float32 summation order: cuBLAS vs CPU in xqᵀ·targets
# The selective scan: the same float32 recurrence summed in another order
# (the reference's kernel test uses 1e-4 too).
SCAN_ATOL = 1e-4
# falcon-mamba at full width, float32 parameters: card vs CPU and decode vs
# the full forward, the reference model tests' own tolerance.
MODEL_ATOL = 1e-3
SERVE = dict(arch="falcon-mamba-7b", batch=4, prompt_len=2048, gen=32)
CODED = dict(batch=4, prompt_len=16, gen=4, kill_shard=2)
# More heads than the first coded_grad kernel took (c*r <= 32).
TRAIN_HEADS = dict(classes=33, iters=2)
PHASES = ("kernels", "train", "train_c33", "teacher", "serve", "profile",
          "consistency", "coded_head", "cluster", "socket", "mpc",
          "mpc_socket", "resilient", "predict", "predict_socket", "alcc",
          "alcc_socket", "alcc_mlp")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float, special: float = 0, imad: float = 0
          ) -> tuple[float, str]:
    """Least ms for the work: bytes at the memory rate against the scalar
    float operations, the special-function ops (exp) and the 32-bit
    integer multiply-adds, each at its rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / SCALAR_OPS_PER_S, special / SPECIAL_OPS_PER_S,
                imad / IMAD_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, trials: int = 3) -> float:
    """Median over trials of (CUDA-event time of `reps` calls) / reps."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def graph_ms(torch, fn, reps: int) -> float:
    """ms per call of `reps` calls captured in one CUDA graph and replayed:
    the device's time without the host's cost of each launch, which an
    eager loop of small launches measures instead (``time_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm-up off the capture: builds, allocator pools
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, 3) / reps


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Checks:
    """Kernel-vs-plain comparisons; remembers the largest error per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {"modmatmul": 0, "coded_grad": 0, "selective_scan": 0.0}

    def compare(self, kernel: str, case: str, got, want, **info) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "bit_equal": err == 0, "max_abs_err": err, **info})
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{kernel} {case}: kernel != plain version "
                                 f"(max abs err {err})")

    def close(self, kernel: str, case: str, got, want, atol: float,
              **info) -> None:
        """Float outputs (tuples of tensors) within ``atol``."""
        torch = self.torch
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(f"{kernel} {case}: shapes {g.shape} vs "
                                     f"{w.shape}")
            err = max(err, float((g.float() - w.float()).abs().max()))
        self.max_err[kernel] = max(self.max_err[kernel], err)
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tolerance": atol, **info})
        if not err <= atol:
            raise AssertionError(f"{kernel} {case}: kernel != plain version "
                                 f"(max abs err {err} > {atol})")


def phase_kernels(torch, checks: Checks) -> list[dict]:
    from repro_torch.core import field, sigmoid_poly
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import coded_grad as cg
    from repro_torch.kernels import modmatmul as mm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    N, K, T, d = CASE1["N"], CASE1["K"], CASE1["T"], CASE1["d"]
    mk = -(-CASE1["m"] // K)

    def rand(shape, p):
        return torch.randint(0, p, shape, generator=gen, dtype=torch.int32,
                             device=dev)

    def full(shape, p):
        return torch.full(shape, p - 1, dtype=torch.int32, device=dev)

    # -- modmatmul: encode / decode shapes, extremes, odd shapes, R bound --
    mm_cases = []
    for p in (field.P, field.P30):
        mm_cases += [
            ("dataset_encode", p, rand((N, K + T), p), rand((K + T, mk * d), p)),
            ("weight_encode_c1r1", p, rand((N, K + T), p), rand((K + T, d), p)),
            ("weight_encode_c10r2", p, rand((N, K + T), p),
             rand((K + T, d * 20), p)),
            ("decode_c1", p, rand((K, N), p), rand((N, d), p)),
            ("decode_c10", p, rand((K, N), p), rand((N, d * 10), p)),
            ("all_p_minus_1", p, full((N, K + T), p), full((K + T, 100003), p)),
            ("odd_257x129x65", p, rand((257, 129), p), rand((129, 65), p)),
            ("odd_1x1x1", p, rand((1, 1), p), rand((1, 1), p)),
        ]
        R = build.reduce_every(p)
        for kk in (R, R + 1, 2 * R + 1):
            mm_cases.append((f"reduce_bound_K={kk}", p, full((5, kk), p),
                             full((kk, 257), p)))
        # each row template (M = 1, 4, 6 -> 8, 17 -> 3 x 8, 40 -> 5 x 8)
        for M in (1, 4, 6, 17, 40):
            mm_cases.append((f"rows_M={M}", p, rand((M, 37), p),
                             rand((37, 1001), p)))
            mm_cases.append((f"rows_M={M}_vec", p, rand((M, 9), p),
                             rand((9, 1 << 20), p)))
        # the fold interval L, worst-case inputs
        L = build.fold_every(p)
        for kk in (L, L + 1, 2 * L + 1):
            mm_cases.append((f"fold_bound_K={kk}", p, full((5, kk), p),
                             full((kk, 257), p)))
        # the K-split's edges: one column, a ragged block, the shard's width
        for NN in (1, 255, 16256):
            mm_cases.append((f"ksplit_K=4096_N={NN}", p, rand((4, 4096), p),
                             rand((4096, NN), p)))
    for case, p, a, b in mm_cases:
        got = mm.modmatmul(a, b, p)
        want = ref.modmatmul_ref(a, b, p)
        M, KK, NN = a.shape[0], a.shape[1], b.shape[1]
        pl = mm.plan(M, KK, NN, vec=b.data_ptr() % 16 == 0,
                     sms=mm.sm_count(a.device))
        checks.compare("modmatmul", case, got, want, p=p, shape=[M, KK, NN],
                       plan=[pl.rows, pl.cols, pl.threads, pl.splits])
        if case.startswith("fold_bound") and pl.splits > 1:
            # the plan's K-slices stay below L at P: fold in one slice too
            one = dataclasses.replace(pl, threads=32, splits=1, slice=KK)
            checks.compare("modmatmul", case + "_one_slice",
                           mm.run(a, b, p, one), want, p=p, shape=[M, KK, NN],
                           plan=[one.rows, one.cols, one.threads, one.splits])

    # -- coded_grad: main-path shapes, both primes, extremes, odd shapes,
    #    many heads (c*r > 32), high degree, the fold interval, re-read --
    def coeffs(r, p):
        return torch.as_tensor(sigmoid_poly.quantized_coeffs(r, 2, 4, 6, p),
                               dtype=torch.int32, device=dev)

    cg_cases = []   # (case, p, x, w, cbar, forced plan or None)
    for p in (field.P, field.P30):
        for c, r in ((1, 1), (10, 2)):
            cg_cases.append((f"case1_c{c}_r{r}", p, rand((N, mk, d), p),
                             rand((N, d, c, r), p), coeffs(r, p), None))
            cg_cases.append((f"all_p_minus_1_c{c}_r{r}", p, full((N, mk, d), p),
                             full((N, d, c, r), p), full((r + 1,), p), None))
        cg_cases.append(("odd_N3_mk97_d131_c3_r3", p, rand((3, 97, 131), p),
                         rand((3, 131, 3, 3), p), coeffs(3, p), None))
        cg_cases.append(("odd_N5_mk65_d33_c10_r3", p, rand((5, 65, 33), p),
                         rand((5, 33, 10, 3), p), coeffs(3, p), None))
        cg_cases.append(("odd_N2_mk1_d1_c1_r1", p, rand((2, 1, 1), p),
                         rand((2, 1, 1, 1), p), coeffs(1, p), None))
        # one socket worker's round: N = 1 at Case 1's share
        cg_cases.append(("worker_N1_c1_r1", p, rand((1, mk, d), p),
                         rand((1, d, 1, 1), p), coeffs(1, p), None))
        # more heads than the old kernel's 32 registers held (c*r > 32)
        cg_cases.append(("case1_c33_r1", p, rand((N, mk, d), p),
                         rand((N, d, 33, 1), p), coeffs(1, p), None))
        cg_cases.append(("N8_mk131_d97_c17_r2", p, rand((8, 131, 97), p),
                         rand((8, 97, 17, 2), p), coeffs(2, p), None))
        cg_cases.append(("N8_mk131_d97_c5_r7", p, rand((8, 131, 97), p),
                         rand((8, 97, 5, 7), p), coeffs(7, p), None))
        # degree 33: no fitted sigmoid of that degree, a random c̄ of 34
        cg_cases.append(("N3_mk9_d21_c1_r33", p, rand((3, 9, 21), p),
                         rand((3, 21, 1, 33), p), rand((34,), p), None))
        # the re-read route: one row of d does not fit in shared memory
        cg_cases.append(("reread_N2_mk5_d60000_c2_r1", p, rand((2, 5, 60000), p),
                         rand((2, 60000, 2, 1), p), coeffs(1, p), None))
    # the fold interval L at P30, all p-1: a thread's column count (d at
    # 32 threads) and the rows per tile at L-1, L and L+1
    p = field.P30
    L = build.fold_every(p)
    for kk in (L - 1, L, L + 1):
        for c, r in ((1, 1), (3, 2)):
            dd = 32 * kk
            pl = cg.fixed_plan(3, 2 * kk + 1, dd, c, r, rows=kk, stages=2,
                               part_smem=True, threads=32, splits=2)
            cg_cases.append((f"fold_L{kk - L:+d}_c{c}_r{r}", p,
                             full((3, 2 * kk + 1, dd), p),
                             full((3, dd, c, r), p), full((r + 1,), p), pl))
    for case, p, x, w, cbar, pl in cg_cases:
        N_, mk_, d_ = x.shape
        c_, r_ = w.shape[2:]
        if pl is None:
            pl = cg.plan(N_, mk_, d_, c_, r_, sms=mm.sm_count(x.device))
            got = cg.coded_grad(x, w, cbar, p)
        else:
            got = cg.run(x, w, cbar, p, pl)
        want = ref.coded_grad_workers_ref(x, w, cbar, p)
        checks.compare("coded_grad", case, got, want, p=p,
                       shape=list(x.shape) + list(w.shape[2:]),
                       plan=[pl.rows, pl.stages, pl.group, pl.chunk, pl.threads,
                             pl.splits, int(pl.part_smem), pl.smem])
        del x, w, got, want
    del cg_cases

    # -- timings at the main path's shapes (Case 1, p = P) --
    p = field.P
    timings = []
    for case, a, b in (
            ("dataset_encode", rand((N, K + T), p), rand((K + T, mk * d), p)),
            ("weight_encode_c1r1", rand((N, K + T), p), rand((K + T, d), p)),
            ("decode_c1", rand((K, N), p), rand((N, d), p))):
        M, KK = a.shape
        NN = b.shape[1]
        b_ms, b_by = bound(4 * (M * KK + KK * NN + M * NN), 2 * M * KK * NN)
        timings.append({
            "kernel": "modmatmul", "case": case, "shape": [M, KK, NN],
            "ms": time_ms(torch, lambda: mm.modmatmul(a, b, p), 20),
            "graph_ms": graph_ms(torch, lambda: mm.modmatmul(a, b, p), 20),
            "plain_ms": time_ms(torch, lambda: ref.modmatmul_ref(a, b, p), 3),
            "bound_ms": b_ms, "bound_by": b_by})
    for n, c, r, case in ((N, 1, 1, "case1_c1_r1"), (N, 10, 2, "case1_c10_r2"),
                          (1, 1, 1, "worker_N1_c1_r1")):
        x, w = rand((n, mk, d), p), rand((n, d, c, r), p)
        cbar = coeffs(r, p)
        nbytes = 4 * (n * mk * d + n * d * c * r + (r + 1) + n * d * c)
        # n mk d (c r + c) multiply-adds of 32x32 -> 64 bits, two IMADs each
        b_ms, b_by = bound(nbytes, 0, imad=2 * n * mk * d * (c * r + c))
        pl = cg.plan(n, mk, d, c, r, sms=mm.sm_count(x.device))
        timings.append({
            "kernel": "coded_grad", "case": case,
            "shape": [n, mk, d, c, r],
            "launches_per_call": 1 + (pl.splits > 1),
            "ms": time_ms(torch, lambda: cg.coded_grad(x, w, cbar, p), 20),
            "graph_ms": graph_ms(torch, lambda: cg.coded_grad(x, w, cbar, p),
                                 20),
            "plain_ms": time_ms(
                torch, lambda: ref.coded_grad_workers_ref(x, w, cbar, p), 3),
            "bound_ms": b_ms, "bound_by": b_by})
    for t in timings:
        emit({"phase": "kernels", "timing": t})
    return timings


def phase_kernels_coded_head(torch, checks: Checks) -> list[dict]:
    """``modmatmul`` at the coded LM head's shapes, P30: one shard's
    product (4 x 4096)·(4096 x 16256) and the head encode
    (6 x 5)·(5 x 4096·16256).  Bit-equal, then timed."""
    from repro_torch.core import field
    from repro_torch.kernels import ref
    from repro_torch.kernels import modmatmul as mm

    p = field.P30
    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda shape: torch.randint(0, p, shape, generator=gen,  # noqa: E731
                                       dtype=torch.int32, device="cuda")
    timings = []
    for case, a, b in (("coded_head_shard", rand((4, 4096)), rand((4096, 16256))),
                       ("coded_head_encode", rand((6, 5)),
                        rand((5, 4096 * 16256)))):
        checks.compare("modmatmul", case, mm.modmatmul(a, b, p),
                       ref.modmatmul_ref(a, b, p), p=p,
                       shape=[a.shape[0], a.shape[1], b.shape[1]])
        M, KK = a.shape
        NN = b.shape[1]
        b_ms, b_by = bound(4 * (M * KK + KK * NN + M * NN), 2 * M * KK * NN)
        timings.append({
            "kernel": "modmatmul", "case": case, "shape": [M, KK, NN],
            "ms": time_ms(torch, lambda: mm.modmatmul(a, b, p), 10),
            "graph_ms": graph_ms(torch, lambda: mm.modmatmul(a, b, p), 4),
            "plain_ms": time_ms(torch, lambda: ref.modmatmul_ref(a, b, p), 1),
            "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "kernels", "timing": timings[-1]})
    return timings


def phase_kernels_mpc(torch, checks: Checks) -> list[dict]:
    """``modmatmul`` at the BGW baseline's two local products at Case 1,
    one worker's whole-dataset share X̄ (m x d), in both orientations:
    z = X̄·w̄ as (m x d)·(d x 1) and as w̄ᵀ·X̄ᵀ, (1 x d)·(d x m) (the port's),
    g = X̄ᵀ·s as (d x m)·(m x 1) and as sᵀ·X̄, (1 x m)·(m x d) (the port's).
    Bit-equal at both primes, then timed at P against the byte bound."""
    from repro_torch.core import field
    from repro_torch.kernels import ref
    from repro_torch.kernels import modmatmul as mm

    gen = torch.Generator(device="cuda").manual_seed(5)
    m, d = CASE1["m"], CASE1["d"]
    timings = []
    for p in (field.P, field.P30):
        def rand(shape):
            return torch.randint(0, p, shape, generator=gen,
                                 dtype=torch.int32, device="cuda")
        x = rand((m, d))
        xt = x.T.contiguous()
        w, s_ = rand((d, 1)), rand((m, 1))
        for case, a, b in (
                ("mpc_mul_direct", x, w),
                ("mpc_mul_transposed", w.T.contiguous(), xt),
                ("mpc_final_direct", xt, s_),
                ("mpc_final_transposed", s_.T.contiguous(), x)):
            M, KK = a.shape
            NN = b.shape[1]
            pl = mm.plan(M, KK, NN, vec=b.data_ptr() % 16 == 0,
                         sms=mm.sm_count(a.device))
            checks.compare("modmatmul", case, mm.modmatmul(a, b, p),
                           ref.modmatmul_ref(a, b, p), p=p,
                           shape=[M, KK, NN],
                           plan=[pl.rows, pl.cols, pl.threads, pl.splits,
                                 pl.blocks])
            if p != field.P:
                continue
            b_ms, b_by = bound(4 * (M * KK + KK * NN + M * NN),
                               2 * M * KK * NN)
            timings.append({
                "kernel": "modmatmul", "case": case, "shape": [M, KK, NN],
                "plan": [pl.rows, pl.cols, pl.threads, pl.splits, pl.blocks],
                "ms": time_ms(torch, lambda: mm.modmatmul(a, b, p), 20),
                "graph_ms": graph_ms(torch, lambda: mm.modmatmul(a, b, p),
                                     20),
                "plain_ms": time_ms(
                    torch, lambda: ref.modmatmul_ref(a, b, p), 3),
                "bound_ms": b_ms, "bound_by": b_by})
            emit({"phase": "kernels", "timing": timings[-1]})
        del x, xt
    return timings


def scan_inputs(torch, gen, B, S, di, n, x_dtype, h0_scale,
                dt_dtype=None):
    """The reference kernel test's distributions, on the card; dt in
    float32 unless ``dt_dtype`` says otherwise (bf16 on the serve path)."""
    F = torch.nn.functional

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (randn(B, S, di) * 0.5).to(x_dtype)
    dt = F.softplus(randn(B, S, di)).to(dt_dtype or torch.float32)
    a_log = torch.log(torch.rand((di, n), generator=gen, device="cuda") * 1.7
                      + 0.3)
    return (x, dt, randn(B, S, n) * 0.5, randn(B, S, n) * 0.5, a_log,
            randn(di), randn(B, di, n) * h0_scale)


def phase_kernels_scan(torch, checks: Checks) -> list[dict]:
    """The selective-scan kernel against its plain version on the card,
    then timed at the serve shape as the serve path calls it (x and dt
    bf16, h0 = 0), and with dt float32 as the first kernel was timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import mamba_scan as ms

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, di, n = SERVE["batch"], SERVE["prompt_len"], 8192, 16
    cases = [
        ("serve_x_dt_bf16", (B, S, di, n), bf16, 0.0, bf16),
        ("serve_x_bf16", (B, S, di, n), bf16, 0.0, f32),
        ("serve_x_bf16_h0", (B, S, di, n), bf16, 0.5, f32),
        ("serve_x_dt_bf16_h0", (B, S, di, n), bf16, 0.5, bf16),
        ("serve_x_f32_h0", (B, S, di, n), f32, 0.5, f32),
        ("S1", (B, 1, di, n), bf16, 0.5, f32),
        ("S33", (2, 33, di, n), f32, 0.5, f32),
        ("di8200_n4", (2, 33, 8200, 4), f32, 0.5, f32),
        ("di8200_n16", (2, 70, 8200, 16), bf16, 0.5, bf16),
        # n below the kernel's 16 register states (masked), di not a
        # multiple of the block's 64 channels, and (di 1001) rows that are
        # not 16-byte aligned; mixed x/dt dtypes are read widened to f32
        ("di1000_n1", (2, 45, 1000, 1), bf16, 0.5, bf16),
        ("di1001_n3", (2, 45, 1001, 3), f32, 0.5, bf16),
        ("di1001_n16_x_bf16", (3, 40, 1001, 16), bf16, 0.5, f32),
        ("B1_di96", (1, 300, 96, 16), bf16, 0.5, bf16),
        ("long_S8192", (1, 8192, di, n), bf16, 0.5, f32),
    ]
    for case, shape, x_dtype, h0_scale, dt_dtype in cases:
        args = scan_inputs(torch, gen, *shape, x_dtype, h0_scale, dt_dtype)
        checks.close("selective_scan", case, ms.selective_scan(*args),
                     ref.selective_scan_ref(*args), SCAN_ATOL,
                     shape=list(shape), x_dtype=str(x_dtype),
                     dt_dtype=str(dt_dtype))
    timings = []
    for case, dt_dtype in (("serve_x_dt_bf16", bf16), ("serve_x_bf16", f32)):
        args = scan_inputs(torch, gen, B, S, di, n, bf16, 0.0, dt_dtype)
        # each input read once in its dtype (x, dt; Bm/Cm/A_log/D/h0 f32),
        # each output written once (y, h_last f32); one exp and ~6 flops
        # per (b, t, i, j)
        nbytes = (B * S * di * (2 + args[1].element_size())
                  + 2 * B * S * n * 4 + (di * n + di) * 4 + B * di * n * 4
                  + B * S * di * 4 + B * di * n * 4)
        b_ms, b_by = bound(nbytes, 6 * B * S * di * n,
                           B * S * di * n + di * n)
        timings.append({
            "kernel": "selective_scan", "case": case,
            "shape": [B, S, di, n], "dt_dtype": str(dt_dtype),
            "ms": time_ms(torch, lambda: ms.selective_scan(*args), 10),
            "plain_ms": time_ms(torch, lambda: ref.selective_scan_ref(*args),
                                1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "exp_ms": (B * S * di * n + di * n) / SPECIAL_OPS_PER_S * 1e3})
        emit({"phase": "kernels", "timing": timings[-1]})
    return timings


def phase_train(torch, out_dir: Path) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import cpml_train

    out = out_dir / "cpml_train_case1.json"
    argv = ["-N", str(CASE1["N"]), "-K", str(CASE1["K"]), "-T", str(CASE1["T"]),
            "--m", str(CASE1["m"]), "--d", str(CASE1["d"]),
            "--iters", str(CASE1["iters"]), "--seed", str(TRAIN_SEED),
            "--device", "cuda",
            "--json-out", str(out)]
    ops.reset_launches()
    rc = cpml_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cpml_train exited {rc}")
    res = json.loads(out.read_text())
    iters = CASE1["iters"]
    # one coded_grad per round; one modmatmul for the dataset encode and
    # two per round (weight encode, decode)
    if launches["coded_grad"] != iters or launches["modmatmul"] != 1 + 2 * iters:
        raise AssertionError(f"kernel launches on the main path: {launches}")
    gap = abs(res["acc_coded"] - res["acc_cleartext"])
    info = {"phase": "train", "argv": argv, "launches": launches,
            "seconds": res["seconds"], "s_per_iteration": res["seconds"] / iters,
            "acc_coded": res["acc_coded"], "acc_cleartext": res["acc_cleartext"],
            "acc_gap": gap}
    emit(info)
    if gap >= 0.03:
        raise AssertionError(f"coded accuracy {res['acc_coded']} is not within "
                             f"0.03 of the cleartext {res['acc_cleartext']}")
    return info


def phase_train_heads(torch, out_dir: Path) -> dict:
    """``cpml_train --classes 33`` on the card (N=8, K=2, T=1 and the CLI's
    other defaults): 33 heads of degree 1, more than the first kernel's 32
    registers held.  It must exit 0 and launch ``coded_grad`` once a round."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cpml_train

    out = out_dir / "cpml_train_c33.json"
    iters = TRAIN_HEADS["iters"]
    argv = ["--classes", str(TRAIN_HEADS["classes"]), "--iters", str(iters),
            "--device", "cuda", "--json-out", str(out)]
    ops.reset_launches()
    rc = cpml_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cpml_train --classes 33 exited {rc}")
    res = json.loads(out.read_text())
    info = {"phase": "train_c33", "argv": argv, "launches": launches,
            "seconds": res["seconds"], "acc_coded": res["acc_coded"],
            "acc_cleartext": res["acc_cleartext"]}
    emit(info)
    if launches["coded_grad"] != iters:
        raise AssertionError(f"coded_grad launches at 33 heads: {launches}")
    return info


def phase_teacher(torch) -> dict:
    from repro_torch.core import protocol
    from repro_torch.core.protocol import engine
    from repro_torch.data import synthetic

    cfg = protocol.CPMLConfig(N=CASE1["N"], K=CASE1["K"], T=CASE1["T"])
    x_np, y_np = synthetic.mnist_like(1, m=CASE1["m"], d=CASE1["d"], margin=12.0)
    runs = {}
    for name in ("cuda", "cpu"):
        draws = protocol.TorchDraws(7, name)
        state = protocol.setup(cfg, torch.as_tensor(x_np, device=name),
                               torch.as_tensor(y_np, device=name), draws=draws)
        runs[name] = (state, draws)
    (sg, dg), (sc, dc) = runs["cuda"], runs["cpu"]
    if not torch.equal(sg.x_shares.cpu(), sc.x_shares):
        raise AssertionError("dataset shares differ between the card and the CPU")
    eta = protocol.lipschitz_eta(sg.xq_real)
    dmat, order = protocol.survivor_round(cfg, None)
    dmat_c, order_c = torch.as_tensor(dmat), torch.as_tensor(order)
    dmat_g, order_g = dmat_c.cuda(), order_c.cuda()
    w2 = torch.zeros((CASE1["d"], 1), device="cuda")
    worst = 0.0
    for t in range(3):
        shares_g = protocol.encode_round_shares(cfg, dg, t, w2)
        parts_g = protocol.round_parts(cfg, sg, shares_g, dmat_g, order_g)
        w_next_g = engine._update_from_parts(cfg, sg, w2, parts_g, None, eta)
        w2_c = w2.cpu()
        shares_c = protocol.encode_round_shares(cfg, dc, t, w2_c)
        parts_c = protocol.round_parts(cfg, sc, shares_c, dmat_c, order_c)
        w_next_c = engine._update_from_parts(cfg, sc, w2_c, parts_c, None, eta)
        torch.cuda.synchronize()
        if not (torch.equal(shares_g.cpu(), shares_c)
                and torch.equal(parts_g.cpu(), parts_c)):
            raise AssertionError(f"round {t}: field values differ card vs CPU")
        err = float((w_next_g.cpu() - w_next_c).abs().max())
        worst = max(worst, err)
        emit({"phase": "teacher", "round": t, "parts_bit_equal": True,
              "w_max_abs_diff": err, "tolerance": WEIGHT_ATOL})
        if err > WEIGHT_ATOL:
            raise AssertionError(f"round {t}: weights differ by {err}")
        w2 = w_next_g

    # steady-state round on the card, by stage (host clock around work that
    # ends in a synchronize)
    stages = {"encode_weights": [], "coded_grad": [], "decode": [], "step": []}
    from repro_torch.core.protocol import compute, decode
    cbar = torch.as_tensor(protocol.poly_coeffs(cfg), device="cuda")
    for t in range(3, 13):
        marks = [time.perf_counter()]
        shares = protocol.encode_round_shares(cfg, dg, t, w2)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        results = compute.all_worker_results(cfg, cbar, sg.x_shares, shares)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        parts = decode.decode_parts(cfg, results[order_g], dmat_g)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        w2 = engine._update_from_parts(cfg, sg, w2, parts, None, eta)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for i, k in enumerate(stages):
            stages[k].append((marks[i + 1] - marks[i]) * 1e3)
    info = {"phase": "teacher", "rounds_checked": 3, "w_max_abs_diff": worst,
            "round_stage_ms_median": {k: statistics.median(v)
                                      for k, v in stages.items()},
            "round_ms_median": statistics.median(
                [sum(v[i] for v in stages.values()) for i in range(10)])}
    emit(info)
    return info


def _read_serve(out: Path, batch: int, gen: int, vocab: int) -> dict:
    res = json.loads(out.read_text())
    toks = res["tokens"]
    if (len(toks) != batch or any(len(t) != gen for t in toks)
            or not all(0 <= x < vocab for t in toks for x in t)):
        raise AssertionError(f"generated tokens out of shape or range: {toks}")
    if not res["logits_finite"]:
        raise AssertionError("non-finite logits while serving")
    return res


def phase_serve(torch, out_dir: Path) -> dict:
    """``repro_torch.launch.serve`` at full width and depth on the card."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = registry.get_config(SERVE["arch"])
    out = out_dir / "serve.json"
    argv = ["--arch", SERVE["arch"], "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--gen",
            str(SERVE["gen"]), "--seed", "0", "--device", "cuda",
            "--json-out", str(out)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"serve exited {rc}")
    res = _read_serve(out, SERVE["batch"], SERVE["gen"], cfg.vocab_size)
    info = {"phase": "serve", "argv": argv, "launches": launches,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_tok_per_s": res["decode_tok_per_s"],
            "prefill_tok_per_s": SERVE["batch"] * SERVE["prompt_len"]
            / res["prefill_s"],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "logits_finite": res["logits_finite"],
            "sample": res["tokens"][0][:8]}
    emit(info)
    # one selective_scan launch per layer, all in the prefill; no field
    # kernel on the plain head
    if launches != {"modmatmul": 0, "coded_grad": 0,
                    "selective_scan": cfg.num_layers}:
        raise AssertionError(f"kernel launches while serving: {launches}")
    return info


def _kernel_group(name: str) -> str:
    if "scan_kernel" in name:
        return "selective_scan"
    if "modmatmul" in name or "coded_grad" in name:
        return "field kernels"
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "cutlass",
                                       "xmma", "cublas")):
        return "matmul (cuBLAS)"
    return "elementwise and other"


def device_profile(torch, step, n: int) -> dict:
    """``step(i)`` for i = 1..n under ``torch.profiler``: the device's ms a
    step by kernel group, kernels a step, and the host clock's ms a step
    (synchronised; the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(1, 1 + n):
            step(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    by_group: dict[str, float] = {}
    kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = _kernel_group(e.name)
            by_group[g] = by_group.get(g, 0.0) + e.device_time_total / 1e3
            kernels += 1
    device_ms = sum(by_group.values()) / n
    return {"steps": n, "host_ms": host_ms, "device_ms": device_ms,
            "device_ms_by_group": {k: v / n for k, v in by_group.items()},
            "device_busy_share": device_ms / host_ms,
            "kernels_per_step": kernels / n}


def phase_profile(torch) -> dict:
    """Where the serve path's time goes: one prefill at the serve shape and
    8 decode steps under ``torch.profiler``: device time by kernel group,
    and the device's busy share of the host-clock time (the profiler's own
    host cost included, so the idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = registry.get_config(SERVE["arch"])
    rc = RunConfig()
    dev = torch.device("cuda")
    B, S, steps = SERVE["batch"], SERVE["prompt_len"], 8
    info: dict = {"phase": "profile", "batch": B, "prompt_len": S,
                  "decode_steps": steps}
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        prompt = serve.make_prompt(cfg, B, S, 0, dev)
        state: dict = {}

        def prefill():
            state["logits"], state["cache"] = M.prefill(
                cfg, rc, model, {"tokens": prompt}, cache_len=S + steps)

        def decode():
            logits, cache = state["logits"], state["cache"]
            for _ in range(steps):
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                logits, cache = M.decode_step(cfg, rc, model, cache,
                                              {"tokens": tok})

        for name, fn in (("prefill", prefill), ("decode", decode)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            by_name: dict[str, float] = {}
            launches = 0
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = (by_name.get(e.name, 0.0)
                                       + e.device_time_total / 1e3)
                    launches += 1
            groups: dict[str, float] = {}
            for k, ms in by_name.items():
                groups[_kernel_group(k)] = groups.get(_kernel_group(k), 0) + ms
            busy = sum(groups.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            info[name] = {"host_ms": wall_ms, "device_ms": busy,
                          "device_ms_by_group": groups,
                          "selective_scan_share_of_device_ms":
                              groups.get("selective_scan", 0.0) / busy,
                          "device_busy_share": busy / wall_ms,
                          "kernel_launches": launches,
                          "top_kernels_ms": {k[:80]: v for k, v in top}}
    emit(info)
    return info


def phase_consistency(torch) -> dict:
    """falcon-mamba at full width, 2 layers, float32: the card against the
    CPU, and decode against the full forward on the card."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    cfg = dataclasses.replace(registry.get_config(SERVE["arch"]), num_layers=2,
                              block_pattern=(("mamba", 2),))
    rc = RunConfig()
    gpu = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
    cpu = M.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu.load_state_dict(gpu.state_dict())
    B, S, extra = 2, 32, 3
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S + extra), generator=gen,
                         dtype=torch.int32, device="cuda")

    def err(a, b):
        return float((a.cpu().float() - b.cpu().float()).abs().max())

    with torch.inference_mode():
        lg, cg = M.prefill(cfg, rc, gpu, {"tokens": toks[:, :S]},
                           cache_len=S + extra)
        lc, cc = M.prefill(cfg, rc, cpu, {"tokens": toks[:, :S].cpu()},
                           cache_len=S + extra)
        errs = {"prefill_logits": err(lg, lc),
                "prefill_ssm": err(cg["seg0"]["ssm"], cc["seg0"]["ssm"]),
                "prefill_conv": err(cg["seg0"]["conv"], cc["seg0"]["conv"])}
        h, _ = M.backbone(cfg, rc, gpu, {"tokens": toks})
        want = M.lm_head(cfg, gpu, h[:, -1:])
        logits, cache = lg, cg
        for t in range(extra):
            logits, cache = M.decode_step(cfg, rc, gpu, cache,
                                          {"tokens": toks[:, S + t: S + t + 1]})
        errs["decode3_vs_backbone"] = err(logits, want)
    info = {"phase": "consistency", "layers": 2, "d_model": cfg.d_model,
            "batch": B, "prompt_len": S, "max_abs_err": errs,
            "tolerance": MODEL_ATOL}
    emit(info)
    bad = {k: v for k, v in errs.items() if not v <= MODEL_ATOL}
    if bad:
        raise AssertionError(f"consistency beyond {MODEL_ATOL}: {bad}")
    return info


def phase_coded_head(torch, out_dir: Path) -> dict:
    """``serve --coded-head --kill-shard 2`` at full width, then the decoded
    field values of the same head, prompt and survivors against the direct
    product (h_q @ w_q) mod p from the plain version."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import coded_linear as CL
    from repro_torch.core import quantize
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = registry.get_config(SERVE["arch"])
    out = out_dir / "serve_coded.json"
    argv = ["--arch", SERVE["arch"], "--batch", str(CODED["batch"]),
            "--prompt-len", str(CODED["prompt_len"]), "--gen",
            str(CODED["gen"]), "--coded-head", "--kill-shard",
            str(CODED["kill_shard"]), "--seed", "0", "--device", "cuda",
            "--json-out", str(out)]
    ops.reset_launches()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"serve --coded-head exited {rc}")
    res = _read_serve(out, CODED["batch"], CODED["gen"], cfg.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI's head, prompt and masks again, from the same seeds
    ccfg = CL.CodedLinearConfig(N=6, K=4, T=1)
    survivors = np.array([i for i in range(ccfg.N) if i != CODED["kill_shard"]])
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        prompt = serve.make_prompt(cfg, CODED["batch"], CODED["prompt_len"], 0,
                                   torch.device("cuda"))
        w, shares = serve.encode_head(cfg, model, ccfg, 0)
        _, _, h = M.prefill(cfg, RunConfig(), model, {"tokens": prompt},
                            cache_len=CODED["prompt_len"] + 1,
                            return_hidden=True)
        del model
        h = h[:, -1].float()
        results, used = CL.shard_results(ccfg, h, shares, survivors)
        got = CL.decode_field(ccfg, results, used)
        want = ref.modmatmul_ref(quantize.quantize_data(h, ccfg.lh, ccfg.p),
                                 quantize.quantize_data(w, ccfg.lw, ccfg.p),
                                 ccfg.p)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(got, want))
        check = serve.coded_head_check(ccfg, h, w, shares, survivors)
    info = {"phase": "coded_head", "argv": argv, "launches": launches,
            "survivors_used": used.tolist(), "field_shape": list(got.shape),
            "field_bit_equal_to_direct_product": bit_equal,
            "rel_err": check["rel_err"],
            "argmax_agreement": check["argmax_agreement"],
            "cli_rel_err": res["coded_head"]["rel_err"],
            "cli_argmax_agreement": res["coded_head"]["argmax_agreement"],
            "decode_tok_per_s": res["decode_tok_per_s"]}
    emit(info)
    if not bit_equal:
        raise AssertionError("coded head: decoded field values != (h_q @ w_q)"
                             " mod p")
    if launches["modmatmul"] == 0:
        raise AssertionError(f"coded head ran no modmatmul: {launches}")
    return info


# The cluster phases' configurations (PERF.md section 4): Case 1 has
# R = (2r+1)(K+T-1)+1 = 40 = N, so no straggler slack; the N=8, K=2 fleet
# (R = 7) has one worker of slack for the fault runs.
SLACK = dict(N=8, K=2, T=1, m=CASE1["m"], d=CASE1["d"], iters=10)
CLUSTER_RUNS = (
    ("case1_lognormal_off", CASE1, ["--latency", "lognormal",
                                    "--pipeline", "off"]),
    ("case1_lognormal_full", CASE1, ["--latency", "lognormal",
                                     "--pipeline", "full"]),
    ("slack_dead", SLACK, ["--latency", "dead"]),
)
SOCKET_RUNS = (
    ("case1_full", CASE1, ["--pipeline", "full"]),
    ("slack_kill_straggle", SLACK, ["--kill-worker", "5", "--kill-at-round",
                                    "4", "--straggle-worker", "3",
                                    "--straggle-sleep", "0.1"]),
    # the same straggler with every round held open to its last arrival:
    # wait-for-all measured on the wall clock beside first-T
    ("slack_straggle_collect_all", SLACK, ["--straggle-worker", "3",
                                           "--straggle-sleep", "0.1",
                                           "--collect-all"]),
)


def _cluster_argv(spec: dict, extra: list, out: Path) -> list:
    return ["-N", str(spec["N"]), "-K", str(spec["K"]), "-T", str(spec["T"]),
            "--m", str(spec["m"]), "--d", str(spec["d"]),
            "--iters", str(spec["iters"]), "--seed", str(TRAIN_SEED),
            "--device", "cuda", *extra, "--json-out", str(out)]


def _run_cluster(torch, name: str, spec: dict, extra: list, out_dir: Path
                 ) -> tuple[list, dict, dict]:
    """``cpml_cluster.main`` with the launch counts reset just before and
    read just after (the whole of ``main``: dataset encode, rounds,
    replay, baseline); fails unless it exits 0 bit-identical to
    train_reference (with ``--protocol mpc``: to the single-host
    ``mpc_baseline.train``; an ALCC socket run within
    ``ALCC_SOCKET_TOL`` of its replay).  The rounds' own counts are
    ``res["launches_run"]``, taken around ``runner.run`` alone."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cpml_cluster

    out = out_dir / f"cluster_{name}.json"
    argv = _cluster_argv(spec, extra, out)
    ops.reset_launches()
    rc = cpml_cluster.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cpml_cluster {name} exited {rc}")
    res = json.loads(out.read_text())
    # an ALCC socket run replays within a tolerance, every other bit for bit
    replayed = (res["bit_identical"] is True
                or (res["bit_identical"] is None
                    and res.get("replay_max_abs_diff", math.inf)
                    <= cpml_cluster.ALCC_SOCKET_TOL))
    if not replayed or res["device"] != "cuda":
        raise AssertionError(f"cpml_cluster {name}: bit_identical "
                             f"{res['bit_identical']} (replay "
                             f"{res.get('replay_max_abs_diff')}) on "
                             f"{res['device']}")
    return argv, res, launches


def _waits(stats: dict) -> dict:
    return {k: {q: stats[k][q] for q in ("mean", "p50", "p95")}
            for k in ("coded_T", "wait_all", "encode", "decode",
                      "critical_path")}


def phase_cluster(torch, out_dir: Path) -> dict:
    """``cpml_cluster`` in process on the card: Case 1 with lognormal
    latencies, pipeline off and full, and the N=8 fleet with a worker dead
    from round 3.  Each run is bit-identical to train_reference over its
    trace and launches ``coded_grad`` once a round for all N workers."""
    runs = {}
    for name, spec, extra in CLUSTER_RUNS:
        argv, res, launches = _run_cluster(torch, name, spec, extra, out_dir)
        iters = spec["iters"]
        info = {"phase": "cluster", "run": name, "argv": argv,
                "launches_main": launches, "launches_run": res["launches_run"],
                "round_ms_host": res["run_s"] / iters * 1e3,
                "waits_simulated_s": _waits(res["wait_stats"]),
                "acc_coded": res["acc_coded"],
                "acc_baseline": res["acc_baseline"]}
        emit(info)
        if res["launches_run"]["coded_grad"] != iters:
            raise AssertionError(f"cluster {name}: coded_grad launches "
                                 f"{res['launches_run']} over {iters} rounds")
        if res["launches_run"]["modmatmul"] < 2 * iters:
            raise AssertionError(f"cluster {name}: modmatmul launches "
                                 f"{res['launches_run']}")
        runs[name] = info
    return {"phase": "cluster", "runs": runs,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[CLUSTER_RUNS[0][0]]["launches_run"]}}


class _MemorySampler:
    """Device memory in use (nvidia-smi, MiB), sampled on a thread: the
    peak over a window that holds many worker processes' contexts."""

    def __init__(self, period_s: float = 0.5):
        import threading
        self.peak_mib = 0
        self.error = None
        self._stop = threading.Event()
        self._period = period_s
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                res = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30)
            except (OSError, subprocess.TimeoutExpired) as e:
                self.error = repr(e)
                return
            if res.returncode != 0 or not res.stdout.strip():
                self.error = f"nvidia-smi exited {res.returncode}: {res.stderr}"
                return
            self.peak_mib = max(self.peak_mib, int(res.stdout.split()[0]))
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def phase_socket(torch, out_dir: Path) -> dict:
    """``cpml_cluster --transport socket`` on the card: one worker process
    per slot, each on cuda.  Case 1 with all 40 workers, the N=8 fleet with
    worker 5 killed at round 4 and worker 3 straggling, and that straggler
    again with every round held to its last arrival.  Each run is
    bit-identical to train_reference; every live worker reports cuda, one
    ``coded_grad`` launch in its warm-up and exactly one a round it
    answered."""
    st = statistics
    runs = {}
    for name, spec, extra in SOCKET_RUNS:
        with _MemorySampler() as mem:
            argv, res, launches = _run_cluster(
                torch, name, spec, ["--transport", "socket", *extra], out_dir)
        iters = spec["iters"]
        reports = res["worker_reports"]
        killed, kill_at = set(), None
        if "--kill-worker" in extra:
            killed = {int(extra[extra.index("--kill-worker") + 1])}
            kill_at = int(extra[extra.index("--kill-at-round") + 1])
        live = [r for r in reports if r["worker"] not in killed]
        if sorted(r["worker"] for r in reports) != list(range(spec["N"])):
            raise AssertionError(f"socket {name}: worker reports "
                                 f"{[r['worker'] for r in reports]}")
        for r in live:
            if (not r["device"].startswith("cuda") or r["rounds"] < 1
                    or r["launches"]["coded_grad"] != r["rounds"]
                    or r["warmup_launches"]["coded_grad"] != 1):
                raise AssertionError(f"socket {name}: worker {r['worker']} "
                                     f"{r}")
        if mem.peak_mib == 0:
            raise AssertionError(f"socket {name}: no device memory reading "
                                 f"from nvidia-smi ({mem.error})")
        stats = res["wait_stats"]
        info = {"phase": "socket", "run": name, "argv": argv,
                "master_launches_main": launches,
                "master_launches_run": res["launches_run"],
                # the rounds' launches: the master's runner.run and every
                # worker's rounds (warm-ups not counted)
                "launches_run": {k: v + sum(r["launches"][k] for r in reports)
                                 for k, v in res["launches_run"].items()},
                "worker_rounds_answered": sum(r["rounds"] for r in reports),
                "workers_connected_s": res["startup_s"],
                "provision_s": res["provision_s"],
                "worker_startup_s": {"median": st.median(
                    r["startup_s"] for r in reports),
                    "max": max(r["startup_s"] for r in reports)},
                "worker_warmup_s": {"median": st.median(
                    r.get("warmup_s", 0.0) for r in reports),
                    "max": max(r.get("warmup_s", 0.0) for r in reports)},
                "run_s": res["run_s"],
                "round_ms_median": stats["critical_path"]["p50"] * 1e3,
                "worker_compute_s": res["worker_compute_s"],
                "waits_wall_s": _waits(stats),
                "dead_rounds": stats["rounds"]["dead_rounds"],
                "wire_bytes_per_round": {
                    "tx": stats["wire_tx_bytes"]["mean"],
                    "rx": stats["wire_rx_bytes"]["mean"]},
                "wire_totals": stats.get("wire_totals"),
                "device_memory_peak_mib": mem.peak_mib,
                "survivors_last_round": res["survivors"][str(iters - 1)]}
        emit(info)
        for t, surv in res["survivors"].items():
            if kill_at is not None and int(t) >= kill_at and killed & set(surv):
                raise AssertionError(f"socket {name}: killed worker decoded "
                                     f"in round {t}")
        runs[name] = info
    return {"phase": "socket", "runs": runs,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[SOCKET_RUNS[0][0]]["launches_run"]}}


# The BGW baseline at Case 1 (N = 40, T = 1, r = 1), in process and over
# sockets, and the slack fleet's size (N = 8, T = 1) with a straggler.
MPC_CASE1 = dict(CASE1, iters=10)
MPC_SLACK = dict(SLACK, iters=10)
MPC_SOCKET_RUNS = (
    ("case1_mpc", MPC_CASE1, []),
    ("slack_mpc_straggle", MPC_SLACK, ["--straggle-worker", "3",
                                       "--straggle-sleep", "0.1"]),
)
RESILIENT_RUNS = (
    # two workers dead from round 3, one more than R = 7 of 8 tolerates
    ("slack_dead_resilient", SLACK, ["--latency", "dead", "--resilient",
                                     "--checkpoint-every", "2"]),
    ("slack_socket_resilient", SLACK, ["--transport", "socket",
                                       "--resilient", "--kill-worker", "0",
                                       "1", "--kill-at-round", "4",
                                       "--checkpoint-every", "2",
                                       "--round-timeout", "10"]),
)


def phase_mpc(torch, out_dir: Path) -> dict:
    """The BGW baseline in process on the card at Case 1 (N = 40, T = 1),
    lognormal latencies, 10 rounds: bit-identical to the single-host
    oracle, and ``modmatmul`` launched exactly twice per worker a round
    (z = w̄ᵀ·X̄ᵀ and g = sᵀ·X̄), nothing else.  Then, apart from the main
    path's run, one runner's rounds under ``torch.profiler`` (device ms a
    round) and its peak device memory from set-up on."""
    from repro_torch.cluster.mpc_runner import MPCClusterRunner, mpc_phase_models
    from repro_torch.core import mpc_baseline
    from repro_torch.core.protocol.draws import TorchMPCDraws
    from repro_torch.data import synthetic

    spec = MPC_CASE1
    iters = spec["iters"]
    argv, res, launches = _run_cluster(
        torch, "mpc_case1_inprocess", spec,
        ["--protocol", "mpc", "--latency", "lognormal"], out_dir)
    want = 2 * spec["N"] * iters
    if res["launches_run"]["modmatmul"] != want or any(
            v for k, v in res["launches_run"].items() if k != "modmatmul"):
        raise AssertionError(f"mpc in process: launches {res['launches_run']}"
                             f", want {want} modmatmul and nothing else")
    # device time of a round and the peak memory, one more runner
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    x, y = synthetic.mnist_like(1, m=spec["m"], d=spec["d"], margin=12.0)
    cfg = mpc_baseline.MPCConfig(N=spec["N"], T=spec["T"])
    runner = MPCClusterRunner(
        cfg, x, y, mpc_phase_models("lognormal", r=cfg.r),
        draws=TorchMPCDraws(TRAIN_SEED, dev), device=dev)
    runner.step_round(0)                                   # warm
    rounds = 3
    prof = device_profile(torch, runner.step_round, rounds)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20 - base_mib
    share_mib = (runner.state.x_shares.numel() * 4
                 + runner.state.x_shares_t.numel() * 4) / 2**20
    del runner
    info = {"phase": "mpc", "argv": argv, "launches_main": launches,
            "launches_run": res["launches_run"],
            "round_ms_host": res["run_s"] / iters * 1e3,
            "waits_simulated_s": {k: res["wait_stats"][k]
                                  for k in ("mpc", "mpc_all")},
            "acc_mpc": res["acc_mpc"],
            "profiled_rounds": rounds,
            "round_ms_host_profiled": prof["host_ms"],
            "round_device_ms": prof["device_ms"],
            "round_device_ms_by_group": prof["device_ms_by_group"],
            "device_busy_share": prof["device_busy_share"],
            "kernels_per_round": prof["kernels_per_step"],
            "peak_device_mib_from_setup": peak_mib,
            "shares_mib": share_mib}
    emit(info)
    return {"phase": "mpc", "info": info, "launches": res["launches_run"]}


def _check_reports(name: str, reports: list, n: int, kernel: str,
                   per_round: int, warmup: int, dead: set) -> None:
    """Every slot reported; every live worker on cuda, left through the
    master's SHUTDOWN, with ``per_round`` launches of ``kernel`` a round
    it answered and ``warmup`` in its warm-up."""
    if sorted({r["worker"] for r in reports}) != list(range(n)):
        raise AssertionError(f"{name}: worker reports "
                             f"{[r['worker'] for r in reports]}")
    for r in reports:
        if r["exit"].startswith("die_at_round"):
            if r["worker"] not in dead:
                raise AssertionError(f"{name}: worker {r['worker']} died")
            continue
        if (not r["device"].startswith("cuda") or r["rounds"] < 1
                or r["exit"] != "shutdown"
                or r["launches"][kernel] != per_round * r["rounds"]
                or r["warmup_launches"][kernel] != warmup):
            raise AssertionError(f"{name}: worker {r['worker']} {r}")


def phase_mpc_socket(torch, out_dir: Path, coded: dict | None) -> dict:
    """``cpml_cluster --protocol mpc --transport socket`` on the card: 40
    worker processes at Case 1 for 10 rounds, then the N = 8 fleet with
    worker 3 sleeping 0.1 s before each phase.  Each run is bit-identical
    to the single-host oracle; every worker reports cuda, two
    ``modmatmul`` launches a round and two in its warm-up.  The Case 1
    round's p50 over the coded socket phase's Case 1 p50 is
    ``speedup_vs_mpc``."""
    runs = {}
    for name, spec, extra in MPC_SOCKET_RUNS:
        with _MemorySampler() as mem:
            argv, res, launches = _run_cluster(
                torch, name, spec,
                ["--protocol", "mpc", "--transport", "socket", *extra],
                out_dir)
        reports = res["worker_reports"]
        _check_reports(f"mpc_socket {name}", reports, spec["N"],
                       "modmatmul", 2, 2, set())
        if mem.peak_mib == 0:
            raise AssertionError(f"mpc_socket {name}: no device memory "
                                 f"reading from nvidia-smi ({mem.error})")
        stats = res["wait_stats"]
        info = {"phase": "mpc_socket", "run": name, "argv": argv,
                "master_launches_main": launches,
                "master_launches_run": res["launches_run"],
                "launches_run": {k: v + sum(r["launches"][k] for r in reports)
                                 for k, v in res["launches_run"].items()},
                "workers_connected_s": res["startup_s"],
                "provision_s": res["provision_s"],
                "provision_wire": res["provision_wire"],
                "run_s": res["run_s"],
                "round_ms_median": stats["critical_path"]["p50"] * 1e3,
                "wait_ms_median": stats["mpc"]["p50"] * 1e3,
                "encode_decode_ms_mean": (stats["encode"]["mean"]
                                          + stats["decode"]["mean"]) * 1e3,
                "wire_bytes_per_round": {
                    "tx": stats["wire_tx_bytes"]["mean"],
                    "rx": stats["wire_rx_bytes"]["mean"]},
                "device_memory_peak_mib": mem.peak_mib,
                "worker_startup_s": {"median": statistics.median(
                    r["startup_s"] for r in reports)},
                "worker_warmup_s": {"median": statistics.median(
                    r["warmup_s"] for r in reports)}}
        emit(info)
        runs[name] = info
    coded_p50 = None
    if coded is not None:
        coded_p50 = coded["runs"][SOCKET_RUNS[0][0]]["round_ms_median"]
    mpc_p50 = runs[MPC_SOCKET_RUNS[0][0]]["round_ms_median"]
    summary = {"phase": "mpc_socket", "case1_round_ms_median": {
        "mpc": mpc_p50, "coded": coded_p50},
        "speedup_vs_mpc": None if coded_p50 is None else mpc_p50 / coded_p50}
    emit(summary)
    return {"phase": "mpc_socket", "runs": runs, **summary,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[MPC_SOCKET_RUNS[0][0]]["launches_run"]}}


def phase_resilient(torch, out_dir: Path) -> dict:
    """``cpml_cluster --resilient`` on the card at the slack fleet (N = 8,
    K = 2, T = 1, Case 1's m and d): in process with two workers dead from
    round 3, then over sockets with workers 0 and 1 crashing at round 4.
    Each run restarts at least once, and is bit-identical to
    train_reference over its trace; over sockets the respawned processes
    for slots 0 and 1 run on cuda and answer rounds."""
    runs = {}
    for name, spec, extra in RESILIENT_RUNS:
        argv, res, launches = _run_cluster(torch, name, spec, extra, out_dir)
        if res.get("restarts", 0) < 1:
            raise AssertionError(f"resilient {name}: no restart ({res})")
        info = {"phase": "resilient", "run": name, "argv": argv,
                "restarts": res["restarts"], "run_s": res["run_s"],
                "launches_main": launches}
        run = dict(res["launches_run"])
        if "worker_reports" in res:
            reports = res["worker_reports"]
            _check_reports(f"resilient {name}", reports, spec["N"],
                           "coded_grad", 1, 1, {0, 1})
            respawned = [r for r in reports if r["worker"] in (0, 1)
                         and not r["exit"].startswith("die_at_round")]
            if len(respawned) != 2:
                raise AssertionError(f"resilient {name}: respawned "
                                     f"{respawned}")
            info["respawned"] = respawned
            run = {k: v + sum(r["launches"][k] for r in reports)
                   for k, v in run.items()}
        if run["coded_grad"] < spec["iters"]:
            raise AssertionError(f"resilient {name}: launches {run}")
        info["launches_run"] = run
        emit(info)
        runs[name] = info
    return {"phase": "resilient", "runs": runs,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[RESILIENT_RUNS[0][0]]["launches_run"]}}


# Coded prediction serving (cluster/serve.py) at the paper's Case 1 fleet
# (N = 40, K = 13, T = 1: threshold 2(K+T-1)+1 = 27, 13 to spare) on the
# multiclass MNIST head (d = 784, 10 classes), 8 rows a part; and the slack
# fleet N = 8, K = 2, T = 1 (threshold 5) for the faults.
PREDICT = dict(N=40, K=13, T=1, d=784, classes=10, max_batch=104,
               max_wait=0.02, queue_cap=64)
PREDICT_SLACK = dict(PREDICT, N=8, K=2, T=1)
PREDICT_OPEN = ["--queries", "256", "--rows", "4", "--rate", "200"]
PREDICT_RUNS = (
    ("case1_open", PREDICT, ["--latency", "lognormal", *PREDICT_OPEN]),
    ("case1_closed", PREDICT, ["--latency", "lognormal", "--mode", "closed",
                               "--queries", "32"]),
)
PREDICT_SOCKET_RUNS = (
    ("case1_straggle", PREDICT, [*PREDICT_OPEN, "--straggle-worker", "7",
                                 "--straggle-sleep", "0.25"]),
    ("slack_kill_straggle", PREDICT_SLACK,
     [*PREDICT_OPEN, "--kill-worker", "5", "--kill-at-round", "3",
      "--straggle-worker", "3", "--straggle-sleep", "0.1"]),
    ("slack_straggle_collect_all", PREDICT_SLACK,
     [*PREDICT_OPEN, "--straggle-worker", "3", "--straggle-sleep", "0.1",
      "--collect-all"]),
)
# The ALCC float engine at Case 1's m and d: in process at the slack fleet
# and at Case 1's fleet (N = 40, K = 13), where the reference's own float
# arithmetic overflows (PERF.md §6), against the exact engine's
# rounds; the slack fleet over sockets; the gelu MLP at the MNIST head's
# widths (hidden 128) on the slack fleet.
ALCC_RUNS = (("slack", dict(SLACK, iters=25), "slack_dead"),
             ("case1", dict(CASE1, iters=25), "case1_lognormal_off"))
ALCC_ACC_TOL = 0.01      # coded against the uncoded float oracle
ALCC_SLACK = dict(SLACK, iters=10)
ALCC_MLP = dict(N=8, K=2, T=1, m=CASE1["m"], d=784, iters=40)
ALCC_MLP_FLAGS = ["--engine", "alcc", "--model", "mlp", "--classes", "10",
                  "--hidden", "128", "--eta", "0.1"]


def phase_kernels_predict(torch, checks: Checks) -> list[dict]:
    """``modmatmul`` at the serving path's shapes (Case 1, P): the
    provision encode (40×14)·(14×7840), a flush's encode (40×14)·(14×6272),
    one worker's product (8×784)·(784×10), the decode (13×27)·(27×80) and
    the oracle (104×784)·(784×10).  Bit-equal, then timed."""
    from repro_torch.core import field
    from repro_torch.kernels import ref
    from repro_torch.kernels import modmatmul as mm

    p = field.P
    gen = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda shape: torch.randint(0, p, shape, generator=gen,  # noqa: E731
                                       dtype=torch.int32, device="cuda")
    N, K, T = PREDICT["N"], PREDICT["K"], PREDICT["T"]
    d, c, b = PREDICT["d"], PREDICT["classes"], PREDICT["max_batch"]
    R, rows = 2 * (K + T - 1) + 1, b // K
    timings = []
    for case, a, bb in (
            ("predict_provision_encode", rand((N, K + T)), rand((K + T, d * c))),
            ("predict_flush_encode", rand((N, K + T)), rand((K + T, rows * d))),
            ("predict_worker_product", rand((rows, d)), rand((d, c))),
            ("predict_decode", rand((K, R)), rand((R, rows * c))),
            ("predict_oracle", rand((b, d)), rand((d, c)))):
        M, KK = a.shape
        NN = bb.shape[1]
        pl = mm.plan(M, KK, NN, vec=bb.data_ptr() % 16 == 0,
                     sms=mm.sm_count(a.device))
        checks.compare("modmatmul", case, mm.modmatmul(a, bb, p),
                       ref.modmatmul_ref(a, bb, p), p=p, shape=[M, KK, NN],
                       plan=[pl.rows, pl.cols, pl.threads, pl.splits,
                             pl.blocks])
        b_ms, b_by = bound(4 * (M * KK + KK * NN + M * NN), 2 * M * KK * NN)
        timings.append({
            "kernel": "modmatmul", "case": case, "shape": [M, KK, NN],
            "plan": [pl.rows, pl.cols, pl.threads, pl.splits, pl.blocks],
            "ms": time_ms(torch, lambda: mm.modmatmul(a, bb, p), 20),
            "graph_ms": graph_ms(torch, lambda: mm.modmatmul(a, bb, p), 20),
            "plain_ms": time_ms(torch, lambda: ref.modmatmul_ref(a, bb, p), 3),
            "bound_ms": b_ms, "bound_by": b_by})
        emit({"phase": "kernels", "timing": timings[-1]})
    return timings


def _serve_argv(spec: dict, extra: list, out: Path) -> list:
    return ["-N", str(spec["N"]), "-K", str(spec["K"]), "-T", str(spec["T"]),
            "--d", str(spec["d"]), "--classes", str(spec["classes"]),
            "--max-batch", str(spec["max_batch"]),
            "--max-wait", str(spec["max_wait"]),
            "--queue-cap", str(spec["queue_cap"]), "--seed", str(TRAIN_SEED),
            "--device", "cuda", *extra, "--json-out", str(out)]


def _run_serve(torch, name: str, spec: dict, extra: list, out_dir: Path
               ) -> tuple[list, dict, dict]:
    """``cpml_serve.main`` with the launch counts reset just before and read
    just after; fails unless it exits 0 on cuda with every flush's
    predictions bit-identical to the uncoded oracle.  ``res["launches_run"]``
    counts the client loop alone."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cpml_serve

    out = out_dir / f"serve_{name}.json"
    argv = _serve_argv(spec, extra, out)
    ops.reset_launches()
    rc = cpml_serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cpml_serve {name} exited {rc}")
    res = json.loads(out.read_text())
    oracle = res["stats"]["oracle"]
    if (res["device"] != "cuda" or not oracle["bit_identical"]
            or oracle["checked"] != res["stats"]["rounds"]
            or res["stats"]["rounds"] < 1):
        raise AssertionError(f"cpml_serve {name}: {res['device']}, oracle "
                             f"{oracle}, {res['stats']['rounds']} flushes")
    return argv, res, launches


def _serve_info(phase: str, name: str, argv: list, res: dict,
                launches: dict) -> dict:
    s = res["stats"]
    return {"phase": phase, "run": name, "argv": argv,
            "launches_main": launches, "launches_run": res["launches_run"],
            "flushes": s["rounds"], "queries": s["queries"],
            "rejected": s["rejected"], "queries_per_s": s["queries_per_s"],
            "rows_per_s": s["rows_per_s"],
            "latency_first_ms": {k: s["latency_first"][k] * 1e3
                                 for k in ("p50", "p99", "mean")},
            "latency_all_ms": {k: s["latency_all"][k] * 1e3
                               for k in ("p50", "p99", "mean")},
            "latency_all_unobserved": s["latency_all"]["unobserved"],
            "run_s_host": res["run_s"],
            "flush_ms": {k: {q: v[q] * 1e3 for q in ("mean", "p50", "p95")}
                         for k, v in res["flush_s"].items()},
            "oracle_bit_identical_flushes": s["oracle"]["checked"]}


def phase_predict(torch, out_dir: Path) -> dict:
    """``cpml_serve`` in process on the card at the Case 1 fleet: 256
    open-loop queries of 4 rows at 200 queries/s, then 32 closed-loop
    queries of 104 rows, under lognormal latencies (simulated clock).  Every
    flush bit-identical to the oracle, and ``modmatmul`` launched exactly
    30 times a flush: the encode, the 27 responders' products, the decode
    and the oracle.  Then one more server's flushes under
    ``torch.profiler``: device ms and kernels a flush."""
    from repro_torch.cluster.latency import make_latency
    from repro_torch.cluster.serve import (PredictionServer, ServeConfig,
                                           open_loop_queries)
    from repro_torch.core.protocol.draws import TorchServeDraws

    R = 2 * (PREDICT["K"] + PREDICT["T"] - 1) + 1
    runs = {}
    for name, spec, extra in PREDICT_RUNS:
        argv, res, launches = _run_serve(torch, name, spec, extra, out_dir)
        info = _serve_info("predict", name, argv, res, launches)
        info["modmatmul_per_flush"] = (res["launches_run"]["modmatmul"]
                                       / info["flushes"])
        emit(info)
        if res["launches_run"]["modmatmul"] != (R + 3) * info["flushes"]:
            raise AssertionError(f"predict {name}: launches "
                                 f"{res['launches_run']} over "
                                 f"{info['flushes']} flushes")
        runs[name] = info
    # device time of a full flush, one more server
    dev = torch.device("cuda")
    cfg = ServeConfig(N=PREDICT["N"], K=PREDICT["K"], T=PREDICT["T"],
                      max_batch=PREDICT["max_batch"],
                      max_wait_s=PREDICT["max_wait"],
                      queue_cap=PREDICT["queue_cap"])
    draws = TorchServeDraws(TRAIN_SEED, dev)
    w = 0.5 * draws.model_weights((PREDICT["d"], PREDICT["classes"]))
    srv = PredictionServer(cfg, w, draws=draws, device=dev, verify=True,
                           latency=make_latency("lognormal", seed=0))
    qs = open_loop_queries(9, rows=cfg.max_batch, d=PREDICT["d"],
                           rate_qps=0.0, seed=3)
    srv.run_closed_loop(qs[:1])                             # warm
    prof_info = {"phase": "predict", "profile": "one full flush",
                 **device_profile(torch, lambda i: srv.run_closed_loop(
                     qs[i:i + 1]), 8)}
    if not srv.stats()["oracle"]["bit_identical"]:
        raise AssertionError("predict profile: oracle mismatch")
    emit(prof_info)
    return {"phase": "predict", "runs": runs, "profile": prof_info,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[PREDICT_RUNS[0][0]]["launches_run"]}}


def phase_predict_socket(torch, out_dir: Path) -> dict:
    """``cpml_serve --transport socket`` on the card: the Case 1 fleet over
    40 worker processes with worker 7 sleeping 0.25 s before each reply;
    the slack fleet with worker 5 killed at flush 3 and worker 3 sleeping
    0.1 s; that straggler again with every flush held to its last arrival.
    Every flush bit-identical to the oracle, the killed worker in no decode
    after its death, every live worker on cuda with one ``modmatmul`` launch
    a flush it answered and one in its warm-up."""
    runs = {}
    for name, spec, extra in PREDICT_SOCKET_RUNS:
        with _MemorySampler() as mem:
            argv, res, launches = _run_serve(
                torch, name, spec, ["--transport", "socket", *extra], out_dir)
        reports = res["worker_reports"]
        killed, kill_at = set(), None
        if "--kill-worker" in extra:
            killed = {int(extra[extra.index("--kill-worker") + 1])}
            kill_at = int(extra[extra.index("--kill-at-round") + 1])
        _check_reports(f"predict_socket {name}", reports, spec["N"],
                       "modmatmul", 1, 1, killed)
        for t, resp in res["responders"].items():
            decoded = set(resp[: 2 * (spec["K"] + spec["T"] - 1) + 1])
            if kill_at is not None and int(t) >= kill_at and killed & decoded:
                raise AssertionError(f"predict_socket {name}: killed worker "
                                     f"decoded in flush {t}")
        if mem.peak_mib == 0:
            raise AssertionError(f"predict_socket {name}: no device memory "
                                 f"reading from nvidia-smi ({mem.error})")
        info = _serve_info("predict_socket", name, argv, res, launches)
        flushes = info["flushes"]
        info.update({
            "launches_run": {k: v + sum(r["launches"][k] for r in reports)
                             for k, v in res["launches_run"].items()},
            "master_launches_run": res["launches_run"],
            "workers_connected_s": res["startup_s"],
            "provision_s": res["provision_s"],
            "wire_bytes_per_flush": {
                "tx": res["wire_run"]["tx_bytes"] / flushes,
                "rx": res["wire_run"]["rx_bytes"] / flushes},
            "device_memory_peak_mib": mem.peak_mib,
            "worker_reports": reports})
        emit(info)
        runs[name] = info
    return {"phase": "predict_socket", "runs": runs,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[PREDICT_SOCKET_RUNS[0][0]]
                         ["launches_run"]}}


def _alcc_info(phase: str, name: str, argv: list, res: dict,
               launches: dict) -> dict:
    a = res["wait_stats"]["alcc"]
    info = {"phase": phase, "run": name, "argv": argv,
            "launches_main": launches, "launches_run": res["launches_run"],
            "run_s": res["run_s"],
            "round_ms_host": res["run_s"] / res["config"]["iters"] * 1e3,
            "bit_identical": res["bit_identical"],
            "replay_max_abs_diff": res.get("replay_max_abs_diff"),
            "decode_cond": a["cond"], "error_budget": a["abs_err_budget"],
            "error_budget_first_decode":
                res["alcc_decode"][0]["abs_err_budget"],
            "fallbacks": a["fallbacks"]["n"]}
    for k in ("acc_coded", "acc_baseline", "oracle_max_abs_diff",
              "loss_coded", "loss_oracle", "acc_oracle", "startup_s",
              "provision_s"):
        if k in res:
            info[k] = res[k]
    if "worker_reports" in res:
        info["worker_devices"] = sorted({r["device"]
                                         for r in res["worker_reports"]})
    return info


def phase_alcc(torch, out_dir: Path, cluster: dict | None) -> dict:
    """``cpml_cluster --engine alcc`` in process on the card at Case 1's m
    = 12396 and d = 1568 (r = 1, sigma 1), 25 rounds under lognormal
    latencies, on the slack fleet (N = 8, K = 2, T = 1) and on Case 1's (N =
    40, K = 13, T = 1).  Each is bit-identical to the port's
    ``alcc_engine.train_reference`` over the observed order (bit patterns,
    NaN included); each prints the decode's condition number and error
    budget and its round beside the cluster phase's exact round of the same
    fleet.  The slack fleet's weights are finite and its accuracy within
    ALCC_ACC_TOL of the uncoded ``float_oracle``'s; at Case 1's fleet the
    float32 worker results overflow, in the reference's arithmetic too.
    Each measured run follows a 2-round warm-up run at its shapes (the
    float products' CUDA modules load at their first call).  Then the slack
    fleet's rounds under ``torch.profiler``: device ms a round."""
    from repro_torch.cluster.latency import make_latency
    from repro_torch.cluster.runner import ClusterRunner
    from repro_torch.core.protocol import alcc_engine
    from repro_torch.core.protocol.draws import TorchALCCDraws
    from repro_torch.data import synthetic

    flags = ["--engine", "alcc", "--latency", "lognormal", "--sigma", "1.0"]
    runs = {}
    for name, spec, exact_run in ALCC_RUNS:
        _run_cluster(torch, f"alcc_{name}_warm", dict(spec, iters=2), flags,
                     out_dir)
        argv, res, launches = _run_cluster(torch, f"alcc_{name}", spec,
                                           flags, out_dir)
        info = _alcc_info("alcc", name, argv, res, launches)
        exact = (cluster["runs"][exact_run]["round_ms_host"]
                 if cluster is not None else None)
        info.update(weights_finite=res["weights_finite"],
                    exact_run=exact_run, exact_round_ms_host=exact,
                    alcc_over_exact_round=(None if exact is None else
                                           info["round_ms_host"] / exact))
        emit(info)
        if name == "slack" and not (
                res["weights_finite"]
                and abs(res["acc_coded"] - res["acc_baseline"])
                <= ALCC_ACC_TOL):
            raise AssertionError(f"alcc {name}: accuracy {res['acc_coded']} "
                                 f"against the float oracle's "
                                 f"{res['acc_baseline']}")
        runs[name] = info
    spec = ALCC_RUNS[0][1]
    x, y = synthetic.mnist_like(1, m=spec["m"], d=spec["d"], margin=12.0)
    dev = torch.device("cuda")
    runner = ClusterRunner(
        alcc_engine.ALCCConfig(N=spec["N"], K=spec["K"], T=spec["T"]), x, y,
        make_latency("lognormal"), engine="alcc",
        draws=TorchALCCDraws(TRAIN_SEED, dev), device=dev)
    runner.step_round(0, 6)                                  # warm
    prof = {"phase": "alcc", "profile": "slack fleet round",
            **device_profile(torch, lambda t: runner.step_round(t, 6), 5)}
    emit(prof)
    del runner
    return {"phase": "alcc", "runs": runs, "profile": prof,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs["slack"]["launches_run"]}}


def phase_alcc_socket(torch, out_dir: Path) -> dict:
    """``cpml_cluster --engine alcc --transport socket``: the slack fleet at
    Case 1's m and d for 10 rounds, worker 3 sleeping 0.1 s; the weights
    within 1e-3 of the replay, every worker on cuda."""
    with _MemorySampler() as mem:
        argv, res, launches = _run_cluster(
            torch, "alcc_slack_socket", ALCC_SLACK,
            ["--engine", "alcc", "--transport", "socket",
             "--straggle-worker", "3", "--straggle-sleep", "0.1"], out_dir)
    info = _alcc_info("alcc_socket", "slack_straggle", argv, res, launches)
    stats = res["wait_stats"]
    info.update({"round_ms_median": stats["critical_path"]["p50"] * 1e3,
                 "wire_bytes_per_round": {
                     "tx": stats["wire_tx_bytes"]["mean"],
                     "rx": stats["wire_rx_bytes"]["mean"]},
                 "device_memory_peak_mib": mem.peak_mib})
    emit(info)
    # every worker on cuda, no field kernel launched (ALCC's are cuBLAS)
    _check_reports("alcc_socket", res["worker_reports"], ALCC_SLACK["N"],
                   "modmatmul", 0, 0, set())
    return {"phase": "alcc_socket", "info": info,
            "launches": {k: v + sum(r["launches"][k]
                                    for r in res["worker_reports"])
                         for k, v in res["launches_run"].items()}}


def phase_alcc_mlp(torch, out_dir: Path) -> dict:
    """``cpml_cluster --engine alcc --model mlp`` on the card: m = 12396,
    d = 784, 10 classes, hidden 128, eta 0.1, 40 steps (80 coded rounds) on
    the slack fleet, in process (bit-identical to the port's
    ``alcc_mlp.train_reference``) and over sockets (within 1e-3); both
    within 0.05 of the plaintext oracle's loss (the CLI's exit code).  A
    2-step warm-up run precedes them; then in-process steps under
    ``torch.profiler``: device ms a step."""
    from repro_torch.cluster.alcc_mlp import ALCCMLPRunner
    from repro_torch.cluster.latency import make_latency
    from repro_torch.core.protocol import alcc_engine
    from repro_torch.core.protocol.draws import TorchALCCDraws
    from repro_torch.data import synthetic

    _run_cluster(torch, "alcc_mlp_warm", dict(ALCC_MLP, iters=2),
                 [*ALCC_MLP_FLAGS, "--latency", "lognormal"], out_dir)
    runs = {}
    for name, extra in (("inprocess", ["--latency", "lognormal"]),
                        ("socket", ["--transport", "socket"])):
        argv, res, launches = _run_cluster(
            torch, f"alcc_mlp_{name}", ALCC_MLP, [*ALCC_MLP_FLAGS, *extra],
            out_dir)
        info = _alcc_info("alcc_mlp", name, argv, res, launches)
        info["step_ms_host"] = info.pop("round_ms_host")
        emit(info)
        if "worker_reports" in res:
            _check_reports("alcc_mlp socket", res["worker_reports"],
                           ALCC_MLP["N"], "modmatmul", 0, 0, set())
        runs[name] = info
    spec = ALCC_MLP
    x, y = synthetic.multiclass_mnist_like(1, m=spec["m"], d=spec["d"], c=10)
    dev = torch.device("cuda")
    runner = ALCCMLPRunner(
        alcc_engine.ALCCConfig(N=spec["N"], K=spec["K"], T=spec["T"], c=10),
        x, y, 128, make_latency("lognormal"),
        draws=TorchALCCDraws(TRAIN_SEED, dev), device=dev, eta=0.1)
    runner.step(0)                                           # warm
    prof = {"phase": "alcc_mlp", "profile": "in-process step",
            **device_profile(torch, runner.step, 4)}
    emit(prof)
    del runner
    return {"phase": "alcc_mlp", "runs": runs, "profile": prof,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs["inprocess"]["launches_run"]}}


def run_phase(name: str, fn, *args):
    """Run one phase; print its seconds.  A failure propagates."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": name, "seconds": time.perf_counter() - t0})
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build "
                         f"(default: all of {','.join(PHASES)}); a partial "
                         "run prints no ok line")
    args = ap.parse_args(argv)
    phases = [x for x in args.phases.split(",") if x]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on a GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": {name: [ln.strip() for ln in (v.parent / f"{name}.log")
                           .read_text().splitlines()
                           if any(k in ln for k in ("entry function",
                                                    "registers", "spill"))]
                    for name, v in libs.items()
                    if (v.parent / f"{name}.log").exists()}})

    checks = Checks(torch)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    ran: dict[str, dict] = {}
    timings: list[dict] = []
    if "kernels" in phases:
        timings += run_phase("kernels", phase_kernels, torch, checks)
        free()
        timings += run_phase("kernels_coded_head", phase_kernels_coded_head,
                             torch, checks)
        timings += run_phase("kernels_mpc", phase_kernels_mpc, torch, checks)
        timings += run_phase("kernels_scan", phase_kernels_scan, torch, checks)
        timings += run_phase("kernels_predict", phase_kernels_predict, torch,
                             checks)
        free()
    for name, fn, args_ in (
            ("train", phase_train, (torch, out_dir)),
            ("train_c33", phase_train_heads, (torch, out_dir)),
            ("teacher", phase_teacher, (torch,)),
            ("serve", phase_serve, (torch, out_dir)),
            ("profile", phase_profile, (torch,)),
            ("consistency", phase_consistency, (torch,)),
            ("coded_head", phase_coded_head, (torch, out_dir)),
            ("cluster", phase_cluster, (torch, out_dir)),
            ("socket", phase_socket, (torch, out_dir)),
            ("mpc", phase_mpc, (torch, out_dir)),
            ("mpc_socket", phase_mpc_socket, (torch, out_dir)),
            ("resilient", phase_resilient, (torch, out_dir)),
            ("predict", phase_predict, (torch, out_dir)),
            ("predict_socket", phase_predict_socket, (torch, out_dir)),
            ("alcc", phase_alcc, (torch, out_dir)),
            ("alcc_socket", phase_alcc_socket, (torch, out_dir)),
            ("alcc_mlp", phase_alcc_mlp, (torch, out_dir))):
        if name in phases:
            if name == "mpc_socket":
                args_ = (*args_, ran.get("socket"))
            if name == "alcc":
                args_ = (*args_, ran.get("cluster"))
            ran[name] = run_phase(name, fn, *args_)
            free()
            free()

    # each kernel's main path: the training round for the field kernels,
    # serving for the scan; launches counted on that path's run
    main_case = {"modmatmul": "dataset_encode", "coded_grad": "case1_c1_r1",
                 "selective_scan": "serve_x_dt_bf16"}
    main_path = {"modmatmul": "train", "coded_grad": "train",
                 "selective_scan": "serve"}
    replaces = {
        "modmatmul": "src/repro/kernels/modmatmul.py:94",
        "coded_grad": "src/repro/kernels/coded_grad.py:117",
        "selective_scan": "src/repro/kernels/mamba_scan.py:83",
    }
    source = {"modmatmul": "modmatmul.cu", "coded_grad": "coded_grad.cu",
              "selective_scan": "mamba_scan.cu"}
    if "kernels" in phases:
        kernels = []
        for name in ("coded_grad", "modmatmul", "selective_scan"):
            t = next(x for x in timings
                     if x["kernel"] == name and x["case"] == main_case[name])
            path = ran.get(main_path[name])
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source[name]}",
                "replaces": replaces[name],
                "launches": path["launches"][name] if path else None,
                "max_abs_err": checks.max_err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "shape": t["shape"],
                "launches_by_path": {
                    k: ran[v]["launches"][name]
                    for k, v in (("train", "train"), ("train_c33", "train_c33"),
                                 ("serve", "serve"),
                                 ("serve_coded_head", "coded_head"),
                                 ("cluster_inprocess", "cluster"),
                                 ("cluster_socket", "socket"),
                                 ("mpc_inprocess", "mpc"),
                                 ("mpc_socket", "mpc_socket"),
                                 ("resilient", "resilient"),
                                 ("predict_inprocess", "predict"),
                                 ("predict_socket", "predict_socket"),
                                 ("alcc_inprocess", "alcc"),
                                 ("alcc_socket", "alcc_socket"),
                                 ("alcc_mlp", "alcc_mlp"))
                    if v in ran}})
            if name == "modmatmul":
                # the serving path's shapes, each timed beside its bound
                kernels[-1]["predict_cases"] = [
                    {k: x[k] for k in ("case", "shape", "ms", "graph_ms",
                                       "plain_ms", "bound_ms", "bound_by")}
                    for x in timings if x["case"].startswith("predict_")]
        emit({"kernels": kernels})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: partial run ({','.join(phases)}): no ok line",
              file=sys.stderr)
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
