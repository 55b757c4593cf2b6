#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--phases kernels[,train,...]]

Run from the repository root on a machine with one CUDA card.  It prints
one JSON object per line, in phases, and fails (non-zero exit) if any
phase fails.  ``--phases`` runs the build and the named phases only (for
iterating on a kernel); such a partial run prints no ok line.

  build     builds the four CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels   holds each field kernel bit for bit against its plain PyTorch
            version on the card: the main path's shapes at the paper's
            Case 1 (N=40, K=13, T=1, m=12396, d=1568), both primes,
            all-(p-1) inputs, odd shapes, the accumulator-reduction
            boundary, ``modmatmul``'s row templates (M = 1, 4, 6, 17, 40),
            fold interval (K = L, L+1, 2L+1, also in one K-slice) and K-split
            edges (K = 4096, N = 1, 255, 16256), and ``modmatmul`` at the
            coded LM head's shapes for falcon-mamba, tinyllama, hymba and
            phi3.5-moe (P30); ``coded_grad`` at Case 1 with
            c = 1, 10 and 33 heads, one socket worker's N = 1, c = 17 r = 2 and c = 5 r = 7 (c*r
            above 32), r = 33 with a random c̄, all-(p-1) inputs at P30
            with a thread's columns and the rows per tile at L-1, L, L+1
            (forced plans), and d = 60000 on the re-read route; the
            selective scan against its plain version within 1e-4 at the
            serve shape (x and dt bf16 as
            served, dt f32, x f32, non-zero h0), S = 1, S = 33, di = 8200,
            n in {1, 3, 4, 16} with di not a multiple of the block's
            channels (and rows not 16-byte aligned), B 1 x di 96,
            S = 8192 and hymba's serve shape (d_inner 3200); the scan's bf16
            a/b mode (``ssm_dtype="bf16"``, chunks of 128) within 1e-4 of
            its plain version at falcon's and hymba's serve shapes with a
            non-zero h0, S = 45 with chunks of 7, S = 300, chunks of 1, and
            falcon-mamba's ``mamba_mix`` at 2 layers in that mode, card
            against CPU within 2^-7 of the largest output (``ab16_mix``);
            ``modmatmul`` at the BGW baseline's two local
            products at Case 1 in both orientations; the scan's backward
            kernels (``selective_scan_bwd``: chunk summaries, carries,
            chunk backward) within 1e-4 of its largest gradient of its
            plain version at hymba's and falcon-mamba's training shapes (x
            and dt bf16 and float32), S = 1, 33 and 8192, n in {1, 3, 16}
            with di not a multiple of the block's channels, one chunk and
            one chunk and a step at hymba's width, h0 and dh_last non-zero,
            and ``SelectiveScanFn``'s bfloat16 gradients through views of
            one projection; two calls bit-identical; its device launches a
            call, per-kernel device ms and ptxas registers and spills; and
            times each
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
  serve_dense  ``serve`` for tinyllama-1.1b at full width and all 22
            layers, bf16, batch 4, prompt 2048, 32 tokens: no kernel
            launched, tokens in range, logits finite; prefill seconds,
            decode tokens/s, peak device memory; then the coded_head check
            for tinyllama (``modmatmul`` launched)
  serve_hybrid  the same for hymba-1.5b (all 32 layers; the prompt passes
            its 1024-token window): ``selective_scan`` launched exactly 32
            times, all in the prefill
  serve_swa ``serve`` for h2o-danube-3-4b at full width and all 24 layers,
            batch 1, prompt 4608 past its 4096-token window, 16 tokens
  serve_wide  qwen2-72b at full width (QKV bias, rope_theta 1e6, head_dim
            128, vocab 152,064) cut to 2 layers, batch 1, prompt 512, 4
            tokens, through ``serve.greedy_decode``
  consistency_dense  float32 at full width, 2 layers: tinyllama and hymba
            (one global and one windowed layer) prefill on the card
            against the CPU, and prefill + 3 decode steps against
            ``backbone`` over S+3; h2o-danube at S = 4100 past its window
            on the card; all within 1e-3
  profile_dense  the profile phase for tinyllama, hymba and h2o-danube
            at their serve shapes, with attention's device ms a prefill
            and its share
  serve_moe phi3.5-moe-42b-a6.6b at full width (16 experts of 6400, top-2)
            cut to 16 of 32 layers, batch 4, prompt 2048, 32 tokens,
            through ``serve.greedy_decode``: no kernel launched; then its
            coded head at the same depth (batch 4, prompt 16, 4 tokens,
            shard 2 lost): ``modmatmul`` launched, the field values
            bit-equal to (h_q @ w_q) mod p; then ``serve --reduced`` for
            phi3.5-moe and arctic-480b through the CLI
  serve_arctic  arctic-480b at full width (128 experts of 4864, top-2,
            the dense residual) cut to 2 of 35 layers, batch 4, prompt
            2048, 8 tokens: no kernel launched
  consistency_moe  phi3.5-moe at full width, 2 layers, float32, capacity
            factor 8: prefill on the card against the CPU, prefill + 3
            decode steps against the full forward, and the sort dispatch
            against the einsum one on the card, within 1e-3; how many
            tokens' top-2 expert sets agree between card and CPU
  profile_moe  the profile phase for phi3.5-moe and arctic at their
            serve_moe and serve_arctic shapes, with the prefill's device ms
            by group: attention, the expert products, dispatch and combine,
            the rest
  serve_whisper  whisper-tiny at its published config (4 encoder and 4
            decoder layers, d 384, vocab 51865), bf16, batch 16 of 1500
            stub frames, a 4-token prompt, 60 tokens through
            ``serve.greedy_decode(..., enc_embeds=...)``: no kernel
            launched; encoder and decoder-prefill ms, decode tokens/s, peak
            device memory; the encoder, prefill and 8 decode steps under
            torch.profiler (launches a step, busy share, attention's share);
            then its coded head (batch 16, prompt 4, 4 tokens, shard 2
            lost): field values bit-equal to (h_q @ w_q) mod p and exactly
            25 ``modmatmul`` launches
  consistency_whisper  whisper-tiny at full width and depth, float32, batch
            2, 1500 frames, prompt 16: the card against the CPU (encoder
            output, prefill logits and caches) and 3 decode steps against
            the full forward, within 1e-3; the share of 2^20 bf16 ``gelu``
            outputs that differ between card and CPU (a finding)
  train_lm  ``repro_torch.launch.train`` at full width and depth, bf16
            parameters, float32 AdamW state, block remat, batch 4 x 2048
            tokens, 10 steps: hymba-1.5b (32 layers; exactly 64
            ``selective_scan`` and 32 ``selective_scan_bwd`` launches a
            step) and tinyllama-1.1b (22 layers, no kernel launched);
            finite losses, the last below 1.05 x the first; step ms (the
            first apart), tokens/s, peak device memory; one warm step of
            each under torch.profiler (device ms by kernel group, the
            optimizer's, launches, busy share, the scan's share) and
            attention alone at the step's shapes
  consistency_train  hymba at full width, 2 layers (one global, one
            windowed), float32, batch 2 x 256: the loss and every gradient
            leaf on the card against the CPU within 1e-3 of each leaf's
            largest |g|; exactly 4 scan and 2 backward launches
  cluster   ``repro_torch.launch.cpml_cluster`` in process on the card:
            Case 1 for 25 rounds under lognormal latencies with ``--pipeline
            off`` and ``full``, and N=8, K=2, T=1 at Case 1's m and d for
            10 rounds with a worker dead from round 3, and Case 1 on a group
            of two masters (``--masters 2``: the dataset encoded on the
            card, a d-slice a master); each bit-identical to
            train_reference over its responder trace, ``coded_grad``
            launched once a round; round ms on the host clock, first-T and
            wait-all waits on the simulated clock; the group run's weights
            are the one-master run's bit for bit, its rounds launch what
            that run's do and the whole of its ``main`` one ``modmatmul``
            more (one a master for the dataset encode), and its line
            carries each master's seconds
  socket    ``cpml_cluster --transport socket`` on the card, one worker
            process per slot, each on cuda: Case 1 with all 40 workers for
            25 rounds (``--pipeline full``), the N=8 fleet for 10 rounds with
            worker 5 killed at round 4 and worker 3 sleeping 0.1 s before
            each reply, that straggler again with ``--collect-all``, Case 1
            on a group of four masters (``case1_masters4``: ``--pipeline
            full --masters 4``), and the N=8 fleet for 14 rounds on a group
            of two with a spare (``slack_elastic_masters2``: worker 5
            killed at round 2 and retired, slot 8 joining at round 10);
            each bit-identical to train_reference, every live worker on
            cuda with a ``coded_grad`` launch per round it answered; start-up
            and provision seconds, median round wall time, first-T against
            wait-all, wire bytes per round, peak device memory (nvidia-smi);
            a group run's master launches ``modmatmul`` exactly S + 1
            times a round (one a master for the weight encode, and the
            mask shares with the pipeline on, the batch decode with it
            off) and nothing else, case1_masters4's weights are
            case1_full's, and its line sets each master's encode (CUDA
            events) and decode (CPU) seconds beside the one-master run's
            walls
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
# The scan's bf16 a/b mode (RunConfig.ssm_dtype="bf16") against its plain
# version on the card: both take the same float32 operations in the same
# order (exp by expf, the products and the h update rounded singly), so
# they round a, b, A_c and B_c alike, and only y's 17-term sum is summed in
# another order: the float32 recurrence's tolerance.
AB16_ATOL = 1e-4
# mamba_mix in the bf16 a/b mode, card against CPU: the card's expf and the
# CPU's vectorised exp (and the two float32 x_proj products) differ in the
# last bit of some a_t and b_t; where that straddles a bf16 rounding
# boundary, the value moves one bf16 step (at most 2^-7 of it), and A_c or
# B_c with it for the rest of the chunk: within 2^-7 of the largest output.
AB16_MIX_REL = 2.0 ** -7
# the chunk length of the bf16 a/b cases: RunConfig()'s scan_chunk
AB16_CHUNK = 128
# falcon-mamba at full width, float32 parameters: card vs CPU and decode vs
# the full forward, the reference model tests' own tolerance.
MODEL_ATOL = 1e-3
SERVE = dict(arch="falcon-mamba-7b", batch=4, prompt_len=2048, gen=32)
# the dense and hybrid serving runs (PERF.md section 4): full width and
# depth, except qwen2-72b's 80 layers, cut to 2 to fit one card; danube's
# prompt passes its 4096-token window, hymba's its 1024
SERVE_DENSE = dict(arch="tinyllama-1.1b", batch=4, prompt_len=2048, gen=32)
SERVE_HYBRID = dict(arch="hymba-1.5b", batch=4, prompt_len=2048, gen=32)
SERVE_SWA = dict(arch="h2o-danube-3-4b", batch=1, prompt_len=4608, gen=16)
SERVE_WIDE = dict(arch="qwen2-72b", layers=2, batch=1, prompt_len=512, gen=4)
# the MoE serving runs (PERF.md section 4): full width, depth cut to fit one
# card (phi3.5-moe 16 of 32 layers, 42.1 GB of bf16; arctic 2 of 35, 55.4 GB)
SERVE_MOE = dict(arch="phi3.5-moe-42b-a6.6b", layers=16, batch=4,
                 prompt_len=2048, gen=32)
SERVE_ARCTIC = dict(arch="arctic-480b", layers=2, batch=4, prompt_len=2048,
                    gen=8)
# the CLI's --reduced runs of the MoE archs on the card
MOE_REDUCED = dict(batch=2, prompt_len=24, gen=4)
CODED = dict(batch=4, prompt_len=16, gen=4, kill_shard=2)
# whisper-tiny at its published config (PERF.md section 4): batch 16 of
# 30-second chunks (1500 stub frames each), a 4-token decoder prompt (the
# length of whisper's start-of-transcript prefix), 60 tokens; its coded
# head at the same batch and prompt for 4 tokens
SERVE_WHISPER = dict(arch="whisper-tiny", batch=16, prompt_len=4, gen=60)
WHISPER_CODED = dict(batch=16, prompt_len=4, gen=4)
# float32 card-vs-CPU and decode-vs-full-forward run of consistency_whisper
CONSISTENCY_WHISPER = dict(batch=2, prompt_len=16, extra=3)
# the falcon-mamba mamba_mix run of the bf16 a/b mode: 2 layers at full
# width, float32 parameters, S not a multiple of the chunk
AB16_MIX = dict(layers=2, batch=2, prompt_len=300)
GELU_SAMPLES = 1 << 20
# The scan's backward kernels against their plain version on the card: each
# gradient within 1e-4 of its largest magnitude.  Both run the same float32
# recurrence; the kernels cut the sequence into chunks joined by carries
# (which reassociate products and sums), sum dbm and dcm over channels
# (warp butterflies, then per-block partials that torch.sum folds), dA_log
# and dD over time, chunks and batch, in another order than the plain
# version, and take a_t from ex2.approx (2 ulp) where the plain version
# calls exp.  No atomics: the kernels' result is the same in every run.
# Where x and dt are bfloat16 the kernel writes dx and ddt in bfloat16: the
# error is measured after taking off that one rounding's share
# (``bwd_err``).
BWD_RTOL = 1e-4
# LM training at full width and depth on one card (PERF.md section 4):
# bf16 parameters, float32 AdamW state, block remat, 10 steps through
# repro_torch.launch.train; hymba's batch and sequence are the serve
# phases' (its 1024-token window passed)
TRAIN_LM = (dict(arch="hymba-1.5b", batch=4, seq=2048, steps=10),
            dict(arch="tinyllama-1.1b", batch=4, seq=2048, steps=10))
# hymba at full width cut to 2 layers (one global, one windowed), float32:
# the loss and every gradient leaf on the card (kernels) against the CPU
# (plain versions), each leaf within 1e-3 of its largest |g| (float32 sums
# in another order through 2 layers' forward and backward)
CONSISTENCY_TRAIN = dict(arch="hymba-1.5b", pattern=(("hybrid_global", 1),
                                                     ("hybrid", 1)),
                         batch=2, seq=256)
GRAD_REL = 1e-3
# More heads than the first coded_grad kernel took (c*r <= 32).
TRAIN_HEADS = dict(classes=33, iters=2)
PHASES = ("kernels", "train", "train_c33", "teacher", "serve", "profile",
          "consistency", "coded_head", "serve_dense", "serve_hybrid",
          "serve_swa", "serve_wide", "consistency_dense", "profile_dense",
          "serve_moe", "serve_arctic", "consistency_moe", "profile_moe",
          "serve_whisper", "consistency_whisper", "train_lm",
          "consistency_train", "cluster", "socket", "mpc",
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
        self.max_err = {"modmatmul": 0, "coded_grad": 0, "selective_scan": 0.0,
                        "selective_scan_bwd": 0.0}

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
    product (B x d)·(d x V/4) and the head encode (6 x 5)·(5 x d·V/4) for
    falcon-mamba (B 4, d 4096, V 65024), tinyllama (4, 2048, 32000), hymba
    (4, 1600, its 32001 cut to 32000), phi3.5-moe (4, 4096, 32064) and
    whisper-tiny (16, 384, its 51865 cut to 51864).  Bit-equal, then
    timed."""
    from repro_torch.core import field
    from repro_torch.kernels import ref
    from repro_torch.kernels import modmatmul as mm

    p = field.P30
    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda shape: torch.randint(0, p, shape, generator=gen,  # noqa: E731
                                       dtype=torch.int32, device="cuda")
    timings = []
    heads = (("", 4, 4096, 16256), ("_tinyllama", 4, 2048, 8000),
             ("_hymba", 4, 1600, 8000), ("_phi35_moe", 4, 4096, 8016),
             ("_whisper", SERVE_WHISPER["batch"], 384, 12966))
    for case, a, b in [c for tag, m, d, v in heads for c in (
            (f"coded_head_shard{tag}", rand((m, d)), rand((d, v))),
            (f"coded_head_encode{tag}", rand((6, 5)), rand((5, d * v))))]:
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
    bf16, h0 = 0), and with dt float32 as the first kernel was timed; then
    the bf16 a/b mode (``ssm_dtype="bf16"``, chunks of 128) at falcon's and
    hymba's serve shapes and odd shapes, timed at the serve shapes."""
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
        # hymba's hybrid layers at its serve shape (d_inner 3200)
        ("hymba_serve_x_dt_bf16", (B, S, 3200, n), bf16, 0.0, bf16),
    ]
    for case, shape, x_dtype, h0_scale, dt_dtype in cases:
        args = scan_inputs(torch, gen, *shape, x_dtype, h0_scale, dt_dtype)
        checks.close("selective_scan", case, ms.selective_scan(*args),
                     ref.selective_scan_ref(*args), SCAN_ATOL,
                     shape=list(shape), x_dtype=str(x_dtype),
                     dt_dtype=str(dt_dtype))
    # the bf16 a/b mode: (case, shape, x/dt dtype, h0 scale, chunk)
    ab16_cases = [
        ("ab16_falcon_serve_h0", (B, S, di, n), bf16, 0.5, AB16_CHUNK),
        ("ab16_hymba_serve_h0", (B, S, 3200, n), bf16, 0.5, AB16_CHUNK),
        # S not a multiple of the chunk, odd widths, states below 16
        ("ab16_S45_chunk7_di1001_n3", (2, 45, 1001, 3), f32, 0.5, 7),
        ("ab16_S300_di8200_n16", (2, 300, 8200, 16), bf16, 0.5, AB16_CHUNK),
        ("ab16_chunk1", (2, 33, 96, 16), f32, 0.5, 1),
    ]
    for case, shape, x_dtype, h0_scale, chunk in ab16_cases:
        args = scan_inputs(torch, gen, *shape, x_dtype, h0_scale, x_dtype)
        checks.close("selective_scan", case,
                     ms.selective_scan(*args, "bf16", chunk),
                     ref.selective_scan_ref(*args, "bf16", chunk), AB16_ATOL,
                     shape=list(shape), x_dtype=str(x_dtype),
                     ssm_dtype="bf16", chunk=chunk)
    timings = []
    for case, di, dt_dtype, mode in (
            ("serve_x_dt_bf16", 8192, bf16, ()),
            ("serve_x_bf16", 8192, f32, ()),
            ("hymba_serve_x_dt_bf16", 3200, bf16, ()),
            ("ab16_falcon_serve", 8192, bf16, ("bf16", AB16_CHUNK)),
            ("ab16_hymba_serve", 3200, bf16, ("bf16", AB16_CHUNK))):
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
            "ms": time_ms(torch, lambda: ms.selective_scan(*args, *mode), 10),
            "plain_ms": time_ms(
                torch, lambda: ref.selective_scan_ref(*args, *mode), 1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "exp_ms": (B * S * di * n + di * n) / SPECIAL_OPS_PER_S * 1e3})
        if mode:
            timings[-1].update(
                ssm_dtype="bf16", chunk=AB16_CHUNK,
                graph_ms=graph_ms(torch,
                                  lambda: ms.selective_scan(*args, *mode), 5))
        emit({"phase": "kernels", "timing": timings[-1]})
    return timings


def phase_ab16_mix(torch) -> dict:
    """falcon-mamba at full width, 2 layers, float32 parameters (seed 0):
    each layer's ``mamba_mix`` with ``ssm_dtype="bf16"`` on one random
    input on the card (the kernel; launches counted just before and after)
    and on the CPU (the plain version), within ``AB16_MIX_REL`` of the
    largest output; beside it the CPU's float32 mode, as a finding: how
    much closer the card's bf16 result lies to the CPU's bf16 result than
    the float32 mode does (RMS)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.models import mamba
    from repro_torch.models import model as M

    full, cfg = cut_config(dict(arch=SERVE["arch"], layers=AB16_MIX["layers"]))
    rc = RunConfig(ssm_dtype="bf16")
    B, S = AB16_MIX["batch"], AB16_MIX["prompt_len"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((B, S, cfg.d_inner), generator=gen, device="cuda")
    info: dict = {"layers": cfg.num_layers, "shape": [B, S, cfg.d_inner,
                                                      cfg.ssm_state],
                  "chunk": rc.scan_chunk, "tolerance_rel": AB16_MIX_REL,
                  "reduced": {"num_layers": [full.num_layers,
                                             cfg.num_layers]},
                  "max_abs_err": {}, "rms_card_vs_cpu": {},
                  "rms_f32_mode_vs_cpu": {}}
    with torch.inference_mode():
        gpu = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
        cpu = M.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
        cpu.load_state_dict(gpu.state_dict())
        ops.reset_launches()
        card = [mamba.mamba_mix(cfg, rc, blk.mamba, x)
                for blk in gpu.segments[0]]
        torch.cuda.synchronize()
        info["launches"] = dict(ops.LAUNCHES)
        for li, blk in enumerate(cpu.segments[0]):
            want = mamba.mamba_mix(cfg, rc, blk.mamba, x.cpu())
            f32 = mamba.mamba_mix(cfg, RunConfig(), blk.mamba, x.cpu())
            for name, g, w, f in zip(("y", "h_last"), card[li], want, f32):
                g = g.cpu()
                key = f"layer{li}_{name}"
                err = float((g - w).abs().max())
                info["max_abs_err"][key] = err
                info["rms_card_vs_cpu"][key] = float((g - w).pow(2).mean()
                                                     .sqrt())
                info["rms_f32_mode_vs_cpu"][key] = float((f - w).pow(2).mean()
                                                         .sqrt())
                tol = AB16_MIX_REL * float(w.abs().max())
                if not err <= tol:
                    raise AssertionError(f"ab16_mix {key}: card vs CPU "
                                         f"{err} > {tol}")
        del gpu, cpu
    emit({"phase": "kernels", "ab16_mix": info})
    _expect_launches("mamba_mix with ssm_dtype='bf16'", info["launches"],
                     cfg.num_layers)
    return info


def scan_bwd_inputs(torch, gen, B, S, di, n, x_dtype, dt_dtype):
    """The forward's inputs (``scan_inputs``, h0 non-zero) and the
    cotangents dy (B, S, di) and dh_last (B, di, n), standard normal."""
    args = scan_inputs(torch, gen, B, S, di, n, x_dtype, 0.5, dt_dtype)
    return (*args, torch.randn((B, S, di), generator=gen, device="cuda"),
            torch.randn((B, di, n), generator=gen, device="cuda"))


def scan_bwd_bound(B: int, S: int, di: int, n: int, xbytes: int
                   ) -> tuple[float, str, float, float]:
    """The backward's least time: (bound ms, by, bytes ms, operations ms).
    Bytes: each input read once in its dtype (x, dt in ``xbytes``; Bm, Cm,
    A_log, D, h0, dy, dh_last float32) and each output written once (dx,
    ddt in x's dtype; dbm, dcm, dA_log, dD, dh0 float32).  Operations: one
    exp (a_t) and ~17 flops a (b, t, i, j) at their rates."""
    el = B * S * di * n
    nbytes = (B * S * di * 2 * xbytes + 2 * B * S * n * 4 + (di * n + di) * 4
              + 2 * B * di * n * 4 + B * S * di * 4              # inputs
              + B * S * di * 2 * xbytes + 2 * B * S * n * 4
              + (di * n + di) * 4 + B * di * n * 4)               # outputs
    b_ms, b_by = bound(nbytes, 17 * el, el)
    return (b_ms, b_by, nbytes / HBM_BYTES_PER_S * 1e3,
            max(17 * el / SCALAR_OPS_PER_S, el / SPECIAL_OPS_PER_S) * 1e3)


def bwd_err(torch, g, w) -> tuple[float, float]:
    """(max |g - w|, the kernel's float32 error as a share of max |w|) for
    a gradient g of the kernel against w of the plain version (float32).
    A bfloat16 g is that error rounded once to nearest even: the rounding's
    share, up to 2^-8 |g| an element, is taken off before it is measured."""
    gf = g.float()
    diff = (gf - w).abs()
    if g.dtype == torch.bfloat16:
        err = float((diff - 2.0 ** -8 * gf.abs()).clamp_min(0).max())
    else:
        err = float(diff.max())
    return float(diff.max()), err / max(float(w.abs().max()), 1e-30)


def scan_fn_views(torch, gen) -> None:
    """``SelectiveScanFn`` as the model calls it: bfloat16 x and dt, and bm
    and cm bfloat16 views of one projection (``models/mamba.py``
    ``_ssm_params``).  Each gradient comes back in its input's dtype and
    slice, within ``BWD_RTOL`` of the plain version's (``bwd_err``)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    B, S, di, n = 2, 45, 1001, 16
    x, dt, bm, cm, a_log, d, h0, dy, dh = scan_bwd_inputs(
        torch, gen, B, S, di, n, torch.bfloat16, torch.bfloat16)
    proj = torch.cat([bm, cm], -1).bfloat16().requires_grad_(True)
    xb, dtb = (t.detach().requires_grad_(True) for t in (x, dt))
    y, h = ms.SelectiveScanFn.apply(xb, dtb, proj[..., :n], proj[..., n:],
                                    a_log, d, h0, "f32", 0)
    ((y * dy).sum() + (h * dh).sum()).backward()
    torch.cuda.synchronize()
    w = ref.selective_scan_bwd_ref(x, dt, proj[..., :n].detach(),
                                   proj[..., n:].detach(), a_log, d, h0, dy,
                                   dh)
    rel = {}
    for name, g, want in (("dx", xb.grad, w[0]), ("ddt", dtb.grad, w[1]),
                          ("dproj", proj.grad, torch.cat(w[2:4], -1))):
        if g.dtype != torch.bfloat16 or g.shape != want.shape:
            raise AssertionError(f"SelectiveScanFn {name}: {g.dtype} "
                                 f"{tuple(g.shape)}, expected bfloat16 "
                                 f"{tuple(want.shape)}")
        rel[name] = bwd_err(torch, g, want)[1]
    emit({"phase": "kernels", "kernel": "selective_scan_bwd",
          "case": "SelectiveScanFn_bf16_views", "max_rel_err": rel,
          "tolerance_rel": BWD_RTOL})
    if not all(v <= BWD_RTOL for v in rel.values()):
        raise AssertionError(f"SelectiveScanFn through views: {rel} beyond "
                             f"{BWD_RTOL}")


def ptxas_report(name: str, match: str) -> dict:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu`` whose
    entry contains ``match``, read from the ``-Xptxas -v`` log that the
    build keeps beside the library: {"<kernel><type>": {...}}."""
    import re

    from repro_torch.kernels import build

    log = build.build_all()[name].parent / f"{name}.log"
    out, cur = {}, None
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
            k = re.search(match + r"_[a-z]+_kernel", entry)
            cur = None
            if k:
                t = entry[k.end():]
                cur = k.group(0) + (
                    "<bf16>" if t.startswith("I13__nv_bf")
                    else "<f32>" if t.startswith("IfE") else "")
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def device_launches(torch, fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the device kernels it
    launches, in all and by group (``_kernel_group``), and the device ms
    of each kernel by its unqualified name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict[str, int] = {}
    ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0) + 1
            k = e.name.replace("(anonymous namespace)::", "")
            k = k.split("<")[0].split("(")[0].split()[-1].split("::")[-1]
            ms[k] = ms.get(k, 0.0) + e.device_time_total / 1e3
    return {"all": sum(groups.values()), "by_group": groups,
            "device_ms_by_kernel": ms}


def phase_kernels_scan_bwd(torch, checks: Checks) -> list[dict]:
    """The scan's backward kernels against their plain version
    (``ref.selective_scan_bwd_ref``) on the card, each gradient within
    ``BWD_RTOL`` of its largest magnitude: hymba's and falcon-mamba's
    training shapes with x and dt bf16 and float32, S = 1, 33 and 8192, n
    in {1, 3, 16} with di not a multiple of the block's 32 channels, one
    chunk and one chunk and a step (S = L and L + 1 at hymba's width, L the
    plan's chunk at hymba's training shape, forced), h0 and dh_last non-zero
    throughout (``bwd_err``), and through ``SelectiveScanFn``
    (``scan_fn_views``); two calls on the same inputs give the same bits.
    Then timed at the two training shapes (CUDA events, and replayed from a
    CUDA graph) beside its bound and the plain version, with the device
    launches a call and each kernel's registers and spills."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(9)
    names = ("dx", "ddt", "dbm", "dcm", "da_log", "dd", "dh0")
    L = ms.plan_bwd(4, 2048, 3200, 2).chunk
    cases = [
        ("hymba_train_bf16", (4, 2048, 3200, 16), bf16, bf16, None),
        ("hymba_train_f32", (4, 2048, 3200, 16), f32, f32, None),
        ("falcon_train_bf16", (4, 2048, 8192, 16), bf16, bf16, None),
        ("falcon_train_f32", (4, 2048, 8192, 16), f32, f32, None),
        ("S1", (4, 1, 8192, 16), bf16, bf16, None),
        ("S33", (2, 33, 8192, 16), f32, f32, None),
        ("long_S8192", (1, 8192, 8192, 16), bf16, bf16, None),
        ("di1000_n1", (2, 45, 1000, 1), bf16, bf16, None),
        ("di1001_n3", (2, 45, 1001, 3), f32, bf16, None),
        ("di1001_n16_x_bf16", (3, 40, 1001, 16), bf16, f32, None),
        ("hymba_S_eq_L", (4, L, 3200, 16), bf16, bf16, L),
        ("hymba_S_eq_L_plus_1", (4, L + 1, 3200, 16), bf16, bf16, L),
    ]
    for case, shape, x_dtype, dt_dtype, chunk in cases:
        args = scan_bwd_inputs(torch, gen, *shape, x_dtype, dt_dtype)
        got = ms.run_bwd(chunk, *args)
        torch.cuda.synchronize()
        want = ref.selective_scan_bwd_ref(*args)
        # dx and ddt in the dtype the kernel reads x and dt in
        xd = bf16 if x_dtype == dt_dtype == bf16 else f32
        abs_err, rel = {}, {}
        for name, g, w in zip(names, got, want):
            dtype = xd if name in ("dx", "ddt") else f32
            if g.shape != w.shape or g.dtype != dtype:
                raise AssertionError(f"selective_scan_bwd {case} {name}: "
                                     f"{g.shape} {g.dtype} vs {w.shape} "
                                     f"{dtype}")
            abs_err[name], rel[name] = bwd_err(torch, g, w)
        checks.max_err["selective_scan_bwd"] = max(
            checks.max_err["selective_scan_bwd"], *abs_err.values())
        pl = ms.plan_bwd(*shape[:3], xd.itemsize, chunk=chunk)
        emit({"phase": "kernels", "kernel": "selective_scan_bwd",
              "case": case, "shape": list(shape), "x_dtype": str(x_dtype),
              "dt_dtype": str(dt_dtype), "chunk": pl.chunk,
              "grid": list(pl.grid), "max_abs_err": abs_err,
              "max_rel_err": rel, "tolerance_rel": BWD_RTOL})
        bad = {k: v for k, v in rel.items() if not v <= BWD_RTOL}
        if bad:
            raise AssertionError(f"selective_scan_bwd {case}: kernel != plain "
                                 f"version beyond {BWD_RTOL} relative: {bad}")
        if case == "hymba_train_bf16":
            again = ms.selective_scan_bwd(*args)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            emit({"phase": "kernels", "kernel": "selective_scan_bwd",
                  "case": case, "bit_identical_second_call": same})
            if not same:
                raise AssertionError("selective_scan_bwd: two calls on the "
                                     "same inputs differ")
            del again
        del args, got, want
        torch.cuda.empty_cache()
    scan_fn_views(torch, gen)
    ptxas = ptxas_report("mamba_scan_bwd", "scan_bwd")
    timings = []
    for case, di in (("hymba_train_bf16", 3200), ("falcon_train_bf16", 8192)):
        B, S, n = 4, 2048, 16
        args = scan_bwd_inputs(torch, gen, B, S, di, n, bf16, bf16)
        b_ms, b_by, bytes_ms, ops_ms = scan_bwd_bound(B, S, di, n, 2)
        pl = ms.plan_bwd(B, S, di, 2)
        timings.append({
            "kernel": "selective_scan_bwd", "case": case,
            "shape": [B, S, di, n], "dt_dtype": str(bf16),
            "chunk": pl.chunk, "grid": list(pl.grid),
            "ms": time_ms(torch, lambda: ms.selective_scan_bwd(*args), 5),
            "graph_ms": graph_ms(torch, lambda: ms.selective_scan_bwd(*args),
                                 3),
            "plain_ms": time_ms(
                torch, lambda: ref.selective_scan_bwd_ref(*args), 1, trials=1),
            "bound_ms": b_ms, "bound_by": b_by, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms,
            "device_launches": device_launches(
                torch, lambda: ms.selective_scan_bwd(*args)),
            "ptxas": ptxas})
        if case == "hymba_train_bf16":  # the plan's chunk and its neighbours
            timings[-1]["graph_ms_by_chunk"] = {
                L: graph_ms(torch, lambda: ms.run_bwd(L, *args), 3)
                for L in (pl.chunk // 2, pl.chunk, 2 * pl.chunk)}
        emit({"phase": "kernels", "timing": timings[-1]})
        del args
        torch.cuda.empty_cache()
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


def _check_served(res: dict, batch: int, gen: int, vocab: int) -> dict:
    toks = res["tokens"]
    if (len(toks) != batch or any(len(t) != gen for t in toks)
            or not all(0 <= x < vocab for t in toks for x in t)):
        raise AssertionError(f"generated tokens out of shape or range: {toks}")
    if not res["logits_finite"]:
        raise AssertionError("non-finite logits while serving")
    return res


def _serve_cli(torch, spec: dict, out: Path, extra: tuple = ()
               ) -> tuple[list, dict, dict]:
    """``repro_torch.launch.serve`` for ``spec`` on the card, as a user runs
    it: (argv, its JSON checked for shape, range and finite logits, the
    kernel launches of the run).  Launch counts and the peak memory are
    reset just before."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--arch", spec["arch"], "--batch", str(spec["batch"]),
            "--prompt-len", str(spec["prompt_len"]), "--gen",
            str(spec["gen"]), *extra, "--seed", "0", "--device", "cuda",
            "--json-out", str(out)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"serve {' '.join(argv)} exited {rc}")
    cfg = registry.get_config(spec["arch"])
    if "--reduced" in extra:
        cfg = registry.reduced_config(cfg)
    vocab = cfg.vocab_size
    res = _check_served(json.loads(out.read_text()), spec["batch"],
                        spec["gen"], vocab)
    return argv, res, launches


def _lm_serve_info(torch, phase: str, spec: dict, cfg, res: dict,
                   launches: dict) -> dict:
    return {"phase": phase, "launches": launches,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_tok_per_s": spec["batch"] * spec["gen"] / res["decode_s"],
            "prefill_tok_per_s": spec["batch"] * spec["prompt_len"]
            / res["prefill_s"],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "logits_finite": res["logits_finite"],
            "sample": res["tokens"][0][:8]}


def _expect_launches(what: str, launches: dict, scans: int) -> None:
    """``scans`` selective_scan launches and no field kernel."""
    if launches != {"modmatmul": 0, "coded_grad": 0, "selective_scan": scans,
                    "selective_scan_bwd": 0}:
        raise AssertionError(f"kernel launches while serving {what}: "
                             f"{launches}")


def phase_serve(torch, out_dir: Path) -> dict:
    """``repro_torch.launch.serve`` at full width and depth on the card."""
    from repro_torch.configs import registry

    cfg = registry.get_config(SERVE["arch"])
    argv, res, launches = _serve_cli(torch, SERVE, out_dir / "serve.json")
    info = dict(_lm_serve_info(torch, "serve", SERVE, cfg, res, launches),
                argv=argv)
    emit(info)
    # one selective_scan launch per layer, all in the prefill; no field
    # kernel on the plain head
    _expect_launches(SERVE["arch"], launches, cfg.num_layers)
    return info


def phase_serve_lm(torch, out_dir: Path, phase: str, spec: dict,
                   coded: bool = True) -> dict:
    """A dense or hybrid model served at full width and depth on the card
    (``selective_scan`` once per hybrid layer, all in the prefill), then,
    with ``coded``, ``--coded-head --kill-shard 2`` with its field values
    checked against the direct product."""
    from repro_torch.configs import registry

    cfg = registry.get_config(spec["arch"])
    argv, res, launches = _serve_cli(torch, spec, out_dir / f"{phase}.json")
    info = dict(_lm_serve_info(torch, phase, spec, cfg, res, launches),
                argv=argv)
    emit(info)
    hybrid = sum(c for k, c in cfg.block_pattern if k.startswith("hybrid"))
    _expect_launches(spec["arch"], launches, hybrid)
    if not coded:
        return info
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI's one-shot head check runs the backbone once more: a second
    # scan per hybrid layer
    info["coded_head"] = coded_head_check(torch, out_dir, spec["arch"],
                                          f"{phase}_coded_head",
                                          scans=2 * hybrid)
    return info


def cut_config(spec: dict):
    """``spec``'s model at full width with its one segment cut to
    ``spec["layers"]`` layers: (the full config, the cut one)."""
    from repro_torch.configs import registry

    full = registry.get_config(spec["arch"])
    (kind, _), = full.block_pattern
    return full, dataclasses.replace(full, num_layers=spec["layers"],
                                     block_pattern=((kind, spec["layers"]),))


def _serve_rc(S: int):
    """``serve``'s run configuration for a prompt of S tokens."""
    from repro_torch.configs.base import RunConfig

    return RunConfig(q_block=min(512, S), kv_block=min(1024, S))


def serve_cut(torch, phase: str, spec: dict) -> dict:
    """``spec``'s model at full width, depth cut (``cut_config``), through
    ``serve.greedy_decode`` (the CLI serves whole models only, and these do
    not fit on one card): no kernel launched, tokens in range, logits
    finite; prefill seconds, decode tokens/s, peak device memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    full, cfg = cut_config(spec)
    S, dev = spec["prompt_len"], torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        prompt = serve.make_prompt(cfg, spec["batch"], S, 0, dev)
        stats: dict = {}
        ops.reset_launches()
        toks = serve.greedy_decode(cfg, _serve_rc(S), model, prompt,
                                   spec["gen"], stats=stats)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    res = dict(stats, tokens=toks.cpu().tolist())
    info = dict(_lm_serve_info(torch, phase, spec, cfg, res, launches),
                reduced={"num_layers": [full.num_layers, spec["layers"]]},
                params=sum(p.numel() for p in model.parameters()),
                batch=spec["batch"], prompt_len=S, gen=spec["gen"])
    emit(info)
    _check_served(res, spec["batch"], spec["gen"], cfg.vocab_size)
    _expect_launches(spec["arch"], launches, 0)
    return info


def phase_serve_wide(torch) -> dict:
    """qwen2-72b at full width (d 8192, 64 heads of 128, QKV bias,
    rope_theta 1e6, vocab 152,064) cut to 2 layers (``serve_cut``)."""
    info = serve_cut(torch, "serve_wide", SERVE_WIDE)
    _, cfg = cut_config(SERVE_WIDE)
    info.update(qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
                head_dim=cfg.head_dim, vocab=cfg.vocab_size)
    return info


def phase_serve_moe(torch, out_dir: Path) -> dict:
    """phi3.5-moe at full width cut to 16 layers (``serve_cut``), then its
    coded head at the same depth (``coded_head_decode``), then
    ``serve --reduced`` for phi3.5-moe and arctic through the CLI."""
    info = serve_cut(torch, "serve_moe", SERVE_MOE)
    gc.collect()
    torch.cuda.empty_cache()
    _, cfg = cut_config(SERVE_MOE)
    info["coded_head"] = coded_head_decode(torch, cfg, "serve_moe_coded_head")
    info["cli_reduced"] = {}
    for arch in (SERVE_MOE["arch"], SERVE_ARCTIC["arch"]):
        argv, res, launches = _serve_cli(
            torch, dict(MOE_REDUCED, arch=arch),
            out_dir / f"serve_moe_reduced_{arch}.json", ("--reduced",))
        _expect_launches(arch, launches, 0)
        info["cli_reduced"][arch] = {"argv": argv, "launches": launches,
                                     "sample": res["tokens"][0]}
    emit({"phase": "serve_moe_cli_reduced", **info["cli_reduced"]})
    return info


def phase_serve_arctic(torch) -> dict:
    """arctic-480b at full width (128 experts of 4864, top-2, the dense
    residual) cut to 2 layers (``serve_cut``)."""
    return serve_cut(torch, "serve_arctic", SERVE_ARCTIC)


def _kernel_group(name: str) -> str:
    if "scan_bwd" in name:
        return "selective_scan_bwd"
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


def profile_window(torch, fn, ranges: tuple[str, ...] = ()) -> dict:
    """``fn()`` once under ``torch.profiler``: device time by kernel group
    and by kernel (the top 8), kernel launches, and the device's busy share
    of the host-clock time (the profiler's own host cost included, so the
    idle share is an upper bound); and for each of ``ranges`` (names of
    ``record_function`` ranges) the device time of the kernels launched
    inside it.  The ranges' own device-side spans are not kernels and are
    not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    by_range = dict.fromkeys(ranges, 0.0)
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3)
            launches += 1
        elif e.device_type == DeviceType.CPU and e.name in by_range:
            by_range[e.name] += e.device_time_total / 1e3
    groups: dict[str, float] = {}
    for k, ms in by_name.items():
        groups[_kernel_group(k)] = groups.get(_kernel_group(k), 0) + ms
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"host_ms": wall_ms, "device_ms": busy,
            "device_ms_by_group": groups,
            "selective_scan_share_of_device_ms":
                groups.get("selective_scan", 0.0) / busy,
            "device_busy_share": busy / wall_ms,
            "kernel_launches": launches,
            "top_kernels_ms": {k[:80]: v for k, v in top},
            **({"device_ms_by_range": by_range} if ranges else {})}


def serve_profile(torch, arch: str, B: int, S: int, steps: int = 8,
                  cfg=None) -> dict:
    """One prefill of ``arch`` at full width and depth (or of ``cfg``) and
    ``steps`` decode steps, each under ``torch.profiler``
    (``profile_window``)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = cfg or registry.get_config(arch)
    rc = RunConfig()
    dev = torch.device("cuda")
    info: dict = {"arch": arch, "layers": cfg.num_layers, "batch": B,
                  "prompt_len": S, "decode_steps": steps}
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
            info[name] = profile_window(torch, fn)
        info["decode"]["kernel_launches_per_step"] = (
            info["decode"]["kernel_launches"] / steps)
        if cfg.num_heads:
            info["prefill"]["attention"] = attention_share(
                torch, cfg, rc, B, S, info["prefill"]["device_ms"])
        if cfg.num_experts:
            info["prefill"]["moe"] = moe_share(
                torch, cfg, rc, model, B, S, info["prefill"])
    return info


def moe_share(torch, cfg, rc, model, B: int, S: int, prefill: dict) -> dict:
    """The MoE layer alone at a prefill's shapes (CUDA events, the first
    layer's parameters, bf16 inputs), summed over the layers: the whole
    layer, its expert products (``moe.expert_ffn`` on the (B, E, C, d)
    dispatched slabs) and the rest of it, the dispatch and combine work
    (router, gating, one-hot and cumsum, the dispatch and combine
    einsums).  Attention's ms (``attention_share``) and the MoE layer's
    leave the rest of the prefill's device ms."""
    from repro_torch.models import moe

    p = model.segments[0][0].moe
    E, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    C = min(max(4, int(-(-S * k * cfg.capacity_factor // E))), S)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((B, S, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    xe = torch.randn((B, E, C, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    L = cfg.num_layers
    layer = time_ms(torch, lambda: moe.moe_forward(cfg, rc, p, x), 3)
    experts = time_ms(torch, lambda: moe.expert_ffn(p, xe), 3)
    flops = 3 * 2 * B * E * C * d * cfg.moe_d_ff
    attn = prefill.get("attention", {}).get("ms_per_prefill", 0.0)
    total = prefill["device_ms"]
    ms = {"attention": attn, "expert_products": L * experts,
          "dispatch_combine": L * (layer - experts),
          "rest": total - attn - L * layer}
    return {"capacity": C, "moe_ms_per_layer": layer,
            "expert_products_ms_per_layer": experts,
            "expert_products_tflop_per_layer": flops / 1e12,
            "expert_products_tflop_per_s": flops / experts / 1e9,
            "ms_per_prefill": ms,
            "share_of_prefill_device_ms": {k: v / total
                                           for k, v in ms.items()}}


def attention_share(torch, cfg, rc, B: int, S: int, prefill_ms: float
                    ) -> dict:
    """``blockwise_attention`` alone at a prefill's shapes (CUDA events),
    once per attention kind of ``cfg`` (full or windowed), summed over its
    layers: attention's device ms in one prefill and its share of
    ``prefill_ms``."""
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (B, S, cfg.num_heads, cfg.head_dim)
    kv = (B, S, cfg.num_kv_heads, cfg.head_dim)
    q, k, v = (torch.randn(s, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for s in (shape, kv, kv))
    layers_by_window: dict = {}
    for kind, count in cfg.block_pattern:
        w = None if kind.endswith("_global") else cfg.sliding_window
        layers_by_window[w] = layers_by_window.get(w, 0) + count
    per_layer, total = {}, 0.0
    for w, count in layers_by_window.items():
        ms = time_ms(torch, lambda: layers.blockwise_attention(
            q, k, v, window=w, q_block=rc.q_block, kv_block=rc.kv_block,
            softcap=cfg.attn_logit_softcap, compute_dtype=rc.attn_dtype), 3)
        per_layer[str(w)] = {"layers": count, "ms_per_layer": ms}
        total += count * ms
    return {"by_window": per_layer, "ms_per_prefill": total,
            "share_of_prefill_device_ms": total / prefill_ms}


def phase_profile(torch) -> dict:
    """Where the serve path's time goes: falcon-mamba's prefill at the serve
    shape and 8 decode steps under ``torch.profiler``."""
    info = {"phase": "profile",
            **serve_profile(torch, SERVE["arch"], SERVE["batch"],
                            SERVE["prompt_len"])}
    del info["arch"]
    emit(info)
    return info


def phase_profile_dense(torch) -> dict:
    """The same for tinyllama, hymba and h2o-danube at their serve shapes,
    with attention's share of the prefill's device time."""
    info: dict = {"phase": "profile_dense"}
    for spec in (SERVE_DENSE, SERVE_HYBRID, SERVE_SWA):
        info[spec["arch"]] = serve_profile(torch, spec["arch"], spec["batch"],
                                           spec["prompt_len"])
        gc.collect()
        torch.cuda.empty_cache()
    emit(info)
    return info


def consistency(torch, cfg, B: int, S: int, extra: int, on_cpu: bool
                ) -> dict:
    """float32 parameters from seed 0 on the card: prefill against the CPU
    (plain versions) when ``on_cpu``, and prefill + ``extra`` decode steps
    against ``backbone`` over S + extra; max abs errors by quantity.  An
    encoder-decoder model reads random float32 frames (the encoder output
    compared too), and its decode steps the card's encoder output."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    rc = RunConfig()
    gpu = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S + extra), generator=gen,
                         dtype=torch.int32, device="cuda")
    frames = {}
    if cfg.is_encoder_decoder:
        frames["enc_embeds"] = torch.randn(
            (B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
            device="cuda")

    def err(a, b):
        return float((a.cpu().float() - b.cpu().float()).abs().max())

    errs = {}
    with torch.inference_mode():
        lg, cg = M.prefill(cfg, rc, gpu, {"tokens": toks[:, :S], **frames},
                           cache_len=S + extra)
        enc = ({"enc_out": M.encode(cfg, rc, gpu, frames["enc_embeds"])}
               if frames else {})
        if on_cpu:
            cpu = M.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
            cpu.load_state_dict(gpu.state_dict())
            cpu_frames = {k: v.cpu() for k, v in frames.items()}
            lc, cc = M.prefill(cfg, rc, cpu, {"tokens": toks[:, :S].cpu(),
                                              **cpu_frames},
                               cache_len=S + extra)
            if frames:
                errs["encode"] = err(enc["enc_out"], M.encode(
                    cfg, rc, cpu, cpu_frames["enc_embeds"]))
            del cpu
            errs["prefill_logits"] = err(lg, lc)
            for si in range(len(cfg.block_pattern)):
                for name in cg[f"seg{si}"]:
                    errs[f"prefill_seg{si}_{name}"] = err(
                        cg[f"seg{si}"][name], cc[f"seg{si}"][name])
        h, _ = M.backbone(cfg, rc, gpu, {"tokens": toks, **frames})
        want = M.lm_head(cfg, gpu, h[:, -1:])
        logits, cache = lg, cg
        for t in range(extra):
            logits, cache = M.decode_step(
                cfg, rc, gpu, cache, {"tokens": toks[:, S + t: S + t + 1],
                                      **enc})
        errs[f"decode{extra}_vs_backbone"] = err(logits, want)
    return errs


def phase_consistency(torch) -> dict:
    """falcon-mamba at full width, 2 layers, float32: the card against the
    CPU, and decode against the full forward on the card."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get_config(SERVE["arch"]), num_layers=2,
                              block_pattern=(("mamba", 2),))
    B, S, extra = 2, 32, 3
    errs = consistency(torch, cfg, B, S, extra, on_cpu=True)
    info = {"phase": "consistency", "layers": 2, "d_model": cfg.d_model,
            "batch": B, "prompt_len": S, "max_abs_err": errs,
            "tolerance": MODEL_ATOL}
    emit(info)
    _within(info)
    return info


def _within(info: dict) -> None:
    bad = {k: v for k, v in info["max_abs_err"].items()
           if not v <= MODEL_ATOL}
    if bad:
        raise AssertionError(f"{info['phase']} beyond {MODEL_ATOL}: {bad}")


# consistency_dense's cuts: 2 layers each, float32 at full width; hymba
# keeps one global and one windowed layer, danube's prompt passes its
# 4096-token window
CONSISTENCY_DENSE = (
    ("tinyllama-1.1b", (("dense", 2),), 2, 32, True),
    ("hymba-1.5b", (("hybrid_global", 1), ("hybrid", 1)), 2, 32, True),
    ("h2o-danube-3-4b", (("dense", 2),), 1, 4100, False),
)


def phase_consistency_dense(torch) -> dict:
    """tinyllama and hymba at full width, 2 layers, float32: prefill on the
    card against the CPU and prefill + 3 decode steps against the full
    forward; h2o-danube past its window on the card only."""
    from repro_torch.configs import registry

    info: dict = {"phase": "consistency_dense", "tolerance": MODEL_ATOL,
                  "max_abs_err": {}, "runs": {}}
    for arch, pattern, B, S, on_cpu in CONSISTENCY_DENSE:
        cfg = dataclasses.replace(registry.get_config(arch), num_layers=2,
                                  block_pattern=pattern)
        errs = consistency(torch, cfg, B, S, 3, on_cpu)
        info["runs"][arch] = {"pattern": pattern, "batch": B,
                              "prompt_len": S, "card_vs_cpu": on_cpu}
        info["max_abs_err"].update({f"{arch}/{k}": v for k, v in errs.items()})
        gc.collect()
        torch.cuda.empty_cache()
    emit(info)
    _within(info)
    return info


def _coded_survivors():
    """The coded head of ``serve --coded-head``: N = 6, K = 4, T = 1, and
    the survivors without shard ``CODED["kill_shard"]``."""
    import numpy as np

    from repro_torch.core import coded_linear as CL

    ccfg = CL.CodedLinearConfig(N=6, K=4, T=1)
    return ccfg, np.array([i for i in range(ccfg.N)
                           if i != CODED["kill_shard"]])


def phase_profile_moe(torch) -> dict:
    """phi3.5-moe's and arctic's prefill at their serve_moe and serve_arctic
    shapes (16 and 2 layers) and 8 decode steps under ``torch.profiler``,
    with the prefill's device ms by group: attention, the expert products,
    dispatch and combine, the rest."""
    info: dict = {"phase": "profile_moe"}
    for spec in (SERVE_MOE, SERVE_ARCTIC):
        info[spec["arch"]] = serve_profile(
            torch, spec["arch"], spec["batch"], spec["prompt_len"],
            cfg=cut_config(spec)[1])
        gc.collect()
        torch.cuda.empty_cache()
    emit(info)
    return info


def whisper_attention(torch, cfg, rc, B: int, S: int) -> dict:
    """``blockwise_attention`` alone at whisper's prefill shapes (CUDA
    events, bf16 inputs), times its layers: the encoder's non-causal
    self-attention over the frames, and the decoder's causal
    self-attention and its cross-attention (S queries over the frames, at
    the default float32 compute dtype)."""
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(9)
    Se, H, KH, hd = cfg.encoder_seq_len, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    qe, ke, ve = rand(B, Se, H, hd), rand(B, Se, KH, hd), rand(B, Se, KH, hd)
    qd, kd, vd = rand(B, S, H, hd), rand(B, S, KH, hd), rand(B, S, KH, hd)
    blocks = dict(q_block=rc.q_block, kv_block=rc.kv_block)
    per_layer = {
        "encoder_self": time_ms(torch, lambda: layers.blockwise_attention(
            qe, ke, ve, causal=False, compute_dtype=rc.attn_dtype, **blocks),
            3),
        "decoder_self": time_ms(torch, lambda: layers.blockwise_attention(
            qd, kd, vd, compute_dtype=rc.attn_dtype, **blocks), 3),
        "decoder_cross": time_ms(torch, lambda: layers.blockwise_attention(
            qd, ke, ve, causal=False, **blocks), 3)}
    layers_of = {"encoder_self": cfg.num_encoder_layers,
                 "decoder_self": cfg.num_layers,
                 "decoder_cross": cfg.num_layers}
    return {"ms_per_layer": per_layer,
            "ms_per_prefill": {k: v * layers_of[k]
                               for k, v in per_layer.items()}}


def whisper_profile(torch, cfg, rc, model, prompt, frames,
                    steps: int = 8) -> dict:
    """whisper's encoder, its decoder's prefill and ``steps`` decode steps,
    each under ``torch.profiler`` (``profile_window``), then attention's
    share of the encoder's and prefill's device ms
    (``whisper_attention``)."""
    from repro_torch.models import model as M

    B, S = prompt.shape
    state: dict = {}

    def encode():
        state["enc_out"] = M.encode(cfg, rc, model, frames)

    def prefill():
        state["logits"], state["cache"] = M.prefill(
            cfg, rc, model, {"tokens": prompt, "enc_out": state["enc_out"]},
            cache_len=S + steps)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for _ in range(steps):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = M.decode_step(
                cfg, rc, model, cache, {"tokens": tok,
                                        "enc_out": state["enc_out"]})

    info: dict = {"decode_steps": steps}
    for name, fn in (("encode", encode), ("prefill", prefill),
                     ("decode", decode)):
        info[name] = profile_window(torch, fn)
    dec = info["decode"]
    dec["kernel_launches_per_step"] = dec["kernel_launches"] / steps
    dec["device_ms_per_step"] = dec["device_ms"] / steps
    attn = whisper_attention(torch, cfg, rc, B, S)
    total = info["encode"]["device_ms"] + info["prefill"]["device_ms"]
    attn["share_of_encode_and_prefill_device_ms"] = {
        k: v / total for k, v in attn["ms_per_prefill"].items()}
    info["attention"] = attn
    return info


def phase_serve_whisper(torch) -> dict:
    """whisper-tiny at its published config (4 encoder and 4 decoder
    layers, d 384, 6 heads of 64, d_ff 1536, vocab 51865, 1500 frames),
    bf16, random weights from seed 0: batch 16 of stub frames, a 4-token
    prompt, 60 tokens through ``serve.greedy_decode(..., enc_embeds=...)``
    (the CLI takes tokens only, as the reference's): no kernel launched,
    tokens in range, logits finite; encoder and decoder-prefill ms, decode
    tokens/s, peak device memory; then ``whisper_profile``; then its coded
    head at batch 16 and prompt 4 (``coded_head_decode``): field values
    bit-equal to (h_q @ w_q) mod p, ``modmatmul`` launches as counted."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    spec = SERVE_WHISPER
    cfg = registry.get_config(spec["arch"])
    B, S, gen = spec["batch"], spec["prompt_len"], spec["gen"]
    # RunConfig()'s 512 and 1024 attention blocks, not serve's rule
    # min(512, prompt_len), which sizes them by the 4-token decoder prompt
    # and would cut the encoder's 1500-frame self-attention into 375 x 375
    # tiles of 4; blockwise_attention clamps them to each call's lengths
    rc = RunConfig()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        prompt = serve.make_prompt(cfg, B, S, 0, dev)
        frames = serve.make_frames(cfg, B, 0, dev)
        stats: dict = {}
        ops.reset_launches()
        toks = serve.greedy_decode(cfg, rc, model, prompt, gen, stats=stats,
                                   enc_embeds=frames)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        profile = whisper_profile(torch, cfg, rc, model, prompt, frames)
        del model
    res = dict(stats, tokens=toks.cpu().tolist())
    info = {"phase": "serve_whisper", "launches": launches,
            "layers": {"encoder": cfg.num_encoder_layers,
                       "decoder": cfg.num_layers},
            "d_model": cfg.d_model, "batch": B, "frames": cfg.encoder_seq_len,
            "prompt_len": S, "gen": gen,
            "params": cfg.param_count() + cfg.d_model,
            "encode_ms": stats["encode_s"] * 1e3,
            "prefill_ms": stats["prefill_s"] * 1e3,
            "decode_s": stats["decode_s"],
            "decode_tok_per_s": B * gen / stats["decode_s"],
            "max_memory_allocated_gb": peak_gb,
            "logits_finite": stats["logits_finite"],
            "sample": res["tokens"][0][:8], "profile": profile}
    emit(info)
    _check_served(res, B, gen, cfg.vocab_size)
    _expect_launches(spec["arch"], launches, 0)
    gc.collect()
    torch.cuda.empty_cache()
    info["coded_head"] = coded_head_decode(
        torch, cfg, "serve_whisper_coded_head", WHISPER_CODED, frames=True)
    return info


def phase_consistency_whisper(torch) -> dict:
    """whisper-tiny at full width and depth, float32: prefill (encoder
    included) on the card against the CPU, and prefill + 3 decode steps
    against the full forward on the card, within 1e-3; then, as a finding
    (no gate), the share of bf16 ``gelu`` outputs that differ between the
    card and the CPU on the same 2^20 inputs from N(0, 16)."""
    from repro_torch.configs import registry
    from repro_torch.models import layers

    cfg = registry.get_config(SERVE_WHISPER["arch"])
    spec = CONSISTENCY_WHISPER
    errs = consistency(torch, cfg, spec["batch"], spec["prompt_len"],
                       spec["extra"], on_cpu=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = (torch.randn(GELU_SAMPLES, generator=gen, device="cuda") * 4
         ).bfloat16()
    card, cpu = layers.gelu(x).cpu(), layers.gelu(x.cpu())
    info = {"phase": "consistency_whisper", "layers": cfg.num_layers,
            "encoder_layers": cfg.num_encoder_layers,
            "d_model": cfg.d_model, "frames": cfg.encoder_seq_len, **spec,
            "max_abs_err": errs, "tolerance": MODEL_ATOL,
            "gelu_bf16_card_vs_cpu": {
                "samples": GELU_SAMPLES,
                "share_differing": float((card != cpu).float().mean()),
                "max_abs_diff": float((card.float() - cpu.float()).abs()
                                      .max())}}
    emit(info)
    _within(info)
    return info


def _ssm_layers(cfg) -> int:
    return sum(c for k, c in cfg.block_pattern
               if k.startswith(("mamba", "hybrid")))


def attention_train_ms(torch, cfg, rc, B: int, S: int) -> dict:
    """``blockwise_attention`` alone at a training step's shapes (CUDA
    events), forward and forward + backward, once per attention kind of
    ``cfg``: its device ms in one step, summed over the layers, counting
    the forward twice (block remat recomputes it in the backward)."""
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (B, S, cfg.num_heads, cfg.head_dim)
    kv = (B, S, cfg.num_kv_heads, cfg.head_dim)
    q, k, v = (torch.randn(s, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(True)
               for s in (shape, kv, kv))
    dout = torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    layers_by_window: dict = {}
    for kind, count in cfg.block_pattern:
        w = None if kind.endswith("_global") else cfg.sliding_window
        layers_by_window[w] = layers_by_window.get(w, 0) + count
    per_layer, total = {}, 0.0
    for w, count in layers_by_window.items():
        def fwd():
            return layers.blockwise_attention(
                q, k, v, window=w, q_block=rc.q_block, kv_block=rc.kv_block,
                softcap=cfg.attn_logit_softcap, compute_dtype=rc.attn_dtype)

        with torch.no_grad():
            f_ms = time_ms(torch, fwd, 2)
        fb_ms = time_ms(torch, lambda: torch.autograd.backward(fwd(), dout),
                        2)
        per_layer[str(w)] = {"layers": count, "forward_ms": f_ms,
                             "forward_backward_ms": fb_ms}
        total += count * (f_ms + fb_ms)
    return {"by_window": per_layer, "ms_per_step": total}


def train_profile(torch, cfg, spec: dict) -> dict:
    """One warm step of ``repro_torch.launch.train.train_step_fn`` for
    ``cfg`` at ``spec``'s shape (the train CLI's run configuration and
    optimizer) under ``torch.profiler``: device ms by kernel group, the
    optimizer's share (the kernels inside the step's
    ``train.OPTIMIZER_RANGE``), launches, the busy share of the host-clock
    step, the scan kernels' share; then attention alone at the step's
    shapes (``attention_train_ms``)."""
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt

    B, S = spec["batch"], spec["seq"]
    rc = train.run_config(S, B)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10)
    model = M.Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"opt": opt.init_state(ocfg, params)}
    step = train.train_step_fn(cfg, rc, ocfg, model)
    with LMBatchLoader("cuda", B, S, cfg.vocab_size) as loader:
        batches = [next(loader) for _ in range(2)]

    def run(batch):
        _, state["opt"], _ = step(params, state["opt"], batch)

    run(batches[0])     # warm-up: the allocator's pools, cuBLAS plans
    w = profile_window(torch, lambda: run(batches[1]),
                       ranges=(train.OPTIMIZER_RANGE,))
    del model, params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    groups, device = w["device_ms_by_group"], w["device_ms"]
    optimizer_ms = w["device_ms_by_range"][train.OPTIMIZER_RANGE]
    if not 0 < optimizer_ms < device:
        raise AssertionError(f"train_profile {cfg.name}: the optimizer's "
                             f"range holds {optimizer_ms} of {device} ms")
    info = {"step_host_ms": w["host_ms"], "step_device_ms": device,
            "device_ms_by_group": groups, "optimizer_device_ms": optimizer_ms,
            "launches_per_step": w["kernel_launches"],
            "device_busy_share": w["device_busy_share"],
            "scan_share_of_device_ms": (groups.get("selective_scan", 0.0)
                                        + groups.get("selective_scan_bwd",
                                                     0.0)) / device,
            "top_kernels_ms": w["top_kernels_ms"]}
    if cfg.num_heads:
        att = attention_train_ms(torch, cfg, rc, B, S)
        att["share_of_step_device_ms"] = att["ms_per_step"] / device
        info["attention"] = att
    return info


def phase_train_lm(torch, out_dir: Path) -> dict:
    """``repro_torch.launch.train`` at full width and depth on the card for
    each of ``TRAIN_LM`` (hymba-1.5b, then tinyllama-1.1b): exit 0, launch
    counts reset just before each run and read just after (per step and
    mamba-bearing layer, ``selective_scan`` twice, the first forward and
    remat's recompute, and ``selective_scan_bwd`` once; nothing else),
    finite losses, the last below 1.05 x the first; step ms (the first step
    apart), tokens/s, peak device memory; then ``train_profile``."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    info: dict = {"phase": "train_lm", "runs": {}}
    for spec in TRAIN_LM:
        arch, steps = spec["arch"], spec["steps"]
        cfg = registry.get_config(arch)
        out = out_dir / f"train_lm_{arch}.json"
        argv = ["--arch", arch, "--batch", str(spec["batch"]), "--seq",
                str(spec["seq"]), "--steps", str(steps), "--log-every", "1",
                "--device", "cuda", "--checkpoint-dir",
                str(out_dir / "train_lm_ckpt"), "--json-out", str(out)]
        ops.reset_launches()
        rc = train.main(argv)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"train {' '.join(argv)} exited {rc}")
        res = json.loads(out.read_text())
        ssm = _ssm_layers(cfg)
        want = {"modmatmul": 0, "coded_grad": 0,
                "selective_scan": 2 * ssm * steps,
                "selective_scan_bwd": ssm * steps}
        losses = res["losses"]
        later = res["step_s"][1:]
        run = {"argv": argv, "launches": launches, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "params": cfg.param_count(),
               "steps": res["steps"], "first_loss": res["first_loss"],
               "last_loss": res["last_loss"], "losses": losses,
               "first_step_ms": res["step_s"][0] * 1e3,
               "step_ms_median": statistics.median(later) * 1e3,
               "step_ms": [t * 1e3 for t in res["step_s"]],
               "tokens_per_s": res["tokens_per_s"], "peak_gb": res["peak_gb"]}
        info["runs"][arch] = run
        emit({"phase": "train_lm", "arch": arch,
              **{k: v for k, v in run.items() if k != "step_ms"}})
        if launches != want:
            raise AssertionError(f"train {arch}: kernel launches {launches}, "
                                 f"expected {want}")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0] * 1.05 and res["steps"] == steps):
            raise AssertionError(f"train {arch}: losses {losses}")
        gc.collect()
        torch.cuda.empty_cache()
        run["profile"] = train_profile(torch, cfg, spec)
        emit({"phase": "train_lm", "arch": arch, "profile": run["profile"]})
    # the slice's main path: hymba's run
    info["launches"] = info["runs"][TRAIN_LM[0]["arch"]]["launches"]
    return info


def phase_consistency_train(torch) -> dict:
    """hymba at full width cut to 2 layers, float32, batch 2 x 256 tokens:
    ``loss_fn`` and its gradients on the card (the scan kernels; launches
    counted) against the CPU (plain versions) from the same parameters,
    every leaf within ``GRAD_REL`` of its largest |g|."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model as M

    spec = CONSISTENCY_TRAIN
    full = registry.get_config(spec["arch"])
    cfg = dataclasses.replace(full, num_layers=len(spec["pattern"]),
                              block_pattern=spec["pattern"])
    B, S = spec["batch"], spec["seq"]
    rc = train.run_config(S, B)
    gen = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gpu = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
    cpu = M.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu.load_state_dict(gpu.state_dict())
    out = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = next(model.parameters()).device
        model.requires_grad_(True)
        ops.reset_launches()
        loss = M.loss_fn(cfg, rc, model, {k: v.to(dev)
                                          for k, v in batch.items()})
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (float(loss.detach()), dict(ops.LAUNCHES),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    (lg, launches, gg), (lc, _, gc_) = out["card"], out["cpu"]
    rel = {k: float((gg[k] - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30)
           for k, w in gc_.items()}
    worst = max(rel, key=rel.get)
    ssm = _ssm_layers(cfg)
    info = {"phase": "consistency_train", "pattern": spec["pattern"],
            "d_model": cfg.d_model, "batch": B, "seq": S,
            "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
            "loss_card": lg, "loss_cpu": lc,
            "loss_rel_err": abs(lg - lc) / abs(lc), "launches": launches,
            "leaves": len(rel), "max_rel_err": rel[worst], "worst_leaf": worst,
            "tolerance_rel": GRAD_REL}
    emit(info)
    want = {"modmatmul": 0, "coded_grad": 0, "selective_scan": 2 * ssm,
            "selective_scan_bwd": ssm}
    if launches != want:
        raise AssertionError(f"consistency_train launches {launches}, "
                             f"expected {want}")
    bad = {k: v for k, v in rel.items() if not v <= GRAD_REL}
    if bad or not info["loss_rel_err"] <= GRAD_REL:
        raise AssertionError(f"consistency_train beyond {GRAD_REL}: loss "
                             f"{info['loss_rel_err']}, leaves {bad}")
    return info


def _mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        kb = next(int(ln.split()[1]) for ln in f
                  if ln.startswith("MemAvailable:"))
    return kb / 2 ** 20


class GatingLog:
    """Records every call of ``moe._top_k_gating`` while active: the
    device, the router logits and the chosen experts (on the host)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        inner = self.fn = self.moe._top_k_gating

        def logged(cfg, logits):
            w, idx = inner(cfg, logits)
            self.calls.append((logits.device.type, logits.float().cpu(),
                               idx.cpu()))
            return w, idx

        self.moe._top_k_gating = logged
        return self

    def __exit__(self, *exc):
        self.moe._top_k_gating = self.fn


def topk_agreement(card: list, cpu: list, k: int) -> dict:
    """Per layer's gating call, the tokens whose top-k expert sets agree
    between the card and the CPU; where one differs, the card's margin
    between its k-th and (k+1)-th logits there (a near tie flips)."""
    agree = total = 0
    margins = []
    for (_, lg, ig), (_, _, ic) in zip(card, cpu):
        same = (ig.sort(-1).values == ic.sort(-1).values).all(-1)
        agree += int(same.sum())
        total += same.numel()
        if not bool(same.all()):
            top = lg.sort(-1, descending=True).values
            margins += (top[..., k - 1] - top[..., k])[~same].tolist()
    return {"tokens_agree": agree, "tokens": total,
            "margins_where_they_differ": margins}


def phase_consistency_moe(torch) -> dict:
    """phi3.5-moe at full width, 2 layers, float32, capacity factor 8 (no
    token dropped, as the reference's test_decode_matches_full_forward):
    prefill on the card against the CPU and prefill + 3 decode steps
    against the full forward (``consistency``), the top-2 expert sets of
    the card's and the CPU's prefills, then ``moe_impl="sort"`` against
    ``"einsum"`` on the card; within 1e-3."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import model as M

    cfg = dataclasses.replace(registry.get_config(SERVE_MOE["arch"]),
                              num_layers=2, block_pattern=(("moe", 2),),
                              capacity_factor=8.0)
    B, S, extra = 2, 32, 3
    need_gb = 2 * cfg.param_count() * 4 / 2 ** 30
    free_gb = _mem_available_gb()
    if free_gb < need_gb + 8:
        raise AssertionError(f"consistency_moe: {free_gb:.1f} GiB free on "
                             f"the host, {need_gb:.1f} GiB needed")
    with GatingLog() as log:
        errs = consistency(torch, cfg, B, S, extra, on_cpu=True)
    # consistency() runs the card's prefill first, then the CPU's
    card = [c for c in log.calls if c[0] == "cuda"][:cfg.num_layers]
    cpu = [c for c in log.calls if c[0] == "cpu"]
    agreement = topk_agreement(card, cpu, cfg.experts_per_token)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
        he, _ = M.backbone(cfg, RunConfig(), model, {"tokens": toks})
        hs, _ = M.backbone(cfg, RunConfig(moe_impl="sort"), model,
                           {"tokens": toks})
        errs["sort_vs_einsum_hidden"] = float((hs - he).abs().max())
        errs["sort_vs_einsum_logits"] = float(
            (M.lm_head(cfg, model, hs) - M.lm_head(cfg, model, he))
            .abs().max())
        del model
    info = {"phase": "consistency_moe", "layers": 2, "d_model": cfg.d_model,
            "capacity_factor": cfg.capacity_factor, "batch": B,
            "prompt_len": S, "host_gib_free": free_gb,
            "max_abs_err": errs, "topk_card_vs_cpu": agreement,
            "tolerance": MODEL_ATOL}
    emit(info)
    _within(info)
    return info


def coded_field_check(torch, cfg, model, prompt, frames=None, rc=None
                      ) -> dict:
    """The coded head of ``model`` (masks from seed 0, as ``serve``) on the
    prompt's last post-final-norm hidden state (an encoder-decoder model
    reads ``frames``; ``rc`` defaults to ``serve``'s): the decoded field
    values against the direct product (h_q @ w_q) mod p from the plain
    version, and the float logits against h @ w."""
    from repro_torch.core import coded_linear as CL
    from repro_torch.core import quantize
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    ccfg, survivors = _coded_survivors()
    S = prompt.shape[1]
    w, shares = serve.encode_head(cfg, model, ccfg, 0)
    batch = {"tokens": prompt}
    if frames is not None:
        batch["enc_embeds"] = frames
    _, _, h = M.prefill(cfg, rc or _serve_rc(S), model, batch,
                        cache_len=S + 1, return_hidden=True)
    h = h[:, -1].float()
    results, used = CL.shard_results(ccfg, h, shares, survivors)
    got = CL.decode_field(ccfg, results, used)
    want = ref.modmatmul_ref(quantize.quantize_data(h, ccfg.lh, ccfg.p),
                             quantize.quantize_data(w, ccfg.lw, ccfg.p),
                             ccfg.p)
    torch.cuda.synchronize()
    check = serve.coded_head_check(ccfg, h, w, shares, survivors)
    return {"head_shape": list(w.shape), "survivors_used": used.tolist(),
            "field_shape": list(got.shape),
            "field_bit_equal_to_direct_product": bool(torch.equal(got, want)),
            "rel_err": check["rel_err"],
            "argmax_agreement": check["argmax_agreement"]}


def _coded_verdict(phase: str, info: dict, scans: int) -> None:
    emit(info)
    if not info["field_bit_equal_to_direct_product"]:
        raise AssertionError(f"{phase}: decoded field values != (h_q @ w_q)"
                             " mod p")
    launches = info["launches"]
    if launches["modmatmul"] == 0 or launches["selective_scan"] != scans:
        raise AssertionError(f"{phase}: launches {launches} (modmatmul > 0 "
                             f"and {scans} selective_scan expected)")


def coded_head_check(torch, out_dir: Path, arch: str, phase: str,
                     scans: int) -> dict:
    """``serve --coded-head --kill-shard 2`` for ``arch`` at full width,
    then the decoded field values of the same head, prompt and survivors
    against the direct product (``coded_field_check``).  The CLI run must
    launch ``modmatmul`` and ``scans`` selective scans."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = registry.get_config(arch)
    argv, res, launches = _serve_cli(
        torch, dict(CODED, arch=arch), out_dir / f"{phase}.json",
        ("--coded-head", "--kill-shard", str(CODED["kill_shard"])))
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI's head, prompt and masks again, from the same seeds
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        prompt = serve.make_prompt(cfg, CODED["batch"], CODED["prompt_len"], 0,
                                   torch.device("cuda"))
        field = coded_field_check(torch, cfg, model, prompt)
        del model
    info = {"phase": phase, "argv": argv, "launches": launches, **field,
            "cli_rel_err": res["coded_head"]["rel_err"],
            "cli_argmax_agreement": res["coded_head"]["argmax_agreement"],
            "decode_tok_per_s": res["decode_tok_per_s"]}
    _coded_verdict(phase, info, scans)
    return info


def coded_head_decode(torch, cfg, phase: str, spec: dict = CODED,
                      frames: bool = False) -> dict:
    """``serve.greedy_decode`` through the coded head (``spec``'s batch,
    prompt and tokens, shard 2 lost) for a config the CLI cannot serve (a
    cut depth, or an encoder-decoder model, which reads stub ``frames``
    and runs at ``RunConfig()``'s attention blocks), launches counted from
    the head's encode on; then ``coded_field_check`` on the same model.
    ``modmatmul`` must launch exactly 1 + gen · (K + T + 1) times (the
    head's encode, then a token's K + T shard products and its decode),
    the scan never."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    ccfg, survivors = _coded_survivors()
    B, S, gen = spec["batch"], spec["prompt_len"], spec["gen"]
    dev = torch.device("cuda")
    rc = RunConfig() if frames else _serve_rc(S)
    with torch.inference_mode():
        model = M.Model(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        prompt = serve.make_prompt(cfg, B, S, 0, dev)
        enc = serve.make_frames(cfg, B, 0, dev) if frames else None
        ops.reset_launches()
        _, shares = serve.encode_head(cfg, model, ccfg, 0)
        stats: dict = {}
        toks = serve.greedy_decode(cfg, rc, model, prompt, gen,
                                   coded={"cfg": ccfg, "shares": shares},
                                   survivors=survivors, stats=stats,
                                   enc_embeds=enc)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        del shares
        field = coded_field_check(torch, cfg, model, prompt, enc, rc)
        del model
    res = dict(stats, tokens=toks.cpu().tolist())
    _check_served(res, B, gen, cfg.vocab_size)
    expected = 1 + gen * (ccfg.threshold + 1)
    info = {"phase": phase, "layers": cfg.num_layers, "launches": launches,
            "modmatmul_expected": expected, **field,
            "survivors": survivors.tolist(), "batch": B, "prompt_len": S,
            "gen": gen, "prefill_s": stats["prefill_s"],
            "decode_tok_per_s": B * gen / stats["decode_s"]}
    _coded_verdict(phase, info, 0)
    if launches["modmatmul"] != expected:
        raise AssertionError(f"{phase}: {launches['modmatmul']} modmatmul "
                             f"launches, {expected} expected")
    return info


def phase_coded_head(torch, out_dir: Path) -> dict:
    """``serve --coded-head --kill-shard 2`` for falcon-mamba at full width,
    checked against the direct product (``coded_head_check``)."""
    from repro_torch.configs import registry

    return coded_head_check(torch, out_dir, SERVE["arch"], "coded_head",
                            scans=2 * registry.get_config(
                                SERVE["arch"]).num_layers)


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
    # the dataset encoded through a group of two masters, a d-slice each
    # on the card; in process each round runs as one engine round
    ("case1_masters2", CASE1, ["--latency", "lognormal", "--pipeline", "off",
                               "--masters", "2"]),
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
    # a group of four masters: the dataset and each round's split weight
    # encode on the card, the streaming decode's folds on the host, a
    # d-slice each
    ("case1_masters4", CASE1, ["--pipeline", "full", "--masters", "4"]),
    # the elastic fleet on a group of two: worker 5 killed at round 2, the
    # spare slot 8 joining at round 10.  Worker 3 sleeps 0.1 s before each
    # reply, so while the fleet is one short every round waits for it: 8
    # rounds of at least 0.1 s put worker 5's silence past the 0.5 s
    # heartbeat timeout, and it is retired (LEAVE) before the join
    ("slack_elastic_masters2", dict(SLACK, iters=14),
     ["--spares", "1", "--kill-worker", "5", "--kill-at-round", "2",
      "--straggle-worker", "3", "--straggle-sleep", "0.1",
      "--heartbeat-timeout", "0.5", "--join-at-round", "10",
      "--masters", "2"]),
)
# Each group run and the one-master run it is set beside: the same flags
# but --masters (case1_masters4's responders are all 40 workers every round,
# so its weights are held to case1_full's bit for bit), or for the elastic
# run the one-master fault run on the same fleet.  The master's launches at
# S > 1, worked out from the code: each master's encode is one
# ``modmatmul`` on its d-slice, and the streaming folds run on the host.
# So set-up's dataset encode launches S where one master launches 1, in
# process the rounds launch what the one-master run's do (the group only
# encodes the dataset there), and over sockets each round launches S for
# the weight encode (whole, or the split's data rows) plus one: with
# ``--pipeline full`` the prefetched mask shares, with it off the batch
# decode.
MASTERS_TWINS = {"case1_masters2": "case1_lognormal_off",
                 "case1_masters4": "case1_full",
                 "slack_elastic_masters2": "slack_kill_straggle"}
SAME_WEIGHTS = ("case1_masters2", "case1_masters4")


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
        info["w_sha256"] = res["w_sha256"]
        if name in MASTERS_TWINS:
            one = runs[MASTERS_TWINS[name]]
            # the rounds launch as one master's; set-up's dataset encode
            # launched once a master (S - 1 more over the whole of main)
            S = res["config"]["masters"]
            want_main = dict(one["launches_main"],
                             modmatmul=one["launches_main"]["modmatmul"]
                             + S - 1)
            if (res["launches_run"] != one["launches_run"]
                    or launches != want_main):
                raise AssertionError(f"cluster {name}: launches {launches}, "
                                     f"run {res['launches_run']}; want "
                                     f"{want_main}, {one['launches_run']}")
            info["masters"] = masters_line("cluster", info, res, one)
        runs[name] = info
    return {"phase": "cluster", "runs": runs,
            "launches": {k: sum(r["launches_run"][k] for r in runs.values())
                         for k in runs[CLUSTER_RUNS[0][0]]["launches_run"]}}


def masters_line(phase: str, info: dict, res: dict, one: dict) -> dict:
    """A ``--masters S`` run's group beside its one-master run (``info``
    and ``one``: the two runs' lines): S, each master's encode (on the
    card, CUDA events) and decode (CPU) seconds, the group's totals and
    critical path, and both runs' master encode and decode walls a round
    (over sockets; in process the
    round is simulated and its host ms are set side by side instead).
    Fails unless the JSON reports the group at its size with a critical
    path above 0 and, for ``SAME_WEIGHTS``, unless the weights are the
    one-master run's bit for bit.  Printed with the card's name and power
    limit."""
    name = info["run"]
    S = res["config"]["masters"]
    g = res["wait_stats"].get("masters")
    if (g is None or g["size"] != S or len(g["per_master"]) != S
            or not g["critical_path_s"] > 0):
        raise AssertionError(f"{phase} {name}: masters stats {g} for "
                             f"--masters {S}")
    same = info["w_sha256"] == one["w_sha256"]
    if name in SAME_WEIGHTS and not same:
        raise AssertionError(f"{phase} {name}: weights differ from the "
                             f"one-master run {one['run']}")
    line = {"phase": phase, "run": name, "card": nvidia_smi(),
            "masters": S, "per_master": g["per_master"],
            "encode_total_s": g["encode_total_s"],
            "decode_total_s": g["decode_total_s"],
            "critical_path_s": g["critical_path_s"],
            "one_master_run": one["run"],
            "weights_equal_one_master": same}
    if phase == "socket":
        for key, x in (("", info), ("one_master_", one)):
            line[key + "encode_decode_walls_s"] = {
                k: {q: x["waits_wall_s"][k][q] for q in ("mean", "p50")}
                for k in ("encode", "decode")}
            line[key + "round_ms_median"] = x["round_ms_median"]
    else:
        line["round_ms_host"] = info["round_ms_host"]
        line["one_master_round_ms_host"] = one["round_ms_host"]
    emit(line)
    return line


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
    worker 5 killed at round 4 and worker 3 straggling, that straggler
    again with every round held to its last arrival, and the two group
    runs (``MASTERS_TWINS``).  Each run is bit-identical to
    train_reference; every live worker (a joiner's slot included) reports
    cuda, one ``coded_grad`` launch in its warm-up and exactly one a round
    it answered.  A group run's master launches ``modmatmul`` S + 1 times
    a round and nothing else; the elastic run both retires the killed worker and
    admits the joiner."""
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
        slots = spec["N"] + ("--join-at-round" in extra)
        if sorted(r["worker"] for r in reports) != list(range(slots)):
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
        info["w_sha256"] = res["w_sha256"]
        if name in MASTERS_TWINS:
            want = {k: 0 for k in res["launches_run"]}
            want["modmatmul"] = iters * (res["config"]["masters"] + 1)
            if res["launches_run"] != want:
                raise AssertionError(f"socket {name}: master launches "
                                     f"{res['launches_run']}, want {want}")
            memb = stats["membership"]
            if "--join-at-round" in extra and not (
                    memb["joins"] >= 1 and memb["leaves"] >= 1):
                raise AssertionError(f"socket {name}: membership {memb}")
            info["masters"] = masters_line("socket", info, res,
                                           runs[MASTERS_TWINS[name]])
            info["membership"] = memb
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
        timings += run_phase("kernels_scan_bwd", phase_kernels_scan_bwd, torch,
                             checks)
        ran["ab16_mix"] = run_phase("kernels_ab16_mix", phase_ab16_mix, torch)
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
            ("serve_dense", phase_serve_lm,
             (torch, out_dir, "serve_dense", SERVE_DENSE)),
            ("serve_hybrid", phase_serve_lm,
             (torch, out_dir, "serve_hybrid", SERVE_HYBRID)),
            ("serve_swa", phase_serve_lm,
             (torch, out_dir, "serve_swa", SERVE_SWA, False)),
            ("serve_wide", phase_serve_wide, (torch,)),
            ("consistency_dense", phase_consistency_dense, (torch,)),
            ("profile_dense", phase_profile_dense, (torch,)),
            ("serve_moe", phase_serve_moe, (torch, out_dir)),
            ("serve_arctic", phase_serve_arctic, (torch,)),
            ("consistency_moe", phase_consistency_moe, (torch,)),
            ("profile_moe", phase_profile_moe, (torch,)),
            ("serve_whisper", phase_serve_whisper, (torch,)),
            ("consistency_whisper", phase_consistency_whisper, (torch,)),
            ("train_lm", phase_train_lm, (torch, out_dir)),
            ("consistency_train", phase_consistency_train, (torch,)),
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
                 "selective_scan": "serve_x_dt_bf16",
                 "selective_scan_bwd": "hymba_train_bf16"}
    main_path = {"modmatmul": "train", "coded_grad": "train",
                 "selective_scan": "serve", "selective_scan_bwd": "train_lm"}
    replaces = {
        "modmatmul": "src/repro/kernels/modmatmul.py:94",
        "coded_grad": "src/repro/kernels/coded_grad.py:117",
        "selective_scan": "src/repro/kernels/mamba_scan.py:83",
        # no TPU kernel: the reference differentiates its plain jnp scan
        "selective_scan_bwd": "src/repro/models/mamba.py:61",
    }
    source = {"modmatmul": "modmatmul.cu", "coded_grad": "coded_grad.cu",
              "selective_scan": "mamba_scan.cu",
              "selective_scan_bwd": "mamba_scan_bwd.cu"}
    if "kernels" in phases:
        kernels = []
        for name in ("coded_grad", "modmatmul", "selective_scan",
                     "selective_scan_bwd"):
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
                                 ("serve_dense", "serve_dense"),
                                 ("serve_hybrid", "serve_hybrid"),
                                 ("serve_swa", "serve_swa"),
                                 ("serve_wide", "serve_wide"),
                                 ("serve_moe", "serve_moe"),
                                 ("serve_arctic", "serve_arctic"),
                                 ("serve_whisper", "serve_whisper"),
                                 ("mamba_mix_ssm_bf16", "ab16_mix"),
                                 ("cluster_inprocess", "cluster"),
                                 ("cluster_socket", "socket"),
                                 ("mpc_inprocess", "mpc"),
                                 ("mpc_socket", "mpc_socket"),
                                 ("resilient", "resilient"),
                                 ("predict_inprocess", "predict"),
                                 ("predict_socket", "predict_socket"),
                                 ("alcc_inprocess", "alcc"),
                                 ("alcc_socket", "alcc_socket"),
                                 ("alcc_mlp", "alcc_mlp"),
                                 ("consistency_train", "consistency_train"))
                    if v in ran}})
            if "train_lm" in ran:
                kernels[-1]["launches_by_path"].update({
                    f"train_lm_{arch}": run["launches"][name]
                    for arch, run in ran["train_lm"]["runs"].items()})
            kernels[-1]["launches_by_path"].update({
                f"{v}_coded_head": ran[v]["coded_head"]["launches"][name]
                for v in ("serve_dense", "serve_hybrid", "serve_moe",
                          "serve_whisper")
                if v in ran})
            # the serving paths' shapes, each timed beside its bound
            for key, prefix in (("predict_cases", "predict_"),
                                ("coded_head_cases", "coded_head_"),
                                ("hymba_cases", "hymba_"),
                                ("ab16_cases", "ab16_"),
                                ("falcon_cases", "falcon_")):
                cases = [{k: x[k] for k in ("case", "shape", "ms", "graph_ms",
                                            "plain_ms", "bound_ms", "bound_by",
                                            "chunk")
                          if k in x}
                         for x in timings if x["kernel"] == name
                         and x["case"].startswith(prefix)]
                if cases:
                    kernels[-1][key] = cases
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
