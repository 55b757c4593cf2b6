#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--phases kernels[,train,...]]

Run from the repository root on a machine with one CUDA card.  It prints
one JSON object per line, in phases, and fails (non-zero exit) if any
phase fails.  ``--phases`` runs the build and the named phases only (for
iterating on a kernel); such a partial run prints no ok line.

  build     builds the four CUDA kernels from ``src/repro_torch/kernels/csrc``
            and, beside them while the kernels phases run, the host-staged
            collective backend of ranks that share the card
            (``src/repro_torch/parallel/csrc/staged_backend.cpp``, with the
            host's C++ compiler; ``build_staged``)
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
            call, per-kernel device ms and ptxas registers and spills; the
            backward in the bf16 a/b mode (``kernels_scan_bwd_ab16``)
            within 1e-4 of its largest gradient of the plain backward of
            that mode at hymba's and falcon-mamba's training shapes (x and
            dt bf16 and float32, chunks of 128), hymba's with chunks of
            100 and 300 and with the plan's chunk forced to 128, chunks of
            1 and 7, S = 1, S not a multiple of the chunk, a chunk of at
            least S, n in {1, 3}, the element that sets each error printed,
            two calls bit-identical, ``SelectiveScanFn`` in the mode, timed
            beside the float32 mode; and
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
  shard     ``cpml_train --backend shard``: N=8, K=2, T=1 at Case 1's m
            and d for 25 rounds, 8 ranks on the one card over the staged
            backend (gloo on the host), one
            coded share a rank: every rank's weights bit-identical to the
            one-process vmap run's, the same accuracy, and on every rank
            exactly 25 ``coded_grad`` launches and the vmap run's
            ``modmatmul`` launches; from the same runs' JSON the median
            round ms (shard's on every rank against vmap's), each rank's
            ``coded_grad`` ms and the all_gather's ms a round (CUDA
            events); round 0's worker step at the path's inputs, each
            rank's share (N=1) and all 8 at once, bit-equal to the plain
            version; then ``coded_head_apply_sharded`` over 6 ranks at tinyllama's
            head width (d 2048, vocab 32000, N=6, K=4, T=1, batch 4, shard 2
            killed): field values bit-equal to the one-process head and to
            (h_q @ w_q) mod p from the plain version, one ``modmatmul`` a
            rank for its product; then ``compat.all_gather`` through a
            one-rank NCCL group.  The backend printed is the launcher's rule
  teacher   3 rounds on the card and again on the CPU (plain versions)
            from the card's weights: shares and decoded parts bit-equal,
            weights within 1e-5; then the round's stages timed on the card
  serve     ``repro_torch.launch.serve`` for falcon-mamba-7b at full width
            and all 64 layers in bf16, batch 4, prompt 2048, 32 generated
            tokens: ``selective_scan`` launched exactly once per layer,
            tokens in range, logits finite; prefill seconds, decode
            tokens/s, peak device memory
  profile   one prefill at the serve shape and 8 decode steps under
            torch.profiler, falcon-mamba cut to 16 of 64 layers: device
            time by kernel group, the scan's share of it, busy share
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
            at their serve shapes, each cut to 4 layers, with attention's
            device ms a prefill and its share
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
  profile_moe  the profile phase for phi3.5-moe (cut to 8 of 32 layers)
            and arctic (2 of 35) at their serve_moe and serve_arctic
            batch and prompt, with the prefill's device ms
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
  train_lm  ``repro_torch.launch.train`` at full width, bf16
            parameters, float32 AdamW state, block remat, batch 4 x 2048
            tokens, 5 steps: hymba-1.5b (cut to 4 of 32 layers; exactly 8
            ``selective_scan`` and 4 ``selective_scan_bwd`` launches a
            step) and tinyllama-1.1b (4 of 22 layers, no kernel launched);
            finite losses, the last below 1.05 x the first; step ms (the
            first apart), tokens/s, peak device memory; one warm step of
            each under torch.profiler (device ms by kernel group, the
            optimizer's, launches, busy share, the scan's share) and
            attention alone at the step's shapes
  train_lm_ab16  hymba-1.5b at full width, cut to 4 layers, trained in
            the scan's bf16 a/b mode (chunks of 128) through
            ``train.train_step_fn``, bf16 parameters, float32 AdamW, block
            remat, batch 4 x 2048, 4 steps: exactly 8 ``selective_scan``
            and 4 ``selective_scan_bwd`` launches a step, finite losses,
            the last below 1.05 x the first; step ms, peak device memory,
            and one more step profiled (the scan backward's device ms a
            step)
  train_sharded  the LM over a mesh of 4 ranks sharing the card
            (``run_ranks`` over ``backend_for``'s route: gloo for host
            tensors, the staged backend for CUDA ones), meshes of DTensors
            placed by the logical-axis rules: on (data 2, model 2)
            hymba-1.5b (25 heads over model 2: the context-parallel branch)
            and tinyllama-1.1b (heads and vocab over model, embed over
            data) at full width cut to 2 blocks, batch 4 x 2048; on
            (data 1, model 4) phi3.5-moe-42b-a6.6b at full width cut to 2
            blocks, batch 4 x 2048 (4 experts a rank, the einsum dispatch
            at capacity factor 1.25); whisper-tiny at full width cut to
            2 encoder and 2 decoder blocks (1500 stub frames from a seed),
            batch 16 x 448, on (2, 2) and (1, 4) (the context-parallel
            branch in its 4 self-attentions);
            bf16 parameters, float32 AdamW, block remat, 3 steps through
            ``train.train_step_fn``: the loss the same on every rank,
            every parameter block the same bits on every rank that holds
            it, the branch counted (2 calls a layer a step where it is
            taken, none elsewhere), the share of dropped (token, choice)
            pairs the same on every rank, and the first forward's
            routing by layer (dropped share, the first group's per-expert
            loads and router-logit spreads) the same on every rank and
            recorded beside that of the same seeded model and batch in one
            process on rank 0, on each rank exactly 2
            ``selective_scan`` launches and 1 ``selective_scan_bwd`` a
            hybrid layer a step, on its own channels, and none for the
            others; step ms, the collectives' share of a profiled step
            and the peak memory by rank; each model in float32 at batch
            2 x 256 (phi3.5-moe at 1 block), sharded gradients within 1e-3
            of each leaf's largest of a one-process run on the card;
            hymba's checkpoint saved by the ranks at (2, 2) and restored
            here with no mesh, bit-equal; ``train.main`` over the 4 ranks
            (mesh data 4) for 3 steps of tinyllama at 2 layers; no rank
            process left alive
  serve_sharded  prefill and decode over a mesh of 4 ranks sharing the
            card (the staged route again): tinyllama-1.1b, hymba-1.5b
            (the context-parallel prefill; one global block, one
            1024-slot ring) and falcon-mamba-7b on (data 2, model 2),
            phi3.5-moe-42b-a6.6b on (1, 4), each at full width cut to 2
            blocks, batch 4 x prompt 2048, and whisper-tiny at its
            published config (batch 16 x 4 tokens, 1500 stub frames) on
            (1, 4); bf16, 16 greedy tokens (falcon-mamba 8) through
            ``serve.greedy_decode`` on a model placed by
            ``model.place_on_mesh``, its prompt and frames placed by
            ``registry.input_specs``: the tokens equal on every rank, every
            cache leaf's block placed as ``input_specs`` says after the
            prefill and every step (the cache's sequence over model),
            exactly one ``selective_scan`` launch a mamba or hybrid layer
            on every rank, none elsewhere; prefill s, decode tokens/s, the
            collectives' share of one profiled decode step by op and the
            peak memory by rank; then in float32 at batch 2, prompt 256
            (whisper 4), 4 teacher-forced steps (phi3.5-moe at 1 block),
            each call's gathered logits within 1e-3 of one process (rank
            0); the scan kernel held to its plain version at falcon-mamba's
            rank blocks in the kernels phase; no rank process left alive
  consistency_train  hymba at full width, 2 layers (one global, one
            windowed), float32, batch 2 x 256: the loss and every gradient
            leaf on the card against the CPU within 1e-3 of each leaf's
            largest |g|; exactly 4 scan and 2 backward launches; then in
            the bf16 a/b mode: every leaf within 2^-7 of its largest |g|
            and within a quarter of the float32 mode's RMS distance, with
            the CPU gradient's own spread under one ulp of float32 noise
  dryrun    the production dry run (``repro_torch.launch.dryrun``), three
            cells on the 16x16 mesh of a fake world of 256 ranks, each in
            its own process, all three at once: tinyllama-1.1b train_4k,
            falcon-mamba-7b prefill_32k (the scan through its op's fake)
            and hymba-1.5b decode_32k, each ``ok`` with its roofline
            terms; meanwhile the cross-check: one train step of hymba-1.5b
            at full width cut to 4 layers, batch 4 x 2048 (train_lm's),
            counted by ``launch/hlo_analysis.py`` on the card and on
            ``abstract_params`` (meta): flops and scan ops equal, the scan
            ops as many as ``kernels.LAUNCHES`` counts on the card, bytes
            within 1%, the op counts beside each other, and MemTracker's
            peak on meta within 0.5-1.5x of ``torch.cuda.max_memory_allocated``
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
import os
import statistics
import subprocess
import sys
import threading
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
# phi3.5-moe's profile at 8 of its 32 layers (its layers are alike), cut
# to leave the time limit room for train_sharded
PROFILE_MOE = dict(SERVE_MOE, layers=8)
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
# The backward in the bf16 a/b mode against its plain version on the card:
# the kernels recompute the mode's forward with the forward kernel's
# operations (expf, the products rounded singly), and the plain version on
# the card with torch's exp and unfused products, the operations it runs
# forward with; the forward's check (AB16_ATOL) finds both rounding a_t,
# b_t, A_c and B_c alike.  What is left is BWD_RTOL's float32 sums in
# another order, and in the split mode chunks the carries G (through P_s,
# the product of the rounded a_t) where the plain version multiplies step
# by step: 1e-4 of each gradient's largest magnitude, as in the float32
# mode.  Where exp and expf straddled a bf16 rounding, one a_t would move
# by 2^-8 of itself, and every later A_c, B_c of its chunk with it: the
# check prints the element that sets each gradient's error to show it.
AB16_BWD_RTOL = BWD_RTOL
# LM training in the bf16 a/b mode (RunConfig(ssm_dtype="bf16"), chunks of
# run_config's scan_chunk, 128): hymba at full width cut to 4 layers, bf16
# parameters, float32 AdamW, block remat, through train.train_step_fn
TRAIN_AB16 = dict(arch="hymba-1.5b", batch=4, seq=2048, steps=4,
                  pattern=(("hybrid_global", 1), ("hybrid", 3)))
# LM training at full width on one card (PERF.md section 4): bf16
# parameters, float32 AdamW state, block remat, 5 steps through
# repro_torch.launch.train; hymba's batch and sequence are the serve
# phases' (its 1024-token window passed).  Depth cut to 4 layers (hymba's
# first 4 blocks, one global; tinyllama's 4 of 22) to leave the time
# limit room for train_sharded
TRAIN_LM = (dict(arch="hymba-1.5b", batch=4, seq=2048, steps=5,
                 pattern=(("hybrid_global", 1), ("hybrid", 3))),
            dict(arch="tinyllama-1.1b", batch=4, seq=2048, steps=5,
                 pattern=(("dense", 4),)))
# hymba at full width cut to 2 layers (one global, one windowed), float32:
# the loss and every gradient leaf on the card (kernels) against the CPU
# (plain versions), each leaf within 1e-3 of its largest |g| (float32 sums
# in another order through 2 layers' forward and backward)
CONSISTENCY_TRAIN = dict(arch="hymba-1.5b", pattern=(("hybrid_global", 1),
                                                     ("hybrid", 1)),
                         batch=2, seq=256)
GRAD_REL = 1e-3
# consistency_train's runs: the float32 scan, then the bf16 a/b mode (its
# gradient on the CPU: the plain backward, ops.PlainAB16ScanFn)
CONSISTENCY_MODES = ("f32", "bf16")
# The bf16 a/b mode card against CPU: the two compute the same function, but
# its forward rounds a_t and b_t to bf16, and where the card's and the CPU's
# float32 inputs to those roundings (x_proj's and in_proj's products, exp)
# differ in their last bits, an a_t or b_t moves one bf16 step (2^-8 of
# itself) and A_c, B_c with it for the rest of the chunk: the gradient is
# as far from itself under float32 noise as card from CPU (the phase
# measures it: the CPU run again from parameters moved by one float32 ulp).
# Each leaf within 2^-7 of its largest |g| (one bf16 step of a_t and of the
# running products, as AB16_MIX_REL), and, to show that the card computes
# the mode's gradient and not the float32 one, each leaf's RMS distance
# card to CPU at most a quarter of its distance from the CPU's float32-mode
# gradient.
AB16_GRAD_REL = 2.0 ** -7
AB16_GRAD_RMS_SHARE = 0.25
# More heads than the first coded_grad kernel took (c*r <= 32).
TRAIN_HEADS = dict(classes=33, iters=2)
# The shard backend (PERF.md section 4): the slack fleet at Case 1's m and d,
# one rank a share on the one card (Case 1's N = 40 over 40 ranks is cut:
# 40 CUDA contexts take ~50 s to start)
SHARD = dict(N=8, K=2, T=1, m=CASE1["m"], d=CASE1["d"], iters=25)
# the sharded coded head at tinyllama-1.1b's head width, shard 2 killed
SHARD_HEAD = dict(d=2048, vocab=32000, N=6, K=4, T=1, batch=4, kill=2)
# the LM over a mesh of 4 ranks sharing the card (mesh data 2 x model 2
# unless a model names its own): each model at full width, bf16
# parameters, float32 AdamW, block remat, 3 steps; hymba and tinyllama cut
# to their first 2 blocks at batch 4 x 2048; phi3.5-moe cut to 2 blocks at
# batch 4 x 2048 on (data 1, model 4), where all its leaves shard over
# model and no expert weight is gathered (PERF.md section 4); whisper-tiny
# at full width cut to 2 of its 4 encoder and 2 of its 4 decoder blocks
# (cut for time; 1500 stub frames from a seed) at batch 16 x 448 decoder
# tokens, its text context, on (2, 2) and on (1, 4), where its 6 heads do
# not divide the model axis (the context-parallel branch in every block's
# self-attention).  Then each
# model's blocks (``check_pattern``'s where given) in float32 at batch
# 2 x 256, the sharded gradients against a one-process run on the card
# (GRAD_REL of each leaf's largest |g|), and the train driver over the 4
# ranks (mesh data 4)
TRAIN_SHARDED = dict(
    world=4, mesh=(2, 2), batch=4, seq=2048, steps=3, check_batch=2,
    check_seq=256,
    models=(dict(arch="hymba-1.5b", pattern=(("hybrid_global", 1),
                                             ("hybrid", 1)), cp=True,
                 checkpoint=True),
            dict(arch="tinyllama-1.1b", pattern=(("dense", 2),), cp=False),
            dict(arch="phi3.5-moe-42b-a6.6b", pattern=(("moe", 2),),
                 check_pattern=(("moe", 1),), mesh=(1, 4), cp=False),
            dict(arch="whisper-tiny", name="whisper-tiny@2x2", batch=16,
                 seq=448, pattern=(("dec", 2),), encoder_layers=2,
                 cp=False),
            dict(arch="whisper-tiny", name="whisper-tiny@1x4", mesh=(1, 4),
                 batch=16, seq=448, pattern=(("dec", 2),), encoder_layers=2,
                 cp=True)),
    driver=dict(arch="tinyllama-1.1b", pattern=(("dense", 2),), batch=4,
                seq=2048, steps=3))
# the scan's (B, S, d_inner, n) on one rank of train_sharded: batch over
# data, hymba's d_inner 3200 over model; at its steps and its float32 check
SHARDED_RANK_SCAN = (TRAIN_SHARDED["batch"] // TRAIN_SHARDED["mesh"][0],
                     TRAIN_SHARDED["seq"], 3200 // TRAIN_SHARDED["mesh"][1],
                     16)
SHARDED_RANK_CHECK_SCAN = (
    TRAIN_SHARDED["check_batch"] // TRAIN_SHARDED["mesh"][0],
    TRAIN_SHARDED["check_seq"], 3200 // TRAIN_SHARDED["mesh"][1], 16)
# prefill and decode over a mesh of 4 ranks sharing the card: each model at
# full width, bf16, cut to 2 blocks (whisper-tiny at its published 4 + 4),
# batch 4 x prompt 2048 (whisper 16 x 4 tokens and 1500 stub frames), 16
# greedy tokens, so a cache of 2064 slots (whisper 20) that splits over a
# model axis of 2 and 4 (the sequence-sharded layout); falcon-mamba, which
# has no k/v cache and whose steps on (2, 2) are its weights' gathers over
# data (PERF.md section 5), decodes 8 (cut for time); then in float32 at
# batch 2, prompt 256 (whisper 4), 4 teacher-forced steps (phi3.5-moe at 1
# block), the gathered logits against one process on rank 0
SERVE_SHARDED = dict(
    world=4, batch=4, prompt=2048, gen=16, check_batch=2, check_prompt=256,
    check_gen=4,
    models=(dict(arch="tinyllama-1.1b", pattern=(("dense", 2),),
                 mesh=(2, 2)),
            dict(arch="hymba-1.5b", pattern=(("hybrid_global", 1),
                                             ("hybrid", 1)), mesh=(2, 2)),
            dict(arch="falcon-mamba-7b", pattern=(("mamba", 2),),
                 mesh=(2, 2), gen=8),
            dict(arch="phi3.5-moe-42b-a6.6b", pattern=(("moe", 2),),
                 check_pattern=(("moe", 1),), mesh=(1, 4)),
            dict(arch="whisper-tiny", mesh=(1, 4), batch=16, prompt=4,
                 check_prompt=4)))
# the scan's (B, S, d_inner, n) on one rank of serve_sharded's falcon-mamba
# (batch over data 2, its d_inner 8192 over model 2), served and checked;
# hymba's blocks there are train_sharded's (SHARDED_RANK_SCAN and
# SHARDED_RANK_CHECK_SCAN)
SERVE_SHARDED_RANK_SCAN = (SERVE_SHARDED["batch"] // 2,
                           SERVE_SHARDED["prompt"], 8192 // 2, 16)
SERVE_SHARDED_RANK_CHECK_SCAN = (SERVE_SHARDED["check_batch"] // 2,
                                 SERVE_SHARDED["check_prompt"], 8192 // 2, 16)
PHASES = ("kernels", "train", "train_c33", "shard", "teacher", "serve", "profile",
          "consistency", "coded_head", "serve_dense", "serve_hybrid",
          "serve_swa", "serve_wide", "consistency_dense", "profile_dense",
          "serve_moe", "serve_arctic", "consistency_moe", "profile_moe",
          "serve_whisper", "consistency_whisper", "train_lm",
          "train_lm_ab16", "train_sharded", "serve_sharded",
          "consistency_train", "dryrun", "cluster",
          "socket", "mpc",
          "mpc_socket", "resilient", "predict", "predict_socket", "alcc",
          "alcc_socket", "alcc_mlp")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, so that a run's log is its own timeline."""
    if "phase" in obj and "t_s" not in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 3)}
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
    smk = -(-SHARD["m"] // SHARD["K"])

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
        # the shard phase's shapes: one rank's share (N = 1) and the
        # one-process vmap run's 8, at the slack fleet's mk
        cg_cases.append(("worker_N1_mk6198", p, rand((1, smk, d), p),
                         rand((1, d, 1, 1), p), coeffs(1, p), None))
        cg_cases.append(("workers_N8_mk6198", p, rand((SHARD["N"], smk, d), p),
                         rand((SHARD["N"], d, 1, 1), p), coeffs(1, p), None))
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
    for n, rows, c, r, case in (
            (N, mk, 1, 1, "case1_c1_r1"), (N, mk, 10, 2, "case1_c10_r2"),
            (1, mk, 1, 1, "worker_N1_c1_r1"),
            (1, smk, 1, 1, "worker_N1_mk6198"),
            (SHARD["N"], smk, 1, 1, "workers_N8_mk6198")):
        x, w = rand((n, rows, d), p), rand((n, d, c, r), p)
        cbar = coeffs(r, p)
        nbytes = 4 * (n * rows * d + n * d * c * r + (r + 1) + n * d * c)
        # n mk d (c r + c) multiply-adds of 32x32 -> 64 bits, two IMADs each
        b_ms, b_by = bound(nbytes, 0, imad=2 * n * rows * d * (c * r + c))
        pl = cg.plan(n, rows, d, c, r, sms=mm.sm_count(x.device))
        timings.append({
            "kernel": "coded_grad", "case": case,
            "shape": [n, rows, d, c, r],
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
    """The selective-scan kernel against its plain version on the card
    (among the cases, one rank's block of train_sharded at its steps' and
    its gradient check's shapes), then timed at the serve shape as the
    serve path calls it (x and dt bf16, h0 = 0), and with dt float32 as
    the first kernel was timed; then
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
        # one rank's block in train_sharded (batch over data 2, inner over
        # model 2), at its training and its float32 check shapes
        ("hymba_rank_train_x_dt_bf16", SHARDED_RANK_SCAN, bf16, 0.0, bf16),
        ("hymba_rank_check_f32", SHARDED_RANK_CHECK_SCAN, f32, 0.0, f32),
        # one rank's block of falcon-mamba in serve_sharded, served (bf16)
        # and in its float32 check
        ("falcon_rank_serve_x_dt_bf16", SERVE_SHARDED_RANK_SCAN, bf16, 0.0,
         bf16),
        ("falcon_rank_check_f32", SERVE_SHARDED_RANK_CHECK_SCAN, f32, 0.0,
         f32),
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


def scan_bwd_bound(B: int, S: int, di: int, n: int, xbytes: int,
                   flops: int = 17) -> tuple[float, str, float, float]:
    """The backward's least time: (bound ms, by, bytes ms, operations ms).
    Bytes: each input read once in its dtype (x, dt in ``xbytes``; Bm, Cm,
    A_log, D, h0, dy, dh_last float32) and each output written once (dx,
    ddt in x's dtype; dbm, dcm, dA_log, dD, dh0 float32).  Operations: one
    exp (a_t) and ``flops`` a (b, t, i, j) at their rates: ~17 for the
    float32 recurrence; the bf16 a/b mode's forward adds b_t's two products,
    A_c's and B_c's three, h_t's two and four roundings: ~28."""
    el = B * S * di * n
    nbytes = (B * S * di * 2 * xbytes + 2 * B * S * n * 4 + (di * n + di) * 4
              + 2 * B * di * n * 4 + B * S * di * 4              # inputs
              + B * S * di * 2 * xbytes + 2 * B * S * n * 4
              + (di * n + di) * 4 + B * di * n * 4)               # outputs
    b_ms, b_by = bound(nbytes, flops * el, el)
    return (b_ms, b_by, nbytes / HBM_BYTES_PER_S * 1e3,
            max(flops * el / SCALAR_OPS_PER_S, el / SPECIAL_OPS_PER_S) * 1e3)


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


def scan_fn_views(torch, gen, ssm_dtype: str = "f32", chunk: int = 0,
                  S: int = 45) -> dict:
    """``SelectiveScanFn`` as the model calls it, in the mode ``ssm_dtype``
    (``chunk``): bfloat16 x and dt, and bm and cm bfloat16 views of one
    projection (``models/mamba.py`` ``_ssm_params``).  Each gradient comes
    back in its input's dtype and slice, within ``BWD_RTOL`` of the plain
    version's (``bwd_err``)."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    B, di, n = 2, 1001, 16
    x, dt, bm, cm, a_log, d, h0, dy, dh = scan_bwd_inputs(
        torch, gen, B, S, di, n, torch.bfloat16, torch.bfloat16)
    proj = torch.cat([bm, cm], -1).bfloat16().requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a_log, d, h0)]
    xb, dtb, alb, db, h0b = leaves
    y, h = ms.SelectiveScanFn.apply(xb, dtb, proj[..., :n], proj[..., n:],
                                    alb, db, h0b, ssm_dtype, chunk)
    ((y * dy).sum() + (h * dh).sum()).backward()
    torch.cuda.synchronize()
    w = ref.selective_scan_bwd_ref(x, dt, proj[..., :n].detach(),
                                   proj[..., n:].detach(), a_log, d, h0, dy,
                                   dh, ssm_dtype, chunk)
    rel = {}
    for name, g, want, dtype in (
            ("dx", xb.grad, w[0], torch.bfloat16),
            ("ddt", dtb.grad, w[1], torch.bfloat16),
            ("dproj", proj.grad, torch.cat(w[2:4], -1), torch.bfloat16),
            ("da_log", alb.grad, w[4], torch.float32),
            ("dd", db.grad, w[5], torch.float32),
            ("dh0", h0b.grad, w[6], torch.float32)):
        if g.dtype != dtype or g.shape != want.shape:
            raise AssertionError(f"SelectiveScanFn {ssm_dtype} {name}: "
                                 f"{g.dtype} {tuple(g.shape)}, expected "
                                 f"{dtype} {tuple(want.shape)}")
        rel[name] = bwd_err(torch, g, want)[1]
    info = {"phase": "kernels", "kernel": "selective_scan_bwd",
            "case": ("SelectiveScanFn_bf16_views" if ssm_dtype == "f32"
                     else "ab16_SelectiveScanFn_bf16_views"),
            "shape": [B, S, di, n], "ssm_dtype": ssm_dtype, "chunk": chunk,
            "max_rel_err": rel, "tolerance_rel": BWD_RTOL}
    emit(info)
    if not all(v <= BWD_RTOL for v in rel.values()):
        raise AssertionError(f"SelectiveScanFn {ssm_dtype} through views: "
                             f"{rel} beyond {BWD_RTOL}")
    return info


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
            k = re.search(match + r"_[a-z0-9_]+?_kernel", entry)
            cur = None
            if k:
                t = entry[k.end():]
                kind = ("bf16" if t.startswith("I13__nv_bf")
                        else "f32" if t.startswith("If") else "")
                if kind and "Lb1E" in t:   # the bf16 a/b mode's instance
                    kind += ",ab16"
                cur = k.group(0) + (f"<{kind}>" if kind else "")
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


def bwd_worst(torch, g, w) -> dict:
    """The element of a gradient g (kernel) that sets its error against w
    (plain version): its index, both values, and max |w|."""
    diff = (g.float() - w).abs()
    k = int(diff.argmax())
    idx = [int(v) for v in torch.unravel_index(torch.tensor(k), w.shape)]
    return {"index": idx, "kernel": float(g.flatten()[k]),
            "plain": float(w.flatten()[k]), "max_abs_plain":
            float(w.abs().max())}


def bwd_check(torch, checks: Checks, gen, case: str, shape, x_dtype,
              dt_dtype, plan_chunk, mode=("f32", 0), tol: float = BWD_RTOL,
              twice: bool = False) -> None:
    """One case of the backward kernels (``run_bwd`` with the plan's chunk
    forced to ``plan_chunk``, None: the plan's own) in ``mode``
    (``ssm_dtype``, chunk) against the plain backward on the same inputs:
    each gradient in its dtype and within ``tol`` of its largest magnitude
    (``bwd_err``), the element that sets each error printed; ``twice``: a
    second call on the same inputs gives the same bits."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    bf16, f32 = torch.bfloat16, torch.float32
    names = ("dx", "ddt", "dbm", "dcm", "da_log", "dd", "dh0")
    args = scan_bwd_inputs(torch, gen, *shape, x_dtype, dt_dtype)
    got = ms.run_bwd(plan_chunk, *args, *mode)
    torch.cuda.synchronize()
    want = ref.selective_scan_bwd_ref(*args, *mode)
    # dx and ddt in the dtype the kernel reads x and dt in
    xd = bf16 if x_dtype == dt_dtype == bf16 else f32
    abs_err, rel, worst = {}, {}, {}
    for name, g, w in zip(names, got, want):
        dtype = xd if name in ("dx", "ddt") else f32
        if g.shape != w.shape or g.dtype != dtype:
            raise AssertionError(f"selective_scan_bwd {case} {name}: "
                                 f"{g.shape} {g.dtype} vs {w.shape} {dtype}")
        abs_err[name], rel[name] = bwd_err(torch, g, w)
        worst[name] = bwd_worst(torch, g, w)
    checks.max_err["selective_scan_bwd"] = max(
        checks.max_err["selective_scan_bwd"], *abs_err.values())
    ab = min(mode[1], shape[1]) if mode[0] == "bf16" else 0
    pl = ms.plan_bwd(*shape[:3], xd.itemsize, chunk=plan_chunk, ab_chunk=ab)
    emit({"phase": "kernels", "kernel": "selective_scan_bwd", "case": case,
          "shape": list(shape), "x_dtype": str(x_dtype),
          "dt_dtype": str(dt_dtype), "ssm_dtype": mode[0],
          "mode_chunk": mode[1], "chunk": pl.chunk,
          "per_mode_chunk": pl.per_ab, "grid": list(pl.grid),
          "max_abs_err": abs_err, "max_rel_err": rel, "worst_element": worst,
          "tolerance_rel": tol})
    bad = {k: v for k, v in rel.items() if not v <= tol}
    if bad:
        raise AssertionError(f"selective_scan_bwd {case}: kernel != plain "
                             f"version beyond {tol} relative: {bad}")
    if twice:
        again = ms.selective_scan_bwd(*args, *mode)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        emit({"phase": "kernels", "kernel": "selective_scan_bwd",
              "case": case, "bit_identical_second_call": same})
        if not same:
            raise AssertionError(f"selective_scan_bwd {case}: two calls on "
                                 f"the same inputs differ")
    del args, got, want
    torch.cuda.empty_cache()


def bwd_timing(torch, gen, case: str, di: int, ptxas: dict,
               mode=("f32", 0)) -> dict:
    """The backward at a training shape (B 4, S 2048, ``di``, n 16; x and
    dt bf16) in ``mode``: CUDA events and a CUDA graph, beside its bound
    and the plain version, the device launches a call and ``ptxas``; at
    hymba's width the plan's chunk against half and twice it; in the bf16
    a/b mode also the float32 mode's graph time in the same call."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    B, S, n = 4, 2048, 16
    ab16 = mode[0] == "bf16"
    args = scan_bwd_inputs(torch, gen, B, S, di, n, torch.bfloat16,
                           torch.bfloat16)
    b_ms, b_by, bytes_ms, ops_ms = scan_bwd_bound(B, S, di, n, 2,
                                                  28 if ab16 else 17)
    pl = ms.plan_bwd(B, S, di, 2, ab_chunk=mode[1] if ab16 else 0)
    t = {"kernel": "selective_scan_bwd", "case": case, "shape": [B, S, di, n],
         "dt_dtype": str(torch.bfloat16), "chunk": pl.chunk,
         "grid": list(pl.grid),
         "ms": time_ms(torch, lambda: ms.selective_scan_bwd(*args, *mode), 5),
         "graph_ms": graph_ms(
             torch, lambda: ms.selective_scan_bwd(*args, *mode), 3),
         "plain_ms": time_ms(
             torch, lambda: ref.selective_scan_bwd_ref(*args, *mode), 1,
             trials=1),
         "bound_ms": b_ms, "bound_by": b_by, "bytes_ms": bytes_ms,
         "operations_ms": ops_ms,
         "device_launches": device_launches(
             torch, lambda: ms.selective_scan_bwd(*args, *mode)),
         "ptxas": ptxas}
    if ab16:
        t.update(ssm_dtype="bf16", mode_chunk=mode[1],
                 per_mode_chunk=pl.per_ab, f32_mode_graph_ms=graph_ms(
                     torch, lambda: ms.selective_scan_bwd(*args), 3))
    if di == 3200:  # the plan's chunk and its neighbours
        t["graph_ms_by_chunk"] = {
            L: graph_ms(torch, lambda: ms.run_bwd(L, *args, *mode), 3)
            for L in (pl.chunk // 2, pl.chunk, 2 * pl.chunk)}
    emit({"phase": "kernels", "timing": t})
    del args
    torch.cuda.empty_cache()
    return t


def phase_kernels_scan_bwd(torch, checks: Checks) -> list[dict]:
    """The scan's backward kernels against their plain version
    (``ref.selective_scan_bwd_ref``) on the card, each gradient within
    ``BWD_RTOL`` of its largest magnitude (``bwd_check``): hymba's and
    falcon-mamba's training shapes with x and dt bf16 and float32, S = 1,
    33 and 8192, n in {1, 3, 16} with di not a multiple of the block's 32
    channels, one chunk and one chunk and a step (S = L and L + 1 at
    hymba's width, L the plan's chunk at hymba's training shape, forced),
    one rank's block of train_sharded at its steps' and its gradient
    check's shapes (``SHARDED_RANK_SCAN``, ``SHARDED_RANK_CHECK_SCAN``) with
    the plan's own chunk there, h0 and dh_last non-zero throughout, and
    through ``SelectiveScanFn``
    (``scan_fn_views``); two calls on the same inputs give the same bits.
    Then timed at the two training shapes (``bwd_timing``)."""
    from repro_torch.kernels import mamba_scan as ms

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(9)
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
        # one rank's block in train_sharded, with the plan's own chunk there
        ("hymba_rank_train_bf16", SHARDED_RANK_SCAN, bf16, bf16, None),
        ("hymba_rank_check_f32", SHARDED_RANK_CHECK_SCAN, f32, f32, None),
    ]
    for case, shape, x_dtype, dt_dtype, chunk in cases:
        bwd_check(torch, checks, gen, case, shape, x_dtype, dt_dtype, chunk,
                  twice=case == "hymba_train_bf16")
    scan_fn_views(torch, gen)
    ptxas = ptxas_report("mamba_scan_bwd", "scan_bwd")
    return [bwd_timing(torch, gen, case, di, ptxas)
            for case, di in (("hymba_train_bf16", 3200),
                             ("falcon_train_bf16", 8192))]


def phase_kernels_scan_bwd_ab16(torch, checks: Checks) -> list[dict]:
    """The backward kernels in the bf16 a/b mode (``ssm_dtype="bf16"``)
    against the plain backward of that mode on the card, each gradient
    within ``AB16_BWD_RTOL`` of its largest magnitude (``bwd_check``, the
    element that sets each error printed): hymba's and falcon-mamba's
    training shapes with x and dt bf16 and float32 at chunks of 128,
    hymba's width at S = 1024 with chunks of 100 (split into plan chunks
    of 64 and 36) and 300 (more than the plan's 256 steps), and with the
    plan's chunk forced to the mode's 128 (one plan chunk a mode chunk);
    chunks of 1 and 7,
    S = 1, S not a multiple of the chunk, a chunk of at least S, n in
    {1, 3} with di not a multiple of the block's channels, mixed x/dt
    dtypes; h0 and dh_last non-zero throughout; two calls on the same
    inputs give the same bits; ``SelectiveScanFn`` in the mode
    (``scan_fn_views``).  Then timed at the two training shapes beside the
    float32 mode (``bwd_timing``), with the mode's registers and spills."""
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    hymba, falcon = (4, 2048, 3200, 16), (4, 2048, 8192, 16)
    # the chunking variants at hymba's width and half its sequence (the
    # same plan chunks and splits, half the plain version's serial steps;
    # cut for the time limit)
    hymba_half = (4, 1024, 3200, 16)
    # (case, shape, x dtype, dt dtype, mode chunk, forced plan chunk)
    cases = [
        ("ab16_hymba_train_bf16", hymba, bf16, bf16, AB16_CHUNK, None),
        ("ab16_hymba_train_f32", hymba, f32, f32, AB16_CHUNK, None),
        ("ab16_falcon_train_bf16", falcon, bf16, bf16, AB16_CHUNK, None),
        ("ab16_falcon_train_f32", falcon, f32, f32, AB16_CHUNK, None),
        ("ab16_hymba_chunk100", hymba_half, bf16, bf16, 100, None),
        ("ab16_hymba_chunk300", hymba_half, bf16, bf16, 300, None),
        ("ab16_hymba_plan128", hymba_half, bf16, bf16, AB16_CHUNK,
         AB16_CHUNK),
        ("ab16_chunk1", (2, 512, 3200, 16), bf16, bf16, 1, None),
        ("ab16_S1", (4, 1, 8192, 16), bf16, bf16, AB16_CHUNK, None),
        ("ab16_chunk_ge_S", (2, 300, 3200, 16), f32, f32, 4096, None),
        ("ab16_S1000_di1001_n3", (2, 1000, 1001, 3), f32, bf16, AB16_CHUNK,
         None),
        ("ab16_S45_chunk7_di1000_n1", (2, 45, 1000, 1), bf16, bf16, 7, None),
    ]
    for case, shape, x_dtype, dt_dtype, chunk, plan_chunk in cases:
        bwd_check(torch, checks, gen, case, shape, x_dtype, dt_dtype,
                  plan_chunk, ("bf16", chunk), AB16_BWD_RTOL,
                  twice=case == "ab16_hymba_train_bf16")
    scan_fn_views(torch, gen, "bf16", AB16_CHUNK, S=300)
    ptxas = {k: v for k, v in ptxas_report("mamba_scan_bwd", "scan_bwd")
             .items() if "ab16" in k}
    return [bwd_timing(torch, gen, case, di, ptxas, ("bf16", AB16_CHUNK))
            for case, di in (("ab16_hymba_train_bf16", 3200),
                             ("ab16_falcon_train_bf16", 8192))]


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


def shard_share_check(torch) -> dict:
    """Round 0's worker step of SHARD on the card at the path's own
    inputs (the CLI's data, draws and zero weights): each rank's share
    through ``ops.coded_grad`` with a worker axis of 1, as the shard body
    calls it, and all N shares in one call, as the vmap run does, each bit
    for bit against ``ref.coded_grad_workers_ref``.  Not counted in the
    main path's launches."""
    from repro_torch.core import protocol
    from repro_torch.core.protocol import engine
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    cfg = protocol.CPMLConfig(N=SHARD["N"], K=SHARD["K"], T=SHARD["T"])
    x, y = synthetic.mnist_like(1, m=SHARD["m"], d=SHARD["d"], margin=12.0)
    draws = protocol.TorchDraws(TRAIN_SEED, dev)
    state = engine.setup(cfg, torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev), draws=draws)
    ws = engine.encode_round_shares(cfg, draws, 0, state.w[:, None])
    xs, cbar = state.x_shares, torch.as_tensor(engine.poly_coeffs(cfg),
                                              device=dev)
    ranks = [torch.equal(ops.coded_grad(xs[i:i + 1], ws[i:i + 1], cbar, cfg.p),
                         ref.coded_grad_workers_ref(xs[i:i + 1], ws[i:i + 1],
                                                    cbar, cfg.p))
             for i in range(cfg.N)]
    every = torch.equal(ops.coded_grad(xs, ws, cbar, cfg.p),
                        ref.coded_grad_workers_ref(xs, ws, cbar, cfg.p))
    return {"shape": list(xs[:1].shape) + list(ws.shape[2:]),
            "ranks_bit_equal": ranks, "all_shares_bit_equal": every}


def shard_head_rank(rank: int, world: int) -> dict:
    """One rank of the sharded coded head at SHARD_HEAD: the head's weights
    and h from a seed, encoded on this rank's card, then
    ``coded_head_apply_sharded`` with shard ``kill`` killed against the
    one-process ``coded_head_apply`` and the plain direct product."""
    import numpy as np
    import torch

    from repro_torch.core import coded_linear as cl
    from repro_torch.core import lagrange, quantize
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh

    s = SHARD_HEAD
    dev = torch.device("cuda")
    cfg = cl.CodedLinearConfig(N=s["N"], K=s["K"], T=s["T"])
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    w = (torch.randn((s["d"], s["vocab"]), generator=gen) * 0.02).to(dev)
    h = torch.randn((s["batch"], s["d"]), generator=gen).to(dev)
    masks = lagrange.draw_masks(gen, cfg.T, (s["d"], s["vocab"] // cfg.K),
                                cfg.p).to(dev)
    shares = cl.encode_weights(cfg, w, masks=masks)
    surv = tuple(i for i in range(cfg.N) if i != s["kill"])
    m = mesh.compat_make_mesh((world,), ("shards",))
    torch.cuda.synchronize()
    ops.reset_launches()
    results, used = cl.gathered_results(cfg, m, "shards", h, shares, surv)
    torch.cuda.synchronize()
    product = dict(ops.LAUNCHES)
    field = cl.decode_field(cfg, results, used)
    logits = cl.coded_head_apply_sharded(cfg, m, "shards", h, shares, surv)
    one_results, one_used = cl.shard_results(cfg, h, shares, np.array(surv))
    one_field = cl.decode_field(cfg, one_results, one_used)
    one_logits = cl.decode_output(cfg, one_results, one_used)
    direct = ref.modmatmul_ref(quantize.quantize_data(h, cfg.lh, cfg.p),
                               quantize.quantize_data(w, cfg.lw, cfg.p), cfg.p)
    torch.cuda.synchronize()
    return {"rank": rank, "product_launches": product,
            "field_equal_one_process": bool(torch.equal(field, one_field)),
            "field_equal_direct": bool(torch.equal(field, direct)),
            "logits_equal_one_process": bool(torch.equal(logits, one_logits)),
            "used": [int(i) for i in used], "logits_shape": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all())}


def nccl_rank(rank: int, world: int) -> dict:
    """``compat.all_gather`` of a CUDA tensor through an NCCL group."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh
    from repro_torch.parallel import compat

    m = mesh.compat_make_mesh((world,), ("workers",))
    x = torch.arange(6, device="cuda", dtype=torch.int32).reshape(1, 6) + rank
    g = compat.all_gather(x, "workers", 0, tiled=True, mesh=m)
    return {"backend": dist.get_backend(), "device": str(g.device),
            "equal": bool(torch.equal(g, torch.cat([x + r - rank
                                                    for r in range(world)])))}


def phase_shard(torch, out_dir: Path) -> dict:
    """The shard backend through ``cpml_train --backend shard`` against the
    one-process vmap run, with the runs' own per-round timings; the
    worker step at the path's shapes against its plain version; the
    sharded coded head and a one-rank NCCL group (see the module
    docstring)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cpml_train, mesh

    s = SHARD
    argv = ["-N", str(s["N"]), "-K", str(s["K"]), "-T", str(s["T"]),
            "--m", str(s["m"]), "--d", str(s["d"]), "--iters", str(s["iters"]),
            "--seed", str(TRAIN_SEED), "--device", "cuda"]
    res, launches = {}, {}
    for backend in ("vmap", "shard"):
        out = out_dir / f"cpml_train_{backend}.json"
        ops.reset_launches()
        rc = cpml_train.main([*argv, "--backend", backend, "--json-out",
                              str(out)])
        torch.cuda.synchronize()
        launches[backend] = dict(ops.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cpml_train --backend {backend} exited {rc}")
        res[backend] = json.loads(out.read_text())
    vmap, shard = res["vmap"], res["shard"]
    want = mesh.backend_for(s["N"], "cuda")


    def after_first(ms: list) -> float:
        return statistics.median(ms[1:])

    per_rank = [r["launches"] for r in shard["ranks"]]
    failures = []
    if launches["vmap"]["coded_grad"] != s["iters"]:
        failures.append(f"vmap launches {launches['vmap']}")
    if shard["rank_backend"] != want:
        failures.append(f"backend {shard['rank_backend']}, rule says {want}")
    for r in shard["ranks"]:
        if r["w_sha256"] != vmap["w_sha256"]:
            failures.append(f"rank {r['rank']}: weights differ from vmap's")
        if not r["device"].startswith("cuda"):
            failures.append(f"rank {r['rank']} on {r['device']}")
        if (r["launches"]["coded_grad"] != s["iters"]
                or r["launches"]["modmatmul"]
                != launches["vmap"]["modmatmul"]):
            failures.append(f"rank {r['rank']} launches {r['launches']}")
    if shard["acc_coded"] != vmap["acc_coded"]:
        failures.append(f"accuracy {shard['acc_coded']} against vmap's "
                        f"{vmap['acc_coded']}")
    share = shard_share_check(torch)
    if not (all(share["ranks_bit_equal"]) and share["all_shares_bit_equal"]):
        failures.append(f"coded_grad against its plain version: {share}")
    head = mesh.run_ranks(shard_head_rank, SHARD_HEAD["N"], device="cuda",
                          timeout=300)
    for r in head.results:
        if not (r["field_equal_one_process"] and r["field_equal_direct"]
                and r["logits_equal_one_process"] and r["finite"]
                and r["product_launches"]["modmatmul"] == 1):
            failures.append(f"sharded head rank {r['rank']}: {r}")
    nccl = mesh.run_ranks(nccl_rank, 1, device="cuda", timeout=120)
    if nccl.backend != "nccl" or not nccl.results[0]["equal"]:
        failures.append(f"one-rank NCCL group: {nccl.backend} "
                        f"{nccl.results[0]}")
    # every rank the launcher started has ended
    left = [p.pid for p in torch.multiprocessing.active_children()]
    if left:
        failures.append(f"rank processes still alive: {left}")
    info = {"phase": "shard", "device": nvidia_smi(), "argv": argv,
            "backend": shard["rank_backend"], "backend_rule": want,
            "startup_s": shard["startup_s"],
            "seconds": {"vmap": vmap["seconds"], "shard": shard["seconds"]},
            "acc_coded": shard["acc_coded"],
            "acc_cleartext": shard["acc_cleartext"],
            "launches_vmap": launches["vmap"],
            "launches_parent_during_shard": launches["shard"],
            "launches": per_rank[0], "launches_per_rank": per_rank,
            "coded_grad_check": share,
            # medians of rounds 2.. of the runs above (round 1 warms up)
            "round_ms": {"vmap": after_first(vmap["round_ms"]),
                         "shard_by_rank": [after_first(r["round_ms"])
                                           for r in shard["ranks"]]},
            "coded_grad_ms": {"vmap_all_8": after_first(vmap["coded_grad_ms"]),
                              "shard_by_rank": [after_first(r["coded_grad_ms"])
                                                for r in shard["ranks"]]},
            "all_gather_ms_by_rank": [after_first(r["all_gather_ms"])
                                      for r in shard["ranks"]],
            "head": {"spec": SHARD_HEAD, "backend": head.backend,
                     "startup_s": head.startup_s,
                     "used": head.results[0]["used"],
                     "product_launches": head.results[0]["product_launches"],
                     "logits_shape": head.results[0]["logits_shape"]},
            "nccl": {"backend": nccl.backend, "startup_s": nccl.startup_s,
                     **nccl.results[0]},
            "children_left": left, "host_load_avg": os.getloadavg()}
    emit(info)
    if failures:
        raise AssertionError("shard: " + "; ".join(failures))
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

    (kind, _), = registry.get_config(spec["arch"]).block_pattern
    return _cut(spec["arch"], ((kind, spec["layers"]),))


def _cut(arch: str, pattern: tuple):
    """``arch`` at full width with ``pattern`` as its blocks."""
    from repro_torch.configs import registry

    full = registry.get_config(arch)
    return full, dataclasses.replace(
        full, num_layers=sum(c for _, c in pattern), block_pattern=pattern)


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


# the profile phases' depth (every layer of a model is alike, so a profile
# of the first PROFILE_LAYERS reads the same per layer; cut to leave the
# time limit room for train_sharded): falcon-mamba's 8 of 64, the dense
# and hybrid models' 4, phi3.5-moe's 8 of 32 (PROFILE_MOE)
PROFILE_LAYERS = {"falcon-mamba-7b": 8, "tinyllama-1.1b": 4,
                  "hymba-1.5b": 4, "h2o-danube-3-4b": 4}


def _profile_cut(arch: str):
    """``arch`` at full width, its first PROFILE_LAYERS blocks."""
    from repro_torch.configs import registry

    full = registry.get_config(arch)
    left, pattern = PROFILE_LAYERS[arch], []
    for kind, count in full.block_pattern:
        if left:
            pattern.append((kind, min(count, left)))
            left -= pattern[-1][1]
    return _cut(arch, tuple(pattern))[1]


def phase_profile(torch) -> dict:
    """Where the serve path's time goes: falcon-mamba's prefill at the serve
    shape and 8 decode steps under ``torch.profiler``, at PROFILE_LAYERS'
    depth."""
    cfg = _profile_cut(SERVE["arch"])
    info = {"phase": "profile",
            **serve_profile(torch, SERVE["arch"], SERVE["batch"],
                            SERVE["prompt_len"], cfg=cfg)}
    del info["arch"]
    emit(info)
    return info


def phase_profile_dense(torch) -> dict:
    """The same for tinyllama, hymba and h2o-danube at their serve shapes
    and PROFILE_LAYERS' depth, with attention's share of the prefill's
    device time."""
    info: dict = {"phase": "profile_dense"}
    for spec in (SERVE_DENSE, SERVE_HYBRID, SERVE_SWA):
        info[spec["arch"]] = serve_profile(
            torch, spec["arch"], spec["batch"], spec["prompt_len"],
            cfg=_profile_cut(spec["arch"]))
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
    batch and prompt (8 layers, PROFILE_MOE, and 2) and 8 decode steps
    under ``torch.profiler``,
    with the prefill's device ms by group: attention, the expert products,
    dispatch and combine, the rest."""
    info: dict = {"phase": "profile_moe"}
    for spec in (PROFILE_MOE, SERVE_ARCTIC):
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
    """``repro_torch.launch.train`` at full width on the card for each of
    ``TRAIN_LM`` (hymba-1.5b, then tinyllama-1.1b, each cut to 4 layers
    and run through ``config_override``): exit 0, launch
    counts reset just before each run and read just after (per step and
    mamba-bearing layer, ``selective_scan`` twice, the first forward and
    remat's recompute, and ``selective_scan_bwd`` once; nothing else),
    finite losses, the last below 1.05 x the first; step ms (the first step
    apart), tokens/s, peak device memory; then ``train_profile``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    info: dict = {"phase": "train_lm", "runs": {}}
    for spec in TRAIN_LM:
        arch, steps = spec["arch"], spec["steps"]
        full, cfg = _cut(arch, spec["pattern"])
        out = out_dir / f"train_lm_{arch}.json"
        argv = ["--arch", arch, "--batch", str(spec["batch"]), "--seq",
                str(spec["seq"]), "--steps", str(steps), "--log-every", "1",
                "--device", "cuda", "--checkpoint-dir",
                str(out_dir / "train_lm_ckpt"), "--json-out", str(out)]
        ops.reset_launches()
        rc = train.main(argv, config_override=cfg)
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
               "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
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


def phase_train_lm_ab16(torch) -> dict:
    """hymba-1.5b at full width, cut to 4 layers, trained in the scan's
    bf16 a/b mode (``TRAIN_AB16``) through ``train.train_step_fn``, the
    entry point
    the train driver runs, with ``dataclasses.replace(train.run_config(seq,
    batch), ssm_dtype="bf16")``: bf16 parameters (seed 0), the driver's
    AdamW and block remat, the reference loader's batches.  Launch counts
    reset just before the steps and read just after (``selective_scan``
    2 a hybrid layer a step, ``selective_scan_bwd`` 1, nothing else);
    finite losses, the last below 1.05 x the first; step ms (the first
    apart; the host clock around a step and its loss's read) and peak
    device memory; then one more step under torch.profiler: the scan
    backward's device ms a step (``selective_scan_bwd`` group)."""
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt

    spec = TRAIN_AB16
    arch, B, S, steps = spec["arch"], spec["batch"], spec["seq"], spec["steps"]
    _, cfg = _cut(arch, spec["pattern"])
    rc = dataclasses.replace(train.run_config(S, B), ssm_dtype="bf16")
    ocfg = opt.OptimizerConfig(warmup_steps=max(2, steps // 10),
                               total_steps=max(steps, 10))
    torch.cuda.reset_peak_memory_stats()
    model = M.Model(cfg, dtype=getattr(torch, rc.param_dtype), device="cuda",
                    seed=0)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"opt": opt.init_state(ocfg, params)}
    step = train.train_step_fn(cfg, rc, ocfg, model)
    losses, step_ms = [], []
    with LMBatchLoader("cuda", B, S, cfg.vocab_size) as loader:
        batches = [next(loader) for _ in range(steps + 1)]
    ops.reset_launches()
    for batch in batches[:steps]:
        t0 = time.perf_counter()
        _, state["opt"], metrics = step(params, state["opt"], batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def one():
        _, state["opt"], _ = step(params, state["opt"], batches[steps])

    w = profile_window(torch, one)
    groups = w["device_ms_by_group"]
    ssm = _ssm_layers(cfg)
    info = {"phase": "train_lm_ab16", "arch": arch, "batch": B, "seq": S,
            "ssm_dtype": rc.ssm_dtype, "scan_chunk": rc.scan_chunk,
            "remat": rc.remat, "layers": cfg.num_layers, "steps": steps,
            "launches": launches, "losses": losses,
            "first_step_ms": step_ms[0],
            "step_ms_median": statistics.median(step_ms[1:]),
            "step_ms": step_ms, "tokens_per_s":
                B * S * (steps - 1) / sum(step_ms[1:]) * 1e3,
            "peak_gb": peak_gb,
            "profiled_step": {
                "device_ms": w["device_ms"], "host_ms": w["host_ms"],
                "device_busy_share": w["device_busy_share"],
                "scan_bwd_device_ms": groups.get("selective_scan_bwd", 0.0),
                "scan_device_ms": groups.get("selective_scan", 0.0),
                "launches_per_step": w["kernel_launches"]}}
    emit(info)
    del model, params, state, step, batches
    want = {"modmatmul": 0, "coded_grad": 0,
            "selective_scan": 2 * ssm * steps,
            "selective_scan_bwd": ssm * steps}
    if launches != want:
        raise AssertionError(f"train_lm_ab16: kernel launches {launches}, "
                             f"expected {want}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] * 1.05):
        raise AssertionError(f"train_lm_ab16: losses {losses}")
    return info


def _tensor_sha(torch, t) -> str:
    """sha256 of a tensor's bytes (bf16 as its bits), on the host."""
    import hashlib

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def _collective_share(torch, fn) -> dict:
    """``fn()`` once under torch.profiler (host activity): the host ms of
    the step and the ms inside the process group's collectives (the
    ``c10d::`` ops, each a host-staged collective on this route: its
    copies, gloo's ring and the wait for the other ranks)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    coll, calls, by_op = 0.0, 0, {}
    for e in prof.key_averages():
        if e.key.startswith("c10d::"):
            coll += e.cpu_time_total / 1e3
            calls += e.count
            by_op[e.key] = [e.count, e.cpu_time_total / 1e3]
    return {"step_ms": wall, "collective_ms": coll, "collective_calls": calls,
            "collective_share": coll / wall, "by_op_calls_ms": by_op}


def _sharded_model(m: dict):
    """A train_sharded model's full config, its cut config (its encoder
    too, where ``encoder_layers`` says) and its name (its mesh's, where
    two runs share an arch)."""
    from repro_torch.configs import registry

    if "pattern" in m:
        full, cfg = _cut(m["arch"], m["pattern"])
    else:
        full = cfg = registry.get_config(m["arch"])
    if "encoder_layers" in m:
        cfg = dataclasses.replace(cfg, num_encoder_layers=m["encoder_layers"])
    return full, cfg, m.get("name", m["arch"])


def _frames(torch, cfg, B: int, seed: int):
    """B stub frame sequences (B, encoder_seq_len, d) from a seed, on the
    card, float32 (``encode`` casts them to the parameters' dtype)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                       device="cuda")


def _placed(torch, batch: dict, mesh) -> dict:
    """The batch's plain tensors placed as ("batch", "seq", None), the
    reference's input specs (the loader's already are)."""
    from repro_torch.parallel import rules

    return {k: v if rules.is_dtensor(v) else rules.distribute(
        v, mesh, rules.act_placements(mesh, v.shape,
                                      ("batch", "seq", None)[:v.ndim]))
            for k, v in batch.items()}


class _DropCount:
    """Counts the (token, choice) pairs the einsum dispatch routes and
    keeps on this rank (``moe.einsum_routing`` wrapped), on the card.  The
    first ``first`` calls after a reset (one forward's layers) are also
    kept one by one: their dropped share, C, and the first group's
    per-expert loads (pairs routed to each expert, before the capacity)
    and router-logit spreads (the std over experts of each expert's mean
    logit over the group's tokens, against the mean over experts of each
    expert's std over the tokens)."""

    def __init__(self, torch, moe):
        self.torch, self.moe, self.real = torch, moe, moe.einsum_routing
        self.pairs = 0
        self.kept = torch.zeros((), dtype=torch.int64, device="cuda")
        self.first, self.calls = 0, []

    def __call__(self, cfg, logits, C):
        out = self.real(cfg, logits, C)
        _, onehot, _, keep = out
        kept = (keep & (onehot > 0)).any(-1).sum()
        self.pairs += onehot[..., 0].numel()
        self.kept += kept
        if len(self.calls) < self.first:
            lg = logits[0].detach().float()                   # (g, E)
            self.calls.append({
                "pairs": onehot[..., 0].numel(), "kept": kept.clone(),
                "C": C, "load": onehot[0].sum((0, 1)).clone(),
                "between": lg.mean(0).std(), "within": lg.std(0).mean()})
        return out

    def reset(self, first: int = 0):
        self.pairs = 0
        self.kept.zero_()
        self.first, self.calls = first, []

    def share_dropped(self):
        return 1.0 - int(self.kept) / self.pairs if self.pairs else None

    def first_calls(self) -> list[dict]:
        return [{"dropped_share": 1.0 - int(c["kept"]) / c["pairs"],
                 "C": c["C"], "group0_load": c["load"].long().tolist(),
                 "group0_logit_spread_between_experts": float(c["between"]),
                 "group0_logit_spread_within_expert": float(c["within"])}
                for c in self.calls]


def _block_sha(torch, params: dict, mesh) -> dict:
    """Each leaf's local block hash on this rank, with the coordinates of
    the block (this rank's on each mesh dim the leaf shards over): ranks
    of equal coordinates hold the same block, and must hold it bit for
    bit."""
    return {k: [[mesh.get_local_rank(i) if pl.is_shard() else None
                 for i, pl in enumerate(p.placements)],
                _tensor_sha(torch, p.to_local())]
            for k, p in params.items()}


def sharded_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of the train_sharded phase (see ``phase_train_sharded``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import layers, moe
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    from repro_torch.parallel import rules

    spec = TRAIN_SHARDED
    meshes: dict = {}
    cp_calls = [0]
    real_cp = layers.context_parallel_attention

    def counted_cp(*a, **kw):
        cp_calls[0] += 1
        return real_cp(*a, **kw)

    layers.context_parallel_attention = counted_cp
    drops = _DropCount(torch, moe)
    moe.einsum_routing = drops
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": str(torch.cuda.current_device()), "models": {}}
    steps = spec["steps"]
    for m in spec["models"]:
        t_part = time.perf_counter()
        shape = tuple(m.get("mesh", spec["mesh"]))
        if shape not in meshes:
            meshes[shape] = mesh_lib.compat_make_mesh(shape,
                                                      ("data", "model"))
        mesh = meshes[shape]
        out["mesh_device_type"] = mesh.device_type
        B, S = m.get("batch", spec["batch"]), m.get("seq", spec["seq"])
        _, cfg, name = _sharded_model(m)
        rc = train.run_config(S, B)
        ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10)
        torch.cuda.reset_peak_memory_stats()
        model = M.Model(cfg, dtype=getattr(torch, rc.param_dtype),
                        device="cuda", seed=0)
        model.requires_grad_(True)
        params, state, _ = train.build_sharded_state(cfg, rc, ocfg, mesh,
                                                     model)
        step = train.train_step_fn(cfg, rc, ocfg, model)
        with LMBatchLoader("cuda", B, S, cfg.vocab_size, mesh=mesh) as ld:
            batches = [next(ld) for _ in range(steps)]
        if cfg.is_encoder_decoder:
            for i, b in enumerate(batches):
                b["enc_embeds"] = _frames(torch, cfg, B, 20 + i)
        batches = [_placed(torch, b, mesh) for b in batches]
        box = {"opt": state}
        part_s = {"state": time.perf_counter() - t_part}
        t_part = time.perf_counter()

        def run(batch):
            with rules.use_rules_mesh(mesh):
                _, box["opt"], metrics = step(params, box["opt"], batch)
            return float(metrics["loss"])

        losses, step_ms, prof = [], [], {}
        ops.reset_launches()
        cp_calls[0] = 0
        drops.reset(first=cfg.num_layers)
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            if i < steps - 1:
                losses.append(run(batch))
            else:           # the last step under the profiler
                prof = _collective_share(
                    torch, lambda: losses.append(run(batch)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        part_s["steps"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        launches, cps = dict(ops.LAUNCHES), cp_calls[0]
        info = {"mesh": list(shape), "batch": B, "seq": S,
                "losses": losses, "step_ms": step_ms, "launches": launches,
                "cp_calls": cps, "profiled_step": prof,
                "dropped_share": drops.share_dropped(),
                "first_forward": drops.first_calls(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "local_batch": list(batches[0]["tokens"].to_local().shape),
                "placements": {k: [repr(x) for x in p.placements]
                               for k, p in list(params.items())[:6]},
                "block_sha": _block_sha(torch, params, mesh)}
        if m.get("checkpoint"):
            info["param_sha"] = {k: _tensor_sha(torch, p.full_tensor())
                                 for k, p in params.items()}
            ckpt = CheckpointManager(job["ckpt_dir"])
            ckpt.save(steps, {"params": params})
            info["checkpoint_step"] = steps
        tokens0 = (batches[0]["tokens"].full_tensor() if cfg.num_experts
                   else None)
        del model, params, box, state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
        if tokens0 is not None and rank == 0:
            # the same seeded model and first batch in one process: its
            # first forward's routing beside the mesh's
            one = M.Model(cfg, dtype=getattr(torch, rc.param_dtype),
                          device="cuda", seed=0)
            drops.reset(first=cfg.num_layers)
            with torch.no_grad():
                M.backbone(cfg, rc, one, {"tokens": tokens0})
            info["one_process_first_forward"] = drops.first_calls()
            del one
            gc.collect()
            torch.cuda.empty_cache()
        del tokens0
        part_s["hash_and_checkpoint"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        check = (_cut(m["arch"], m["check_pattern"])[1]
                 if "check_pattern" in m else cfg)
        info["grads"] = _sharded_grads(torch, check, mesh, rank)
        gc.collect()
        torch.cuda.empty_cache()
        part_s["grads"] = time.perf_counter() - t_part
        info["part_s"] = part_s
        out["models"][name] = info
    layers.context_parallel_attention = real_cp
    moe.einsum_routing = drops.real
    # the train driver over the same ranks: its own mesh, data = world
    d = spec["driver"]
    _, cfg = _cut(d["arch"], d["pattern"])
    argv = ["--arch", d["arch"], "--batch", str(d["batch"]), "--seq",
            str(d["seq"]), "--steps", str(d["steps"]), "--log-every", "1",
            "--device", "cuda", "--checkpoint-dir", job["driver_ckpt"]]
    if rank == 0:
        argv += ["--json-out", job["driver_json"]]
    gc.collect()
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    out["driver_rc"] = train.main(argv, config_override=cfg)
    out["driver_s"] = time.perf_counter() - t_part
    return out


def _sharded_grads(torch, cfg, mesh, rank: int) -> dict:
    """``cfg`` in float32 at TRAIN_SHARDED's check batch (and frames): the
    loss's gradients on the mesh against a one-process, unsharded run on
    the card (rank 0 computes it), each leaf's largest error over its
    largest |g|, gathered one leaf at a time."""
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.parallel import rules

    spec = TRAIN_SHARDED
    B, S = spec["check_batch"], spec["check_seq"]
    rc = train.run_config(S, B)
    gen = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = _frames(torch, cfg, B, 11)
    want = loss1 = None
    if rank == 0:
        one = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
        one.requires_grad_(True)
        loss = M.loss_fn(cfg, rc, one, batch)
        loss.backward()
        loss1 = float(loss)
        want = {k: p.grad for k, p in one.named_parameters()}
        del one, loss
    model = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
    model.requires_grad_(True)
    M.place_on_mesh(cfg, model, mesh)
    with rules.use_rules_mesh(mesh):
        loss = M.loss_fn(cfg, rc, model, _placed(torch, batch, mesh))
        loss.backward()
    lossm = float(loss.full_tensor())
    rel = {}
    for k, p in model.named_parameters():
        got = p.grad.redistribute(mesh, p.placements).full_tensor()
        p.grad = None
        if rank == 0:
            w = want.pop(k)
            rel[k] = float((got - w).abs().max()) / max(float(w.abs().max()),
                                                        1e-30)
        del got
    if rank != 0:
        return {"loss": lossm}
    worst = max(rel, key=rel.get)
    return {"loss": lossm, "loss_one_process": loss1,
            "loss_rel_err": abs(lossm - loss1) / abs(loss1),
            "layers": cfg.num_layers, "leaves": len(rel),
            "max_rel_err": rel[worst], "worst_leaf": worst,
            "tolerance_rel": GRAD_REL}


def _replicas_differ(per: list[dict]) -> list[str]:
    """The leaves whose blocks differ between ranks that hold the same
    block (``_block_sha``'s coordinates)."""
    bad = []
    for k in per[0]["block_sha"]:
        seen: dict = {}
        for r in per:
            coords, digest = r["block_sha"][k]
            if seen.setdefault(tuple(coords), digest) != digest:
                bad.append(k)
                break
    return bad


def phase_train_sharded(torch, out_dir: Path) -> dict:
    """The LM over a mesh of 4 ranks sharing the card (TRAIN_SHARDED):
    ``launch/mesh.py: run_ranks`` over ``backend_for``'s route, each
    model on its mesh of DTensors.  For hymba-1.5b (the context-parallel
    branch: 25 heads over model 2) and tinyllama-1.1b at full width, 2
    blocks, phi3.5-moe at full width, 2 blocks on (1, 4), and whisper-tiny
    at full width, 2 + 2 blocks, on (2, 2) and (1, 4): 3 steps of
    ``train.train_step_fn`` on the loader's mesh batches (whisper's with
    stub frames placed as the tokens), the loss the same on every rank and
    every parameter block the same bits on every rank that holds it; the
    branch counted (each self-attention layer twice a step where it is
    taken, none elsewhere); the share of dropped (token, choice) pairs the
    same on every rank of an MoE run, and its first forward's routing by
    layer (``_DropCount.first_calls``) the same on every rank, beside the
    same seeded model's on the same batch in one process (rank 0); on
    each rank exactly 2
    ``selective_scan`` launches (the forward and block remat's recompute)
    and 1 ``selective_scan_bwd`` a hybrid layer a step, on its own
    channels, and none for the other models; step ms, the collectives'
    share of one profiled step and the peak memory, by rank.  Then each
    model in float32 (phi3.5-moe at 1 block): the sharded gradients within
    GRAD_REL of each leaf's largest of one unsharded process on the card.
    hymba's checkpoint, saved by the ranks at (2, 2), restored here with
    no mesh on the card bit-equal.  ``train.main`` over the 4 ranks (mesh
    data 4) for 3 steps of tinyllama at 2 layers.  No rank process is left
    alive."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as mesh_lib

    spec = TRAIN_SHARDED
    job = {"ckpt_dir": str(out_dir / "train_sharded_ckpt"),
           "driver_ckpt": str(out_dir / "train_sharded_driver_ckpt"),
           "driver_json": str(out_dir / "train_sharded_driver.json")}
    for d in (job["ckpt_dir"], job["driver_ckpt"]):
        if os.path.isdir(d):
            import shutil
            shutil.rmtree(d)
    rule = mesh_lib.backend_for(spec["world"], "cuda")
    run = mesh_lib.run_ranks(sharded_rank, spec["world"], (job,),
                             device="cuda", timeout=900)
    failures = []
    left = [p.pid for p in torch.multiprocessing.active_children()]
    if left:
        failures.append(f"rank processes still alive: {left}")
    if run.backend != rule:
        failures.append(f"backend {run.backend}, rule says {rule}")
    info: dict = {"phase": "train_sharded", "device": nvidia_smi(),
                  "backend": run.backend, "backend_rule": rule,
                  "startup_s": run.startup_s,
                  "mesh_device_type": run.results[0]["mesh_device_type"],
                  "models": {}, "children_left": left}
    for m in spec["models"]:
        full, cfg, name = _sharded_model(m)
        per = [r["models"][name] for r in run.results]
        ssm = _ssm_layers(cfg)
        want = {"modmatmul": 0, "coded_grad": 0,
                "selective_scan": 2 * ssm * spec["steps"],
                "selective_scan_bwd": ssm * spec["steps"]}
        attn_layers = (cfg.num_layers + cfg.num_encoder_layers
                       if m["cp"] else 0)
        g = per[0]["grads"]
        model_info = {
            "arch": m["arch"], "mesh": per[0]["mesh"],
            "batch": per[0]["batch"], "seq": per[0]["seq"],
            "reduced": {"num_layers": [full.num_layers, cfg.num_layers],
                        "num_encoder_layers": [full.num_encoder_layers,
                                               cfg.num_encoder_layers]},
            "losses": per[0]["losses"],
            "step_ms_by_rank": [r["step_ms"] for r in per],
            "collective_share_by_rank": [r["profiled_step"]["collective_share"]
                                         for r in per],
            "profiled_step_by_rank": [r["profiled_step"] for r in per],
            "peak_gb_by_rank": [r["peak_gb"] for r in per],
            "launches_by_rank": [r["launches"] for r in per],
            "cp_calls_by_rank": [r["cp_calls"] for r in per],
            "dropped_share_by_rank": [r["dropped_share"] for r in per],
            "first_forward_rank0": per[0]["first_forward"],
            "one_process_first_forward": per[0].get(
                "one_process_first_forward"),
            "local_batch": per[0]["local_batch"],
            "part_s_rank0": per[0]["part_s"],
            "placements_sample": per[0]["placements"], "grads": g}
        info["models"][name] = model_info
        if any(r["losses"] != per[0]["losses"] for r in per):
            failures.append(f"{name}: losses differ between ranks")
        if not all(math.isfinite(x) for x in per[0]["losses"]):
            failures.append(f"{name}: losses {per[0]['losses']}")
        bad = _replicas_differ(per)
        if bad:
            failures.append(f"{name}: blocks differ between ranks that hold "
                            f"them: {bad[:4]}")
        if len({r["dropped_share"] for r in per}) != 1 or (
                cfg.num_experts and per[0]["dropped_share"] is None):
            failures.append(f"{name}: dropped shares "
                            f"{model_info['dropped_share_by_rank']}")
        if any(r["first_forward"] != per[0]["first_forward"] for r in per):
            failures.append(f"{name}: the first forward's routing differs "
                            f"between ranks")
        for r in per:
            if r["launches"] != want:
                failures.append(f"{name}: launches {r['launches']}, "
                                f"expected {want}")
            if r["cp_calls"] != attn_layers * spec["steps"] * 2:
                failures.append(f"{name}: context-parallel calls "
                                f"{r['cp_calls']}, expected "
                                f"{attn_layers * spec['steps'] * 2}")
        if not (g["max_rel_err"] <= GRAD_REL
                and g["loss_rel_err"] <= GRAD_REL):
            failures.append(f"{name}: sharded gradients {g}")
        if m.get("checkpoint"):
            restored = CheckpointManager(job["ckpt_dir"]).restore(
                device="cuda")
            got = {k: _tensor_sha(torch, t)
                   for k, t in restored["params"].items()}
            model_info["checkpoint_restored_bit_equal"] = (
                got == per[0]["param_sha"] and restored["step"]
                == per[0]["checkpoint_step"]
                and all(t.is_cuda for t in restored["params"].values()))
            if not model_info["checkpoint_restored_bit_equal"]:
                failures.append(f"{name}: checkpoint restored differs")
            del restored
        emit({"phase": "train_sharded", "model": name,
              "device": info["device"],
              **{k: v for k, v in model_info.items()
                 if k != "profiled_step_by_rank"},
              "profiled_step_rank0": per[0]["profiled_step"]})
    drv = json.loads(Path(job["driver_json"]).read_text())
    info["driver"] = {"rc": [r["driver_rc"] for r in run.results],
                      "seconds_rank0": run.results[0]["driver_s"],
                      "mesh": drv["mesh"], "losses": drv["losses"],
                      "step_s": drv["step_s"], "peak_gb_rank0": drv["peak_gb"]}
    if info["driver"]["rc"] != [0] * spec["world"] or drv["mesh"] != {
            "data": spec["world"], "model": 1}:
        failures.append(f"train driver over the ranks: {info['driver']}")
    emit({k: v for k, v in info.items() if k != "models"})
    if failures:
        raise AssertionError("train_sharded: " + "; ".join(failures))
    # hymba's run, the slice's main path on each rank
    info["launches"] = info["models"][spec["models"][0]["arch"]][
        "launches_by_rank"][0]
    return info


class _CacheWatch:
    """Wraps ``model.prefill`` and ``model.decode_step`` while it is
    entered: after each call, every cache leaf's block on this rank is
    held to the placements and block shape of its ``input_specs`` leaf
    (``specs``, the decode cell of the run's cache length), and the last
    cache and the step's batch are kept (for one more, profiled step)."""

    def __init__(self, M, specs: dict, mesh):
        self.M, self.specs, self.mesh = M, specs, mesh
        self.calls, self.bad, self.last = 0, [], None

    def _check(self, cache):
        self.calls += 1
        for seg, leaves in cache.items():
            if seg == "index":
                continue
            for name, t in leaves.items():
                want = self.specs[seg][name]
                got = (tuple(t.placements), tuple(t.to_local().shape))
                if got != (want.placements, _block_shape(want, self.mesh)):
                    self.bad.append(f"call {self.calls} {seg}.{name}: "
                                    f"{got} against {want}")

    def __enter__(self):
        M = self.M
        self.real = (M.prefill, M.decode_step)
        real_prefill, real_step = self.real

        def prefill(*a, **kw):
            out = real_prefill(*a, **kw)
            self._check(out[1])
            return out

        def decode_step(cfg, rc, model, cache, batch, **kw):
            out = real_step(cfg, rc, model, cache, batch, **kw)
            self._check(out[1])
            self.last = (cache, batch)
            return out

        M.prefill, M.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        self.M.prefill, self.M.decode_step = self.real


def _block_shape(leaf, mesh) -> tuple:
    """The block of ``leaf`` (an ``InputSpec``) one rank holds."""
    shape = list(leaf.shape)
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard():
            shape[pl.dim] //= mesh.size(i)
    return tuple(shape)


def _serve_sharded_model(m: dict):
    """A serve_sharded model's cut config (whisper-tiny whole), its check
    config (``check_pattern``'s where given) and its depth cut."""
    from repro_torch.configs import registry

    full = registry.get_config(m["arch"])
    cfg = _cut(m["arch"], m["pattern"])[1] if "pattern" in m else full
    check = (_cut(m["arch"], m["check_pattern"])[1] if "check_pattern" in m
             else cfg)
    return full, cfg, check


def _sharded_serve_rc(cfg, S: int):
    """serve's run configuration for a prompt of S tokens; whisper's
    ``RunConfig()`` (512 and 1024 attention blocks), as serve_whisper's:
    a 4-token prompt's blocks would tile the 1500-frame encoder in 4s."""
    from repro_torch.configs.base import RunConfig

    return RunConfig() if cfg.is_encoder_decoder else _serve_rc(S)


def serve_sharded_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of the serve_sharded phase (see ``phase_serve_sharded``),
    on ``job["device"]``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.parallel import rules

    spec = SERVE_SHARDED
    dev = job["device"]
    cuda = dev == "cuda"
    meshes: dict = {}
    out = {"rank": rank, "backend": dist.get_backend(), "models": {}}
    for m in spec["models"]:
        shape = tuple(m["mesh"])
        if shape not in meshes:
            meshes[shape] = mesh_lib.compat_make_mesh(shape,
                                                      ("data", "model"))
        mesh = meshes[shape]
        out["mesh_device_type"] = mesh.device_type
        full, cfg, check = _serve_sharded_model(m)
        B, S = m.get("batch", spec["batch"]), m.get("prompt", spec["prompt"])
        n = m.get("gen", spec["gen"])
        rc = _sharded_serve_rc(cfg, S)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.Model(cfg, dtype=torch.bfloat16, device=dev, seed=0)
        M.place_on_mesh(cfg, model, mesh)
        pre = registry.input_specs(cfg, ShapeConfig("p", S, B, "prefill"),
                                   mesh, rc)
        dec = registry.input_specs(cfg, ShapeConfig("d", S + n, B, "decode"),
                                   mesh, rc)
        prompt = rules.distribute(serve.make_prompt(
            cfg, B, S, 0, torch.device(dev)), mesh, pre["tokens"].placements)
        frames = None
        if cfg.is_encoder_decoder:
            frames = rules.distribute(serve.make_frames(
                cfg, B, 0, torch.device(dev)), mesh,
                pre["enc_embeds"].placements)
        if cuda:
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stats: dict = {}
        ops.reset_launches()
        with _CacheWatch(M, dec["cache"], mesh) as watch, \
                torch.inference_mode():
            toks = serve.greedy_decode(cfg, rc, model, prompt, n,
                                       stats=stats, enc_embeds=frames)
        launches = dict(ops.LAUNCHES)
        cache, batch = watch.last

        def one_step():
            with rules.use_rules_mesh(mesh), torch.inference_mode():
                M.decode_step(cfg, rc, model, cache, batch)

        prof = _collective_share(torch, one_step)
        info = {"mesh": list(shape), "batch": B, "prompt": S, "gen": n,
                "build_s": build_s, "stats": stats,
                "decode_tok_s": B * n / stats["decode_s"],
                "launches": launches, "profiled_step": prof,
                "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
                "tokens": rules.full(toks).cpu().tolist(),
                "local_prompt": list(prompt.to_local().shape),
                "cache_calls_checked": watch.calls,
                "cache_bad": watch.bad[:4],
                "cache_placements": {
                    f"{seg}.{k}": [repr(p) for p in v.placements]
                    for seg, leaves in dec["cache"].items()
                    if seg != "index" for k, v in leaves.items()},
                "reduced": {"num_layers": [full.num_layers,
                                           cfg.num_layers]}}
        del model, cache, batch, watch, prompt, frames, toks
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        info["check"] = _serve_sharded_check(torch, check, mesh, rank, m,
                                             dev)
        info["check_s"] = time.perf_counter() - t0
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        out["models"][m["arch"]] = info
    return out


def _serve_sharded_check(torch, cfg, mesh, rank: int, m: dict,
                         dev: str) -> dict:
    """``cfg`` in float32 at SERVE_SHARDED's check batch and prompt: the
    prefill and ``check_gen`` decode steps teacher-forced on random tokens
    (and frames) on the mesh, each call's gathered logits against the same
    seeded model in one process on the card (rank 0), max abs error by
    call; the scan's launches in the mesh's prefill; every cache leaf's
    block against ``input_specs`` after each call."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.parallel import rules

    spec = SERVE_SHARDED
    B = spec["check_batch"]
    S, n = m.get("check_prompt", spec["check_prompt"]), spec["check_gen"]
    rc = _sharded_serve_rc(cfg, S)
    gen = torch.Generator(device=dev).manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, S + n), generator=gen,
                         dtype=torch.int32, device=dev)
    frames = (torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                          generator=gen, device=dev)
              if cfg.is_encoder_decoder else None)
    pre = registry.input_specs(cfg, ShapeConfig("p", S, B, "prefill"), mesh,
                               rc)
    dec = registry.input_specs(cfg, ShapeConfig("d", S + n, B, "decode"),
                               mesh, rc)

    def run(model, place):
        """The prefill and n steps; each call's logits, whole."""
        out = []
        enc = {}
        if frames is not None:
            enc["enc_out"] = M.encode(cfg, rc, model,
                                      place(frames, pre["enc_embeds"]))
        lg, cache = M.prefill(cfg, rc, model,
                              {"tokens": place(toks[:, :S], pre["tokens"]),
                               **enc}, cache_len=S + n)
        out.append(rules.full(lg).float())
        scans = ops.LAUNCHES["selective_scan"]
        for t in range(n):
            lg, cache = M.decode_step(
                cfg, rc, model, cache,
                {"tokens": place(toks[:, S + t: S + t + 1], dec["tokens"]),
                 **enc})
            out.append(rules.full(lg).float())
        return out, scans

    model = M.Model(cfg, dtype=torch.float32, device=dev, seed=0)
    M.place_on_mesh(cfg, model, mesh)
    ops.reset_launches()
    with _CacheWatch(M, dec["cache"], mesh) as watch, \
            rules.use_rules_mesh(mesh), torch.inference_mode():
        got, scans = run(model, lambda t, leaf: rules.distribute(
            t, mesh, leaf.placements))
    info = {"layers": cfg.num_layers, "batch": B, "prompt": S, "gen": n,
            "scan_launches_prefill": scans,
            "cache_calls_checked": watch.calls, "cache_bad": watch.bad[:4]}
    del model
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        one = M.Model(cfg, dtype=torch.float32, device=dev, seed=0)
        with torch.inference_mode():
            want, _ = run(one, lambda t, leaf: t)
        info["max_abs_err"] = [float((a - b).abs().max())
                               for a, b in zip(got, want)]
        info["tolerance"] = MODEL_ATOL
        del one
    return info


def phase_serve_sharded(torch) -> dict:
    """Prefill and decode over a mesh of 4 ranks sharing the card
    (SERVE_SHARDED): ``launch/mesh.py: run_ranks`` over ``backend_for``'s
    route, each model placed by ``model.place_on_mesh`` and its prompt
    (and frames) by ``registry.input_specs``, through
    ``serve.greedy_decode``: tinyllama-1.1b, hymba-1.5b (25 heads over model
    2: the context-parallel prefill; one global block and one 1024-slot
    ring) and falcon-mamba-7b on (2, 2), phi3.5-moe on (1, 4), each at full
    width cut to 2 blocks, and whisper-tiny at its published config on
    (1, 4).  The greedy tokens equal on every rank; every cache leaf's
    block placed by ``input_specs`` after the prefill and every step;
    exactly one ``selective_scan`` launch a mamba or hybrid layer a
    prefill on every rank, none elsewhere; in float32 at the check shape,
    the gathered logits of the prefill and each step within MODEL_ATOL of
    one process's (rank 0).  Prefill seconds, decode tokens/s, the
    collectives' share of one profiled decode step by op and the peak
    memory, by rank.  No rank process is left alive."""
    from repro_torch.launch import mesh as mesh_lib

    spec = SERVE_SHARDED
    rule = mesh_lib.backend_for(spec["world"], "cuda")
    run = mesh_lib.run_ranks(serve_sharded_rank, spec["world"],
                             ({"device": "cuda"},), device="cuda",
                             timeout=600)
    failures = []
    left = [p.pid for p in torch.multiprocessing.active_children()]
    if left:
        failures.append(f"rank processes still alive: {left}")
    if run.backend != rule:
        failures.append(f"backend {run.backend}, rule says {rule}")
    info: dict = {"phase": "serve_sharded", "device": nvidia_smi(),
                  "backend": run.backend, "backend_rule": rule,
                  "startup_s": run.startup_s,
                  "mesh_device_type": run.results[0]["mesh_device_type"],
                  "models": {}, "children_left": left}
    for m in spec["models"]:
        name = m["arch"]
        _, cfg, check = _serve_sharded_model(m)
        per = [r["models"][name] for r in run.results]
        want = {"modmatmul": 0, "coded_grad": 0,
                "selective_scan": _ssm_layers(cfg), "selective_scan_bwd": 0}
        c0 = per[0]["check"]
        model_info = {
            "arch": name, "mesh": per[0]["mesh"], "batch": per[0]["batch"],
            "prompt": per[0]["prompt"], "gen": per[0]["gen"],
            "reduced": per[0]["reduced"],
            "prefill_s_by_rank": [r["stats"]["prefill_s"] for r in per],
            "encode_s_by_rank": [r["stats"].get("encode_s") for r in per],
            "decode_s_by_rank": [r["stats"]["decode_s"] for r in per],
            "decode_tok_s_by_rank": [r["decode_tok_s"] for r in per],
            "collective_share_by_rank": [
                r["profiled_step"]["collective_share"] for r in per],
            "profiled_step_rank0": per[0]["profiled_step"],
            "peak_gb_by_rank": [r["peak_gb"] for r in per],
            "launches_by_rank": [r["launches"] for r in per],
            "local_prompt": per[0]["local_prompt"],
            "cache_placements": per[0]["cache_placements"],
            "cache_calls_checked": per[0]["cache_calls_checked"],
            "build_s_rank0": per[0]["build_s"],
            "check_s_rank0": per[0]["check_s"],
            "tokens_row0": per[0]["tokens"][0], "check": c0}
        info["models"][name] = model_info
        if any(r["tokens"] != per[0]["tokens"] for r in per):
            failures.append(f"{name}: greedy tokens differ between ranks")
        toks = per[0]["tokens"]
        if not (len(toks) == per[0]["batch"]
                and all(len(t) == per[0]["gen"] for t in toks)
                and all(0 <= x < cfg.vocab_size for t in toks for x in t)):
            failures.append(f"{name}: tokens out of shape or range")
        if not all(r["stats"]["logits_finite"] for r in per):
            failures.append(f"{name}: non-finite logits")
        for rank, r in enumerate(per):
            if r["launches"] != want:
                failures.append(f"{name}: rank {rank} launches "
                                f"{r['launches']}, expected {want}")
            if r["check"]["scan_launches_prefill"] != _ssm_layers(check):
                failures.append(f"{name}: check prefill scan launches "
                                f"{r['check']['scan_launches_prefill']}")
            if r["cache_bad"] or r["check"]["cache_bad"]:
                failures.append(f"{name}: cache placement "
                                f"{r['cache_bad'] or r['check']['cache_bad']}")
            if r["cache_calls_checked"] != r["gen"] + 1 or (
                    r["check"]["cache_calls_checked"]
                    != spec["check_gen"] + 1):
                failures.append(f"{name}: cache checked after "
                                f"{r['cache_calls_checked']} calls")
        if not all(e <= MODEL_ATOL for e in c0["max_abs_err"]):
            failures.append(f"{name}: float32 logits against one process "
                            f"{c0['max_abs_err']}")
        emit({"phase": "serve_sharded", "model": name,
              "device": info["device"], **model_info})
    emit({k: v for k, v in info.items() if k != "models"})
    if failures:
        raise AssertionError("serve_sharded: " + "; ".join(failures))
    # falcon-mamba's run, the scan kernel's launches on this path (rank 0)
    info["launches"] = info["models"]["falcon-mamba-7b"]["launches_by_rank"][0]
    return info


# the dryrun phase's cells, each through the CLI in its own process, on
# the 16x16 mesh: a train, a prefill (a mamba arch: the scan's fake) and a
# decode cell; their traces take 3-40 s each on one host core
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"),
                ("falcon-mamba-7b", "prefill_32k"),
                ("hymba-1.5b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300
# the cross-check's bytes on the card against meta, and MemTracker's peak
# on meta against the card's allocator peak
DRYRUN_BYTES_REL = 0.01
DRYRUN_PEAK_RANGE = (0.5, 1.5)


def dryrun_cross_check(torch) -> dict:
    """One train step of train_lm's hymba (``TRAIN_LM[0]``: full width, 4
    layers, batch 4 x 2048, ``train.train_step_fn``), counted by
    ``hlo_analysis.Counter`` on the card (seed 0, the loader's tokens) and
    on ``abstract_params`` (meta, zeros for tokens), with MemTracker on
    the meta run.  Holds flops and the scan ops equal, the scan ops to the
    card's kernel launches, bytes within ``DRYRUN_BYTES_REL`` and the
    predicted peak within ``DRYRUN_PEAK_RANGE`` of the card's."""
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis, train
    from repro_torch.launch.dryrun import LocalMemTracker
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt

    spec = TRAIN_LM[0]
    _, cfg = _cut(spec["arch"], spec["pattern"])
    B, S = spec["batch"], spec["seq"]
    rc = train.run_config(S, B)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10)
    runs = {}
    for dev in ("cuda", "meta"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = (M.Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
                 if dev == "cuda" else M.abstract_params(cfg))
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = opt.init_state(ocfg, params)
        if dev == "cuda":
            with LMBatchLoader("cuda", B, S, cfg.vocab_size) as loader:
                batch = next(loader)
        else:
            batch = {k: torch.zeros((B, S), dtype=torch.int64, device="meta")
                     for k in ("tokens", "labels")}
        step = train.train_step_fn(cfg, rc, ocfg, model)
        counter = hlo_analysis.Counter()
        ops.reset_launches()
        t0 = time.perf_counter()
        if dev == "cuda":
            with counter:
                step(params, state, batch)
            torch.cuda.synchronize()
            run = {"launches": dict(ops.LAUNCHES),
                   "peak_bytes": torch.cuda.max_memory_allocated() - base}
        else:
            tracker = LocalMemTracker()
            tracker.track_external(model, *state["mu"].values(),
                                   *state["nu"].values(), state["step"],
                                   *batch.values())
            with tracker, counter:
                step(params, state, batch)
            run = {"peak_bytes": sum(
                snap["Total"] for snap in
                tracker.get_tracker_snapshot("peak").values())}
        run.update(seconds=time.perf_counter() - t0, **counter.summary())
        runs[dev] = run
        del model, params, state, batch, step, counter
    card, meta = runs["cuda"], runs["meta"]
    scan_ops = {dev: {k: r["op_counts"].get(f"repro_torch.{k}", 0)
                      for k in ("selective_scan", "selective_scan_bwd")}
                for dev, r in runs.items()}
    names = set(card["op_counts"]) | set(meta["op_counts"])
    counts = {k: (card["op_counts"].get(k, 0), meta["op_counts"].get(k, 0))
              for k in names}
    differ = {k: v for k, v in counts.items() if v[0] != v[1]}
    info = {
        "arch": cfg.name, "layers": cfg.num_layers, "batch": B, "seq": S,
        "flops": {"cuda": card["flops"], "meta": meta["flops"]},
        "bytes": {"cuda": card["bytes"], "meta": meta["bytes"]},
        "bytes_rel_diff": abs(card["bytes"] - meta["bytes"]) / card["bytes"],
        "scan_ops": scan_ops, "launches": card["launches"],
        "ops_dispatched": {dev: sum(r["op_counts"].values())
                           for dev, r in runs.items()},
        "op_counts_cuda_meta": dict(sorted(
            counts.items(), key=lambda kv: -kv[1][0])[:25]),
        "op_counts_differ": differ,
        "memtracker_peak_meta_bytes": meta["peak_bytes"],
        "max_memory_allocated_bytes": card["peak_bytes"],
        "peak_ratio": meta["peak_bytes"] / card["peak_bytes"],
        "seconds": {dev: r["seconds"] for dev, r in runs.items()}}
    emit({"phase": "dryrun", "cross_check": info})
    if card["flops"] != meta["flops"] or scan_ops["cuda"] != scan_ops["meta"]:
        raise AssertionError(f"dryrun cross-check: flops {info['flops']}, "
                             f"scan ops {scan_ops}")
    want = {k: card["launches"][k] for k in scan_ops["cuda"]}
    if scan_ops["cuda"] != want or not all(want.values()):
        raise AssertionError(f"dryrun cross-check: scan ops {scan_ops['cuda']}"
                             f" against launches {card['launches']}")
    if info["bytes_rel_diff"] > DRYRUN_BYTES_REL:
        raise AssertionError(f"dryrun cross-check: bytes {info['bytes']} "
                             f"differ by {info['bytes_rel_diff']:.4f}; "
                             f"ops {differ}")
    lo, hi = DRYRUN_PEAK_RANGE
    if not lo <= info["peak_ratio"] <= hi:
        raise AssertionError(f"dryrun cross-check: MemTracker's peak "
                             f"{meta['peak_bytes']} against the card's "
                             f"{card['peak_bytes']}")
    return info


def phase_dryrun(torch, out_dir: Path) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS``
    in its own process, all at once, each ending ``ok``; the cross-check
    (``dryrun_cross_check``) runs here meanwhile."""
    out = out_dir / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)}
    procs = []
    try:
        for arch, shape in DRYRUN_CELLS:
            log = open(out / f"{arch}__{shape}.log", "w")
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out", str(out)]
            procs.append((arch, shape, argv, log, subprocess.Popen(
                argv, env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT)))
        info = {"phase": "dryrun", "cross_check": dryrun_cross_check(torch),
                "cells": {}}
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        for arch, shape, argv, log, p in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            cell = json.loads((out / f"dryrun_{arch}__{shape}__16x16.json")
                              .read_text())
            keep = {k: cell.get(k) for k in (
                "status", "chips", "roofline_terms_s", "dominant",
                "step_time_bound_s", "useful_ratio", "memory", "fits",
                "hlo_flops_per_device", "collective_bytes_per_device",
                "ops_dispatched", "trace_s", "analyze_s", "error")}
            info["cells"][f"{arch}__{shape}"] = keep
            emit({"phase": "dryrun", "arch": arch, "shape": shape,
                  "exit": rc, **keep})
            if rc != 0 or cell["status"] != "ok":
                raise AssertionError(f"dryrun {' '.join(argv[2:])} exited "
                                     f"{rc}: {cell.get('error')}")
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    info["launches"] = info["cross_check"]["launches"]
    return info


def phase_consistency_train(torch) -> dict:
    """hymba at full width cut to 2 layers, float32, batch 2 x 256 tokens:
    ``loss_fn`` and its gradients on the card (the scan kernels; launches
    counted) against the CPU (plain versions) from the same parameters,
    every leaf within ``GRAD_REL`` of its largest |g|; then in the bf16 a/b
    mode (``CONSISTENCY_MODES``), whose CPU gradient is the plain backward
    of that mode, every leaf within ``AB16_GRAD_REL`` and nearer the CPU's
    mode gradient than its float32 one (``AB16_GRAD_RMS_SHARE``), with the
    CPU gradient's own spread under one ulp of float32 noise beside it."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model as M

    spec = CONSISTENCY_TRAIN
    full = registry.get_config(spec["arch"])
    cfg = dataclasses.replace(full, num_layers=len(spec["pattern"]),
                              block_pattern=spec["pattern"])
    B, S = spec["batch"], spec["seq"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gpu = M.Model(cfg, dtype=torch.float32, device="cuda", seed=0)
    cpu = M.Model(cfg, dtype=torch.float32, device="cpu", seed=None)
    cpu.load_state_dict(gpu.state_dict())
    ssm = _ssm_layers(cfg)
    want = {"modmatmul": 0, "coded_grad": 0, "selective_scan": 2 * ssm,
            "selective_scan_bwd": ssm}
    res: dict = {"phase": "consistency_train", "pattern": spec["pattern"],
                 "d_model": cfg.d_model, "batch": B, "seq": S,
                 "reduced": {"num_layers": [full.num_layers, cfg.num_layers]},
                 "tolerance_rel": GRAD_REL, "modes": {}}

    def rms_rel(g, w):
        return float((g - w).pow(2).mean().sqrt()
                     / max(float(w.pow(2).mean().sqrt()), 1e-30))

    def grads(model, rc, dev):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        loss = M.loss_fn(cfg, rc, model, {k: v.to(dev)
                                          for k, v in batch.items()})
        loss.backward()
        return float(loss.detach()), {k: p.grad.cpu() for k, p in
                                      model.named_parameters()}

    cpu_grads = {}
    for mode in CONSISTENCY_MODES:
        rc = dataclasses.replace(train.run_config(S, B), ssm_dtype=mode)
        ops.reset_launches()
        lg, gg = grads(gpu, rc, "cuda")
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        lc, gc_ = grads(cpu, rc, "cpu")
        cpu_grads[mode] = gc_
        rel = {k: float((gg[k] - w).abs().max()) / max(float(w.abs().max()),
                                                        1e-30)
               for k, w in gc_.items()}
        worst = max(rel, key=rel.get)
        tol = GRAD_REL if mode == "f32" else AB16_GRAD_REL
        info = {"ssm_dtype": mode, "scan_chunk": rc.scan_chunk,
                "loss_card": lg, "loss_cpu": lc,
                "loss_rel_err": abs(lg - lc) / abs(lc), "launches": launches,
                "leaves": len(rel), "max_rel_err": rel[worst],
                "worst_leaf": worst, "tolerance_rel": tol}
        if mode == "bf16":
            # the mode's own spread: the CPU again from parameters moved by
            # one float32 ulp (a finding, not a check)
            state = {k: v.clone() for k, v in cpu.state_dict().items()}
            noise = torch.Generator().manual_seed(12)
            with torch.no_grad():
                for p in cpu.parameters():
                    p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape,
                                                        generator=noise))
            _, gn = grads(cpu, rc, "cpu")
            cpu.load_state_dict(state)
            ratio = {k: rms_rel(gg[k], w) / max(rms_rel(cpu_grads["f32"][k],
                                                        w), 1e-30)
                     for k, w in gc_.items()}
            info.update(
                rms_rel_card_vs_cpu_max=max(rms_rel(gg[k], w)
                                            for k, w in gc_.items()),
                rms_rel_f32_mode_vs_cpu_min=min(
                    rms_rel(cpu_grads["f32"][k], w) for k, w in gc_.items()),
                rms_share_max=max(ratio.values()),
                rms_share_worst_leaf=max(ratio, key=ratio.get),
                rms_share_tolerance=AB16_GRAD_RMS_SHARE,
                cpu_ulp_noise_max_rel=max(
                    float((gn[k] - w).abs().max()) / max(float(w.abs().max()),
                                                         1e-30)
                    for k, w in gc_.items()),
                cpu_ulp_noise_rms_rel_max=max(rms_rel(gn[k], w)
                                              for k, w in gc_.items()))
        res["modes"][mode] = info
        emit({"phase": "consistency_train", **info})
        if launches != want:
            raise AssertionError(f"consistency_train {mode} launches "
                                 f"{launches}, expected {want}")
        bad = {k: v for k, v in rel.items() if not v <= tol}
        if bad or not info["loss_rel_err"] <= GRAD_REL:
            raise AssertionError(f"consistency_train {mode} beyond {tol}: "
                                 f"loss {info['loss_rel_err']}, leaves {bad}")
        if mode == "bf16" and not info["rms_share_max"] <= AB16_GRAD_RMS_SHARE:
            raise AssertionError(f"consistency_train bf16: leaf "
                                 f"{info['rms_share_worst_leaf']} lies "
                                 f"{info['rms_share_max']} of the float32 "
                                 f"mode's distance from the CPU's")
    # the float32 run's launches, as before; the mode's beside them
    res["launches"] = res["modes"]["f32"]["launches"]
    res["launches_ab16"] = res["modes"]["bf16"]["launches"]
    return res


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
# Over sockets the Case 1 fleet's 40 processes with a straggler (~50 s to
# start), then the slack fleet with a kill and with --collect-all
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


def _build_staged(out: dict) -> None:
    from repro_torch.parallel import staged

    t0 = time.perf_counter()
    try:
        out["library"] = str(staged.build().relative_to(ROOT))
    except BaseException as e:      # reported where the phases wait for it
        out["error"] = e
    out["seconds"] = time.perf_counter() - t0


def _join_staged(thread, out: dict) -> None:
    """Wait for ``_build_staged`` (once) and report it."""
    if "reported" in out:
        return
    thread.join()
    if "error" in out:
        raise out["error"]
    out["reported"] = True
    emit({"phase": "build_staged", "seconds": out["seconds"],
          "library": out["library"]})


def run_phase(name: str, fn, *args):
    """Run one phase; print its seconds.  A failure propagates."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": name, "seconds": time.perf_counter() - t0})
    return out


def bytecode_cache() -> dict:
    """Give this process and every process it starts (ranks, socket
    workers) one bytecode cache, under the checkout's ``build/pycache``.

    Where the environment sets PYTHONDONTWRITEBYTECODE and the installed
    torch carries no compiled bytecode, every process compiles torch's
    Python sources as it imports them: 8.7 s a process on the H100
    machine, 52 s for a fleet of 40 on its 8 cores.  With the cache, the
    first import compiles and writes it and the others read it.  Nothing
    is written outside the checkout (PYTHONPYCACHEPREFIX); a prefix the
    caller set is kept."""
    was = os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    prefix = os.environ.setdefault("PYTHONPYCACHEPREFIX",
                                   str(ROOT / "build" / "pycache"))
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    return {"prefix": prefix, "env_dont_write_bytecode": was}


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
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    cache = bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on a GPU only",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "bytecode_cache": cache})

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    staged_s: dict = {}
    staged_build = threading.Thread(target=_build_staged,
                                    args=(staged_s,), daemon=True)
    staged_build.start()
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
    # the staged collective backend (the ranks of shard, train_sharded and
    # serve_sharded) compiles while the kernels phases run
    wait_staged = (lambda: _join_staged(staged_build, staged_s))
    if "kernels" in phases:
        timings += run_phase("kernels", phase_kernels, torch, checks)
        free()
        timings += run_phase("kernels_coded_head", phase_kernels_coded_head,
                             torch, checks)
        timings += run_phase("kernels_mpc", phase_kernels_mpc, torch, checks)
        timings += run_phase("kernels_scan", phase_kernels_scan, torch, checks)
        timings += run_phase("kernels_scan_bwd", phase_kernels_scan_bwd, torch,
                             checks)
        timings += run_phase("kernels_scan_bwd_ab16",
                             phase_kernels_scan_bwd_ab16, torch, checks)
        ran["ab16_mix"] = run_phase("kernels_ab16_mix", phase_ab16_mix, torch)
        timings += run_phase("kernels_predict", phase_kernels_predict, torch,
                             checks)
        free()
    for name, fn, args_ in (
            ("train", phase_train, (torch, out_dir)),
            ("train_c33", phase_train_heads, (torch, out_dir)),
            ("shard", phase_shard, (torch, out_dir)),
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
            ("train_lm_ab16", phase_train_lm_ab16, (torch,)),
            ("train_sharded", phase_train_sharded, (torch, out_dir)),
            ("serve_sharded", phase_serve_sharded, (torch,)),
            ("consistency_train", phase_consistency_train, (torch,)),
            ("dryrun", phase_dryrun, (torch, out_dir)),
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
            if name in ("shard", "train_sharded", "serve_sharded"):
                wait_staged()
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
                                 ("shard_per_rank", "shard"),
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
                                 ("consistency_train", "consistency_train"),
                                 ("train_lm_ab16", "train_lm_ab16"),
                                 ("train_sharded_per_rank", "train_sharded"),
                                 ("serve_sharded_per_rank", "serve_sharded"),
                                 ("dryrun_cross_check", "dryrun"))
                    if v in ran}})
            if "consistency_train" in ran:
                kernels[-1]["launches_by_path"]["consistency_train_ab16"] = (
                    ran["consistency_train"]["launches_ab16"][name])
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
