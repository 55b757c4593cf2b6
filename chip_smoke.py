#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  It prints
one JSON object per line, in phases, and fails (non-zero exit) if any
phase fails:

  build     builds both CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels   holds each kernel bit for bit against its plain PyTorch version
            on the card: the main path's shapes at the paper's Case 1
            (N=40, K=13, T=1, m=12396, d=1568), both primes, all-(p-1)
            inputs, odd shapes and the accumulator-reduction boundary; and
            times each (CUDA events) beside its plain version and its bound
  train     ``repro_torch.launch.cpml_train`` at Case 1 for 25 rounds on
            the card: both kernels launched (launch counts reset just
            before, read just after), coded accuracy within 0.03 of the
            cleartext baseline
  teacher   3 rounds on the card and again on the CPU (plain versions)
            from the card's weights: shares and decoded parts bit-equal,
            weights within 1e-5; then the round's stages timed on the card
  summary   the {"kernels": [...]} line, then the card's name and power
            limit, then {"ok": true, "device": {...}} as the last line

It exits non-zero and prints no result without CUDA, or without the rest
of the repository beside it.  It imports no JAX.
"""
from __future__ import annotations

import json
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
WEIGHT_ATOL = 1e-5  # float32 summation order: cuBLAS vs CPU in xqᵀ·targets


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
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


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class Checks:
    """Kernel-vs-plain comparisons; remembers the largest error per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {"modmatmul": 0, "coded_grad": 0}

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
    for case, p, a, b in mm_cases:
        got = mm.modmatmul(a, b, p)
        want = ref.modmatmul_ref(a, b, p)
        checks.compare("modmatmul", case, got, want, p=p,
                       shape=[a.shape[0], a.shape[1], b.shape[1]])

    # -- coded_grad: main-path shapes, both primes, extremes, odd shapes --
    cg_cases = []
    for p in (field.P, field.P30):
        for c, r in ((1, 1), (10, 2)):
            cbar = torch.as_tensor(sigmoid_poly.quantized_coeffs(r, 2, 4, 6, p),
                                   dtype=torch.int32, device=dev)
            cg_cases.append((f"case1_c{c}_r{r}", p, rand((N, mk, d), p),
                             rand((N, d, c, r), p), cbar))
            cg_cases.append((f"all_p_minus_1_c{c}_r{r}", p, full((N, mk, d), p),
                             full((N, d, c, r), p), full((r + 1,), p)))
        cbar3 = torch.as_tensor(sigmoid_poly.quantized_coeffs(3, 2, 4, 6, p),
                                dtype=torch.int32, device=dev)
        cg_cases.append(("odd_N3_mk97_d131_c3_r3", p, rand((3, 97, 131), p),
                         rand((3, 131, 3, 3), p), cbar3))
        cg_cases.append(("odd_N5_mk65_d33_c10_r3", p, rand((5, 65, 33), p),
                         rand((5, 33, 10, 3), p), cbar3))
        cbar1 = torch.as_tensor(sigmoid_poly.quantized_coeffs(1, 2, 4, 6, p),
                                dtype=torch.int32, device=dev)
        cg_cases.append(("odd_N2_mk1_d1_c1_r1", p, rand((2, 1, 1), p),
                         rand((2, 1, 1, 1), p), cbar1))
    for case, p, x, w, cbar in cg_cases:
        got = cg.coded_grad(x, w, cbar, p)
        want = ref.coded_grad_workers_ref(x, w, cbar, p)
        checks.compare("coded_grad", case, got, want, p=p,
                       shape=list(x.shape) + list(w.shape[2:]))

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
            "plain_ms": time_ms(torch, lambda: ref.modmatmul_ref(a, b, p), 3),
            "bound_ms": b_ms, "bound_by": b_by})
    for c, r in ((1, 1), (10, 2)):
        x, w = rand((N, mk, d), p), rand((N, d, c, r), p)
        cbar = torch.as_tensor(sigmoid_poly.quantized_coeffs(r, 2, 4, 6, p),
                               dtype=torch.int32, device=dev)
        nbytes = 4 * (N * mk * d + N * d * c * r + (r + 1) + N * d * c)
        b_ms, b_by = bound(nbytes, 2 * N * mk * d * (c * r + c))
        timings.append({
            "kernel": "coded_grad", "case": f"case1_c{c}_r{r}",
            "shape": [N, mk, d, c, r],
            "ms": time_ms(torch, lambda: cg.coded_grad(x, w, cbar, p), 20),
            "plain_ms": time_ms(
                torch, lambda: ref.coded_grad_workers_ref(x, w, cbar, p), 3),
            "bound_ms": b_ms, "bound_by": b_by})
    for t in timings:
        emit({"phase": "kernels", "timing": t})
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


def main() -> int:
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

    t0 = time.perf_counter()
    libs = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": {name: [ln for ln in (v.parent / f"{name}.log").read_text()
                           .splitlines() if "registers" in ln or "spill" in ln]
                    for name, v in libs.items()
                    if (v.parent / f"{name}.log").exists()}})

    checks = Checks(torch)
    timings = phase_kernels(torch, checks)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    train = phase_train(torch, out_dir)
    phase_teacher(torch)

    main_case = {"modmatmul": "dataset_encode", "coded_grad": "case1_c1_r1"}
    replaces = {
        "modmatmul": "src/repro/kernels/modmatmul.py:94",
        "coded_grad": "src/repro/kernels/coded_grad.py:117",
    }
    kernels = []
    for name in ("coded_grad", "modmatmul"):
        t = next(x for x in timings
                 if x["kernel"] == name and x["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": train["launches"][name],
            "max_abs_err": checks.max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
