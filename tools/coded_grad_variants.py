#!/usr/bin/env python3
"""Time design variants of the ``coded_grad`` CUDA kernel on one card.

    python3 tools/coded_grad_variants.py [--out build/coded_grad_variants.jsonl]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is either a launch plan (``coded_grad.fixed_plan``: rows per
tile, ring stages, threads, residues in shared or global memory, column
chunk) run through the stock kernel, or a compile-time edit of
``csrc/coded_grad.cu`` built into ``build/coded_grad_variants/``.  Every
variant runs at Case 1's worker step (x (40, 954, 1568), p = P) with
c = 1, r = 1 and c = 10, r = 2; its output is compared with the plain
version (``bit_equal``; the ring-only variant skips the arithmetic and is
a floor, not a result) and its time is the CUDA-graph replay of 20 calls
(``chip_smoke.graph_ms``).  One JSON object per line, first the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

CASE1 = dict(N=40, mk=954, d=1568)
HEADS = ((1, 1), (10, 2))

# Compile-time variants: (name, [(text in coded_grad.cu, replacement)]).
LOOP_BUTTERFLY = '''template <int V, typename T>
__device__ __forceinline__ T warp_sum_many(T (&v)[V], int lane, uint32_t p) {
#pragma unroll
  for (int n = V, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const T send = upper ? v[q] : v[q + n / 2];
      const T keep = upper ? v[q + n / 2] : v[q];
      v[q] = sum2(keep, __shfl_xor_sync(0xffffffffu, send, o), p);
    }
  }
  T s = v[0];'''
EDITS = {
    # the arithmetic skipped: the ring's own speed
    "ring_only": [("    const uint32_t* xs = tile_x(t);\n",
                   "    if (prm.c > 0) { __syncthreads(); continue; }\n"
                   "    const uint32_t* xs = tile_x(t);\n")],
    # the warp butterfly as a loop with two induction variables
    "loop_butterfly": [('''template <int V, typename T>
__device__ __forceinline__ T warp_sum_many(T (&v)[V], int lane, uint32_t p) {
  halve<V, V>(v, lane, p);
  T s = v[0];''', LOOP_BUTTERFLY)],
    "no_unroll": [("CH == 1 ? 4 : 2;", "CH == 1 ? 1 : 1;")],
    "unroll_8_2": [("CH == 1 ? 4 : 2;", "CH == 1 ? 8 : 2;")],
    "no_min_blocks": [("__launch_bounds__(kMaxThreads, 2)",
                       "__launch_bounds__(kMaxThreads)")],
    "no_w_vector": [("const bool wvec = CH > 1 &&", "const bool wvec = false &&")],
    # rings of 3 and 4 stages (the plan uses 1 or 2)
    "deep_ring": [("      if (prm.stages == 2) cp_async_wait<1>();",
                   "      if (prm.stages == 4) cp_async_wait<3>();\n"
                   "      else if (prm.stages == 3) cp_async_wait<2>();\n"
                   "      else if (prm.stages == 2) cp_async_wait<1>();"),
                  ("q.stages > 2 ||", "q.stages > 4 ||")],
}


def edited_sources(src: str) -> dict[str, str]:
    out = {}
    for name, edits in EDITS.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"variant {name}: text not found: {old[:60]!r}")
            s = s.replace(old, new)
        out[name] = s
    return out


def build_variants(build, out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every edited source in parallel; returns the loaded libs."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "field.cuh").write_text((build.CSRC / "field.cuh").read_text())
    procs = {}
    for name, text in edited_sources((build.CSRC / "coded_grad.cu").read_text()).items():
        cu = out_dir / f"coded_grad_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.coded_grad_launch.argtypes = build._ARGTYPES["coded_grad_launch"]
        lib.coded_grad_launch.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "stack frame" in ln])
    return libs


def plans(cg, N, mk, d, c, r, sms, deep=False):
    """The plan's own launch, then the launch-plan variants; with ``deep``
    the rings of 3 and 4 stages instead (for the deep_ring kernel)."""
    base = cg.plan(N, mk, d, c, r, sms)
    out = {} if deep else {"plan": base}

    def add(name, rows, stages, part, threads, chunk=None):
        pl = cg.fixed_plan(N, mk, d, c, r, rows, stages, part, threads, 1)
        if chunk is not None:
            pl = dataclasses.replace(pl, chunk=chunk, smem=cg.smem_bytes(
                d, c, r, rows, stages, pl.group, chunk, threads, part))
        if pl.smem > cg.SMEM_OPTIN:
            return
        bps = cg.blocks_per_sm(pl.smem, threads)
        full = cg.fixed_plan(N, mk, d, c, r, rows, stages, part, threads,
                             sms * bps // N)
        out[name] = dataclasses.replace(full, chunk=pl.chunk, smem=pl.smem)

    if deep:
        for rows in (4, 8):
            for stages in (3, 4):
                add(f"rows{rows}_stages{stages}", rows, stages, base.part_smem, 256)
        return out
    add("residues_in_smem", 8, 2, True, 256)
    add("residues_in_global", 8, 2, False, 256)
    add("threads_128", 8, 2, base.part_smem, 128)
    add("rows4_stages2", 4, 2, base.part_smem, 256)
    if c * r > 2:
        add("chunk_2", 8, 2, base.part_smem, 256, chunk=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "coded_grad_variants.jsonl"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("coded_grad_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import field, sigmoid_poly
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import coded_grad as cg
    from repro_torch.kernels import modmatmul as mm

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sink = out.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    emit({"nvidia_smi": cs.nvidia_smi(), "torch": torch.__version__})
    stock = build.library("coded_grad")
    libs = {"stock": (stock, None)}
    libs.update(build_variants(build, build.BUILD_ROOT.parent / "coded_grad_variants"))
    for name, (_, ptxas) in libs.items():
        if ptxas:
            emit({"variant": name, "ptxas": ptxas})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = field.P
    N, mk, d = CASE1["N"], CASE1["mk"], CASE1["d"]
    sms = mm.sm_count(dev)
    for c, r in HEADS:
        x = torch.randint(0, p, (N, mk, d), generator=gen, dtype=torch.int32, device=dev)
        w = torch.randint(0, p, (N, d, c, r), generator=gen, dtype=torch.int32, device=dev)
        cbar = torch.as_tensor(sigmoid_poly.quantized_coeffs(r, 2, 4, 6, p),
                               dtype=torch.int32, device=dev)
        want = ref.coded_grad_workers_ref(x, w, cbar, p)
        runs = [("stock", name, pl, None) for name, pl in plans(cg, N, mk, d, c, r, sms).items()]
        base = runs[0][2]
        runs.append(("stock", "plan_sums_reduced", base, 0))
        runs += [(name, "plan", base, None) for name in libs if name != "stock"]
        runs += [("deep_ring", name, pl, None)
                 for name, pl in plans(cg, N, mk, d, c, r, sms, deep=True).items()]
        for lib_name, plan_name, pl, raw in runs:
            lib = libs[lib_name][0]
            prm = cg._params(pl, p)
            if raw is not None:
                prm = build.CodedGradParams(*(getattr(prm, f) for f, _ in prm._fields_))
                prm.raw = raw

            def call():
                res = torch.empty((N, d, c), dtype=torch.int32, device=dev)
                slot = (torch.empty((pl.splits, N, d, c), dtype=torch.int32, device=dev)
                        if pl.splits > 1 else None)
                err = lib.coded_grad_launch(
                    x.data_ptr(), w.data_ptr(), cbar.data_ptr(),
                    None if slot is None else slot.data_ptr(), res.data_ptr(), prm,
                    torch.cuda.current_stream().cuda_stream)
                build.check(err, "coded_grad")
                return res

            got = call()
            torch.cuda.synchronize()
            emit({"c": c, "r": r, "kernel": lib_name, "plan": plan_name,
                  "raw_sums": bool(prm.raw),
                  "launch": [pl.rows, pl.stages, pl.group, pl.chunk, pl.threads,
                             pl.splits, int(pl.part_smem), pl.smem],
                  "bit_equal": bool(torch.equal(got, want)),
                  "graph_ms": cs.graph_ms(torch, call, 20)})
        del x, w, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
