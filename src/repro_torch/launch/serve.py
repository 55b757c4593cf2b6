"""Serving driver on the GPU: batched prefill + greedy decode, optionally
through the Lagrange-coded LM head; mirrors ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 2048 --gen 32 [--coded-head --kill-shard 2]

``--coded-head`` routes the vocab projection through ``core/coded_linear``:
the head is Lagrange-encoded over N shards (K data + T privacy masks), so
any K+T shard results give the exact field logits; ``--kill-shard i``
drops one.  Weights are random, drawn from ``--seed`` (the prompt from
seed+1, the head's masks from seed+2).  Runs on CUDA unless ``--device
cpu``.  It serves the dense models (tinyllama-1.1b, h2o-danube-3-4b,
qwen2-72b, mistral-large-123b, qwen2-vl-7b), falcon-mamba-7b, the hybrid
hymba-1.5b and the MoE ones (phi3.5-moe-42b-a6.6b, arctic-480b).  Like
the reference's driver it takes tokens only, so the encoder-decoder
whisper-tiny, which needs frame embeddings, exits 2; it is served through
``greedy_decode(..., enc_embeds=make_frames(...))``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.core import coded_linear as CL
from repro_torch.models import model as M
from repro_torch.parallel import rules


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_decode(cfg, rc, model, prompt, steps, coded=None, survivors=None,
                  stats: dict | None = None,
                  enc_embeds: torch.Tensor | None = None):
    """prompt: (B, S) tokens.  Returns (B, steps) generated tokens.

    An encoder-decoder model takes its frame embeddings ``enc_embeds``
    (B, Se, d): the encoder runs once, and the prefill and every decode
    step read its output.  On a mesh (a model placed by
    ``model.place_on_mesh``, the prompt and frames placed as
    ``registry.input_specs`` says) the cache stays placed throughout,
    and each step's token is the argmax of the gathered last-position
    logits, the same on every rank; the tokens come back placed as the
    prompt.  With a ``stats`` dict, the device is
    synchronised after the encoder, after the prefill and at the end, and
    ``encode_s`` (encoder-decoder models), ``prefill_s`` (the decoder's
    prefill) and ``decode_s`` (host clock) are recorded, with
    ``logits_finite``: whether every step's logits were finite.
    """
    if rules.is_dtensor(prompt):
        if coded is not None:
            raise ValueError("the coded head is not served on a mesh")
        if rules.rules_mesh() is None:
            with rules.use_rules_mesh(prompt.device_mesh):
                return greedy_decode(cfg, rc, model, prompt, steps,
                                     stats=stats, enc_embeds=enc_embeds)
    B, S = prompt.shape
    enc: dict = {}
    t0 = time.perf_counter()
    if enc_embeds is not None:
        enc["enc_out"] = M.encode(cfg, rc, model, enc_embeds)
        if stats is not None:
            _sync(prompt.device)
            stats["encode_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    logits, cache, h = M.prefill(cfg, rc, model, {"tokens": prompt, **enc},
                                 cache_len=S + steps, return_hidden=True)
    if stats is not None:
        _sync(prompt.device)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    logits = rules.full(logits)
    finite = torch.isfinite(logits).all()
    outs = []
    for _ in range(steps):
        if coded is not None:
            # coded path: project the REAL post-final-norm hidden state
            # through the Lagrange-coded head instead of lm_head
            lg = CL.coded_head_apply(coded["cfg"], h[:, -1].float(),
                                     coded["shares"], survivors=survivors)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            finite &= torch.isfinite(lg).all()
        else:
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        outs.append(tok)
        logits, cache, h = M.decode_step(cfg, rc, model, cache,
                                         {"tokens": _like(tok, prompt),
                                          **enc},
                                         return_hidden=True)
        logits = rules.full(logits)
        finite &= torch.isfinite(logits).all()
    toks = _like(torch.cat(outs, dim=1), prompt)
    if stats is not None:
        _sync(prompt.device)
        stats["decode_s"] = time.perf_counter() - t1
        stats["logits_finite"] = bool(finite)
    return toks


def _like(tok: torch.Tensor, prompt: torch.Tensor) -> torch.Tensor:
    """Tokens (B, n) laid out as the prompt: on a mesh its batch
    placement, the tokens' ``input_specs`` spec (batch over the data axes
    where it divides, the rest whole)."""
    if not rules.is_dtensor(prompt):
        return tok
    return rules.distribute(tok, prompt.device_mesh, prompt.placements)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="batched prefill + greedy decode "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--coded-head", action="store_true")
    ap.add_argument("--coded-k", type=int, default=4)
    ap.add_argument("--coded-t", type=int, default=1)
    ap.add_argument("--coded-n", type=int, default=6)
    ap.add_argument("--kill-shard", type=int, default=-1,
                    help="simulate loss of one coded head shard")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json-out", type=str, default=None,
                    help="write timings, tokens and coded-head numbers here")
    return ap


def coded_head_check(ccfg: CL.CodedLinearConfig, h: torch.Tensor,
                     w: torch.Tensor, shares: torch.Tensor,
                     survivors: np.ndarray | None) -> dict:
    """Coded head vs the uncoded projection h @ w on h (m, d) float32."""
    lg = CL.coded_head_apply(ccfg, h, shares, survivors=survivors)
    ref = h @ w
    return {"rel_err": float((lg - ref).abs().max() / (ref.abs().max() + 1e-9)),
            "argmax_agreement": float((lg.argmax(-1) == ref.argmax(-1))
                                      .float().mean())}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = registry.reduced_config(cfg)
    if cfg.is_encoder_decoder:
        print(f"error: {cfg.name} needs frame embeddings (batch['enc_embeds'])"
              ", which this driver does not take: like the reference's "
              "(repro/launch/serve.py:27), it serves tokens only; call "
              "serve.greedy_decode(..., enc_embeds=make_frames(...))",
              file=sys.stderr)
        return 2
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rc = RunConfig(q_block=min(512, args.prompt_len),
                   kv_block=min(1024, args.prompt_len),
                   scan_chunk=min(128, args.prompt_len))
    with torch.inference_mode():
        return _serve(args, cfg, rc, dev)


def make_prompt(cfg, batch: int, prompt_len: int, seed: int,
                dev: torch.device) -> torch.Tensor:
    """The random (batch, prompt_len) prompt of seed ``seed`` + 1."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, dtype=torch.int32, device=dev)


def make_frames(cfg, batch: int, seed: int, dev: torch.device
                ) -> torch.Tensor:
    """Stub frame embeddings (batch, cfg.encoder_seq_len, d_model) in bf16,
    standard normal from seed ``seed`` + 3: what the audio frontend, a stub
    in the reference too, would hand the encoder."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    return torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                       generator=gen, device=dev).to(torch.bfloat16)


def encode_head(cfg, model: M.Model, ccfg: CL.CodedLinearConfig, seed: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The LM head in float32, cut to a multiple of K columns, and its coded
    shares with masks drawn from seed ``seed`` + 2."""
    w = (model.embed.T if cfg.tie_embeddings else model.lm_head).float()
    w = w[:, : w.shape[1] - w.shape[1] % ccfg.K]
    gen = torch.Generator(device=w.device).manual_seed(seed + 2)
    return w, CL.encode_weights(ccfg, w, gen=gen)


def _serve(args, cfg, rc, dev: torch.device) -> int:
    model = M.Model(cfg, dtype=getattr(torch, rc.param_dtype), device=dev,
                    seed=args.seed)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, args.seed, dev)
    out: dict = {"arch": cfg.name, "device": str(dev), "batch": args.batch,
                 "prompt_len": args.prompt_len, "gen": args.gen}
    coded = None
    survivors = None
    if args.coded_head:
        ccfg = CL.CodedLinearConfig(N=args.coded_n, K=args.coded_k,
                                    T=args.coded_t)
        w, shares = encode_head(cfg, model, ccfg, args.seed)
        if args.kill_shard >= 0:
            survivors = np.array([i for i in range(ccfg.N)
                                  if i != args.kill_shard])
            print(f"killed shard {args.kill_shard}; decoding from "
                  f"{len(survivors)} survivors (threshold {ccfg.threshold})")
        # one-shot accuracy check on the prompt's hidden states before
        # generating: coded head vs the uncoded projection
        h, _ = M.backbone(cfg, rc, model, {"tokens": prompt})
        check = coded_head_check(ccfg, h[:, -1].float(), w, shares, survivors)
        print(f"coded head: rel err {check['rel_err']:.4f}, argmax agreement "
              f"{check['argmax_agreement']:.2%}, useful fraction K/N = "
              f"{args.coded_k}/{args.coded_n}")
        out["coded_head"] = check
        coded = {"cfg": ccfg, "shares": shares}
    stats: dict = {}
    toks = greedy_decode(cfg, rc, model, prompt, args.gen, coded=coded,
                         survivors=survivors, stats=stats)
    total = stats["prefill_s"] + stats["decode_s"]
    print(f"generated {tuple(toks.shape)} in {total:.2f}s "
          f"({args.batch * args.gen / total:.1f} tok/s): prefill "
          f"{stats['prefill_s']:.3f}s, decode {stats['decode_s']:.3f}s "
          f"({args.batch * args.gen / stats['decode_s']:.1f} tok/s)")
    print("sample:", toks[0].cpu().numpy()[:16])
    if args.json_out:
        out.update(stats, tokens=toks.cpu().tolist(),
                   decode_tok_per_s=args.batch * args.gen / stats["decode_s"])
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
