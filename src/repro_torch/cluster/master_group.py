"""Sharded master group: split the master's Lagrange coding over d.

Mirrors ``repro/cluster/master_group.py``.  The master serializes all
encode/decode work for the full model dimension d each round; past a few
thousand features that serial coding, not the workers, caps round
throughput.  The Lagrange encode (Uᵀ applied along the K+T axis) and the
streaming decode fold are elementwise-linear across d, so a group of S
masters can each own a contiguous d-slice and run the dataset encode, the
per-round weight encode and the streaming decode on 1/S of the columns,
bit-identically.

The ONE rule that keeps sharding bit-identical: ALL RANDOMNESS IS DRAWN AT
FULL SHAPE.  The quantization uniforms and the T privacy masks come from
the draws seam (core/protocol/draws.py: ``draws.dataset_masks(...)``,
``draws.round(t, ...)``) once, for the whole model; only the
deterministic linear algebra (encode rows, addmod, decode folds) runs per
shard.  Privacy is unchanged for the same reason: the group holds exactly
the masks a single master would hold.

Each master's encode is one master's own, on its d-slice:
``lagrange.encode`` / ``encode_data``, exact mod p, where the tensors lie
(on the card one ``modmatmul`` launch a master).  On the card each master
runs on its own CUDA stream and its seconds are the span between two CUDA
events on that stream; on the CPU each runs on its own single-thread
executor and its seconds are PER-THREAD CPU seconds
(``time.thread_time``), so where the threads timeslice each still
measures exactly that master's share.  The streaming decode's results
arrive as host arrays off the wire, as for one master; each shard's folds
run on its master's executor, timed the same way.  ``group_stats``'s
critical path (the largest master's encode + decode) estimates the group's
wall-clock where the S masters are separate processes.

Differences from the reference: the encode runs where the tensors lie (the
reference's is host int64 numpy, ``_host_encode_rows``); the dataset
encode takes a draws object where the reference takes a key, and returns
the shares on x's device (the engine keeps its state there); the round
encode takes (draws, t) or the prefetched (uniforms, mask shares) and
returns numpy for the wire, as the reference's.
"""
from __future__ import annotations

import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import field, lagrange, quantize
from repro_torch.core.protocol import decode, encode
from repro_torch.core.protocol.config import CPMLConfig


def d_shard_slices(cfg: CPMLConfig, d: int, size: int) -> list[slice]:
    """Contiguous d-slices for a master group of ``size``: np.array_split's
    balanced blocks (sizes differ by at most one), so every master's share
    is within one column of 1/S.

    The reference first asks a local mesh and the divisible-or-replicate
    rules whether d shards evenly over the model axis; where it does, its
    equal blocks are these same blocks, so the port does not consult its
    placement modules (launch/mesh.py, parallel/rules.py).  ``cfg`` keeps
    the reference's signature.
    """
    size = max(1, min(int(size), d))
    step, extra = divmod(d, size)
    bounds = [i * step + min(i, extra) for i in range(size + 1)]
    return [slice(bounds[i], bounds[i + 1]) for i in range(size)]


class ShardedStreamingDecoder:
    """S per-shard ``decode.StreamingDecoder``s behind the one-decoder
    interface.

    Each shard's decoder runs on its master's single-thread executor, so
    same-shard folds keep arrival order while shards overlap each other
    (and the collect loop).  The DecodePlan is shared: its coefficient
    columns are (K,) per worker, d-independent, so every shard predicts
    and hits alike and ``streamed`` agrees across shards.
    """

    def __init__(self, cfg: CPMLConfig, plan, slices: list[slice],
                 pools: list[ThreadPoolExecutor], walls: list[dict]):
        self.cfg = cfg
        self._slices = slices
        self._pools = pools
        self._walls = walls
        self._decs = [decode.StreamingDecoder(cfg, plan) for _ in slices]
        self._futs: list = []
        self.streamed = False

    def _timed(self, s: int, fn, *args):
        # thread_time: this master's own CPU seconds (see MasterGroup)
        t0 = _time.thread_time()
        try:
            return fn(*args)
        finally:
            self._walls[s]["decode_s"] += _time.thread_time() - t0

    def fold(self, worker: int, result) -> None:
        h = np.asarray(result, dtype=np.int32)
        self._futs = [
            pool.submit(self._timed, s, self._decs[s].fold, worker, h[sl])
            for s, (sl, pool) in enumerate(zip(self._slices, self._pools))]

    def finish(self, order: np.ndarray) -> np.ndarray:
        for f in self._futs:            # the last fold lands before finish
            f.result()
        futs = [pool.submit(self._timed, s, self._decs[s].finish, order)
                for s, pool in enumerate(self._pools)]
        parts = [f.result() for f in futs]
        self.streamed = all(d.streamed for d in self._decs)
        return np.concatenate(parts, axis=1)        # (K, d, c) along d


class MasterGroup:
    """S logical masters, each owning a contiguous 1/S slice of d.

    The master-side coding surfaces the runner uses: ``encode_dataset``
    (provision time, through ``engine.setup``'s ``dataset_encoder`` hook),
    ``encode_round_shares`` / ``encode_round_shares_split`` (the per-round
    weight encode) and ``make_decoder`` (the per-round streaming decode).
    Each is bit-identical to the single-master engine path: randomness at
    full shape, linear algebra per shard, exact mod p.
    """

    def __init__(self, cfg: CPMLConfig, size: int = 1):
        if size < 1:
            raise ValueError(f"master group size {size} < 1")
        self.cfg = cfg
        self.size = int(size)
        self._pools: list[ThreadPoolExecutor] = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"master{i}")
            for i in range(self.size)]
        # per-master seconds (group_stats)
        self.walls: list[dict[str, float]] = [
            {"encode_s": 0.0, "decode_s": 0.0} for _ in range(self.size)]
        self._slices: dict[int, list[slice]] = {}
        self._streams: dict[torch.device, list] = {}

    # -- plumbing -------------------------------------------------------

    def close(self) -> None:
        for p in self._pools:
            p.shutdown(wait=True)

    def __enter__(self) -> "MasterGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def slices(self, d: int) -> list[slice]:
        """This group's d-slices, worked out once per d."""
        if d not in self._slices:
            self._slices[d] = d_shard_slices(self.cfg, d, self.size)
        return self._slices[d]

    def _per_master(self, d: int, device: torch.device,
                    fn: Callable[[slice], torch.Tensor]) -> list[torch.Tensor]:
        """``fn(sl)`` for each master's d-slice, its seconds added to that
        master's encode: on the card on the master's own stream between two
        CUDA events (launched from this thread, one master after another),
        on the CPU on its executor thread in ``thread_time``."""
        slices = self.slices(d)
        if device.type != "cuda":
            def one(s: int, sl: slice) -> torch.Tensor:
                t0 = _time.thread_time()
                try:
                    return fn(sl)
                finally:
                    self.walls[s]["encode_s"] += _time.thread_time() - t0

            futs = [pool.submit(one, s, sl)
                    for s, (sl, pool) in enumerate(zip(slices, self._pools))]
            return [f.result() for f in futs]
        cur = torch.cuda.current_stream(device)
        if device not in self._streams:
            self._streams[device] = [torch.cuda.Stream(device)
                                     for _ in range(self.size)]
        streams = self._streams[device]
        outs, spans = [], []
        for sl, st in zip(slices, streams):
            st.wait_stream(cur)                 # the full-shape inputs
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(st):
                start.record(st)
                out = fn(sl)
                end.record(st)
            out.record_stream(cur)              # read by the caller's stream
            outs.append(out)
            spans.append((start, end))
        for s, ((start, end), st) in enumerate(zip(spans, streams)):
            end.synchronize()
            self.walls[s]["encode_s"] += start.elapsed_time(end) / 1e3
            cur.wait_stream(st)
        return outs

    def _parts(self, u: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
        """W̄ (d, c, r) quantized at full shape from the round's full-shape
        uniforms, as the K data parts (a view)."""
        wbar = quantize.quantize_weights(w2, u.to(w2.device), self.cfg.lw,
                                         self.cfg.p)
        return wbar[None].expand(self.cfg.K, *wbar.shape)

    # -- provision-time dataset encode ----------------------------------

    def encode_dataset(self, cfg: CPMLConfig, draws, x: torch.Tensor
                       ) -> tuple[torch.Tensor, dict[str, Any]]:
        """Sharded twin of ``encode.encode_dataset`` (same signature, so it
        plugs into ``engine.setup``'s ``dataset_encoder`` hook): the
        quantization and the T masks at full shape, only the (K+T)-row
        encode per d-shard.  Shares (N, m/K, d) int32 on x's device."""
        xq = encode.pad_rows(quantize.quantize_data(x, cfg.lx, cfg.p), cfg.K)
        mk = xq.shape[0] // cfg.K
        d = xq.shape[-1]
        parts = xq.reshape(cfg.K, mk, d)
        masks = draws.dataset_masks(cfg.T, mk, d, cfg.p).to(x.device)
        shares = self._per_master(d, x.device, lambda sl: lagrange.encode(
            cfg.scheme, parts[..., sl], masks[..., sl], cfg.p))
        return (torch.cat(shares, dim=2),
                {"xq": xq, "m_padded": int(xq.shape[0])})

    # -- per-round weight encode ----------------------------------------

    def encode_round_shares(self, draws, t: int, w2: torch.Tensor
                            ) -> np.ndarray:
        """Sharded twin of ``engine.encode_round_shares``: round t's draws
        at full shape, the encode per shard.  (N, d, c, r) int32."""
        cfg = self.cfg
        u, masks = draws.round(t, (*w2.shape, cfg.r), cfg.T, cfg.p)
        parts = self._parts(u, w2)
        masks = masks.to(w2.device)
        shares = self._per_master(w2.shape[0], w2.device,
                                  lambda sl: lagrange.encode(
                                      cfg.scheme, parts[:, sl], masks[:, sl],
                                      cfg.p))
        return torch.cat(shares, dim=1).cpu().numpy()

    def encode_round_shares_split(self, u: torch.Tensor,
                                  mask_shares: torch.Tensor,
                                  w2: torch.Tensor) -> np.ndarray:
        """Sharded twin of ``engine.encode_round_shares_split``: the
        W-dependent finish only, from the prefetched uniforms and mask
        shares (``engine.round_mask_context``): quantize at full shape, then
        per shard the K-row data encode plus the masks' contribution."""
        cfg = self.cfg
        parts = self._parts(u, w2)
        mask_shares = mask_shares.to(w2.device)
        shares = self._per_master(w2.shape[0], w2.device,
                                  lambda sl: field.addmod(
                                      lagrange.encode_data(
                                          cfg.scheme, parts[:, sl], cfg.p),
                                      mask_shares[:, sl], cfg.p))
        return torch.cat(shares, dim=1).cpu().numpy()

    # -- per-round decode ------------------------------------------------

    def make_decoder(self, plan, d: int) -> ShardedStreamingDecoder:
        """A sharded streaming decoder over this group's executors."""
        slices = self.slices(d)
        return ShardedStreamingDecoder(self.cfg, plan, slices,
                                       self._pools[: len(slices)],
                                       self.walls)

    # -- accounting ------------------------------------------------------

    def group_stats(self) -> dict[str, Any]:
        """Per-master encode/decode seconds and the group's critical path:
        the largest master's encode + decode, the group's wall-clock where
        the S masters run as separate processes."""
        per = [dict(w) for w in self.walls]
        return {
            "size": self.size,
            "per_master": per,
            "encode_total_s": float(sum(w["encode_s"] for w in per)),
            "decode_total_s": float(sum(w["decode_s"] for w in per)),
            "critical_path_s": float(max(
                w["encode_s"] + w["decode_s"] for w in per)),
        }
