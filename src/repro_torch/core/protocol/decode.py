"""Decode stage: survivor pattern -> decode matrix -> field decode -> real.

Mirrors ``repro/core/protocol/decode.py``.  The batch decode: the decode
matrix of a survivor set is built on the host (cached per pattern) and
applied as one field matmul (``modmatmul`` on the card).  The streaming
decode (``DecodePlan``, ``prefix_decode_plan``, ``StreamingDecoder``)
folds worker results on the host in numpy, as the reference does: its
inputs arrive one at a time off the wire, as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import field, quantize
from repro_torch.core.lagrange import CodingScheme
from repro_torch.core.protocol.config import CPMLConfig


def make_decode_matrix(cfg: CPMLConfig, survivors: np.ndarray,
                       device: str | torch.device = "cpu") -> torch.Tensor:
    """(R, K) int32 decode matrix of the first ``threshold`` survivors."""
    surv = np.asarray(survivors)[: cfg.threshold]
    return torch.as_tensor(
        _cached_decode_matrix(cfg.scheme, tuple(int(i) for i in surv)),
        dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=512)
def _cached_decode_matrix(scheme: CodingScheme, survivors: tuple[int, ...]
                          ) -> np.ndarray:
    """Host Lagrange-coefficient solve, cached per (scheme, pattern)."""
    return scheme.decode_matrix(np.asarray(survivors))


def decode_parts(cfg: CPMLConfig, results: torch.Tensor,
                 decode_mat: torch.Tensor) -> torch.Tensor:
    """Recover the K per-part field results h(beta_k) from survivors.

    results: (R, d, c) evaluations h(alpha_i) in survivor order.
    Returns (K, d, c), exactly X̄_kᵀ ḡ(X̄_k, W̄) mod p.
    """
    flat = results.reshape(results.shape[0], -1)
    out = field.matmul(decode_mat.T.contiguous(), flat.contiguous(), cfg.p)
    return out.reshape(cfg.K, *results.shape[1:])


def parts_to_gradient(cfg: CPMLConfig, parts: torch.Tensor) -> torch.Tensor:
    """(K, d, c) decoded field parts -> real (d, c) gradient."""
    return quantize.dequantize(parts, cfg.grad_scale, cfg.p).sum(dim=0)


def decode_gradient(cfg: CPMLConfig, results: torch.Tensor,
                    decode_mat: torch.Tensor) -> torch.Tensor:
    """Decode the K sub-gradients and sum them in the real domain, which
    buys log2(K) bits of wrap-around headroom per part.  (R, d, c) -> (d, c).
    """
    return parts_to_gradient(cfg, decode_parts(cfg, results, decode_mat))


# ---------------------------------------------------------------------------
# Streaming threshold decode (DESIGN.md §9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Decode-coefficient structure for one PREDICTED responder subset.

    ``cols[w]`` is worker w's (K,) Lagrange coefficient column for the
    predicted first-`threshold` responder SET.  The column depends only on
    (set, w) — never on arrival order — and the decoded parts are
    order-invariant too (permuting survivors permutes D's rows and the
    result rows consistently; exact mod-p sums commute).  So the streaming
    fold hits whenever the observed threshold SET matches the prediction,
    in ANY arrival order — the stable quantity under persistent stragglers.
    Built (plus plausible one-displacement variants, cache-warmed) by
    ``prefix_decode_plan`` ahead of the round, off the critical path.
    """
    subset: frozenset[int]          # predicted first-`threshold` responders
    cols: dict[int, np.ndarray]     # worker -> (K,) int64 coefficients


def prefix_decode_plan(cfg: CPMLConfig, predicted: np.ndarray | None
                       ) -> DecodePlan | None:
    """Precompute decode coefficients for a predicted responder prefix.

    ``predicted`` is any observed/forecast arrival order with at least
    ``threshold`` entries (shorter predictions yield no plan).  Besides the
    predicted threshold prefix itself, the host decode-matrix cache is
    warmed for every plausible NEAR-MISS subset prefix: each single
    displacement where one predicted responder is late and the next
    predicted worker slides into the threshold set — so even a fallback
    decode usually finds its coefficients precomputed.
    """
    if predicted is None:
        return None
    pred = [int(w) for w in np.asarray(predicted).ravel()]
    R = cfg.threshold
    if len(pred) < R:
        return None
    prefix = tuple(pred[:R])
    dmat = np.asarray(_cached_decode_matrix(cfg.scheme, prefix), np.int64)
    if len(pred) > R:
        nxt = pred[R]
        for i in range(R):                   # one-displacement variants
            variant = prefix[:i] + prefix[i + 1:] + (nxt,)
            _cached_decode_matrix(cfg.scheme, variant)
    return DecodePlan(subset=frozenset(prefix),
                      cols={w: dmat[i] for i, w in enumerate(prefix)})


class StreamingDecoder:
    """Fold survivor shares into the Lagrange reconstruction as they arrive.

    Host-side exact integer arithmetic mod p (int64 never overflows: each
    coefficient-share product is < p^2 < 2^60 and the accumulator is
    reduced after every fold).  With a plan whose predicted SUBSET matches
    the observed threshold responders (any arrival order), the decode
    remaining after the threshold-th share lands is ONE fold; on a miss
    (or with no plan) ``finish`` batch-decodes the retained shares over
    the observed order.  All paths produce the same bits as
    ``decode_parts`` on device.
    """

    def __init__(self, cfg: CPMLConfig, plan: DecodePlan | None = None):
        self.cfg = cfg
        self.plan = plan
        self._R = cfg.threshold
        self._shares: dict[int, np.ndarray] = {}   # worker -> (d, c) field
        self._arrived: list[int] = []              # accepted arrival order
        self._acc: np.ndarray | None = None        # (K, d*c) int64 mod p
        self._on_plan = plan is not None
        self.streamed = False                      # set by finish()

    def fold(self, worker: int, result) -> None:
        """Ingest one accepted arrival (in order).  O(K * d * c) when it
        belongs to the predicted subset; O(d * c) bookkeeping otherwise."""
        worker = int(worker)
        h = np.asarray(result, dtype=np.int32)
        pos = len(self._arrived)
        self._arrived.append(worker)
        self._shares[worker] = h
        if pos >= self._R:
            return                                  # beyond the threshold
        if not (self._on_plan and worker in self.plan.cols):
            self._on_plan = False                   # off-subset arrival in
            return                                  # the threshold prefix
        col = self.plan.cols[worker]                # (K,) int64 < p
        prod = col[:, None] * h.reshape(-1).astype(np.int64)    # < p^2
        if self._acc is None:
            self._acc = prod % self.cfg.p
        else:
            self._acc = (self._acc + prod) % self.cfg.p

    def finish(self, order: np.ndarray) -> np.ndarray:
        """Decoded (K, d, c) field parts for the OBSERVED first-threshold
        responder ``order`` — streamed accumulator on a subset-prediction
        hit (any arrival order), batch fallback otherwise."""
        order_t = tuple(int(w) for w in np.asarray(order).ravel())[: self._R]
        assert len(order_t) == self._R, (
            f"{len(order_t)} responders < threshold {self._R}")
        shape = next(iter(self._shares.values())).shape
        if (self._on_plan and self._acc is not None
                and frozenset(self._arrived[: self._R]) == self.plan.subset
                and frozenset(order_t) == self.plan.subset):
            self.streamed = True
            return self._acc.reshape(self.cfg.K, *shape).astype(np.int32)
        dmat = np.asarray(_cached_decode_matrix(self.cfg.scheme, order_t),
                          np.int64)                  # (R, K)
        acc = np.zeros((self.cfg.K, int(np.prod(shape))), np.int64)
        for i, w in enumerate(order_t):             # reduce after each fold:
            h = self._shares[w].reshape(-1).astype(np.int64)
            acc = (acc + dmat[i][:, None] * h) % self.cfg.p
        self.streamed = False
        return acc.reshape(self.cfg.K, *shape).astype(np.int32)
