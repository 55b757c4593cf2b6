"""Pipelined round engine: prefetch W-independent work ahead of the decode.

A copy of ``repro/cluster/pipeline.py`` with two additions: a context
carries the CUDA event its consumer waits on, and a build that raises is
raised again by ``get`` (the reference's consumer would wait forever).

CodedPrivateML's per-round critical path is

    encode W̃ -> dispatch -> wait for the fastest `threshold` -> decode -> step

and only the WAIT involves the workers; encode and decode are master-side
serial time the sequential loop pays every round.  The data dependency is
narrow: round t+1's encode needs round t's DECODED WEIGHTS, but the round
key split, the T fresh privacy masks, their encoded contribution
(encode.weight_mask_shares), the mini-batch draw, and the decode-coefficient
structures for the plausible responder prefixes depend only on (kloop, t) —
they can all be computed while round t is still in flight (DESIGN.md §9).

``RoundPrefetcher`` runs a one-round-ahead producer thread with the same
single-slot mailbox discipline as data/loader.py's ``LMBatchLoader``
prefetch thread: the producer builds round t+1's W-independent
``RoundContext`` while the consumer (cluster/runner.py) is blocked in round
t's collect loop.  Unlike the loader, training can REWIND (checkpoint
restore replays earlier rounds), so ``get(t)`` for an unexpected t resets
the producer to t instead of asserting monotonicity.

Privacy is unaffected: the masks are the SAME fresh per-round draws the
sequential encode makes (identical key derivation), merely computed
earlier on the master — which holds them in either case.  Bit-identity is
structural: every context is a pure function of (cfg, kloop, t), so
prefetched rounds replay exactly (tests/test_pipeline.py).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np

from repro_torch.obs.trace import NULL_RECORDER

PIPELINE_MODES = ("off", "prefetch", "streaming", "full")


@dataclasses.dataclass
class RoundContext:
    """W-independent context for one round, built ahead of its dispatch."""
    t: int
    kq: Any                          # stochastic-quantization draw: the
                                     # reference's key, the port's uniforms
    mask_shares: Any                 # (N, d, c, r) encoded mask contribution
    batch_idx: Any | None            # (batch_rows,) or None
    plan: Any | None                 # decode.DecodePlan for the predicted
                                     # responder order (None = no prediction)
    next_batch: np.ndarray | None = None
                                     # round t+1's batch indices, shipped to
                                     # workers so they pre-slice while idle
                                     # (drawn here, off the critical path)
    ready: Any | None = None         # CUDA event recorded after the build's
                                     # launches; the consumer waits on it
                                     # before it reads the context (None on
                                     # the CPU)
    epoch: int = 0                   # membership epoch the context was built
                                     # under; a fence that bumped the epoch
                                     # invalidates only the PLAN (its
                                     # predicted responders referenced the
                                     # old fleet) — kq/masks/batch are pure
                                     # functions of (kloop, t), epoch-free


class RoundPrefetcher:
    """One-round-ahead producer of ``RoundContext``s.

    ``build_fn(t) -> RoundContext`` runs on the producer thread (the GIL is
    released while torch launches and copies and while the consumer blocks
    in a socket poll, so the build overlaps the in-flight round; the
    runner sends the build's launches to its own CUDA stream).  An
    exception in ``build_fn`` is raised again by the ``get`` that waits
    for it.  Use as a context manager or call
    ``close()``: like LMBatchLoader, the thread is joined on close so a
    finished run never leaks a producer.
    """

    def __init__(self, build_fn: Callable[[int], RoundContext],
                 start: int, stop: int, recorder=None):
        self._build = build_fn
        # flight-recorder hook (DESIGN.md §11): builds get their own
        # "prefetch" track so the overlap with the in-flight round is
        # visible in the waterfall; the default NullRecorder is a no-op
        self._obs = recorder if recorder is not None else NULL_RECORDER
        self._stop_t = stop
        self._cond = threading.Condition()
        self._next = start          # next t the producer should build
        self._ready: RoundContext | None = None
        self._halt = False
        self._error: Exception | None = None
        # the GATE times the overlap: after get(t) hands a context out the
        # producer stays parked until release() — called by the runner just
        # before it blocks in the collect loop — so the t+1 build competes
        # with the master's idle WAIT, never with its W-dependent encode
        # (which runs on the critical path right after get()).
        self._gate = True
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        while True:
            with self._cond:
                while not self._halt and (self._ready is not None
                                          or not self._gate
                                          or self._next >= self._stop_t):
                    self._cond.wait()
                if self._halt:
                    return
                t = self._next
            try:
                with self._obs.span("prefetch_build", track="prefetch",
                                    round=t):
                    ctx = self._build(t)            # heavy work, no lock
            except Exception as e:                  # handed to get()
                with self._cond:
                    self._error = e
                    self._cond.notify_all()
                return
            with self._cond:
                if self._halt:
                    return
                if self._next == t and self._ready is None:
                    self._ready = ctx               # else: a rewind raced
                    self._next = t + 1              # in; rebuild next loop
                    self._cond.notify_all()

    def get(self, t: int) -> RoundContext:
        """Round t's context: the prefetched one when the producer is on
        track, else (first round, or a rewind after checkpoint restore)
        reset the producer to t and wait for the fresh build.  Parks the
        producer until the next ``release()``."""
        with self._cond:
            if self._ready is not None and self._ready.t == t:
                ctx, self._ready = self._ready, None
                self._gate = False
                self._cond.notify_all()
                return ctx
            self._ready = None                       # stale or absent
            self._next = t
            self._gate = True                        # we NEED a build now
            self._cond.notify_all()
            while not (self._halt or self._error is not None
                       or (self._ready is not None and self._ready.t == t)):
                self._cond.wait()
            if self._error is not None:
                raise RuntimeError(
                    f"building round {t}'s context failed") from self._error
            if self._halt:
                raise RuntimeError("prefetcher closed while waiting")
            ctx, self._ready = self._ready, None
            self._gate = False
            self._cond.notify_all()
            return ctx

    def release(self) -> None:
        """Un-park the producer: the caller is about to block waiting on
        workers, so the next round's build can use the idle master."""
        with self._cond:
            self._gate = True
            self._cond.notify_all()

    def close(self) -> None:
        """Stop and JOIN the producer thread (idempotent)."""
        with self._cond:
            self._halt = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def __enter__(self) -> "RoundPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
