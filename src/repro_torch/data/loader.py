"""Synthetic LM batch loader with a prefetch thread; mirrors
``repro/data/loader.py``.

Deterministic (seed + step -> batch): the host draws each batch with the
reference's numpy formula, so the tokens are bit-identical to the
reference loader's, and a one-batch-ahead prefetch thread overlaps the
draw with the device's work.  Batches go to the caller's device or, with
``mesh=`` (a ``DeviceMesh``), become ``DTensor``s on it: every rank draws
the same global batch and keeps its own rows, the batch split over the
data axes where it divides their product and replicated otherwise, as the
reference's batch sharding.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np
import torch


class LMBatchLoader:
    """Use as a context manager (``with LMBatchLoader(...) as loader:``) or
    call ``close()`` explicitly: the prefetch thread is joined on close, so
    a finished run never leaks a producer blocked on a full queue.

    Yields {"tokens": (batch, seq), "labels": (batch, seq)} on ``device``
    in ``dtype`` (int64 by default; the reference's values are int32); with
    ``mesh``, global-shape ``DTensor``s on it laid out as ``placements()``
    (``device`` is then the rank's device of the mesh's type)."""

    def __init__(self, device: torch.device | str, batch: int, seq: int,
                 vocab: int, seed: int = 0, prefetch: int = 2,
                 dtype: torch.dtype = torch.int64, mesh=None):
        self.device, self.dtype, self.mesh = torch.device(device), dtype, mesh
        self.batch, self.seq, self.vocab, self.seed = batch, seq, vocab, seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def placements(self) -> tuple | None:
        """The batch's placements on the mesh (None without one): rows
        over the data axes ("pod", "data") where the batch divides their
        product, replicated otherwise."""
        if self.mesh is None:
            return None
        from repro_torch.parallel import rules

        names = self.mesh.mesh_dim_names
        axes = tuple(a for a in ("pod", "data") if a in names)
        total = math.prod(self.mesh.size(names.index(a)) for a in axes)
        rows = (axes if len(axes) > 1 else axes[0]) if axes else None
        if self.batch % total:
            rows = None
        return rules.placements(self.mesh, (rows, None))

    def _make(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _produce(self):
        step = 0
        while not self._stop.is_set():
            batch = self._make(step)
            try:
                self._q.put(batch, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        host = self._q.get()
        if self.mesh is not None:
            from torch.distributed.tensor import DTensor

            from repro_torch.parallel import rules

            pl = self.placements()
            return {k: DTensor.from_local(
                        rules.local_block(torch.from_numpy(v), self.mesh, pl)
                        .to(device=self.device, dtype=self.dtype),
                        self.mesh, pl, run_check=False)
                    for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device=self.device, dtype=self.dtype)
                for k, v in host.items()}

    def close(self):
        """Stop and JOIN the prefetch thread (idempotent).

        The producer may be blocked in a bounded-queue put; its 1s put
        timeout re-checks the stop flag, and draining the queue here
        unblocks it immediately instead.
        """
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "LMBatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
