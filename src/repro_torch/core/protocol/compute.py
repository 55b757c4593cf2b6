"""Compute stage: the worker polynomial f (paper Eq. 20), per backend.

Mirrors ``repro/core/protocol/compute.py``.  f(X̃, W̃) = X̃ᵀ ḡ(X̃, W̃) over
F_p, c one-vs-all heads over the same share: W̃ (d, c, r) -> (d, c).

  * ``"vmap"``: the reference's ``jax.vmap`` over workers is a written-out
    worker axis here: on the GPU all N workers go through ONE
    ``coded_grad`` kernel call (one launch, or two when each worker's rows
    are split across blocks), for any number of heads c and degree r.
  * ``"shard"``: one coded share a rank along ``cfg.mesh_axis`` of the
    ambient mesh (``parallel/compat.py``), whose size must be N: each rank
    runs its own share through one ``coded_grad`` call with a worker axis
    of 1, with no collective in the worker step, and one ``all_gather``
    ("send results to the master") gives every rank all N results, so
    that the decode runs, replicated, on every rank.

On the CPU the plain version runs.  The reference's ``use_kernel`` flag
has no counterpart, since the device decides.

Timing (off by default): while ``TIMES`` is a list, each call of
``all_worker_results`` appends its marks: before the worker step, after
it and, under ``"shard"``, after the all_gather.  On the card a mark is a
CUDA event on the current stream (no synchronisation is added), on the
CPU the host clock; ``marks_ms`` reads the gaps once the work is done.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.kernels import ops
from repro_torch.parallel import compat

TIMES: list[list] | None = None


def _mark(marks: list | None, device: torch.device) -> None:
    if marks is None:
        return
    if device.type == "cuda":
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)
    else:
        marks.append(time.perf_counter())


def marks_ms(marks: list) -> list[float]:
    """The ms between successive marks of one call (its work done)."""
    return [a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
            else (b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def _workers(cfg: CPMLConfig, cbar: torch.Tensor, x_shares: torch.Tensor,
             w_shares: torch.Tensor) -> torch.Tensor:
    return ops.coded_grad(x_shares, w_shares, cbar.to(torch.int32), cfg.p)


def all_worker_results(cfg: CPMLConfig, cbar: torch.Tensor,
                       x_shares: torch.Tensor, w_shares: torch.Tensor
                       ) -> torch.Tensor:
    """(N, mk, d) x (N, d, c, r) -> (N, d, c) worker results."""
    marks = None
    if TIMES is not None:
        marks = []
        TIMES.append(marks)
    dev = x_shares.device
    _mark(marks, dev)
    if cfg.backend == "vmap":
        res = _workers(cfg, cbar, x_shares, w_shares)
        _mark(marks, dev)
        return res
    mesh = compat.ambient_mesh()
    axis = cfg.mesh_axis
    size = compat.axis_size(axis, mesh)
    if size != cfg.N:
        # the body runs one share a rank: a smaller axis would drop shares
        raise ValueError(f"backend 'shard' needs mesh axis {axis!r} of size "
                         f"N={cfg.N}, got {size}")

    def shard_body(xs: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
        res = _workers(cfg, cbar, xs, ws)                       # (1, d, c)
        _mark(marks, dev)
        out = compat.all_gather(res, axis, 0, tiled=True)      # (N, d, c)
        _mark(marks, dev)
        return out

    return compat.shard_map(shard_body, mesh, ((axis,), (axis,)), ())(
        x_shares, w_shares)


def worker_fn(cfg: CPMLConfig, cbar: torch.Tensor
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """f(X̃, W̃) for ONE worker: (mk, d), (d, c, r) -> (d, c).

    The binary shape (d, r) is also accepted and returns (d,).
    """

    def f(x_share: torch.Tensor, w_share: torch.Tensor) -> torch.Tensor:
        if w_share.ndim == 2:
            return f(x_share, w_share[:, None, :])[:, 0]
        return _workers(cfg, cbar, x_share[None], w_share[None])[0]

    return f
