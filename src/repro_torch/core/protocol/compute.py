"""Compute stage: the worker polynomial f (paper Eq. 20).

Mirrors ``repro/core/protocol/compute.py``.  f(X̃, W̃) = X̃ᵀ ḡ(X̃, W̃) over
F_p, c one-vs-all heads over the same share: W̃ (d, c, r) -> (d, c).

The reference's ``jax.vmap`` over workers is a written-out worker axis
here: on the GPU all N workers go through ONE ``coded_grad`` kernel call
(one launch, or two when each worker's rows are split across blocks), for
any number of heads c and degree r, as in the reference; on the CPU the
plain version runs.  The reference's ``use_kernel`` flag has no
counterpart, since the device decides.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.kernels import ops


def all_worker_results(cfg: CPMLConfig, cbar: torch.Tensor,
                       x_shares: torch.Tensor, w_shares: torch.Tensor
                       ) -> torch.Tensor:
    """(N, mk, d) x (N, d, c, r) -> (N, d, c) worker results."""
    return ops.coded_grad(x_shares, w_shares, cbar.to(torch.int32), cfg.p)


def worker_fn(cfg: CPMLConfig, cbar: torch.Tensor
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """f(X̃, W̃) for ONE worker: (mk, d), (d, c, r) -> (d, c).

    The binary shape (d, r) is also accepted and returns (d,).
    """

    def f(x_share: torch.Tensor, w_share: torch.Tensor) -> torch.Tensor:
        if w_share.ndim == 2:
            return f(x_share, w_share[:, None, :])[:, 0]
        return all_worker_results(cfg, cbar, x_share[None], w_share[None])[0]

    return f
