"""Faults planted underneath the program's timed path, to show that the
comparison catches them (``check.py`` on the card, the tests on the CPU).

  unchanged   the gradient step returns the weights it was given
  half_batch  every worker computes on the first half of its share's rows,
              and the result is doubled: the mean over the rest
  altered     one worker's result is off by one where it is produced
  weak_masks  the masks of the dataset and of every round are drawn as
              before but kept below 2^16: in F_p, and far from uniform

A one-card cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_batch", "altered", "weak_masks")


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.core import field
    from repro_torch.core.protocol import compute, draws, engine
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    if name == "weak_masks":
        cls = draws.TorchDraws
        saved = (cls.dataset_masks, cls.round)

        def dataset_masks(self, *args):
            return saved[0](self, *args) % (1 << 16)

        def round_(self, *args):
            u, masks = saved[1](self, *args)
            return u, masks % (1 << 16)
        cls.dataset_masks, cls.round = dataset_masks, round_
        try:
            yield
        finally:
            cls.dataset_masks, cls.round = saved
        return
    if name == "unchanged":
        module, attr = engine, "_update_from_parts"

        def broken(cfg, state, w2, parts, batch_idx, eta):
            return w2
    else:
        module, attr = compute, "all_worker_results"
        orig = compute.all_worker_results

        def broken(cfg, cbar, x, w):
            if name == "half_batch":
                res = orig(cfg, cbar, x[:, : max(1, x.shape[1] // 2)]
                           .contiguous(), w)
                return field.addmod(res, res, cfg.p)
            res = orig(cfg, cbar, x, w).clone()
            res[0, 0, 0] = (res[0, 0, 0] + 1) % cfg.p
            return res
    saved = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, saved)
