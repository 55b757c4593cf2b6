"""The randomness seam of the protocol, in one place.

Every random draw the protocol makes goes through a draws object with
three methods:

  dataset_masks(T, mk, d, p)      -> (T, mk, d) int32 privacy masks, drawn
                                     once for the dataset encode
  round(t, wbar_shape, T, p)      -> (uniforms (*wbar_shape) float32,
                                      masks (T, *wbar_shape) int32) for round
                                     t's weight quantization and encode
  batch(t, mk, rows)              -> (rows,) int64 distinct row indices of
                                     round t's coded sub-batch

``TorchDraws`` draws everything on a CPU ``torch.Generator`` seeded from
(seed, purpose, round), then moves it to its device: a CPU run and a CUDA
run see the same bits, and round t's draws do not depend on which rounds
ran before.  The reference draws with ``jax.random`` (threefry); the port's
tests hand its draws to the port through an object with the same methods.
"""
from __future__ import annotations

import hashlib

import torch


class TorchDraws:
    def __init__(self, seed: int, device: str | torch.device = "cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _gen(self, *tags) -> torch.Generator:
        digest = hashlib.sha256(repr((self.seed,) + tags).encode()).digest()
        return torch.Generator().manual_seed(
            int.from_bytes(digest[:8], "little") >> 1)

    def dataset_masks(self, T: int, mk: int, d: int, p: int) -> torch.Tensor:
        g = self._gen("dataset")
        return torch.randint(0, p, (T, mk, d), generator=g,
                             dtype=torch.int32).to(self.device)

    def round(self, t: int, wbar_shape: tuple[int, ...], T: int, p: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self._gen("round", int(t))
        u = torch.rand(tuple(wbar_shape), generator=g, dtype=torch.float32)
        masks = torch.randint(0, p, (T, *wbar_shape), generator=g,
                              dtype=torch.int32)
        return u.to(self.device), masks.to(self.device)

    def batch(self, t: int, mk: int, rows: int) -> torch.Tensor:
        if rows > mk:
            raise ValueError(f"batch_rows={rows} exceeds the {mk} rows per "
                             f"encoded part (padded m / K)")
        g = self._gen("batch", int(t))
        return torch.randperm(mk, generator=g)[:rows].to(self.device)
