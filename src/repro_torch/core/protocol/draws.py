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

``TorchMPCDraws`` is the same seam for the BGW baseline
(core/mpc_baseline.py), with four methods:

  data_masks(T, m, d, p)          -> (T, m, d) int32 Shamir masks of the
                                     dataset, drawn once
  step(t, wbar_shape, T, p)       -> (uniforms (*wbar_shape) float32,
                                      masks (T, *wbar_shape) int32) for
                                     iteration t's weight quantization and
                                     weight shares
  reshare_seed(t, phase)          -> an int the master ships to every
                                     worker for one degree reduction
  reshare_masks(seed, worker, T, shape, p)
                                  -> (T, *shape) int32 masks with which
                                     ``worker`` re-shares its product
                                     share; a function of (seed, worker)
                                     alone, so a worker process draws its
                                     own from the shipped seed

``TorchServeDraws`` is the seam of the coded prediction server
(cluster/serve.py):

  weight_masks(T, shape, p)       -> (T, *shape) int32 masks of the model's
                                     encode, drawn once per provision
  flush_masks(t, T, shape, p)     -> (T, *shape) int32 fresh masks of flush
                                     t's query encode
  model_weights(shape)            -> float32 standard normals: the CLI's
                                     stand-in model (launch/cpml_serve.py)

``TorchALCCDraws`` is the seam of the ALCC float engine
(core/protocol/alcc_engine.py, cluster/alcc_mlp.py).  Its masks are
float32 standard normals that ``alcc.draw_masks`` scales by sigma:

  data_masks(shape)               -> (T, mk, d) masks of the dataset encode
  round_masks(t, shape)           -> (T, *shape) masks of coded round t (the
                                     MLP's rounds 2s and 2s+1 are step s's)
  batch(t, mk, rows)              -> as TorchDraws.batch
  mlp_init(d, hidden, c)          -> (w1 (d, hidden), w2 (hidden, c))
                                     float32 initial MLP weights, normals
                                     over sqrt(fan-in)
"""
from __future__ import annotations

import hashlib
import math

import torch


def _seed_of(*tags) -> int:
    """A 63-bit integer from the tags' repr."""
    digest = hashlib.sha256(repr(tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class TorchDraws:
    def __init__(self, seed: int, device: str | torch.device = "cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _gen(self, *tags) -> torch.Generator:
        return torch.Generator().manual_seed(_seed_of(self.seed, *tags))

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


class TorchMPCDraws(TorchDraws):
    """The BGW baseline's draws (see the module docstring)."""

    def data_masks(self, T: int, m: int, d: int, p: int) -> torch.Tensor:
        g = self._gen("mpc_data")
        return torch.randint(0, p, (T, m, d), generator=g,
                             dtype=torch.int32).to(self.device)

    def step(self, t: int, wbar_shape: tuple[int, ...], T: int, p: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self._gen("mpc_step", int(t))
        u = torch.rand(tuple(wbar_shape), generator=g, dtype=torch.float32)
        masks = torch.randint(0, p, (T, *wbar_shape), generator=g,
                              dtype=torch.int32)
        return u.to(self.device), masks.to(self.device)

    def reshare_seed(self, t: int, phase: int) -> int:
        return _seed_of(self.seed, "mpc_reshare", int(t), int(phase))

    def reshare_masks(self, seed: int, worker: int, T: int,
                      shape: tuple[int, ...], p: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(_seed_of(int(seed), int(worker)))
        return torch.randint(0, p, (T, *shape), generator=g,
                             dtype=torch.int32).to(self.device)


class TorchServeDraws(TorchDraws):
    """The prediction server's draws (see the module docstring)."""

    def weight_masks(self, T: int, shape: tuple[int, ...], p: int
                     ) -> torch.Tensor:
        g = self._gen("serve_weights")
        return torch.randint(0, p, (T, *shape), generator=g,
                             dtype=torch.int32).to(self.device)

    def flush_masks(self, t: int, T: int, shape: tuple[int, ...], p: int
                    ) -> torch.Tensor:
        g = self._gen("serve_flush", int(t))
        return torch.randint(0, p, (T, *shape), generator=g,
                             dtype=torch.int32).to(self.device)

    def model_weights(self, shape: tuple[int, ...]) -> torch.Tensor:
        g = self._gen("serve_model")
        return torch.randn(tuple(shape), generator=g,
                           dtype=torch.float32).to(self.device)


class TorchALCCDraws(TorchDraws):
    """The ALCC engine's draws (see the module docstring)."""

    def data_masks(self, shape: tuple[int, ...]) -> torch.Tensor:
        g = self._gen("alcc_data")
        return torch.randn(tuple(shape), generator=g,
                           dtype=torch.float32).to(self.device)

    def round_masks(self, t: int, shape: tuple[int, ...]) -> torch.Tensor:
        g = self._gen("alcc_round", int(t))
        return torch.randn(tuple(shape), generator=g,
                           dtype=torch.float32).to(self.device)

    def mlp_init(self, d: int, hidden: int, c: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        g = self._gen("alcc_mlp_init")
        w1 = torch.randn((d, hidden), generator=g, dtype=torch.float32)
        w2 = torch.randn((hidden, c), generator=g, dtype=torch.float32)
        return ((w1 / math.sqrt(d)).to(self.device),
                (w2 / math.sqrt(hidden)).to(self.device))
