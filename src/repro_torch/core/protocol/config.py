"""CPMLConfig: the static parameters of one CodedPrivateML deployment.

Mirrors ``repro/core/protocol/config.py``.  The reference's ``use_kernel``
flag has no counterpart: in the port the device decides (a CUDA tensor
runs the kernels, a CPU tensor their plain versions), and ``mesh_axis``
belongs to the ``"shard"`` backend, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import field, lagrange, sigmoid_poly


@dataclasses.dataclass(frozen=True)
class CPMLConfig:
    N: int                  # workers
    K: int                  # parallelization (dataset split)
    T: int                  # privacy threshold
    r: int = 1              # sigmoid polynomial degree
    c: int = 1              # one-vs-all heads (1 = binary logistic regression)
    lx: int = 2             # dataset quantization scale (paper §5)
    lw: int = 4             # weight quantization scale (paper §5)
    lc: int = 6             # sigmoid-coefficient scale (see sigmoid_poly.py)
    p: int = field.P
    backend: str = "vmap"   # all N workers on one device
    batch_rows: int | None = None   # rows per part per round (None = full)

    def __post_init__(self):
        if self.backend == "shard":
            raise NotImplementedError(
                "backend='shard' (one share per GPU) is not ported yet: "
                "ROADMAP.md queue 1 item 4")
        if self.backend != "vmap":
            raise ValueError(f"unknown backend {self.backend!r}")
        need = lagrange.recovery_threshold(self.K, self.T, self.r)
        if self.N < need:
            raise ValueError(
                f"N={self.N} < recovery threshold {need} for (K={self.K}, "
                f"T={self.T}, r={self.r}); Theorem 1 violated")
        if self.c < 1 or (self.batch_rows is not None and self.batch_rows < 1):
            raise ValueError(f"bad c={self.c} / batch_rows={self.batch_rows}")

    @property
    def threshold(self) -> int:
        return lagrange.recovery_threshold(self.K, self.T, self.r)

    @property
    def scheme(self) -> lagrange.CodingScheme:
        return lagrange.CodingScheme(self.N, self.K, self.T, self.p)

    @property
    def grad_scale(self) -> int:
        return sigmoid_poly.gradient_scale_poly(self.lx, self.lw, self.r,
                                                self.lc)

    def headroom_bits(self, x_max: float, m: int) -> float:
        """log2((p-1)/2) - log2(worst-case decoded magnitude); negative means
        a decoded sub-gradient can wrap around (paper §3.1)."""
        rows = m / self.K if self.batch_rows is None else self.batch_rows
        per_part = rows * (2 ** self.lx * max(x_max, 1e-9)) \
            * 2 ** (self.lc + self.r * (self.lx + self.lw))
        return math.log2((self.p - 1) / 2) - math.log2(per_part)
