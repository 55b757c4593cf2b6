"""Operations, bytes and peaks: the yardstick of the per-layer shares.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
1,979 T int8 operations/s on the tensor cores, the card's highest rate of
any kind, so no implementation of an integer product can read above it;
3.35 TB/s of HBM3.  Counts come from shapes alone: a field multiply-add is
2 operations, an int32 element 4 bytes, each input byte read once and each
output byte written once.
"""
from __future__ import annotations

PEAK_OPS = 1979e12
PEAK_BYTES = 3.35e12
ELEM = 4


def coded_grad_ops(N: int, rows: int, d: int, c: int, r: int) -> float:
    """The worker polynomial over all N shares: X̃W̃ (r products a head) and
    X̃ᵀs (one), each rows·d multiply-adds a head and a worker."""
    return 2.0 * (r + 1) * N * rows * d * c


def coded_grad_bytes(N: int, rows: int, d: int, c: int, r: int) -> float:
    """x shares (N, rows, d), w shares (N, d, c, r), results (N, d, c)."""
    return ELEM * float(N * rows * d + N * d * c * r + N * d * c)


def coded_grad_least_s(N: int, rows: int, d: int, c: int, r: int) -> float:
    """The least time any implementation could take on the card."""
    return max(coded_grad_ops(N, rows, d, c, r) / PEAK_OPS,
               coded_grad_bytes(N, rows, d, c, r) / PEAK_BYTES)


def round_ops(N: int, K: int, T: int, R: int, rows: int, d: int, c: int,
              r: int) -> float:
    """A round's field operations: the weight encode ((N, K+T) by
    (K+T, d·c·r)), the worker polynomial and the decode ((K, R) by
    (R, d·c))."""
    encode = N * (K + T) * d * c * r
    decode = K * R * d * c
    return 2.0 * (encode + decode) + coded_grad_ops(N, rows, d, c, r)
