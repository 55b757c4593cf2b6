"""Finite-field (F_p) arithmetic on torch tensors.

Mirrors ``repro/core/field.py``.  The paper computes over F_p with
p = 15485863 (the largest 24-bit prime); ``P30`` is the 30-bit option.

Conventions:
  * field elements are int32 tensors in [0, p) at every public boundary;
  * a product of two elements needs up to 2*bits(p) bits, so products are
    formed in int64 inside a function, never in int32 (torch, like XLA,
    wraps int32 silently);
  * any p < 2^30 is supported (``addmod`` needs 2p < 2^31).

``matmul`` is the exact field matrix product.  On a CPU tensor it runs the
plain PyTorch version (``kernels/ref.py``); on a CUDA tensor it launches the
hand-written ``modmatmul`` kernel or raises (``kernels/ops.py``).
"""
from __future__ import annotations

import numpy as np
import torch

# The paper's modulus: largest prime below 2^24 (§5).
P = 15485863
# Extended-precision prime 2^30 - 35 (2p < 2^31).
P30 = 1073741789

LIMB_BITS = 8
LIMB_MASK = (1 << LIMB_BITS) - 1


def n_limbs(p: int) -> int:
    """8-bit limbs needed to cover elements of F_p (3 for P, 4 for P30)."""
    return -(-p.bit_length() // LIMB_BITS)


def fmod(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """Reduce an integer tensor (possibly negative) into [0, p).

    Floor-mod, as ``jnp.remainder``: ``torch.remainder``, never
    ``torch.fmod``, which truncates and returns negative residues.
    """
    return torch.remainder(x, p).to(torch.int32)


def addmod(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    """(a + b) mod p.  a, b in [0, p): the sum is < 2p < 2^31."""
    s = a + b
    return torch.where(s >= p, s - p, s).to(torch.int32)


def submod(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + p, d).to(torch.int32)


def negmod(a: torch.Tensor, p: int = P) -> torch.Tensor:
    return torch.where(a == 0, 0, p - a).to(torch.int32)


def limbs(x: torch.Tensor, p: int = P) -> list[torch.Tensor]:
    """Split int32 field elements into 8-bit limbs (low first)."""
    return [((x >> (LIMB_BITS * i)) & LIMB_MASK).to(torch.int32)
            for i in range(n_limbs(p))]


def double_mod(x: torch.Tensor, times: int, p: int) -> torch.Tensor:
    """x * 2^times mod p via repeated doubling; x stays < 2p < 2^31."""
    for _ in range(times):
        x = x + x
        x = torch.where(x >= p, x - p, x)
    return x


def mulmod(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    """Element-wise (a * b) mod p; the product is formed in int64."""
    return torch.remainder(a.to(torch.int64) * b.to(torch.int64),
                           p).to(torch.int32)


def powmod(a: torch.Tensor, e: int, p: int = P) -> torch.Tensor:
    """a^e mod p by square-and-multiply (e is a python int)."""
    result = torch.ones_like(a, dtype=torch.int32)
    base = a.to(torch.int32)
    while e > 0:
        if e & 1:
            result = mulmod(result, base, p)
        base = mulmod(base, base, p)
        e >>= 1
    return result


def invmod(a: torch.Tensor, p: int = P) -> torch.Tensor:
    """Modular inverse via Fermat: a^(p-2) mod p.  a must be nonzero."""
    return powmod(a, p - 2, p)


def matmul(a: torch.Tensor, b: torch.Tensor, p: int = P) -> torch.Tensor:
    """Exact (a @ b) mod p for int32 field matrices.

    a: (M, K), b: (K, N) -> (M, N) int32 in [0, p).  A CPU tensor runs the
    plain version; a CUDA tensor launches the ``modmatmul`` kernel.
    """
    from repro_torch.kernels import ops
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    return ops.modmatmul(a, b, p)


def to_signed(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """phi^{-1} of Eq. (25): map [0,p) back to signed integers."""
    half = (p - 1) // 2
    return torch.where(x >= half, x - p, x)


def from_signed(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """phi of Eq. (7): embed signed integers into [0, p)."""
    return torch.where(x < 0, x + p, x).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side (numpy / python int) builders of the encode/decode matrices.
# They run once per code or survivor pattern, so python ints are fine.
# ---------------------------------------------------------------------------

def host_inv(a: int, p: int = P) -> int:
    return pow(int(a) % p, p - 2, p)


def host_lagrange_coeffs(eval_points: np.ndarray, interp_points: np.ndarray,
                         p: int = P) -> np.ndarray:
    """U[i, j] = prod_{l != i} (alpha_j - beta_l) / (beta_i - beta_l) mod p.

    Returns the (len(interp_points), len(eval_points)) encoding matrix of
    Eq. (12): column j encodes evaluation at alpha_j.
    """
    betas = [int(b) % p for b in interp_points]
    alphas = [int(a) % p for a in eval_points]
    kpt = len(betas)
    U = np.zeros((kpt, len(alphas)), dtype=np.int64)
    denom_inv = []
    for i in range(kpt):
        d = 1
        for l in range(kpt):
            if l != i:
                d = d * ((betas[i] - betas[l]) % p) % p
        denom_inv.append(host_inv(d, p))
    for j, alpha in enumerate(alphas):
        for i in range(kpt):
            num = 1
            for l in range(kpt):
                if l != i:
                    num = num * ((alpha - betas[l]) % p) % p
            U[i, j] = num * denom_inv[i] % p
    return U


def host_vandermonde_inv(points: np.ndarray, p: int = P) -> np.ndarray:
    """Inverse of the Vandermonde matrix V[i,j] = points[i]^j over F_p
    (Gauss-Jordan elimination with python ints)."""
    pts = [int(x) % p for x in points]
    n = len(pts)
    M = [[pow(pts[i], j, p) for j in range(n)]
         + [1 if k == i else 0 for k in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if M[r][col] % p != 0)
        M[col], M[piv] = M[piv], M[col]
        inv = host_inv(M[col][col], p)
        M[col] = [v * inv % p for v in M[col]]
        for r in range(n):
            if r != col and M[r][col] % p:
                f = M[r][col]
                M[r] = [(M[r][c] - f * M[col][c]) % p for c in range(2 * n)]
    return np.array([[M[i][n + j] for j in range(n)] for i in range(n)],
                    dtype=np.int64)
