"""Plain PyTorch versions of the kernels; mirrors ``repro/kernels/ref.py``.

They run on CPU and CUDA tensors alike.  The CPU path of the port uses
them; on the card they are the oracle the kernels are held against
(``chip_smoke.py``).  Nothing on the main path calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import field, sigmoid_poly

# Output columns per float64 limb product: bounds the float64 temporaries of
# the full-width dataset encode to a few hundred MB on either device.
COL_CHUNK = 1 << 17


def modmatmul_ref(a: torch.Tensor, b: torch.Tensor, p: int = field.P
                  ) -> torch.Tensor:
    """Exact (a @ b) mod p: a (M, K), b (K, N) int32 in [0, p) -> (M, N).

    Both operands are split into 8-bit limbs, and all nl x nl limb-pair
    products come from ONE float64 matmul of the stacked limbs.  A limb
    product is < 2^16, so every partial sum of K of them is an integer
    < 2^16 · K, exact in float64's 53-bit mantissa while K < 2^37 whatever
    the summation order.  Each limb-pair sum is reduced mod p, weighted by
    2^{8(i+j)} mod p in int64 (< 2^60) and summed.
    """
    M, K = a.shape
    N = b.shape[1]
    if K >= 1 << 37:
        raise ValueError(f"contraction {K} breaks float64 exactness")
    nl = field.n_limbs(p)
    dev = a.device
    al = torch.cat(field.limbs(a, p), 0).to(torch.float64)      # (nl*M, K)
    idx = torch.arange(nl, device=dev)
    weights = torch.tensor([pow(2, field.LIMB_BITS * s, p)
                            for s in range(2 * nl - 1)],
                           dtype=torch.int64, device=dev)
    wgt = weights[idx[:, None] + idx[None, :]][:, None, :, None]  # (nl,1,nl,1)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    for start in range(0, N, COL_CHUNK):
        bc = b[:, start:start + COL_CHUNK]
        n = bc.shape[1]
        bl = torch.cat(field.limbs(bc, p), 1).to(torch.float64)  # (K, nl*n)
        prod = (al @ bl).to(torch.int64).reshape(nl, M, nl, n)
        terms = torch.remainder(torch.remainder(prod, p) * wgt, p)
        out[:, start:start + n] = torch.remainder(
            terms.sum(dim=(0, 2)), p).to(torch.int32)
    return out


def coded_grad_ref(x: torch.Tensor, w: torch.Tensor, cbar: torch.Tensor,
                   p: int = field.P) -> torch.Tensor:
    """X̃ᵀ ḡ(X̃, W̃) mod p for one worker (paper Eq. 20).

    x (mk, d), w (d, r), cbar (r+1,) -> (d,).
    """
    xw = modmatmul_ref(x, w, p)                          # (mk, r)
    s = sigmoid_poly.gbar_field(xw, cbar, p)             # (mk,)
    return modmatmul_ref(x.T, s[:, None], p)[:, 0]       # (d,)


def coded_grad_mc_ref(x: torch.Tensor, w: torch.Tensor, cbar: torch.Tensor,
                      p: int = field.P) -> torch.Tensor:
    """Multi-head Eq. 20 for one worker: x (mk, d), w (d, c, r) -> (d, c).

    Column cls*r + j of X̃ @ W̃.reshape(d, c*r) is head cls's degree-j
    product, so one field matmul feeds all c polynomial heads.
    """
    d, c, r = w.shape
    xw = modmatmul_ref(x, w.reshape(d, c * r), p).reshape(x.shape[0], c, r)
    s = sigmoid_poly.gbar_field(xw, cbar, p)             # (mk, c)
    return modmatmul_ref(x.T, s, p)                      # (d, c)


def coded_grad_workers_ref(x: torch.Tensor, w: torch.Tensor,
                           cbar: torch.Tensor, p: int = field.P
                           ) -> torch.Tensor:
    """All N workers: x (N, mk, d), w (N, d, c, r) -> (N, d, c)."""
    return torch.stack([coded_grad_mc_ref(x[i], w[i], cbar, p)
                        for i in range(x.shape[0])])


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
                       h0: torch.Tensor, ssm_dtype: str = "f32",
                       chunk: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequential float32 recurrence of the Mamba-1 selective scan
    (``repro/kernels/mamba_scan.py::ref_selective_scan``).

    x, dt (B, S, di); bm, cm (B, S, n); a_log (di, n); d (di,);
    h0 (B, di, n) -> (y (B, S, di), h_last (B, di, n)), both float32.

    ``ssm_dtype="bf16"`` is the reference model's bf16 a/b chunked scan
    (``repro/models/mamba.py``: ``_discretize``, ``_chunk_scan``):
    a_t = exp(dt_t A) and b_t = (dt_t B_t) x_t rounded to bf16, the
    chunk's running products A_c <- a_t A_c and B_c <- a_t B_c + b_t in
    bf16 (each step rounded), h_t = A_c h_c0 + B_c in float32 from the
    state h_c0 at the chunk's start, restarted every ``chunk`` steps.
    """
    wide = _wide(x)
    A = -torch.exp(a_log.to(wide))
    d = d.to(wide)
    h = h0.to(wide)
    ab16 = ssm_dtype == "bf16"
    if ab16:
        if chunk < 1:
            raise ValueError(f"ssm_dtype='bf16' needs chunk >= 1, got {chunk}")
        bf16 = torch.bfloat16
        h_c0 = h
        a_c = torch.ones(h.shape, dtype=bf16, device=h.device)
        b_c = torch.zeros(h.shape, dtype=bf16, device=h.device)
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t = x[:, t].to(wide), dt[:, t].to(wide)
        a_t = torch.exp(dt_t[:, :, None] * A[None])
        if ab16:
            if t % chunk == 0:
                h_c0 = h
                a_c, b_c = torch.ones_like(a_c), torch.zeros_like(b_c)
            a_t = a_t.to(bf16)
            b_t = (dt_t[:, :, None] * bm[:, t, None, :].float()
                   * x_t[:, :, None]).to(bf16)
            a_c = a_t * a_c
            b_c = a_t * b_c + b_t
            h = a_c.float() * h_c0 + b_c.float()
        else:
            h = a_t * h + (dt_t * x_t)[:, :, None] * bm[:, t, None, :].to(wide)
        ys.append((h * cm[:, t, None, :].to(wide)).sum(-1) + d * x_t)
    return torch.stack(ys, 1), h


def _wide(x: torch.Tensor) -> torch.dtype:
    """The scans' working dtype: float32, or float64 for float64 inputs
    (``torch.autograd.gradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           bm: torch.Tensor, cm: torch.Tensor,
                           a_log: torch.Tensor, d: torch.Tensor,
                           h0: torch.Tensor, dy: torch.Tensor,
                           dh_last: torch.Tensor, ssm_dtype: str = "f32",
                           chunk: int = 0) -> tuple[torch.Tensor, ...]:
    """The gradient of ``selective_scan_ref`` by its explicit reverse
    recurrence (what ``csrc/mamba_scan_bwd.cu`` computes).

    With a_t = exp(dt_t A), A = -exp(a_log), and g_t = dL/dh_t:
    g_t = dy_t C_t + a_{t+1} g_{t+1}, started at dh_last; then
    dx_t = dt_t Σ_j g_t B_t + d dy_t, ddt_t = x_t Σ_j g_t B_t
    + Σ_j g_t h_{t-1} a_t A, dbm_t = Σ_i g_t dt_t x_t, dcm_t = Σ_i dy_t h_t,
    da_log = A Σ_{b,t} g_t h_{t-1} a_t dt_t, dd = Σ_{b,t} dy_t x_t and
    dh0 = a_0 g_0.  The forward's states are kept, all S + 1 of them.
    Returns (dx, ddt, dbm, dcm, da_log, dd, dh0) in float32 (float64 for
    float64 inputs).

    ``ssm_dtype="bf16"``: the gradient of the bf16 a/b mode's forward in
    chunks of ``chunk`` steps, with every bf16 rounding straight-through
    (its derivative taken as 1, as the transpose of ``astype`` takes it):
    that of a_t = bf16(e_t), e_t = exp(dt_t A), of b_t = bf16(dt_t B_t x_t)
    and of the running products A_c <- bf16(a_t A_c),
    B_c <- bf16(bf16(a_t B_c) + b_t).  The forward's values are the mode's
    own: a_t, A_c, B_c rounded, h_t = A_c h_c0 + B_c.  Within a chunk the
    adjoint of (A_c, B_c) is (h_c0 g, g) with g carried by the rounded
    a_t, so the recurrence above holds with a_t rounded where it carries g
    and e_t where exp is differentiated (g_t h_{t-1} e_t), and h_{t-1} the
    mode's.  Across a chunk's start the state h_c0 enters every h_t of the
    chunk through its own A_c,t: the carry into the step before is
    Σ_{t in c} A_c,t dy_t C_t + A_c,last Γ_c, where Γ_c is the carry into
    the chunk's last step (dh_last for the last chunk), and dh0 that of
    chunk 0.  The cotangents are float32 (float64 for float64 inputs),
    never rounded to bf16.
    """
    wide = _wide(x)
    A = -torch.exp(a_log.to(wide))
    x, dt, bm, cm, dy = (t.to(wide) for t in (x, dt, bm, cm, dy))
    S = x.shape[1]
    ab16 = ssm_dtype == "bf16"
    hs = [h0.to(wide)]
    if ab16:
        if chunk < 1:
            raise ValueError(f"ssm_dtype='bf16' needs chunk >= 1, got {chunk}")
        bf16 = torch.bfloat16
        acs = []   # A_c,t of each step, for the carry across a chunk's start
        for t in range(S):
            if t % chunk == 0:
                h_c0 = hs[-1]
                a_c = torch.ones(h_c0.shape, dtype=bf16, device=x.device)
                b_c = torch.zeros(h_c0.shape, dtype=bf16, device=x.device)
            a_t = torch.exp(dt[:, t, :, None] * A).to(bf16)
            b_t = (dt[:, t, :, None] * bm[:, t, None, :]
                   * x[:, t, :, None]).to(bf16)
            a_c = a_t * a_c
            b_c = a_t * b_c + b_t
            acs.append(a_c.to(wide))
            hs.append(a_c.to(wide) * h_c0 + b_c.to(wide))
    else:
        for t in range(S):
            a_t = torch.exp(dt[:, t, :, None] * A)
            hs.append(a_t * hs[-1]
                      + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :])
    g = dh_last.to(wide)
    dA = torch.zeros_like(g)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    for t in reversed(range(S)):
        x_t, dt_t, dy_t = x[:, t], dt[:, t], dy[:, t]
        e_t = torch.exp(dt_t[:, :, None] * A)
        a_t = e_t.to(bf16).to(wide) if ab16 else e_t
        if ab16 and (t == S - 1 or t % chunk == chunk - 1):
            g_last, gam, a_last = g, torch.zeros_like(g), acs[t]
        dyc = dy_t[:, :, None] * cm[:, t, None, :]
        g = g + dyc
        dcm[:, t] = (dy_t[:, :, None] * hs[t + 1]).sum(1)
        dbm[:, t] = (g * (dt_t * x_t)[:, :, None]).sum(1)
        gb = (g * bm[:, t, None, :]).sum(-1)
        gha = g * hs[t] * e_t
        dx[:, t] = gb * dt_t + d.to(wide) * dy_t
        ddt[:, t] = gb * x_t + (gha * A).sum(-1)
        dA = dA + gha * dt_t[:, :, None]
        g = a_t * g
        if ab16:
            gam = gam + acs[t] * dyc
            if t % chunk == 0:
                g = gam + a_last * g_last
    return (dx, ddt, dbm, dcm, dA.sum(0) * A, (dy * x).sum((0, 1)), g)
