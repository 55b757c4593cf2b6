"""ALCC engine on torch: the float backend behind the exact engine's hooks.

Mirrors ``repro/core/protocol/alcc_engine.py``: no quantization, Gaussian
privacy masks and a least-squares decode (core/alcc.py), so every decode
returns an info dict (condition number, fallback flag, a-priori error
budget) that the runners and CLIs surface in ``wait_stats["alcc"]``.  The logistic
round: the master encodes W replicated at the K data points with T fresh
masks; worker i computes f(X̃_i, W̃_i) = X̃_iᵀ ĝ(X̃_i W̃_i) in float32; any
(2r+1)(K+T-1)+1 responses decode to the per-part sub-gradients.  The MLP
half (``mlp_*``) runs two degree-2 coded phases per step with the gelu and
softmax applied by the master in the clear between them
(cluster/alcc_mlp.py drives it).

Differences from the reference:

  * randomness comes from a draws object (``draws.TorchALCCDraws``, or a
    test's replay of the reference's keys): round t's masks are
    ``draws.round_masks(t, ...)``, its batch ``draws.batch(t, ...)``;
  * every tensor of a state lives on one device.  Worker arithmetic is
    float32 there; the master's encode, decode and step are float64 there
    too (the reference runs them in numpy), with the scheme's matrices
    built on the host and cached;
  * the simulated round evaluates each responder's product on its own
    share with the op its socket worker runs (``worker_eval``,
    ``mlp_worker_eval``), and ``train_reference`` runs the same
    ``round_fn``: a simulated run replays bit for bit on its device, and a
    socket run differs from its replay only where a worker's matmul sums
    in another order than the master's (the reference holds its socket
    runs within 1e-3; the port's are too).

No Pallas kernel is on this path in the reference (its products run in
numpy or XLA), so none is on it here: the products are ``torch`` matmuls.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core import alcc, sigmoid_poly
from repro_torch.core.protocol import engine as _exact
from repro_torch.core.protocol.draws import TorchALCCDraws

# float-side helpers shared with the exact engine (none touch the field)
lipschitz_eta = _exact.lipschitz_eta
sigmoid = _exact.sigmoid
loss_and_accuracy = _exact.loss_and_accuracy
multiclass_loss_and_accuracy = _exact.multiclass_loss_and_accuracy
_w_internal = _exact._w_internal
_w_public = _exact._w_public
_eval_metrics = _exact._eval_metrics


@dataclasses.dataclass(frozen=True)
class ALCCConfig:
    """Static parameters of one ALCC deployment (the float CPMLConfig).

    ``sigma`` is the Gaussian mask std (the privacy knob, paid in decode
    roundoff); ``beta_scale`` and ``cond_max`` are the decode's
    conditioning knobs (core/alcc.py).  N/K/T/r/c/batch_rows mean what
    they mean in CPMLConfig.
    """
    N: int
    K: int
    T: int
    r: int = 1
    c: int = 1
    sigma: float = 1.0
    batch_rows: int | None = None
    beta_scale: float = 0.45
    cond_max: float = 1e8

    def __post_init__(self):
        need = alcc.recovery_threshold(self.K, self.T, self.r)
        assert self.N >= need, (
            f"N={self.N} < recovery threshold {need} for "
            f"(K={self.K}, T={self.T}, r={self.r})")
        assert self.c >= 1
        assert self.batch_rows is None or self.batch_rows >= 1

    @property
    def threshold(self) -> int:
        """Logistic-round recovery threshold (deg f = 2r+1)."""
        return alcc.recovery_threshold(self.K, self.T, self.r)

    @property
    def mlp_threshold(self) -> int:
        """Per-phase MLP threshold: both coded phases are bilinear."""
        return alcc.degree_threshold(self.K, self.T, 2)

    @property
    def scheme(self) -> alcc.AnalogScheme:
        return _scheme(self.N, self.K, self.T, self.sigma,
                       self.beta_scale, self.cond_max)


@functools.lru_cache(maxsize=64)
def _scheme(N, K, T, sigma, beta_scale, cond_max) -> alcc.AnalogScheme:
    # one instance per parameter tuple: its cached matrices survive copies
    return alcc.AnalogScheme(N=N, K=K, T=T, sigma=sigma,
                             beta_scale=beta_scale, cond_max=cond_max)


@dataclasses.dataclass
class ALCCState:
    """Float mirror of CPMLState (the runner reads the same fields)."""
    w: torch.Tensor             # (d,) or (d, c) float32
    x_shares: torch.Tensor      # (N, mk, d) float32 coded dataset
    xty: torch.Tensor           # (d, c) float64 full-data X̄ᵀY
    m: int
    mk: int
    xq_real: torch.Tensor       # (m_padded, d) float32 plaintext (metrics)
    xq_parts: torch.Tensor      # (K, mk, d) float64 split plaintext
    y: torch.Tensor             # (m_padded,) padded labels
    y_parts: torch.Tensor       # (K, mk, c) float64 split targets


def _pad_parts(K: int, x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Zero-pad rows to a multiple of K and split: (K, mk, d) float64, mk."""
    m, d = x.shape
    mk = -(-m // K)
    x_pad = x.new_zeros((mk * K, d), dtype=torch.float64)
    x_pad[:m] = x
    return x_pad.reshape(K, mk, d), mk


def _encode_dataset(cfg: ALCCConfig, draws, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(x_shares (N, mk, d) float32, parts (K, mk, d) float64, mk)."""
    parts, mk = _pad_parts(cfg.K, x.to(torch.float64))
    masks = alcc.draw_masks(draws.data_masks((cfg.T, mk, x.shape[1])),
                            cfg.sigma)
    shares = alcc.encode(cfg.scheme, parts, masks).to(torch.float32)
    return shares, parts, mk


def _pad_labels(y: torch.Tensor, m_padded: int) -> torch.Tensor:
    return torch.cat([y, y.new_zeros(m_padded - y.shape[0])])


def setup(cfg: ALCCConfig, x: torch.Tensor, y: torch.Tensor,
          w0: torch.Tensor | None = None, *, draws) -> ALCCState:
    """Encode the float dataset once and precompute the master's context.

    x (m, d) and y (m,) on the run's device.  Rows are zero-padded to K·mk
    (zero rows add nothing to X̄ᵀ·anything), split into K parts and
    encoded with T masks from ``draws.data_masks``; shares are float32,
    the encode float64.
    """
    m, d = x.shape
    x_shares, parts, mk = _encode_dataset(cfg, draws, x)
    y_pad = _pad_labels(y, mk * cfg.K)
    targets = _exact._targets(cfg, y_pad).to(torch.float64)   # (m_pad, c)
    x_pad = parts.reshape(mk * cfg.K, d)
    if w0 is None:
        w0 = torch.zeros((d,) if cfg.c == 1 else (d, cfg.c),
                         dtype=torch.float32, device=x.device)
    return ALCCState(w=w0.to(torch.float32), x_shares=x_shares,
                     xty=x_pad.T @ targets, m=m, mk=mk,
                     xq_real=x_pad.to(torch.float32), xq_parts=parts,
                     y=y_pad, y_parts=targets.reshape(cfg.K, mk, cfg.c))


def poly_coeffs(cfg: ALCCConfig) -> np.ndarray:
    """The real sigmoid-surrogate coefficients ĝ (float32): the exact
    engine's least-squares fit, unquantized."""
    return np.asarray(sigmoid_poly.fit_sigmoid(cfg.r), np.float32)


def poly_eval(cbar: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of the ascending-coefficient surrogate; ``cbar``
    a float32 tensor on z's device."""
    out = z * 0 + cbar[-1]
    for i in range(cbar.shape[0] - 2, -1, -1):
        out = out * z + cbar[i]
    return out


def worker_eval(cbar: torch.Tensor, xb: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """The ALCC worker function f(X̃, W̃) = X̃ᵀ ĝ(X̃ W̃), float32: one
    socket worker's product."""
    return xb.T @ poly_eval(cbar, xb @ w)


def _coded_batch(x_shares: torch.Tensor, i: int,
                 batch_idx: torch.Tensor | None) -> torch.Tensor:
    """Worker i's coded (sub-)batch, gathered as its worker process does."""
    return (x_shares[i] if batch_idx is None
            else x_shares[i].index_select(0, batch_idx))


def responders_eval(cbar: torch.Tensor, x_shares: torch.Tensor,
                    w_shares: torch.Tensor, order: np.ndarray,
                    batch_idx: torch.Tensor | None = None) -> torch.Tensor:
    """The responders' f in ``order``, float32 (R, d, c): each one's
    ``worker_eval`` on its own shares, the product its worker runs."""
    return torch.stack([
        worker_eval(cbar, _coded_batch(x_shares, i, batch_idx), w_shares[i])
        for i in order.tolist()])


def _cbar(cfg: ALCCConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(poly_coeffs(cfg), device=device)


# ---------------------------------------------------------------------------
# Decode + gradient step (master side, float64)
# ---------------------------------------------------------------------------

def survivor_round_info(cfg: ALCCConfig, surv
                        ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Responder set -> (decode matrix (rows, K) float64, order, info).

    The rows read depend on the conditioning: the square path reads
    ``threshold`` responders, the ill-conditioned fallback all of them
    (core/alcc.py).  ``order`` lists exactly the responders the decode
    reads, in arrival order.
    """
    surv = np.arange(cfg.N) if surv is None else np.asarray(surv)
    assert len(surv) >= cfg.threshold, (
        f"{len(surv)} survivors < recovery threshold {cfg.threshold}")
    dmat, info = cfg.scheme.decode_matrix(surv, 2 * cfg.r + 1)
    return dmat, surv[: info["rows"]].astype(np.int64), info


def survivor_round(cfg: ALCCConfig, surv) -> tuple[np.ndarray, np.ndarray]:
    """(dmat, order), the exact engine's contract."""
    dmat, order, _ = survivor_round_info(cfg, surv)
    return dmat, order


def _batch_scale(cfg: ALCCConfig, state: ALCCState, eta: float,
                 batch_idx: torch.Tensor | None
                 ) -> tuple[torch.Tensor, float]:
    """(X̄ᵀY over this round's rows, eta / real-row count): padded rows
    are zero and must not shrink the step."""
    if batch_idx is None:
        return state.xty, eta / state.m
    xqb = state.xq_parts[:, batch_idx]                     # (K, b, d)
    yb = state.y_parts[:, batch_idx]                       # (K, b, c)
    xty = torch.einsum("kbd,kbc->dc", xqb, yb)
    part0 = torch.arange(cfg.K, device=batch_idx.device)[:, None] * state.mk
    real = int(((batch_idx[None, :] + part0) < state.m).sum())
    return xty, eta / max(real, 1)


def _decode_and_step(cfg: ALCCConfig, state: ALCCState, eta: float,
                     w2: torch.Tensor, fastest: torch.Tensor,
                     order: np.ndarray, batch_idx, info_sink
                     ) -> torch.Tensor:
    """Least-squares decode of the responders' (R, d, c) float32 results
    in ``order`` and the gradient step, float64; the decode's info lands
    in ``info_sink``."""
    xg, info = cfg.scheme.decode_sum(fastest, order, 2 * cfg.r + 1)
    xty, scale = _batch_scale(cfg, state, eta, batch_idx)
    w_new = w2.to(torch.float64) - scale * (xg - xty)
    if info_sink is not None:
        info_sink.append(info)
    return w_new.to(torch.float32)


def round_fn(cfg: ALCCConfig, state: ALCCState, eta: float, draws,
             info_sink: list | None = None) -> Callable[..., torch.Tensor]:
    """Simulated round: ``run(t, w2, order, batch_idx=None) -> w2``.

    Encodes round t's weight shares, evaluates the responders in ``order``
    in float32 as their workers would, decodes and steps.  The runner and
    ``train_reference`` both call it, so they agree bit for bit.
    """
    cbar = _cbar(cfg, state.x_shares.device)

    def run(t: int, w2: torch.Tensor, order, batch_idx=None) -> torch.Tensor:
        w_shares = encode_round_shares(cfg, draws, t, w2)   # (N, d, c) f32
        order = np.asarray(order, np.int64)
        fastest = responders_eval(cbar, state.x_shares, w_shares, order,
                                  batch_idx)
        return _decode_and_step(cfg, state, eta, w2, fastest, order,
                                batch_idx, info_sink)

    return run


def update_fn(cfg: ALCCConfig, state: ALCCState, eta: float,
              info_sink: list | None = None) -> Callable[..., torch.Tensor]:
    """Decode-and-update for results computed elsewhere: ``run(w2,
    fastest, order, batch_idx=None) -> w2`` with fastest the (R, d, c)
    float32 payloads of the responders in ``order``."""

    def run(w2, fastest, order, batch_idx=None) -> torch.Tensor:
        fastest = torch.as_tensor(fastest, dtype=torch.float32,
                                  device=w2.device)
        return _decode_and_step(cfg, state, eta, w2, fastest,
                                np.asarray(order, np.int64), batch_idx,
                                info_sink)

    return run


def round_fn_split(cfg, state, eta, info_sink=None):
    """Pipelined encode is exact-engine only; refuses at call time."""
    def run(*a, **k):
        raise RuntimeError("pipeline modes are exact-engine only")
    return run


def update_from_parts_fn(cfg, state, eta, info_sink=None):
    """Streaming decode is exact-engine only; refuses at call time."""
    def run(*a, **k):
        raise RuntimeError("streaming decode is exact-engine only")
    return run


def encode_round_shares(cfg: ALCCConfig, draws, t: int, w2: torch.Tensor
                        ) -> torch.Tensor:
    """Round t's weight shares (N, d, c) float32: W replicated at the K
    data betas + T fresh masks (fresh every round)."""
    masks = alcc.draw_masks(draws.round_masks(t, (cfg.T, *w2.shape)),
                            cfg.sigma)
    return alcc.encode_replicated(cfg.scheme, w2, masks).to(torch.float32)


# ---------------------------------------------------------------------------
# Training loops: reference replay + uncoded float oracle
# ---------------------------------------------------------------------------

def _prepare(x, y, draws, device):
    dev = _device.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, device=dev)
    return x, y, (draws if draws is not None else TorchALCCDraws(0, dev))


def _batch(cfg, draws, t: int, mk: int, device) -> torch.Tensor | None:
    if cfg.batch_rows is None:
        return None
    return torch.as_tensor(draws.batch(t, mk, cfg.batch_rows),
                           dtype=torch.int64, device=device)


def train_reference(cfg: ALCCConfig, x, y, iters: int,
                    eta: float | None = None,
                    survivor_fn: Callable[[int], np.ndarray] | None = None,
                    eval_every: int = 0, info_sink: list | None = None, *,
                    draws=None, device: str | torch.device | None = None):
    """Per-step loop over ``round_fn``.  Replaying a runner's responder
    trace with the same draws on the same device reproduces its weights
    bit for bit.  Returns (w, history)."""
    x, y, draws = _prepare(x, y, draws, device)
    state = setup(cfg, x, y, draws=draws)
    if eta is None:
        eta = lipschitz_eta(state.xq_real)
    run = round_fn(cfg, state, eta, draws, info_sink=info_sink)
    w2 = _w_internal(cfg, state.w)
    history: list[dict[str, float]] = []
    for t in range(iters):
        surv = survivor_fn(t) if survivor_fn is not None else None
        _, order, _ = survivor_round_info(cfg, surv)
        w2 = run(t, w2, order, _batch(cfg, draws, t, state.mk, x.device))
        if eval_every and (t + 1) % eval_every == 0:
            l, a = _eval_metrics(cfg, w2, state.xq_real[: state.m],
                                 state.y[: state.m])
            history.append({"iter": t + 1, "loss": float(l), "acc": float(a)})
    return _w_public(cfg, w2), history


def float_oracle(cfg: ALCCConfig, x, y, iters: int, eta: float | None = None,
                 *, draws=None, device: str | torch.device | None = None):
    """Uncoded float GD with the same surrogate, batches and step sizes:
    |w_alcc - w_oracle| measures the coding's float error alone."""
    x, y, draws = _prepare(x, y, draws, device)
    state = setup(cfg, x, y, draws=draws)    # same padding and X̄ᵀY
    if eta is None:
        eta = lipschitz_eta(state.xq_real)
    cbar = _cbar(cfg, x.device)
    w2 = _w_internal(cfg, state.w).to(torch.float64)
    for t in range(iters):
        bidx = _batch(cfg, draws, t, state.mk, x.device)
        xqb = (state.xq_parts if bidx is None
               else state.xq_parts[:, bidx]).to(torch.float32)
        z = torch.einsum("kbd,dc->kbc", xqb, w2.to(torch.float32))
        g = poly_eval(cbar, z)
        xg = torch.einsum("kbd,kbc->dc", xqb, g).to(torch.float64)
        xty, scale = _batch_scale(cfg, state, eta, bidx)
        w2 = w2 - scale * (xg - xty)
    return _w_public(cfg, w2.to(torch.float32))


# ---------------------------------------------------------------------------
# MLP under ALCC: two degree-2 coded phases per step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ALCCMLPState:
    """One gelu-MLP training run's master-side state."""
    w1: torch.Tensor            # (d, hidden) float32
    w2: torch.Tensor            # (hidden, c) float32
    x_shares: torch.Tensor      # (N, mk, d) float32 coded dataset
    xq_parts: torch.Tensor      # (K, mk, d) float64 plaintext parts
    y_parts: torch.Tensor       # (K, mk, c) float64 one-hot targets
    xq_real: torch.Tensor       # (m_padded, d) float32 (metrics)
    y: torch.Tensor             # (m_padded,) labels
    m: int
    mk: int


def mlp_setup(cfg: ALCCConfig, x: torch.Tensor, y: torch.Tensor,
              hidden: int, *, draws) -> ALCCMLPState:
    """Encode the dataset once and take the two dense layers' initial
    weights from ``draws.mlp_init``.  cfg.c >= 2 (softmax cross-entropy);
    cfg.r is unused."""
    assert cfg.c >= 2, "the ALCC MLP trains a softmax head; need c >= 2"
    m, d = x.shape
    x_shares, parts, mk = _encode_dataset(cfg, draws, x)
    y_pad = _pad_labels(y, mk * cfg.K)
    onehot = F.one_hot(y_pad.to(torch.int64), cfg.c).to(torch.float64)
    w1, w2 = draws.mlp_init(d, hidden, cfg.c)
    return ALCCMLPState(
        w1=w1.to(x.device), w2=w2.to(x.device), x_shares=x_shares,
        xq_parts=parts, y_parts=onehot.reshape(cfg.K, mk, cfg.c),
        xq_real=parts.reshape(mk * cfg.K, d).to(torch.float32),
        y=y_pad, m=m, mk=mk)


def mlp_row_mask(cfg: ALCCConfig, state: ALCCMLPState, batch_idx
                 ) -> torch.Tensor:
    """(K, b) float32, 1.0 where part-k row batch_idx[j] is a real sample
    (global row k·mk + idx < m), 0.0 on the padding."""
    dev = state.x_shares.device
    rows = (torch.arange(state.mk, device=dev) if batch_idx is None
            else batch_idx)
    part0 = torch.arange(cfg.K, device=dev)[:, None] * state.mk
    return ((rows[None, :] + part0) < state.m).to(torch.float32)


def _gelu(z: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(z, approximate="tanh")


def _mlp_middle(z1, w2, yb, mask):
    """The in-the-clear middle of one MLP step from decoded Z1 = X·W1.

    z1 (n, h), yb (n, c) one-hot, mask (n,) real-row indicator.  Returns
    (gw2, dz1, loss, acc), dz1 the VJP of the masked softmax-CE loss of
    gelu(z1) @ w2 through the gelu.
    """
    with torch.enable_grad():
        zg = z1.detach().requires_grad_(True)
        hg = _gelu(zg)
        h = hg.detach()
        logits = h @ w2
        n = torch.clamp(mask.sum(), min=1.0)
        p = torch.softmax(logits, dim=-1)
        delta2 = (p - yb) * mask[:, None] / n
        gw2 = h.T @ delta2
        (dz1,) = torch.autograd.grad(hg, zg, grad_outputs=delta2 @ w2.T)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -((yb * logp).sum(dim=-1) * mask).sum() / n
    acc = ((torch.argmax(logits, dim=-1) == torch.argmax(yb, dim=-1))
           * mask).sum() / n
    return gw2, dz1, loss, acc


def mlp_middle(cfg: ALCCConfig, state: ALCCMLPState, z1_parts, batch_idx):
    """Decoded forward activations -> (gw2, delta1 parts (K, b, h)
    float64, loss, acc).

    Like the reference (``alcc_engine.mlp_middle``), the middle reads the
    state's initial W2, not the W2 the run has reached (ROADMAP.md queue
    3): the port keeps that semantics so that it replays the reference.
    """
    K, b, h = z1_parts.shape
    mask = mlp_row_mask(cfg, state, batch_idx).reshape(K * b)
    yb = (state.y_parts if batch_idx is None
          else state.y_parts[:, batch_idx])
    gw2, dz1, loss, acc = _mlp_middle(
        z1_parts.reshape(K * b, h).to(torch.float32), state.w2,
        yb.reshape(K * b, -1).to(torch.float32), mask)
    return (gw2, dz1.to(torch.float64).reshape(K, b, h), float(loss),
            float(acc))


def mlp_encode_forward(cfg: ALCCConfig, draws, rid: int, w1: torch.Tensor
                       ) -> torch.Tensor:
    """Phase-A shares (N, d, h) float32: W1 replicated + round ``rid``'s
    fresh masks."""
    masks = alcc.draw_masks(draws.round_masks(rid, (cfg.T, *w1.shape)),
                            cfg.sigma)
    return alcc.encode_replicated(cfg.scheme, w1, masks).to(torch.float32)


def mlp_encode_backward(cfg: ALCCConfig, draws, rid: int,
                        delta1_parts: torch.Tensor) -> torch.Tensor:
    """Phase-B shares (N, b, h) float32: the per-part deltas (encoded like
    data) + round ``rid``'s fresh masks."""
    masks = alcc.draw_masks(
        draws.round_masks(rid, (cfg.T, *delta1_parts.shape[1:])), cfg.sigma)
    return alcc.encode(cfg.scheme, delta1_parts, masks).to(torch.float32)


def mlp_worker_eval(phase: int, xb: torch.Tensor, share: torch.Tensor
                    ) -> torch.Tensor:
    """One worker's MLP product: phase 0 (round 2t) X̃_i @ W̃1_i (b, h),
    phase 1 (round 2t+1) X̃_iᵀ @ δ̃1_i (d, h); both degree 2."""
    return xb @ share if phase == 0 else xb.T @ share


def mlp_responders_eval(phase: int, x_shares: torch.Tensor,
                        shares: torch.Tensor, order: np.ndarray,
                        batch_idx: torch.Tensor | None) -> torch.Tensor:
    """The responders' MLP products in ``order``, each the product its
    worker runs on its own shares."""
    return torch.stack([
        mlp_worker_eval(phase, _coded_batch(x_shares, i, batch_idx),
                        shares[i]) for i in order.tolist()])


def mlp_decode_forward(cfg: ALCCConfig, fastest, order):
    """(R, b, h) responses -> ((K, b, h) Z1 parts float64, info)."""
    return cfg.scheme.decode(fastest, order, 2)


def mlp_decode_backward(cfg: ALCCConfig, fastest, order):
    """(R, d, h) responses -> ((d, h) summed W1 gradient float64, info)."""
    return cfg.scheme.decode_sum(fastest, order, 2)


def gelu_mlp_loss(w1, w2, xb, yb, mask):
    """Masked softmax cross-entropy of ``layers.gelu_mlp``."""
    from repro_torch.models import layers
    logp = torch.log_softmax(layers.gelu_mlp(xb, w1, w2), dim=-1)
    n = torch.clamp(mask.sum(), min=1.0)
    return -((yb * logp).sum(dim=-1) * mask).sum() / n


def mlp_oracle(cfg: ALCCConfig, x, y, hidden: int, iters: int, eta: float,
               *, draws=None, device: str | torch.device | None = None):
    """Plaintext autograd training of ``layers.gelu_mlp``: the same initial
    weights, batches and step size as the coded run.  Returns (w1, w2)."""
    x, y, draws = _prepare(x, y, draws, device)
    state = mlp_setup(cfg, x, y, hidden, draws=draws)
    w1, w2 = state.w1, state.w2
    for t in range(iters):
        bidx = _batch(cfg, draws, t, state.mk, x.device)
        xqb = state.xq_parts if bidx is None else state.xq_parts[:, bidx]
        yb = state.y_parts if bidx is None else state.y_parts[:, bidx]
        K, b, d = xqb.shape
        mask = mlp_row_mask(cfg, state, bidx).reshape(K * b)
        with torch.enable_grad():
            a1 = w1.detach().requires_grad_(True)
            a2 = w2.detach().requires_grad_(True)
            loss = gelu_mlp_loss(
                a1, a2, xqb.reshape(K * b, d).to(torch.float32),
                yb.reshape(K * b, -1).to(torch.float32), mask)
            g1, g2 = torch.autograd.grad(loss, (a1, a2))
        w1 = w1 - eta * g1
        w2 = w2 - eta * g2
    return w1, w2


def mlp_metrics(state: ALCCMLPState, w1, w2) -> tuple[float, float]:
    """Full-data loss and accuracy of (w1, w2) on the plaintext dataset."""
    from repro_torch.models import layers
    x, y = state.xq_real[: state.m], state.y[: state.m].to(torch.int64)
    logits = layers.gelu_mlp(x, w1, w2)
    onehot = F.one_hot(y, logits.shape[-1]).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean((onehot * logp).sum(dim=-1))
    acc = (torch.argmax(logits, dim=-1) == y).to(torch.float32).mean()
    return float(loss), float(acc)
