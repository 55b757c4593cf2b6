"""Engine stage: the training driver over encode / compute / decode.

Mirrors ``repro/core/protocol/engine.py`` (paper Algorithm 1, with c
one-vs-all heads and optional coded mini-batch SGD).  Differences:

  * randomness comes from a draws object (``draws.py``): round t's
    uniforms and masks are ``draws.round(t, ...)``, its batch
    ``draws.batch(t, ...)``, the dataset masks ``draws.dataset_masks``;
  * the reference's jitted ``lax.scan`` (``_train_scan``) is a Python loop
    over the same ``_round``, so ``train`` equals ``train_reference`` by
    construction.

Every tensor of a ``CPMLState`` lives on one device: the GPU runs the
kernels, the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import quantize, sigmoid_poly
from repro_torch.core.protocol import compute, decode, encode
from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.core.protocol.draws import TorchDraws


# ---------------------------------------------------------------------------
# State + setup
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CPMLState:
    w: torch.Tensor          # real weights: (d,) when c == 1, else (d, c)
    x_shares: torch.Tensor   # (N, mk, d) coded dataset (encoded ONCE)
    xty: torch.Tensor        # real X̄ᵀY over the padded data: (d,) or (d, c)
    m: int                   # number of (unpadded) samples
    mk: int                  # rows per part (padded m / K)
    xq_real: torch.Tensor    # dequantized dataset (m_padded, d)
    xq_parts: torch.Tensor   # the same, split (K, mk, d)
    y: torch.Tensor          # padded labels, original form (m_padded,)
    y_parts: torch.Tensor    # targets split (K, mk, c), one-hot if c > 1


def _targets(cfg: CPMLConfig, y: torch.Tensor) -> torch.Tensor:
    """(m,) labels -> (m, c) real regression targets for the c heads."""
    if cfg.c == 1:
        return y.to(torch.float32)[:, None]
    return torch.nn.functional.one_hot(y.to(torch.int64), cfg.c).to(
        torch.float32)


def _w_internal(cfg: CPMLConfig, w: torch.Tensor) -> torch.Tensor:
    return w[:, None] if cfg.c == 1 and w.ndim == 1 else w


def _w_public(cfg: CPMLConfig, w2: torch.Tensor) -> torch.Tensor:
    return w2[:, 0] if cfg.c == 1 else w2


def setup(cfg: CPMLConfig, x: torch.Tensor, y: torch.Tensor,
          w0: torch.Tensor | None = None, *, draws,
          dataset_encoder=None) -> CPMLState:
    """Encode the dataset once and precompute the master's cleartext context.

    x (m, d) float32 and y (m,) on the device the run uses; y holds 0/1
    labels when cfg.c == 1, integer class ids otherwise.  ``draws`` gives
    the dataset's privacy masks (draws.py).  ``dataset_encoder`` (the
    signature of ``encode.encode_dataset``) lets a sharded master group own
    the encode (cluster/master_group.py); it must be bit-identical to the
    default, which the group guarantees by drawing at full shape.
    """
    encoder = dataset_encoder or encode.encode_dataset
    x_shares, ctx = encoder(cfg, draws, x)
    xq_real = quantize.dequantize(ctx["xq"], cfg.lx, cfg.p)
    m_padded = ctx["m_padded"]
    mk = m_padded // cfg.K
    y_pad = torch.cat([y, y.new_zeros(m_padded - y.shape[0])])
    targets = _targets(cfg, y_pad)                        # (m_padded, c)
    xty = _w_public(cfg, xq_real.T @ targets)
    d = x.shape[1]
    if w0 is None:
        w0 = torch.zeros((d,) if cfg.c == 1 else (d, cfg.c),
                         dtype=torch.float32, device=x.device)
    return CPMLState(
        w=w0, x_shares=x_shares, xty=xty, m=x.shape[0], mk=mk,
        xq_real=xq_real, xq_parts=xq_real.reshape(cfg.K, mk, d),
        y=y_pad, y_parts=targets.reshape(cfg.K, mk, cfg.c))


# ---------------------------------------------------------------------------
# One protocol round
# ---------------------------------------------------------------------------

def poly_coeffs(cfg: CPMLConfig) -> np.ndarray:
    """The quantized sigmoid-surrogate coefficients c̄ the workers evaluate."""
    return np.asarray(
        sigmoid_poly.quantized_coeffs(cfg.r, cfg.lx, cfg.lw, cfg.lc, cfg.p),
        dtype=np.int32)


def _gradient_step(cfg: CPMLConfig, state: CPMLState, w2: torch.Tensor,
                   xg: torch.Tensor, batch_idx: torch.Tensor | None,
                   eta: float) -> torch.Tensor:
    """Apply one gradient step given the decoded real gradient xg (d, c).

    Batch index i selects global sample k*mk + i from every part k; rows
    past m are zero padding, so 1/batch counts only the real rows.  The
    scale is formed in float32 as the reference forms it.
    """
    if batch_idx is None:
        xty = _w_internal(cfg, state.xty)
        # a float32 quotient, exact as a python float: no device copy
        scale = float(np.float32(eta) / np.float32(state.m))
    else:
        dev = w2.device
        xqb = state.xq_parts[:, batch_idx]                   # (K, b, d)
        yb = state.y_parts[:, batch_idx]                     # (K, b, c)
        xty = torch.einsum("kbd,kbc->dc", xqb, yb)
        part0 = torch.arange(cfg.K, device=dev) * state.mk   # row offsets
        real = ((batch_idx[None, :] + part0[:, None]) < state.m).sum()
        scale = torch.tensor(eta, dtype=torch.float32, device=dev) / real.to(
            torch.float32)
    return w2 - scale * (xg - xty)


def encode_round_shares(cfg: CPMLConfig, draws, t: int, w2: torch.Tensor
                        ) -> torch.Tensor:
    """Round t's weight shares (N, d, c, r) from round t's draws."""
    u, masks = draws.round(t, (*w2.shape, cfg.r), cfg.T, cfg.p)
    return encode.encode_weights(cfg, w2, u, masks)


def round_parts(cfg: CPMLConfig, state: CPMLState, w_shares: torch.Tensor,
                dmat: torch.Tensor, order: torch.Tensor,
                batch_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Worker compute over all N shares, then decode of the R responders in
    ``order``: (K, d, c) field parts."""
    cbar = torch.as_tensor(poly_coeffs(cfg), device=w_shares.device)
    xb = state.x_shares if batch_idx is None else state.x_shares[:, batch_idx]
    results = compute.all_worker_results(cfg, cbar, xb, w_shares)  # (N, d, c)
    return decode.decode_parts(cfg, results[order], dmat)


def _update_from_parts(cfg: CPMLConfig, state: CPMLState, w2: torch.Tensor,
                       parts: torch.Tensor, batch_idx: torch.Tensor | None,
                       eta: float) -> torch.Tensor:
    xg = decode.parts_to_gradient(cfg, parts)
    return _gradient_step(cfg, state, w2, xg, batch_idx, eta)


def _round_update(cfg: CPMLConfig, state: CPMLState, w2: torch.Tensor,
                  fastest: torch.Tensor, dmat: torch.Tensor,
                  batch_idx: torch.Tensor | None, eta: float) -> torch.Tensor:
    """Decode the (R, d, c) responder results and take the gradient step."""
    parts = decode.decode_parts(cfg, fastest, dmat)
    return _update_from_parts(cfg, state, w2, parts, batch_idx, eta)


def _round(cfg: CPMLConfig, draws, t: int, w2: torch.Tensor,
           state: CPMLState, dmat: torch.Tensor, order: torch.Tensor,
           batch_idx: torch.Tensor | None, eta: float) -> torch.Tensor:
    """w2 (d, c) -> updated (d, c): encode -> compute -> decode -> step."""
    w_shares = encode_round_shares(cfg, draws, t, w2)
    parts = round_parts(cfg, state, w_shares, dmat, order, batch_idx)
    return _update_from_parts(cfg, state, w2, parts, batch_idx, eta)


def round_fn(cfg: CPMLConfig, state: CPMLState, eta: float, draws
             ) -> Callable[..., torch.Tensor]:
    """Returns ``run(t, w2, dmat, order, batch_idx=None) -> w2``: the exact
    round ``train`` and ``train_reference`` run."""

    def run(t: int, w2: torch.Tensor, dmat: torch.Tensor,
            order: torch.Tensor, batch_idx: torch.Tensor | None = None
            ) -> torch.Tensor:
        return _round(cfg, draws, t, w2, state, dmat, order, batch_idx, eta)

    return run


def round_fn_split(cfg: CPMLConfig, state: CPMLState, eta: float
                   ) -> Callable[..., torch.Tensor]:
    """``round_fn`` with the W-independent encode half supplied by the caller.

    Returns ``run(u, mask_shares, w2, dmat, order, batch_idx=None) -> w2``:
    (u, mask_shares) come from ``round_mask_context`` for the same round,
    built ahead of time (cluster/pipeline.py); the result is bit-identical
    to ``round_fn``'s for that round.
    """

    def run(u: torch.Tensor, mask_shares: torch.Tensor, w2: torch.Tensor,
            dmat: torch.Tensor, order: torch.Tensor,
            batch_idx: torch.Tensor | None = None) -> torch.Tensor:
        w_shares = encode.encode_weights_finish(cfg, u, mask_shares, w2)
        parts = round_parts(cfg, state, w_shares, dmat, order, batch_idx)
        return _update_from_parts(cfg, state, w2, parts, batch_idx, eta)

    return run


def update_from_parts_fn(cfg: CPMLConfig, state: CPMLState, eta: float
                         ) -> Callable[..., torch.Tensor]:
    """Decode-and-update hook for streamed rounds.

    Returns ``run(w2, parts, batch_idx=None) -> w2`` where ``parts`` is the
    (K, d, c) field output of ``decode.StreamingDecoder.finish`` (host
    numpy): the same ``_update_from_parts`` the in-process round composes.
    """

    def run(w2: torch.Tensor, parts, batch_idx: torch.Tensor | None = None
            ) -> torch.Tensor:
        parts = torch.as_tensor(parts, dtype=torch.int32, device=w2.device)
        return _update_from_parts(cfg, state, w2, parts, batch_idx, eta)

    return run


def round_mask_context(cfg: CPMLConfig, draws, t: int,
                       w_shape: tuple[int, ...]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The W-independent half of round t's weight encode.

    Round t's draws (uniforms and the T fresh masks) and the masks' encoded
    contribution (N, *w_shape, r).  Returns ``(u, mask_shares)`` for
    ``encode_round_shares_split``; a pipelined master builds it while round
    t-1 is still in flight.
    """
    u, masks = draws.round(t, (*w_shape, cfg.r), cfg.T, cfg.p)
    return u, encode.weight_mask_shares(cfg, masks)


def encode_round_shares_split(cfg: CPMLConfig, u: torch.Tensor,
                              mask_shares: torch.Tensor, w2: torch.Tensor
                              ) -> torch.Tensor:
    """The W-dependent half: bit-identical to ``encode_round_shares`` when
    (u, mask_shares) came from ``round_mask_context`` for the same round."""
    return encode.encode_weights_finish(cfg, u, mask_shares, w2)


def update_fn(cfg: CPMLConfig, state: CPMLState, eta: float
              ) -> Callable[..., torch.Tensor]:
    """Returns ``run(w2, fastest, dmat, batch_idx=None) -> w2`` for worker
    results computed elsewhere: the same ``_round_update`` the in-process
    round composes."""

    def run(w2: torch.Tensor, fastest: torch.Tensor, dmat: torch.Tensor,
            batch_idx: torch.Tensor | None = None) -> torch.Tensor:
        return _round_update(cfg, state, w2, fastest, dmat, batch_idx, eta)

    return run


# ---------------------------------------------------------------------------
# Static per-round schedule (survivor decode matrices / batches)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Schedule:
    decode_mats: torch.Tensor          # (iters, R, K) int32
    orders: torch.Tensor               # (iters, R) int64 survivor indices
    batch_idx: torch.Tensor | None     # (iters, b) int64, or None (full)


def survivor_round(cfg: CPMLConfig, surv: np.ndarray | None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Survivor indices -> (decode matrix (R, K), order (R,)) for one round."""
    surv = np.arange(cfg.N) if surv is None else np.asarray(surv)
    if len(surv) < cfg.threshold:
        raise ValueError(f"{len(surv)} survivors < recovery threshold "
                         f"{cfg.threshold}")
    surv = surv[: cfg.threshold]
    return (decode.make_decode_matrix(cfg, surv).numpy(),
            surv.astype(np.int64))


def make_schedule(cfg: CPMLConfig, draws, iters: int, mk: int,
                  survivor_fn: Callable[[int], np.ndarray] | None = None,
                  device: str | torch.device = "cpu") -> Schedule:
    dmats, orders = [], []
    for t in range(iters):
        surv = survivor_fn(t) if survivor_fn is not None else None
        try:
            dmat, order = survivor_round(cfg, surv)
        except ValueError as e:
            raise ValueError(f"round {t}: {e}") from None
        dmats.append(dmat)
        orders.append(order)
    batch_idx = None
    if cfg.batch_rows is not None:
        batch_idx = torch.stack([
            torch.as_tensor(draws.batch(t, mk, cfg.batch_rows),
                            dtype=torch.int64).cpu()
            for t in range(iters)]).to(device)
    return Schedule(
        decode_mats=torch.as_tensor(np.stack(dmats), dtype=torch.int32,
                                    device=device),
        orders=torch.as_tensor(np.stack(orders), device=device),
        batch_idx=batch_idx)


# ---------------------------------------------------------------------------
# Training drivers
# ---------------------------------------------------------------------------

def _prepare(cfg, x, y, iters, eta, survivor_fn, draws, device):
    dev = _device.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, device=dev)
    draws = draws if draws is not None else TorchDraws(0, dev)
    state = setup(cfg, x, y, draws=draws)
    if eta is None:
        eta = lipschitz_eta(state.xq_real)
    sched = make_schedule(cfg, draws, iters, state.mk, survivor_fn, dev)
    return state, float(eta), sched, draws


def _record(cfg, state, w2, t, eval_every, history):
    if eval_every and (t + 1) % eval_every == 0:
        loss, acc = _eval_metrics(cfg, w2, state.xq_real[: state.m],
                                  state.y[: state.m])
        history.append({"iter": t + 1, "loss": float(loss),
                        "acc": float(acc)})


def train(cfg: CPMLConfig, x, y, iters: int, eta: float | None = None,
          survivor_fn: Callable[[int], np.ndarray] | None = None,
          eval_every: int = 0, *, draws=None,
          device: str | torch.device | None = None
          ) -> tuple[torch.Tensor, list[dict[str, float]]]:
    """Full Algorithm 1: a loop of ``_round`` over the static schedule.
    Returns (w, history).  Runs on CUDA unless ``device="cpu"``."""
    state, eta, sched, draws = _prepare(cfg, x, y, iters, eta, survivor_fn,
                                        draws, device)
    w2 = _w_internal(cfg, state.w)
    history: list[dict[str, float]] = []
    for t in range(iters):
        bidx = None if sched.batch_idx is None else sched.batch_idx[t]
        w2 = _round(cfg, draws, t, w2, state, sched.decode_mats[t],
                    sched.orders[t], bidx, eta)
        _record(cfg, state, w2, t, eval_every, history)
    return _w_public(cfg, w2), history


def train_reference(cfg: CPMLConfig, x, y, iters: int,
                    eta: float | None = None,
                    survivor_fn: Callable[[int], np.ndarray] | None = None,
                    eval_every: int = 0, *, draws=None,
                    device: str | torch.device | None = None
                    ) -> tuple[torch.Tensor, list[dict[str, float]]]:
    """Per-step loop through the ``round_fn`` hook over the same schedule
    as ``train``; the two are bit-identical."""
    state, eta, sched, draws = _prepare(cfg, x, y, iters, eta, survivor_fn,
                                        draws, device)
    run = round_fn(cfg, state, eta, draws)
    w2 = _w_internal(cfg, state.w)
    history: list[dict[str, float]] = []
    for t in range(iters):
        bidx = None if sched.batch_idx is None else sched.batch_idx[t]
        w2 = run(t, w2, sched.decode_mats[t], sched.orders[t], bidx)
        _record(cfg, state, w2, t, eval_every, history)
    return _w_public(cfg, w2), history


# ---------------------------------------------------------------------------
# Cleartext-side helpers: step size, metrics
# ---------------------------------------------------------------------------

def lipschitz_eta(xq_real: torch.Tensor) -> float:
    """eta = 1/L with L = max eig(X̄ᵀX̄)/(4m), by power iteration (see the
    reference's docstring for the 1/m the paper's Lemma 2 omits)."""
    m, d = xq_real.shape
    v = torch.ones(d, dtype=torch.float32, device=xq_real.device) / math.sqrt(d)
    for _ in range(50):
        v = xq_real.T @ (xq_real @ v)
        v = v / (torch.linalg.norm(v) + 1e-30)
    lam = v @ (xq_real.T @ (xq_real @ v))
    return float(4.0 * m / lam)


def sigmoid(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-z))


def cleartext_baseline(cfg: CPMLConfig, x: torch.Tensor, y: torch.Tensor,
                       iters: int, eta: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-private GD on the quantized dataset with the TRUE sigmoid.
    Returns (w, xq): w shaped like train()'s output, xq the dequantized
    dataset."""
    xq = quantize.dequantize(quantize.quantize_data(x, cfg.lx, cfg.p),
                             cfg.lx, cfg.p)
    m = x.shape[0]
    if eta is None:
        eta = lipschitz_eta(xq)
    targets = _targets(cfg, y)
    w = torch.zeros((x.shape[1], cfg.c), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        w = w - eta * (xq.T @ (sigmoid(xq @ w) - targets)) / m
    return _w_public(cfg, w), xq


def loss_and_accuracy(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary logistic loss + accuracy (w (d,), y (m,) in {0,1})."""
    yhat = sigmoid(x @ w)
    eps = 1e-7
    loss = -torch.mean(y * torch.log(yhat + eps)
                       + (1 - y) * torch.log(1 - yhat + eps))
    acc = ((yhat > 0.5) == (y > 0.5)).to(torch.float32).mean()
    return loss, acc


def multiclass_loss_and_accuracy(w: torch.Tensor, x: torch.Tensor,
                                 labels: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-vs-all logistic loss (mean over heads) + argmax accuracy."""
    z = x @ w
    yhat = sigmoid(z)
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                         w.shape[1]).to(torch.float32)
    eps = 1e-7
    loss = -torch.mean(onehot * torch.log(yhat + eps)
                       + (1 - onehot) * torch.log(1 - yhat + eps))
    acc = (torch.argmax(z, dim=1) == labels.to(torch.int64)).to(
        torch.float32).mean()
    return loss, acc


def per_class_accuracy(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """(c,) recall per class under the argmax decision rule."""
    pred = torch.argmax(x @ w, dim=1)
    labels = labels.to(torch.int64)
    c = w.shape[1]
    hit = torch.zeros(c, device=w.device).index_add_(
        0, labels, (pred == labels).to(torch.float32))
    cnt = torch.zeros(c, device=w.device).index_add_(
        0, labels, torch.ones_like(labels, dtype=torch.float32))
    return hit / torch.clamp(cnt, min=1.0)


def _eval_metrics(cfg: CPMLConfig, w2: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if cfg.c == 1:
        return loss_and_accuracy(w2[:, 0], x, y)
    return multiclass_loss_and_accuracy(w2, x, y)
