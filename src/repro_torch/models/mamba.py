"""Mamba-1 selective SSM block (falcon-mamba); mirrors
``repro/models/mamba.py``.

Prefill runs the whole sequence through ``kernels.ops.selective_scan``: the
hand-written CUDA kernel on a CUDA tensor, its plain sequential version on
a CPU tensor.  The reference's chunked associative scan (``_chunk_scan``
over materialised (B, chunk, d_inner, n) tensors) has no counterpart here:
the kernel keeps h on chip for the whole sequence.  With the default
``RunConfig.ssm_dtype="f32"`` it computes the same function as the
reference's ``mamba_mix`` (``tests/test_kernels_mamba.py`` holds the
reference kernel against it), and ``scan_chunk`` changes nothing.  With
``ssm_dtype="bf16"`` the kernel rounds a and b to bf16 and combines them
in bf16 within chunks of ``scan_chunk`` steps, h in float32 across
chunks, as the reference does; it combines sequentially where the
reference combines a chunk as a tree, so the two round in another order.

On a device mesh (``DTensor`` inputs) the channel-local parts run on each
rank's own ``inner`` block under ``local_map`` (batch over the data axes):
the depthwise conv and silu, and the scan, so the forward kernel and its
backward kernel run unchanged on the rank's channels; the projections
between them are ``DTensor`` matmuls.

Decode is the exact single-step recurrence with (conv window, ssm state)
carried in the cache, in plain PyTorch as in the reference.  On a mesh the
conv window and the recurrence are ``local_map`` bodies on the rank's
channels, the conv cache (B, cw-1, di) and the state (B, di, n) placed
with ``inner`` over ``model``, and the projections between them are the
prefill's ``DTensor`` products (``_ssm_params``).
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import rules

Params = Mapping[str, torch.Tensor]


def mamba_template(cfg: ModelConfig, d_model: int | None = None
                   ) -> dict[str, ParamSpec]:
    d = d_model or cfg.d_model
    di, n, dtr, cw = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.conv_width
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamSpec((cw, di), (None, "inner")),
        "conv_b": ParamSpec((di,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * n), ("inner", None)),
        "dt_proj": ParamSpec((dtr, di), (None, "inner")),
        "dt_bias": ParamSpec((di,), ("inner",), init="ones"),
        "A_log": ParamSpec((di, n), ("inner", None), dtype=torch.float32,
                           init="ones"),
        "D": ParamSpec((di,), ("inner",), dtype=torch.float32, init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _ssm_params(p: Params, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, L, di) post-conv activations -> (dt, B_mat, C_mat) in the
    parameter dtype.

    The projections run in the parameter dtype and the softplus in it too;
    the cast to float32 is the caller's, as the reference casts last: the
    decode step casts all three, and the prefill's scan kernel reads dt and
    Bm/Cm in their own dtype (an exact widening).
    """
    dtr = p["dt_proj"].shape[0]
    n = (p["x_proj"].shape[1] - dtr) // 2
    # on a mesh the product sums over the channels' ranks: placed whole
    proj = rules.constrain(x @ rules.gathered(p["x_proj"]),
                           ("batch", "seq", None))           # (B, L, dtr+2n)
    dt = layers.softplus(proj[..., :dtr] @ rules.gathered(p["dt_proj"])
                         + p["dt_bias"].to(proj.dtype))      # (B, L, di)
    Bm = proj[..., dtr: dtr + n]                             # (B, L, n)
    Cm = proj[..., dtr + n:]                                 # (B, L, n)
    return dt, Bm, Cm


def _discretize(p: Params, dt: torch.Tensor, Bm: torch.Tensor,
                x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = exp(dt*A) (B,L,di,n); b = dt*B*x (B,L,di,n), float32."""
    A = -torch.exp(p["A_log"].float())                       # (di, n)
    a = torch.exp(dt[..., None] * A[None, None])
    b = dt[..., None] * Bm[:, :, None, :] * x.float()[..., None]
    return a, b


def mamba_mix(cfg: ModelConfig, rc: RunConfig, p: Params, x_in: torch.Tensor,
              h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective-scan core.  x_in: (B, S, di) pre-conv.  Returns
    (y (B, S, di) in x_in's dtype, h_last (B, di, n) float32).
    ``rc.ssm_dtype`` and ``rc.scan_chunk`` choose the scan's a/b mode.
    On ``DTensor``s the conv and the scan run on each rank's channels."""
    if rules.is_dtensor(x_in):
        return _mix_on_mesh(cfg, rc, p, x_in, h0)
    x = _conv(x_in, p["conv_w"], p["conv_b"])
    dt, Bm, Cm = _ssm_params(p, x)
    y, h_last = _scan(x, dt, Bm, Cm, p["A_log"], p["D"], h0, rc)
    return y.to(x_in.dtype), h_last


def _conv(x_in: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor
          ) -> torch.Tensor:
    """Depthwise causal conv then silu: the cw shifted slices summed in
    the reference's order (F.conv1d rounds bf16 differently)."""
    cw, S = conv_w.shape[0], x_in.shape[1]
    xp = F.pad(x_in, (0, 0, cw - 1, 0))
    x = sum(xp[:, i: i + S] * conv_w[i] for i in range(cw))
    return layers.silu(x + conv_b.to(x.dtype))


def _scan(x, dt, Bm, Cm, a_log, d, h0, rc: RunConfig):
    """``ops.selective_scan`` in ``rc``'s a/b mode, from h0 or zeros."""
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2], a_log.shape[1]),
                         dtype=torch.float32, device=x.device)
    return ops.selective_scan(x, dt, Bm, Cm, a_log, d, h0, rc.ssm_dtype,
                              rc.scan_chunk)


def _mix_on_mesh(cfg: ModelConfig, rc: RunConfig, p: Params, x_in, h0):
    """``mamba_mix`` on ``DTensor``s: ``inner`` over ``model`` and batch
    over the data axes, as the rules place them.  The conv and the scan
    are ``local_map`` bodies on the rank's channels; the gradients of the
    inputs a rank shares with the other ranks of an axis (B and C over
    ``model``, the parameters over the data axes) are its part of theirs."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x_in.device_mesh
    B, S, di = x_in.shape
    n = cfg.ssm_state

    def pl(shape, logical):
        return rules.act_placements(mesh, shape, logical)

    xpl = pl((B, S, di), ("batch", None, "inner"))
    cwpl = pl((cfg.conv_width, di), (None, "inner"))
    cbpl = pl((di,), ("inner",))
    x = local_map(_conv, out_placements=list(xpl),
                  in_placements=(xpl, cwpl, cbpl),
                  in_grad_placements=(xpl,
                                      layers.grad_placements(cwpl, xpl),
                                      layers.grad_placements(cbpl, xpl)),
                  device_mesh=mesh, redistribute_inputs=True)(
        x_in, p["conv_w"], p["conv_b"])
    dt, Bm, Cm = _ssm_params(p, x)
    bcpl = pl((B, S, n), ("batch", None, None))
    apl, dpl = pl((di, n), ("inner", None)), pl((di,), ("inner",))
    hpl = pl((B, di, n), ("batch", "inner", None))
    ins, in_pl = [x, dt, Bm, Cm, p["A_log"], p["D"]], [xpl, xpl, bcpl, bcpl,
                                                        apl, dpl]
    if h0 is not None:
        ins.append(h0)
        in_pl.append(hpl)
    grads = [layers.grad_placements(q, xpl) for q in in_pl]

    def body(x, dt, bm, cm, a_log, d, h0=None):
        return _scan(x, dt, bm, cm, a_log, d, h0, rc)

    y, h_last = local_map(body, out_placements=(xpl, hpl),
                          in_placements=tuple(in_pl),
                          in_grad_placements=tuple(grads), device_mesh=mesh,
                          redistribute_inputs=True)(*ins)
    return y.to(x_in.dtype), h_last


def mamba_forward(cfg: ModelConfig, rc: RunConfig, p: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """Full mamba block.  x: (B, S, d_model) -> (B, S, d_model)."""
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    y, _ = mamba_mix(cfg, rc, p, x_in)
    return (y * layers.silu(z)) @ p["out_proj"]


def _conv_step(x_in: torch.Tensor, conv: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv window (B, cw-1, di) and one new input (B, 1, di) ->
    (the post-conv activation (B, 1, di), the window shifted by one)."""
    conv_buf = torch.cat([conv.to(x_in.dtype), x_in], dim=1)   # (B, cw, di)
    xc = torch.einsum("bwi,wi->bi", conv_buf, conv_w)[:, None]
    return layers.silu(xc + conv_b.to(xc.dtype)), conv_buf[:, 1:]


def _step(xc, dt, Bm, Cm, a_log, d, h0) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence from the state h0 (B, di, n): (y (B, 1,
    di) float32, the new state)."""
    dt, Bm, Cm = dt.float(), Bm.float(), Cm.float()
    a, b = _discretize({"A_log": a_log}, dt, Bm, xc)   # (B, 1, di, n)
    h = a[:, 0] * h0 + b[:, 0]                         # (B, di, n)
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None]
    return y + d.float() * xc.float(), h


def mamba_decode_core(cfg: ModelConfig, p: Params, x_in: torch.Tensor,
                      cache: Mapping[str, torch.Tensor]
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token recurrence on the pre-conv branch input.

    x_in: (B, 1, di); cache: conv (B, cw-1, di), ssm (B, di, n).
    Returns (y (B, 1, di), new cache).  O(1) in context length.  On
    ``DTensor``s: ``_decode_core_on_mesh``.
    """
    if rules.is_dtensor(x_in):
        return _decode_core_on_mesh(cfg, p, x_in, cache)
    xc, conv = _conv_step(x_in, cache["conv"], p["conv_w"], p["conv_b"])
    dt, Bm, Cm = _ssm_params(p, xc)
    y, h = _step(xc, dt, Bm, Cm, p["A_log"], p["D"], cache["ssm"])
    return y.to(x_in.dtype), {"conv": conv, "ssm": h}


def _decode_core_on_mesh(cfg: ModelConfig, p: Params, x_in, cache):
    """``mamba_decode_core`` on ``DTensor``s: ``inner`` over ``model`` and
    batch over the data axes.  The conv step and the recurrence run on the
    rank's channels; x_proj's product sums over them and is reduced once
    over ``model`` (``_ssm_params``' constraint)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x_in.device_mesh
    B, _, di = x_in.shape
    n = cfg.ssm_state

    def pl(shape, logical):
        return rules.act_placements(mesh, shape, logical)

    xpl = pl((B, 1, di), ("batch", None, "inner"))
    cpl = pl(tuple(cache["conv"].shape), ("batch", None, "inner"))
    hpl = pl((B, di, n), ("batch", "inner", None))
    xc, conv = local_map(
        _conv_step, out_placements=(xpl, cpl),
        in_placements=(xpl, cpl, pl((cfg.conv_width, di), (None, "inner")),
                       pl((di,), ("inner",))),
        device_mesh=mesh, redistribute_inputs=True)(
        x_in, cache["conv"], p["conv_w"], p["conv_b"])
    dt, Bm, Cm = _ssm_params(p, xc)
    bcpl = pl((B, 1, n), ("batch", None, None))
    y, h = local_map(
        _step, out_placements=(xpl, hpl),
        in_placements=(xpl, xpl, bcpl, bcpl, pl((di, n), ("inner", None)),
                       pl((di,), ("inner",)), hpl),
        device_mesh=mesh, redistribute_inputs=True)(
        xc, dt, Bm, Cm, p["A_log"], p["D"], cache["ssm"])
    return y.to(x_in.dtype), {"conv": conv, "ssm": h}


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Mapping[str, torch.Tensor]
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-block single-token step.  x: (B, 1, d_model)."""
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)                # (B, 1, di)
    y, new_cache = mamba_decode_core(cfg, p, x_in, cache)
    return (y * layers.silu(z)) @ p["out_proj"], new_cache
