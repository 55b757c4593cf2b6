"""The comparison that decides ``correct``.

The program's outputs of a run (the coded dataset, and for each of the
first ``CHECKED`` rounds its weight shares, every worker's result, the
decoded parts and the weights after the step) are held against the plain
reference (``references/<name>.py``), which works each of them out again
from the raw dataset.  The masks are random: the judge reads them off the
program's shares (the values of the shares' polynomial at the T mask
points) and holds them to the uniform distribution on F_p, so any way of
drawing uniform masks passes.  Six numbers come out, each with a limit of
its own (``limits/<cell>.json``):

  field_mismatch  field elements that differ from the reference: the coded
                  dataset (its values at the K data points against the
                  reference's quantization, and all N shares against the
                  reference's encode of those values and the program's
                  masks), and in each checked round the K data points of
                  the weight shares (each must hold the same W̄), all N
                  weight shares, all N worker results and the decoded
                  parts.  Exact: the limit is 0.
  wbar_mismatch   entries of each checked round's W̄ (read off the weight
                  shares) that no stochastic rounding of 2^lw w can give,
                  w being the program's own weights before that round:
                  W̄ is floor(2^lw w), or floor + 1 where 2^lw w is not an
                  integer.  Exact (a power of two scales a float exactly):
                  the limit is 0.  The reference goes on from the
                  program's W̄, so that a rounding flip at a step boundary
                  does not cascade; this number checks the stage it skips.
  mask_bin_gap    the largest relative gap between the masks' count in one
                  of 16 equal bins of F_p and the uniform distribution's,
                  over the dataset's masks and each checked round's: the
                  privacy the configuration states, as far as a count
                  shows it.
  loss_gap        the largest relative gap of the loss after steps 1..3.
  grad_gap        the first gradient, per head (a head's d weights are one
                  leaf), from the weights after one step: the worst head's
                  gap between the two norms, over the reference's norm of
                  that head or the median head's, whichever is larger.
  change_gap      the same for the weights' change over the three steps.

Heads whose reference gradient is under a thousandth of the median head's
are left out of grad_gap and change_gap (none are at the benchmark's
sizes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

CHECKED = 3
NUMBERS = ("field_mismatch", "wbar_mismatch", "mask_bin_gap", "loss_gap",
           "grad_gap", "change_gap")


@dataclasses.dataclass
class ProgramOutputs:
    """What the program produced, as the judge reads it."""
    x_shares: torch.Tensor               # (N, mk, d)
    rounds: list[dict[str, torch.Tensor]]  # w_shares, results, parts
    weights: list[torch.Tensor]          # w0..w_CHECKED, each (d, c)


def wbar_mismatch(w: torch.Tensor, wbar: torch.Tensor, lw: int, p: int
                  ) -> int:
    """Entries of W̄ (*w.shape, r) that are neither floor(v) nor, where v is
    not an integer, floor(v) + 1, for v = 2^lw w in w's own dtype."""
    v = (w * float(2 ** lw))[..., None]
    low = torch.floor(v)
    wbar = wbar.to(device=v.device, dtype=torch.int64)
    n = torch.where(wbar >= (p - 1) // 2, wbar - p, wbar)
    fl = low.to(torch.int64)
    ok = (n == fl) | ((n == fl + 1) & (v > low))
    return int((~ok).sum())


def head_gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor
             ) -> float:
    """Worst kept head's |‖prog_h‖ - ‖ref_h‖| / max(‖ref_h‖, median)."""
    pn = torch.linalg.vector_norm(prog.to(torch.float64), dim=0)
    rn = torch.linalg.vector_norm(ref.to(torch.float64), dim=0)
    med = torch.median(rn)
    gap = (pn - rn).abs() / torch.maximum(rn, med)
    return float(gap[keep].max())


def _differ(a: torch.Tensor, b: torch.Tensor, block: int = 8) -> int:
    """Elements of a and b (same shape, any integer dtype) that differ,
    compared a block of leading rows at a time."""
    dev = b.device
    return sum(int((a[s:s + block].to(dev).to(torch.int64)
                    != b[s:s + block].to(torch.int64)).sum())
               for s in range(0, a.shape[0], block))


def judge(ref, code, x: torch.Tensor, y: torch.Tensor, out: ProgramOutputs
          ) -> dict[str, float]:
    """The six numbers for one run.  ``ref`` is the reference module,
    ``code`` its code, (x, y) the raw dataset both sides were given."""
    p, K = code.p, code.K
    dev = x.device
    rows = ref.recover_rows(code, out.x_shares.to(dev))
    mism = _differ(rows[:K], ref.quantized_parts(code, x))
    masks = rows[K:]
    del rows
    mask_gap = ref.mask_bin_gap(masks, p)
    ds = ref.setup(code, x, y, masks)
    del masks
    mism += _differ(out.x_shares, ds.x_shares)
    d = x.shape[1]
    w = torch.zeros((d, code.c), dtype=ds.xq_real.dtype, device=dev)
    ref_w = [w]
    wbar_bad = 0
    for t in range(CHECKED):
        got = out.rounds[t]
        rows = ref.recover_rows(code, got["w_shares"].to(dev))
        wbar = rows[0]
        mism += _differ(rows[1:K], wbar.expand(K - 1, *wbar.shape))
        mask_gap = max(mask_gap, ref.mask_bin_gap(rows[K:], p))
        wbar_bad += wbar_mismatch(out.weights[t].to(dev), wbar, code.lw, p)
        res = ref.round_update(ds, w, wbar, rows[K:], range(code.threshold))
        for key in ("w_shares", "results", "parts"):
            mism += _differ(got[key], res[key])
        w = res["w"]
        ref_w.append(w)
    prog_w = [v.to(dev).to(torch.float64) for v in out.weights]
    ref_w = [v.to(torch.float64) for v in ref_w]
    loss_gap = max(abs(ref.loss(ds, a) - ref.loss(ds, b)) / abs(ref.loss(ds, b))
                   for a, b in zip(prog_w[1:], ref_w[1:]))
    g_ref = ref_w[0] - ref_w[1]
    gn = torch.linalg.vector_norm(g_ref, dim=0)
    keep = gn >= 1e-3 * torch.median(gn)
    return {
        "field_mismatch": mism,
        "wbar_mismatch": wbar_bad,
        "mask_bin_gap": mask_gap,
        "loss_gap": loss_gap,
        "grad_gap": head_gap(prog_w[0] - prog_w[1], g_ref, keep),
        "change_gap": head_gap(prog_w[CHECKED] - prog_w[0],
                               ref_w[CHECKED] - ref_w[0], keep),
    }


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct when every number is at or under its limit (and finite)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS)


def control_outputs(ref, code, x: torch.Tensor, y: torch.Tensor, seed: int,
                    real: torch.dtype) -> ProgramOutputs:
    """The control: the reference put in the program's place, with its own
    draws, its real values (step size, weights, dequantized gradient, step)
    in ``real``, the precision below the configuration's float32."""
    draws = ref.Draws(seed)
    d = x.shape[1]
    mk = -(-x.shape[0] // code.K)
    ds = ref.setup(code, x, y, draws.dataset_masks(code.T, mk, d, code.p),
                   real=real)
    w = torch.zeros((d, code.c), dtype=real, device=x.device)
    rounds, weights = [], [w]
    for t in range(CHECKED):
        u, masks = draws.round(t, (d, code.c, code.r), code.T, code.p)
        wbar = ref.quantize_weights(w, u, code.lw, code.p)
        res = ref.round_update(ds, w, wbar, masks, range(code.threshold))
        rounds.append(res)
        w = res["w"]
        weights.append(w)
    return ProgramOutputs(ds.x_shares, rounds, weights)
