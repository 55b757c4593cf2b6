"""Optimizers from scratch: AdamW and SGD-momentum, the warmup-cosine
schedule and global-norm clipping; mirrors ``repro/optim/optimizers.py``.

Parameters, gradients and state are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``), where the reference maps over
pytrees.  The moments are float32 whatever the parameter dtype, and each
update is computed in float32 and cast back to the parameter's dtype, as
in the reference.  ``apply_updates`` writes the new parameters and state
in place under ``torch.no_grad()`` (the reference returns new trees) and
returns the same dicts, so a full-width model holds no second copy.

On a device mesh the leaves are ``DTensor``s: the moments are laid out
as their parameters, each gradient is brought to its parameter's layout
before the update (a reduce-scatter or an all-reduce of what the backward
left split over ranks), and the global norm is the norm of the whole
tree, every rank's blocks counted once.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.parallel import rules

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | sgd
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0
    compress: str = "none"           # none | stochastic_quant (optim/compress)
    compress_bits: int = 8


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * cos


def init_state(cfg: OptimizerConfig, params: Tree) -> dict:
    """{"step": int32 0, "mu"/"nu" (AdamW) or "mom" (SGD): float32 zeros
    per parameter, on its device and, on a mesh, in its layout}."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    first = next(iter(params.values()))
    dev = rules.local(first).device
    state: dict = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    names = ("mu", "nu") if cfg.name == "adamw" else ("mom",)
    for name in names:
        state[name] = {k: zeros(p) for k, p in params.items()}
    return state


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient g in its parameter's layout (a no-op off a mesh)."""
    if rules.is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, leaves in order.
    On a mesh each rank sums its own blocks' squares, each divided by the
    number of ranks that hold a copy of that block, and one all-reduce a
    mesh dim adds the ranks' sums: a plain tensor, the same on every
    rank."""
    leaves = list(tree.values())
    if not leaves or not rules.is_dtensor(leaves[0]):
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in leaves))
    mesh = leaves[0].device_mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            raise ValueError("global_norm of a partial sum: redistribute "
                             "it to its parameter's layout first")
        copies = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                           if p.is_replicate())
        local = g.to_local().to(torch.float32)
        total = total + torch.sum(torch.square(local)) / copies
    for i in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """(every leaf in float32 times min(1, max_norm / norm), norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: g.to(torch.float32) * scale for k, g in tree.items()}, norm


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Tree, grads: Tree,
                  state: dict) -> tuple[Tree, dict, dict]:
    """One optimizer step, in place.  Returns (params, state, metrics) with
    metrics {"grad_norm", "lr"}.

    The gradients are clipped by their global norm leaf by leaf (each
    leaf's float32 copy lives only while its update runs), then AdamW
    (bias-corrected moments, decoupled weight decay) or SGD-momentum.  A
    parameter with no gradient (``None``) takes a zero gradient, as the
    reference's ``value_and_grad`` gives one.
    """
    grads = {k: torch.zeros_like(p) if grads.get(k) is None else
             _as_param(grads[k], p) for k, p in params.items()}
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    if cfg.name == "adamw":
        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        p32 = p.to(torch.float32)
        if cfg.name == "adamw":
            m, v = state["mu"][k], state["nu"][k]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p32
            p.copy_((p32 - lr * u).to(p.dtype))
        else:
            m = state["mom"][k]
            m.copy_(cfg.momentum * m + g)
            p.copy_((p32 - lr * m).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
