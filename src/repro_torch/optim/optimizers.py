"""Optimizers from scratch: AdamW and SGD-momentum, the warmup-cosine
schedule and global-norm clipping; mirrors ``repro/optim/optimizers.py``.

Parameters, gradients and state are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``), where the reference maps over
pytrees.  The moments are float32 whatever the parameter dtype, and each
update is computed in float32 and cast back to the parameter's dtype, as
in the reference.  ``apply_updates`` writes the new parameters and state
in place under ``torch.no_grad()`` (the reference returns new trees) and
returns the same dicts, so a full-width model holds no second copy.
"""
from __future__ import annotations

import dataclasses
import math

import torch

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
    per parameter, on its device}."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(iter(params.values())).device
    state: dict = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    names = ("mu", "nu") if cfg.name == "adamw" else ("mom",)
    for name in names:
        state[name] = {k: zeros(p) for k, p in params.items()}
    return state


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, leaves in order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


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
    grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
             for k, p in params.items()}
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
