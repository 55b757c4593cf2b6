"""Carry the reference's configuration and state across to the port.

The reference's objects never cross directly (the port imports nothing of
``repro``): the caller flattens them to plain python and numpy first,
``dataclasses.asdict(cfg)`` for a config and the ``CPMLState`` fields as
numpy arrays for a state, ``jax.tree.map(np.asarray, params)`` for a
model's parameter pytree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.core.protocol.engine import CPMLState

# The reference field with no counterpart: the device picks the kernel path.
_DROPPED = ("use_kernel",)


def config_from_reference(d: dict) -> CPMLConfig:
    """``dataclasses.asdict`` of a reference CPMLConfig -> the port's."""
    known = {f.name for f in dataclasses.fields(CPMLConfig)}
    unknown = set(d) - known - set(_DROPPED)
    if unknown:
        raise ValueError(f"reference config fields with no counterpart: "
                         f"{sorted(unknown)}")
    return CPMLConfig(**{k: v for k, v in d.items() if k in known})


def state_from_reference(arrays: dict[str, np.ndarray],
                         device: str | torch.device) -> CPMLState:
    """The reference CPMLState's fields (numpy arrays, python ints for m and
    mk) -> the port's CPMLState on ``device``, dtypes kept."""
    fields = {}
    for f in dataclasses.fields(CPMLState):
        v = arrays[f.name]
        if f.name in ("m", "mk"):
            fields[f.name] = int(v)
        else:
            fields[f.name] = torch.as_tensor(np.array(v), device=device)
    return CPMLState(**fields)


def run_config_from_reference(d: dict) -> RunConfig:
    """``dataclasses.asdict`` of a reference RunConfig -> the port's."""
    unknown = set(d) - {f.name for f in dataclasses.fields(RunConfig)}
    if unknown:
        raise ValueError(f"reference run-config fields with no counterpart: "
                         f"{sorted(unknown)}")
    return RunConfig(**d)


def _tensor(a, device: str | torch.device) -> torch.Tensor:
    """numpy -> torch, dtype kept (bfloat16 arrives as ml_dtypes'
    bfloat16, which torch cannot read directly: its bits are reinterpreted)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a.copy(), device=device)


def _flatten(tree: dict, prefix: str, layer: int | None):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.", layer)
        else:
            yield f"{prefix}{k}", (v if layer is None else v[layer])


def params_from_reference(cfg: ModelConfig, tree: dict,
                          device: str | torch.device = "cpu"):
    """The reference's ``init_params`` pytree (numpy leaves) -> the port's
    ``models.model.Model`` on ``device``, dtypes kept.

    A segment with count > 1 stacks its layers on a leading axis in the
    reference (``repro/models/model.py``); here each layer is its own
    module, so that axis is unstacked.  A block's sub-dicts (``attn``,
    ``mlp``, ``moe``, ``mamba``, ``xattn``) become dotted names, the MoE
    experts' (E, d, ff) leaves and the float32 router among them.  An
    encoder-decoder model's ``enc`` segment and ``enc_norm`` come across
    the same way, as ``enc.{layer}`` and ``enc_norm``.
    """
    from repro_torch.models import model as M

    state = {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                  "enc_norm") if k in tree}
    stacks = [(tree[f"seg{si}"]["params"], f"segments.{si}.", count)
              for si, (_, count) in enumerate(cfg.block_pattern)]
    if cfg.is_encoder_decoder:
        stacks.append((tree["enc"]["params"], "enc.", cfg.num_encoder_layers))
    for seg, prefix, count in stacks:
        for li in range(count):
            state.update(_flatten(seg, f"{prefix}{li}.",
                                  li if count > 1 else None))
    state = {k: _tensor(v, device) for k, v in state.items()}
    model = M.Model(cfg, dtype=state["embed"].dtype, device=device, seed=None)
    own = model.state_dict()
    if set(own) != set(state):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(state))}, extra "
                         f"{sorted(set(state) - set(own))}")
    for k, t in own.items():
        if t.shape != state[k].shape or t.dtype != state[k].dtype:
            raise ValueError(f"{k}: reference {tuple(state[k].shape)} "
                             f"{state[k].dtype}, port {tuple(t.shape)} {t.dtype}")
    model.load_state_dict(state)
    return model
