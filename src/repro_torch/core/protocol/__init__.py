"""CodedPrivateML protocol engine (paper Algorithm 1) on torch tensors.

Mirrors ``repro/core/protocol``: one module per stage.

  encode.py   quantize -> Lagrange-encode (dataset once, weights per round)
  compute.py  worker polynomial f (Eq. 20), all N workers in one kernel
  decode.py   survivor pattern -> cached decode matrix -> dequantize
  engine.py   training drivers: train(), train_reference(), metrics
  draws.py    the randomness seam (masks, uniforms, batches)
  config.py   the static CPMLConfig every stage reads
"""
from repro_torch.core.protocol.config import CPMLConfig
from repro_torch.core.protocol.draws import TorchDraws
from repro_torch.core.protocol.encode import (
    encode_dataset,
    encode_weights,
    encode_weights_finish,
    pad_rows,
    weight_mask_shares,
)
from repro_torch.core.protocol.compute import all_worker_results, worker_fn
from repro_torch.core.protocol.decode import (
    decode_gradient,
    decode_parts,
    make_decode_matrix,
    parts_to_gradient,
)
from repro_torch.core.protocol.engine import (
    CPMLState,
    Schedule,
    cleartext_baseline,
    encode_round_shares,
    lipschitz_eta,
    loss_and_accuracy,
    make_schedule,
    multiclass_loss_and_accuracy,
    per_class_accuracy,
    poly_coeffs,
    round_fn,
    round_parts,
    setup,
    sigmoid,
    survivor_round,
    train,
    train_reference,
    update_fn,
)

__all__ = [
    "CPMLConfig",
    "CPMLState",
    "Schedule",
    "TorchDraws",
    "all_worker_results",
    "cleartext_baseline",
    "decode_gradient",
    "decode_parts",
    "encode_dataset",
    "encode_round_shares",
    "encode_weights",
    "encode_weights_finish",
    "lipschitz_eta",
    "loss_and_accuracy",
    "make_decode_matrix",
    "make_schedule",
    "multiclass_loss_and_accuracy",
    "pad_rows",
    "parts_to_gradient",
    "per_class_accuracy",
    "poly_coeffs",
    "round_fn",
    "round_parts",
    "setup",
    "sigmoid",
    "survivor_round",
    "train",
    "train_reference",
    "update_fn",
    "weight_mask_shares",
    "worker_fn",
]
