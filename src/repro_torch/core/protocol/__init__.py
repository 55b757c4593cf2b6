"""CodedPrivateML protocol engine (paper Algorithm 1) on torch tensors.

Mirrors ``repro/core/protocol``: one module per stage.

  encode.py   quantize -> Lagrange-encode (dataset once, weights per round)
  compute.py  worker polynomial f (Eq. 20): all N workers in one kernel,
              or one share a rank (backend="shard")
  decode.py   survivor pattern -> cached decode matrix -> dequantize;
              the host streaming decoder of the cluster runtime
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
    DecodePlan,
    StreamingDecoder,
    decode_parts,
    make_decode_matrix,
    parts_to_gradient,
    prefix_decode_plan,
)
from repro_torch.core.protocol.engine import (
    CPMLState,
    Schedule,
    cleartext_baseline,
    encode_round_shares,
    encode_round_shares_split,
    lipschitz_eta,
    loss_and_accuracy,
    make_schedule,
    multiclass_loss_and_accuracy,
    per_class_accuracy,
    poly_coeffs,
    round_fn,
    round_fn_split,
    round_mask_context,
    round_parts,
    setup,
    sigmoid,
    survivor_round,
    train,
    train_reference,
    update_fn,
    update_from_parts_fn,
)

__all__ = [
    "CPMLConfig",
    "CPMLState",
    "DecodePlan",
    "Schedule",
    "StreamingDecoder",
    "TorchDraws",
    "all_worker_results",
    "cleartext_baseline",
    "decode_gradient",
    "decode_parts",
    "encode_dataset",
    "encode_round_shares",
    "encode_round_shares_split",
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
    "prefix_decode_plan",
    "round_fn",
    "round_fn_split",
    "round_mask_context",
    "round_parts",
    "setup",
    "sigmoid",
    "survivor_round",
    "train",
    "train_reference",
    "update_fn",
    "update_from_parts_fn",
    "weight_mask_shares",
    "worker_fn",
]
