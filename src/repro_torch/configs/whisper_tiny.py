"""whisper-tiny — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

The audio conv frontend is a stub: input_specs() provides precomputed frame
embeddings (batch, enc_frames, d_model).  Positional scheme normalized to
RoPE across the pool (DESIGN.md §6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, act="gelu",
    is_encoder_decoder=True, num_encoder_layers=4, encoder_seq_len=1500,
    frontend="audio",
    block_pattern=(("dec", 4),),
    source="[arXiv:2212.04356; unverified]",
)
