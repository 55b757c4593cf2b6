"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig

# 32 layers, 3 full-attention layers (first / middle / last — Hymba paper),
# sliding-window attention elsewhere; every block runs attention ∥ mamba.
CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, ssm_state=16,
    sliding_window=1024,
    block_pattern=(("hybrid_global", 1), ("hybrid", 14), ("hybrid_global", 1),
                   ("hybrid", 14), ("hybrid_global", 1), ("hybrid", 1)),
    source="[arXiv:2411.13676; hf]",
)
