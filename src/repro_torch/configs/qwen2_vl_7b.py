"""qwen2-vl-7b — M-RoPE, dynamic-resolution ViT (STUB frontend)
[arXiv:2409.12191; hf].

The vision tower is a stub: input_specs() feeds precomputed patch embeddings
(batch, seq, d_model).  M-RoPE degenerates to 1-D RoPE for text-only
position streams; the (t,h,w) section split is recorded for provenance.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision",
    source="[arXiv:2409.12191; hf]",
)
