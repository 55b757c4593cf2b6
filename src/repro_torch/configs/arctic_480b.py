"""arctic-480b — 128-expert top-2 MoE + dense residual [hf:Snowflake; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, moe_d_ff=4864,
    dense_residual_d_ff=4864,
    source="[hf:Snowflake/snowflake-arctic-base; hf]",
)
