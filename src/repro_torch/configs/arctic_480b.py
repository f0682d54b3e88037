"""arctic-480b — 128-expert top-2 MoE with a parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, moe_top_k=2,
    moe_dense_residual=True, moe_dense_ff=4864,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="arctic-480b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=96, vocab=512, head_dim=16,
    n_experts=8, moe_top_k=2,
    moe_dense_residual=True, moe_dense_ff=96,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)
