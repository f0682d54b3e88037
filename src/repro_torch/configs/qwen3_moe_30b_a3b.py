"""qwen3-moe-30b-a3b — 128-expert top-8 MoE with QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, moe_top_k=8, qk_norm=True,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=64, vocab=512, head_dim=16,
    n_experts=8, moe_top_k=4, qk_norm=True,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)
