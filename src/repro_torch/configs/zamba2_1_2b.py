"""zamba2-1.2b — Mamba2 backbone + ONE shared attention block applied
every 6 blocks (with per-site LoRA adapters).  [arXiv:2411.15242; hf]

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared block runs at width 2*d on concat([hidden, embedding]) as in
the Zamba design; the MLP width 8192 is the shared block's FFN.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    attn_every=6, shared_lora_rank=128,
    mlp="gelu", norm="rmsnorm", rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4, ssm_chunk=8,
    attn_every=2, shared_lora_rank=8,
    mlp="gelu", norm="rmsnorm", rope_theta=10000.0,
)
