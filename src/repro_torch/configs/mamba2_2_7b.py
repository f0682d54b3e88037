"""mamba2-2.7b — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]

64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d = 5120, headdim 64 -> 80 SSM heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_chunk=256, norm="rmsnorm",
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=512,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4,
    ssm_chunk=16, norm="rmsnorm",
)
