"""seamless-m4t-large-v2 — encoder-decoder multimodal backbone.
[arXiv:2308.11596; hf]

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  The speech frontend
is a STUB per the assignment: input_specs() provides precomputed frame
embeddings (fbank-stack width 160); the DEPAM pipeline from this repo is
the natural producer of those features (see examples/train_audio_lm.py).

Shape policy for enc-dec (documented in DESIGN.md): train/prefill shapes
give the ENCODER length; the decoder runs at seq_len/4 for train and
prefill, and decode steps one decoder token against both caches.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    encdec=True, enc_layers=24,
    frontend="audio_stub", frontend_dim=160,
    mlp="gelu", norm="layernorm", rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=6,
    d_ff=384, vocab=512, head_dim=16,
    encdec=True, enc_layers=2,
    frontend="audio_stub", frontend_dim=40,
    mlp="gelu", norm="layernorm", rope_theta=10000.0,
)
