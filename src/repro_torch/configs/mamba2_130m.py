"""Mamba2-130M [ssm]: SSD (state-space duality), attention-free
(arXiv:2405.21060)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280, head_dim=0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, tie_embeddings=True)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, vocab_size=512,
                       ssm_state=16, ssm_head_dim=32, ssm_chunk=64)
