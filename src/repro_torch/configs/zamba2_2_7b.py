"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention block applied
every 6 layers (arXiv:2411.15242)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6)

SMOKE = CONFIG.replace(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab_size=512, head_dim=32, ssm_state=16,
                       ssm_head_dim=32, ssm_chunk=64, attn_every=2)
