"""Granite-3.0-3B-A800M [moe, 40 experts top-8]
(hf:ibm-granite/granite-3.0-3b-a800m-base)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=40, experts_per_token=8)

SMOKE = CONFIG.replace(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                       d_ff=64, vocab_size=515, head_dim=16, n_experts=5,
                       experts_per_token=2)
