"""Moonlight-16B-A3B [moe, 64 experts top-6]
(hf:moonshotai/Moonlight-16B-A3B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840, head_dim=128,
    n_experts=64, experts_per_token=6)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=64, vocab_size=512, head_dim=32, n_experts=8,
                       experts_per_token=2)
