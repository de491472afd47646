"""Qwen1.5-32B [dense, QKV bias]  (hf:Qwen/Qwen1.5-32B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064, head_dim=128,
    qkv_bias=True)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab_size=512, head_dim=32)
