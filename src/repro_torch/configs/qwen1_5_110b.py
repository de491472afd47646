"""Qwen1.5-110B [dense, GQA kv=8, QKV bias]  (hf:Qwen/Qwen1.5-110B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152064, head_dim=128,
    qkv_bias=True)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                       d_ff=384, vocab_size=512, head_dim=16)
