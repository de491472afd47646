"""Llama-3-70B: the paper's own evaluation model (§6.1): 8 KV heads,
64 QO heads, head_dim 128.  Used by the paper-figure benchmarks."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256, head_dim=128,
    rope_theta=5e5)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                       d_ff=256, vocab_size=512, head_dim=16)
