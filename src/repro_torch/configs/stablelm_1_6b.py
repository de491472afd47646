"""StableLM-2-1.6B [dense]  (hf:stabilityai/stablelm-2-1_6b)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab_size=100352, head_dim=64,
    rope_theta=10000.0)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab_size=512, head_dim=32)
