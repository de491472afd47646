"""CodeQwen1.5-7B [dense, qwen1.5 arch: QKV bias]  (hf:Qwen/CodeQwen1.5-7B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=13440, vocab_size=92416, head_dim=128,
    qkv_bias=True)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=320, vocab_size=512, head_dim=32)
