"""InternVL2-1B [vlm]: InternViT frontend (STUB: precomputed 1024-d patch
embeddings) + Qwen2-0.5B-class language backbone (arXiv:2404.16821)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, frontend="vit", frontend_dim=1024)

SMOKE = CONFIG.replace(n_layers=2, d_model=112, n_heads=7, n_kv_heads=1,
                       d_ff=224, vocab_size=517, head_dim=16,
                       frontend_dim=64)
