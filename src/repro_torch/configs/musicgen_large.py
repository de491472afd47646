"""MusicGen-large [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284).  The EnCodec frontend is a STUB: input_specs
provides precomputed frame embeddings / token streams."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048, head_dim=64,
    frontend="encodec", frontend_dim=128)

SMOKE = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                       d_ff=256, vocab_size=260, head_dim=32,
                       frontend_dim=32)
