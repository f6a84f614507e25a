"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global, 128k context. [hf:google/gemma-3-1b-pt]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",), window=1024,
    post_norm=True, gemma_style=True, qk_norm=True,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
)
