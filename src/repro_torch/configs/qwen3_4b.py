"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
    subquadratic=False,
)
