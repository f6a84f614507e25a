"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay. [arXiv:2404.05892]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=7168, vocab_size=65536,
    mixer="rwkv", ffn="rwkv_cm", tie_embeddings=False,
    subquadratic=True,   # O(1) state decode
)
