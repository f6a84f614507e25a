"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000; local+global alternating, logit softcaps. [arXiv:2408.00118]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab_size=256000,
    layer_pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True, gemma_style=True,
    tie_embeddings=True,
    subquadratic=True,   # local layers are windowed; global decode is linear/step
)
