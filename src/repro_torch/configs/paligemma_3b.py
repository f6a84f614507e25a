"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216; SigLIP frontend is a STUB (precomputed patch embeddings),
gemma backbone, prefix-LM attention. [arXiv:2407.07726]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=257216,
    gemma_style=True, tie_embeddings=True,
    n_image_tokens=256, d_image=1152, prefix_lm=True,
    subquadratic=False,
)
