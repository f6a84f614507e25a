"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attn+mamba heads. [arXiv:2411.13676]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    mixer="hymba", ssm_state=16,
    layer_pattern=("local",), window=1024,   # hymba uses SWA on most layers
    tie_embeddings=True,
    subquadratic=True,   # hybrid: SWA attention + constant-state SSM
)
