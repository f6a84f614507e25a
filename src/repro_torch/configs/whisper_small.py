"""whisper-small [audio] — 12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865; enc-dec; conv frontend is a STUB (precomputed frame
embeddings). [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab_size=51865,
    enc_dec=True, n_enc_layers=12, d_frame=768, use_rope=False,
    tie_embeddings=True,
    subquadratic=False,
)
