"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840; MoE 384 experts top-8 + 1 shared (paper-table trillion-param
config). [arXiv:2501.kimi2]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163840,
    ffn="moe", n_experts=384, moe_top_k=8, n_shared_experts=1,
    d_ff_expert=2048, capacity_factor=1.0,
    rope_theta=500_000.0, tie_embeddings=False,
    param_dtype="bfloat16",
    subquadratic=False,
)
