"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; 16 experts top-4 fine-grained. [hf:databricks/dbrx-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab_size=100352,
    ffn="moe", n_experts=16, moe_top_k=4, d_ff_expert=10752,
    rope_theta=500_000.0, tie_embeddings=False,
    param_dtype="bfloat16",
    subquadratic=False,
)
