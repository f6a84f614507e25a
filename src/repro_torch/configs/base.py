"""Model + shape configuration dataclasses and the --arch registry.

A copy of ``repro.configs.base`` whose dtype names map to torch dtypes;
the architecture files beside it are copies of the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # layer composition: pattern cycled over layers ("global"|"local")
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 0                    # sliding window for "local" layers
    mixer: str = "attn"                # attn|rwkv|hymba
    ffn: str = "swiglu"                # swiglu|moe|rwkv_cm
    # attention details
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norm: bool = False            # gemma-2/3 post-block norms
    gemma_style: bool = False          # (1+w) RMSNorm + sqrt(d) embed scale
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0      # 0 → same as rope_theta
    use_rope: bool = True              # whisper: sinusoidal abs pos instead
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM
    ssm_state: int = 0
    # VLM stub (paligemma): precomputed patch embeddings
    n_image_tokens: int = 0
    d_image: int = 0
    prefix_lm: bool = False
    # enc-dec (whisper): encoder consumes precomputed frame embeddings
    enc_dec: bool = False
    n_enc_layers: int = 0
    d_frame: int = 0                   # stub frame-embedding dim
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # sub-quadratic? (drives long_500k dry-run eligibility)
    subquadratic: bool = False

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail_layers(self) -> Tuple[str, ...]:
        r = self.n_layers % self.period
        return self.layer_pattern[:r]

    def layer_type(self, i: int) -> str:
        return self.layer_pattern[i % self.period]

    def active_params_per_token_factor(self) -> float:
        """Fraction of FFN params active per token (MoE)."""
        if self.n_experts:
            return (self.moe_top_k + self.n_shared_experts) / max(
                1, self.n_experts + self.n_shared_experts)
        return 1.0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCHS = ["qwen3-1.7b", "gemma3-27b", "gemma2-2b", "qwen3-4b", "rwkv6-1.6b",
         "hymba-1.5b", "paligemma-3b", "dbrx-132b", "kimi-k2-1t-a32b",
         "whisper-small"]

_MODULES = {
    "qwen3-1.7b": "qwen3_1p7b", "gemma3-27b": "gemma3_27b",
    "gemma2-2b": "gemma2_2b", "qwen3-4b": "qwen3_4b",
    "rwkv6-1.6b": "rwkv6_1p6b", "hymba-1.5b": "hymba_1p5b",
    "paligemma-3b": "paligemma_3b", "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2", "whisper-small": "whisper_small",
}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (per instructions)."""
    period = cfg.period
    n_layers = max(period * 2, 2)
    if cfg.n_layers % period:
        n_layers += cfg.n_layers % period   # keep a tail to exercise it
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(1, cfg.n_heads)),
        d_head=16,
        d_ff=128,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_image_tokens=8 if cfg.n_image_tokens else 0,
        d_image=32 if cfg.d_image else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        d_frame=32 if cfg.d_frame else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
