"""Roofline terms of a dry-run cell, on an NVIDIA H100.

Port of ``repro.launch.roofline`` (``CollectiveStats``, ``model_flops``,
``roofline_terms``), the TPU v5e constants replaced by an NVIDIA H100 80GB
HBM3 SXM card at 700 W, from NVIDIA's datasheet (figures, not
measurements):
    peak bf16 compute : 989 TFLOP/s (dense tensor cores)
    HBM3 bandwidth    : 3.35 TB/s
    NVLink 4          : 450 GB/s a direction (900 GB/s both)

Terms (seconds, per step, per device; the dry run costs one device's
share of the step):
    compute    = FLOPs / peak
    memory     = bytes / HBM bandwidth
    collective = bytes moved between devices / link bandwidth

The reference also reads collectives out of XLA's optimized HLO
(``parse_collectives``); the port has no HLO, and its moves between
devices are its own (``launch/dryrun.py`` costs them from the shardings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, float]
    total_bytes: float
    count: int
    lines: List[str]


def model_flops(cfg, shape) -> tuple:
    """``(MODEL_FLOPS, total params)``: 6·N_active·D (training) or
    2·N_active·D (inference), D the cell's tokens."""
    from ..models.model import lm_metas
    from ..models.params import _walk
    total = 0
    active = 0.0
    for path, meta in _walk(lm_metas(cfg)):
        n = int(np.prod(meta.shape))
        total += n
        if path[-1] == "embed":
            # gather costs ~0 flops; the table only "computes" when tied
            active += n if cfg.tie_embeddings else 0
        elif "experts" in meta.axes:
            # routed expert weights: top_k of E active per token
            active += n * cfg.moe_top_k / max(1, cfg.n_experts)
        else:
            active += n
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * active * tokens, total


def roofline_terms(cost: Dict, coll: CollectiveStats, n_chips: int) -> Dict:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = byts / HBM_BW
    t_coll = coll.total_bytes / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": byts,
        "collective_bytes_per_chip": coll.total_bytes,
        "collective_ops": coll.count,
        "collective_per_op": coll.per_op,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
