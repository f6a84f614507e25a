"""Example problems for every built-in registered op, keyed by registry tag.

Port of ``repro.analysis.op_examples``: the same seeded patterns (one
``default_rng(1234)``, the same draws in the same order), so every tag's
operands are the reference's arrays for every seed.

One table shared by the consumers that must *enumerate* the registry
rather than hard-code tags:

* the dynamic purity harness (:mod:`.purity_check`) — replays each op
  with a fixed pattern and perturbed values;
* ``chip_smoke.py``'s replay on the card — drives each op cold, then
  warm, through one ``ReapRuntime(device="cuda")`` and holds it against
  the same op on the host.

Each :class:`OpExample` builds operands whose *pattern* is fixed at
construction while values vary with ``value_seed`` — the repeated-pattern
workload (iterative solvers, decode steps, re-scored batches) that the
plan cache exists for.  A registered non-router op with no entry here is
a coverage gap; both consumers report it as a failure instead of
silently skipping it.

This module imports numpy, torch and repro_torch.core, which the analysis
package's static checker must not (it stays stdlib-only); import it only
from code already running inside the full stack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.formats import CSR, random_csr, random_spd_csr


@dataclasses.dataclass(frozen=True)
class OpExample:
    """A registered op plus operands with a fixed pattern, seedable values.

    ``operands(value_seed)`` returns a fresh operand tuple: identical
    sparsity pattern for every seed, values drawn from the seed.  ``kw``
    is passed to ``ReapRuntime.run(tag, *operands, **kw)`` and to the
    spec hooks (after ``prepare``).  ``runtime_kw`` holds the op's
    RuntimeConfig overrides (its ``block``); the device is the caller's.
    """

    tag: str
    operands: Callable[[int], Tuple]
    kw: Dict = dataclasses.field(default_factory=dict)
    runtime_kw: Dict = dataclasses.field(default_factory=dict)


def _revalue(a: CSR, rng: np.random.Generator) -> CSR:
    """Same pattern, fresh values."""
    return CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
               rng.standard_normal(a.nnz).astype(a.data.dtype))


def builtin_examples(n: int = 384) -> Dict[str, OpExample]:
    """Example table for the built-in ops, problem scale ``n``.

    Patterns are built once here (seeded) so every ``operands(seed)``
    call shares them; only values move with the seed.
    """
    prng = np.random.default_rng(1234)
    a_pat = random_csr(n, n, 0.01, prng)
    b_pat = random_csr(n, n, 0.01, prng)
    blocky_a = random_csr(n, n, 0.02, prng, "blocky")
    blocky_b = random_csr(n, n, 0.02, prng, "blocky")
    spd = random_spd_csr(n // 2, 0.02, prng)
    w_pat = random_csr(n, n, 0.02, prng, "blocky")
    expert_ids = prng.integers(0, 8, (n, 2))
    # block_attention wants a fixed power-of-two-friendly seq; keep it
    # independent of ``n`` so the mask stays a few q/kv blocks at block=64
    attn_seq = 256
    attn_mask = random_csr(attn_seq, attn_seq, 0.03, prng, "blocky")

    def gather_ops(seed: int):
        rng = np.random.default_rng(seed)
        return _revalue(a_pat, rng), _revalue(b_pat, rng)

    def block_ops(seed: int):
        rng = np.random.default_rng(seed)
        return _revalue(blocky_a, rng), _revalue(blocky_b, rng)

    def spd_ops(seed: int):
        # scaling keeps SPD-ness (numeric factorization stays valid)
        # while the value bytes move with the seed
        return (CSR(spd.n_rows, spd.n_cols, spd.indptr, spd.indices,
                    spd.data * (1.0 + 0.25 * seed)),)

    def moe_ops(seed: int):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((n, 64)), expert_ids)

    def spmm_ops(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((32, n)).astype(np.float32)
        return x, _revalue(w_pat, rng)

    def attn_ops(seed: int):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((1, 2, attn_seq, 32)).astype(np.float32)
        k = rng.standard_normal((1, 2, attn_seq, 32)).astype(np.float32)
        v = rng.standard_normal((1, 2, attn_seq, 32)).astype(np.float32)
        return q, k, v, _revalue(attn_mask, rng)

    def spmv_ops(seed: int):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(spd.n_cols)
        return _revalue(spd, rng), x

    examples = [
        OpExample("spgemm_gather", gather_ops),
        OpExample("spgemm_block", block_ops,
                  runtime_kw=dict(block=64)),
        OpExample("cholesky", spd_ops, kw=dict(dtype=torch.float32)),
        OpExample("moe_dispatch", moe_ops, kw=dict(n_experts=8)),
        OpExample("spmm", spmm_ops,
                  runtime_kw=dict(block=64)),
        OpExample("block_attention", attn_ops,
                  runtime_kw=dict(block=64)),
        OpExample("spmv", spmv_ops,
                  runtime_kw=dict(block=64)),
    ]
    return {ex.tag: ex for ex in examples}
