"""Kernel K1 on the card: the CUDA kernel against its plain version, and
the port's main path through it.  Every test here carries the ``gpu``
marker and skips without a CUDA card (decided inside the test, never at
import).  This file imports neither JAX nor ``repro``, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.kernels.bsr_spgemm import (bsr_spgemm, bsr_spgemm_plain,
                                            bsr_spgemm_schedule)
from repro_torch.runtime import (ReapRuntime, bucket_block_schedule,
                                 build_block_chunkset)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; K1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ids(dev, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_k1_matches_plain(cuda, bs):
    a = P.random_csr(600, 600, 0.03, np.random.default_rng(bs), "blocky")
    plan = P.inspect_spgemm_block(a, a, bs)
    tiles = torch.from_numpy(plan.a_pat.scatter(a.data)).to(cuda)
    before = bsr_spgemm.launches
    got = bsr_spgemm_schedule(plan.schedule, tiles, tiles,
                              n_out_blocks=plan.n_out_blocks)
    assert bsr_spgemm.launches == before + 1
    want = bsr_spgemm_plain(tiles, tiles,
                            *_ids(cuda, plan.a_id, plan.b_id, plan.out_id),
                            n_out_blocks=plan.n_out_blocks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k1_bucketed_chunk_dead_group(cuda):
    a = P.random_csr(2000, 2000, 0.01, np.random.default_rng(1), "blocky")
    plan = P.inspect_spgemm_block(a, a, 32)
    for k in range(3):
        sched = bucket_block_schedule(build_block_chunkset(plan, 3).chunk(k))
        rng = np.random.default_rng(k)
        ab = torch.from_numpy(rng.standard_normal(
            (sched["a_cap"], 32, 32)).astype(np.float32)).to(cuda)
        bb = torch.from_numpy(rng.standard_normal(
            (sched["b_cap"], 32, 32)).astype(np.float32)).to(cuda)
        n_out = sched["out_cap"] + 1
        got = bsr_spgemm_schedule(sched, ab, bb, n_out_blocks=n_out)
        want = bsr_spgemm_plain(
            ab, bb, *_ids(cuda, sched["a_id"], sched["b_id"],
                          sched["out_id"]), n_out_blocks=n_out)
        torch.testing.assert_close(got[:-1], want[:-1], rtol=1e-5, atol=1e-5)
        # the dead group sums pair_cap - n_pairs copies of one product, so
        # its rounding grows with the sum: hold it relative to its size
        torch.testing.assert_close(got[-1], want[-1], rtol=1e-5,
                                   atol=1e-5 * want[-1].abs().max().item())
        live = bsr_spgemm_schedule(sched["k1"], ab, bb, n_out_blocks=n_out)
        torch.testing.assert_close(live[:-1], want[:-1], rtol=1e-5,
                                   atol=1e-5)
        assert not live[-1].any()


def test_k1_rejects_unsupported_block(cuda):
    tiles = torch.zeros(1, 8, 8, device=cuda)
    sched = dict(a_id=[0], b_id=[0], out_id=[0], is_first=[1], is_last=[1])
    with pytest.raises(ValueError, match="bs"):
        bsr_spgemm_schedule(sched, tiles, tiles, n_out_blocks=1)


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_runtime_block_path_launches_k1(cuda, n_chunks):
    a = P.random_csr(3000, 3000, 0.004, np.random.default_rng(2), "banded")
    rt = ReapRuntime(device="cuda", n_chunks=n_chunks)
    before = bsr_spgemm.launches
    c, stats = rt.spgemm(a, a, method="block")
    assert bsr_spgemm.launches > before
    ref = P.spgemm_ref_numpy(a, a)
    assert np.array_equal(c.indptr, ref.indptr)
    assert np.array_equal(c.indices, ref.indices)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-4, atol=1e-5)


def test_runtime_gather_and_cholesky_on_card(cuda):
    a = P.random_csr(2000, 2000, 0.002, np.random.default_rng(3))
    c, stats = ReapRuntime(device="cuda").spgemm(a, a)
    assert stats["method"] == "gather_chunked"
    ref = P.spgemm_ref_numpy(a, a)
    assert np.array_equal(c.indices, ref.indices)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-4, atol=1e-5)
    s = P.random_spd_csr(300, 0.03, np.random.default_rng(4))
    rt = ReapRuntime(device="cuda")
    for overlap in (True, False):
        plan, vals, _ = rt.cholesky(s, overlap=overlap)
        base, _ = P.cholesky_baseline_numpy(plan, P.cholesky_values(s))
        np.testing.assert_allclose(vals, base, rtol=1e-10, atol=1e-12)
