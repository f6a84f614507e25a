"""Kernels K1 to K6 and K4's, K5's and K6's backward on the card: each CUDA
kernel against its plain version, and the port's paths through them
(training too: K4, K5 and K6 under autograd, the kernels without a backward
(K1-K3) raising where a gradient is asked for, train steps on the card
against the host).  Every test here carries the ``gpu``
marker and skips without a CUDA card (decided inside the test, never at
import).  This file imports neither JAX nor ``repro``, so it runs on a
machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.rir import ScheduleBundle
from repro_torch.core.solver import cg_solve
from repro_torch.kernels.bsr_spgemm import (bsr_spgemm, bsr_spgemm_plain,
                                            bsr_spgemm_schedule,
                                            prepare_schedule)
from repro_torch.kernels.bsr_spmm import (bsr_spmm, bsr_spmm_plain,
                                          inspect_spmm,
                                          prepare_spmm_schedule,
                                          spmm_ref_numpy)
from repro_torch.kernels.flash_attention import (
    block_attention_ref, block_sparse_attention,
    block_sparse_attention_plain, block_sparse_attention_plan,
    inspect_block_attention)
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_plain,
                                          moe_gemm_schedule)
from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_plain
from repro_torch.models import model as M
from repro_torch.models.moe import (moe_ffn, moe_ffn_host,
                                    moe_params_from_numpy)
from repro_torch.runtime import (ReapRuntime, bucket_block_schedule,
                                 build_block_chunkset)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
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


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_holds_cancelling_sums(cuda, seed):
    # filter3D-like tiles (banded, about 25 stored values a row, bs = 128):
    # every pair (a, b) of the schedule is joined by (a', b) with A_a' =
    # -A_a (1 + 1e-3 r), so each output tile is -1e-3 sum (A_a r) B_b, a
    # small difference of the products' sums: only the absolute term of the
    # limit holds.  Values are scaled by 1/4, so that the uncancelled sums
    # are near 1 and fp32's own rounding of them (the plain version's, near
    # 5e-7) stays far inside 1e-5, while TF32 products (three decimal
    # digits) or a lost carry would not
    a = P.random_csr(1536, 1536, 25 / 1536, np.random.default_rng(seed),
                     "banded")
    a.data *= 0.25
    plan = P.inspect_spgemm_block(a, a, 128)
    tiles = plan.a_pat.scatter(a.data)
    r = np.random.default_rng(seed + 10).standard_normal(tiles.shape)
    a_tiles = np.concatenate([tiles, -tiles * (1 + 1e-3 * r)]).astype(
        np.float32)
    n_a = tiles.shape[0]
    order = np.argsort(np.concatenate([plan.out_id, plan.out_id]),
                       kind="stable")
    sched = {k: np.concatenate([x, x + n_a if k == "a_id" else x])[order]
             for k, x in (("a_id", plan.a_id), ("b_id", plan.b_id),
                          ("out_id", plan.out_id))}
    a_t = torch.from_numpy(a_tiles).to(cuda)
    b_t = torch.from_numpy(plan.b_pat.scatter(a.data)).to(cuda)
    got = bsr_spgemm_schedule(sched, a_t, b_t,
                              n_out_blocks=plan.n_out_blocks)
    want = bsr_spgemm_plain(a_t, b_t, *_ids(cuda, sched["a_id"],
                                            sched["b_id"], sched["out_id"]),
                            n_out_blocks=plan.n_out_blocks)
    assert want.abs().max().item() < 0.02      # the sums did cancel
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k1_warm_call_uploads_no_schedule(cuda):
    a = P.random_csr(3000, 3000, 0.004, np.random.default_rng(12), "banded")
    plan = P.inspect_spgemm_block(a, a, 128)
    tiles = torch.from_numpy(plan.a_pat.scatter(a.data)).to(cuda)
    sched = prepare_schedule(plan.schedule)
    before = bsr_spgemm.uploads
    first = bsr_spgemm_schedule(sched, tiles, tiles,
                                n_out_blocks=plan.n_out_blocks)
    assert bsr_spgemm.uploads == before + 1
    second = bsr_spgemm_schedule(sched, tiles, tiles,   # the memoized copy
                                 n_out_blocks=plan.n_out_blocks)
    assert bsr_spgemm.uploads == before + 1
    assert torch.equal(first, second)
    third = bsr_spgemm(tiles, tiles, plan.a_id, plan.b_id, plan.out_id,
                       None, None, n_out_blocks=plan.n_out_blocks)
    assert bsr_spgemm.uploads == before + 2     # an array schedule: each call
    assert torch.equal(first, third)
    for n_chunks in (1, 4):                     # the runtime: once per plan
        rt = ReapRuntime(device="cuda", n_chunks=n_chunks)
        rt.spgemm(a, a, method="block")
        before = bsr_spgemm.uploads
        for _ in range(3):
            rt.spgemm(a, a, method="block")
        assert bsr_spgemm.uploads == before


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


# -- K2: bsr_spmm ------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 5, 33, 100, 256])   # 100: a ragged 128-row tile
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_k2_matches_plain(cuda, bs, t):
    w = P.random_csr(700, 600, 0.02, np.random.default_rng(bs + t), "blocky")
    plan = inspect_spmm(w, bs)
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, plan.pat.n_rows)).astype(np.float32)).to(cuda)
    tiles = torch.from_numpy(plan.scatter(w.data)).to(cuda)
    before = bsr_spmm.launches
    got = bsr_spmm(x, tiles, plan.schedule, n_j_blocks=plan.n_j_blocks)
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm_plain(x, tiles, *_ids(cuda, plan.w_id, plan.k_blk,
                                          plan.j_blk),
                          n_j_blocks=plan.n_j_blocks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _cancelling_stack(w, eps, seed):
    """``w`` stacked on ``-w (1 + eps r)``: ``[x, x]`` times it is a small
    difference of large sums."""
    r = np.random.default_rng(seed).standard_normal(w.nnz)
    return P.CSR(2 * w.n_rows, w.n_cols,
                 np.concatenate([w.indptr, w.indptr[1:] + w.nnz]),
                 np.concatenate([w.indices, w.indices]),
                 np.concatenate([w.data, -w.data * (1 + eps * r)])
                 .astype(np.float32))


@pytest.mark.parametrize("t", [33, 256])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_k2_holds_cancelling_sums(cuda, bs, t):
    # outputs near 0.1 made from sums of |terms| near 500: only the absolute
    # term of the limit holds, so a loss of fp32 accuracy fails here
    w = _cancelling_stack(P.random_csr(1500, 600, 0.05, np.random.default_rng(
        bs + t), "blocky"), 1e-3, t)
    plan = inspect_spmm(w, bs)
    x_np = np.random.default_rng(t).standard_normal(
        (t, w.n_rows // 2)).astype(np.float32)
    x = np.zeros((t, plan.pat.n_rows), np.float32)
    x[:, :w.n_rows] = np.concatenate([x_np, x_np], 1)
    x = torch.from_numpy(x).to(cuda)
    tiles = torch.from_numpy(plan.scatter(w.data)).to(cuda)
    got = bsr_spmm(x, tiles, plan.schedule, n_j_blocks=plan.n_j_blocks)
    want = bsr_spmm_plain(x, tiles, *_ids(cuda, plan.w_id, plan.k_blk,
                                          plan.j_blk),
                          n_j_blocks=plan.n_j_blocks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_k2_warm_call_uploads_no_schedule(cuda):
    w = P.random_csr(900, 700, 0.02, np.random.default_rng(11), "blocky")
    plan = inspect_spmm(w, 64)
    sched = prepare_spmm_schedule(plan.schedule, plan.n_j_blocks)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (256, plan.pat.n_rows)).astype(np.float32)).to(cuda)
    tiles = torch.from_numpy(plan.scatter(w.data)).to(cuda)
    before = bsr_spmm.uploads
    first = bsr_spmm(x, tiles, sched, n_j_blocks=plan.n_j_blocks)
    assert bsr_spmm.uploads == before + 1
    second = bsr_spmm(x, tiles, sched, n_j_blocks=plan.n_j_blocks)
    assert bsr_spmm.uploads == before + 1       # the memoized device copy
    assert torch.equal(first, second)
    rt = ReapRuntime(device="cuda", block=64)   # the op reuses its plan's
    before = bsr_spmm.uploads
    for _ in range(3):
        rt.run("spmm", x[:5].cpu().numpy()[:, :900], w)
    assert bsr_spmm.uploads == before + 1


def test_k2_rejects_what_it_does_not_take(cuda):
    sched = dict(w_id=[0], k_blk=[0], j_blk=[0])
    with pytest.raises(ValueError, match="bs"):
        bsr_spmm(torch.zeros(2, 8, device=cuda),
                 torch.zeros(1, 8, 8, device=cuda), sched, n_j_blocks=1)
    with pytest.raises(ValueError, match="float32"):
        bsr_spmm(torch.zeros(2, 16, device=cuda, dtype=torch.float64),
                 torch.zeros(1, 16, 16, device=cuda, dtype=torch.float64),
                 sched, n_j_blocks=1)


def test_runtime_spmm_and_cg_launch_k2(cuda):
    w = P.random_csr(900, 700, 0.02, np.random.default_rng(5), "blocky")
    x = np.random.default_rng(6).standard_normal((40, 900)).astype(
        np.float32)
    rt = ReapRuntime(device="cuda", block=64)
    before = bsr_spmm.launches
    y, st = rt.run("spmm", x, w)
    assert bsr_spmm.launches == before + 1 and not st["cache_hit"]
    np.testing.assert_allclose(y, spmm_ref_numpy(x, w), rtol=1e-4,
                               atol=1e-4)
    a = P.random_spd_csr(600, 0.02, np.random.default_rng(7), "blocky")
    b = np.random.default_rng(8).standard_normal(600)
    before = bsr_spmm.launches
    xs, info = cg_solve(a, b, rt, tol=1e-5, dtype=np.float32,
                        precond="cholesky")
    assert info["converged"]
    assert bsr_spmm.launches == before + info["iterations"]
    assert info["spmv_cache_hits"] == info["iterations"] - 1
    dense = a.to_dense()
    assert np.linalg.norm(dense @ xs - b) / np.linalg.norm(b) < 1e-4
    before = bsr_spmm.launches          # float64: the plain executor
    xs, info = cg_solve(a, b, rt, tol=1e-10, dtype=np.float64)
    assert info["converged"] and bsr_spmm.launches == before
    assert np.linalg.norm(dense @ xs - b) / np.linalg.norm(b) < 1e-8


# -- K3: block_sparse_attention ----------------------------------------------

def _attention_problem(s, bs, seed, h=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, s - bs, 6 * s)    # the last q block sees nothing
    col = rng.integers(0, s, 6 * s)
    mask = P.CSR.from_coo(P.COO(s, s, row, col,
                                np.ones(row.size, np.float32)))
    q, k, v = (rng.standard_normal((2, n, s, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    return mask, q, k, v


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bs,d,softcap", [
    (64, 64, 0.0), (64, 128, 5.0), (128, 128, 50.0), (32, 32, 0.0),
    # the runtime's block 16 and head dims 16 and 256 (reduced_config,
    # gemma2-2b and paligemma-3b): D = 256 splits the output in two halves
    (16, 16, 0.0), (16, 64, 0.0), (16, 256, 5.0), (32, 16, 0.0),
    (128, 16, 0.0), (64, 256, 0.0), (128, 256, 50.0),
    # softcap 50 (gemma2's) at the other block sizes
    (16, 128, 50.0), (32, 64, 50.0), (64, 128, 50.0)])
def test_k3_matches_plain(cuda, dtype, tol, bs, d, softcap):
    s = 4 * bs
    mask, q, k, v = _attention_problem(s, bs, seed=bs + d, d=d)
    plan = inspect_block_attention(mask, bs)
    assert plan.n_kv[-1] == 0
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    before = block_sparse_attention.launches
    got = block_sparse_attention(q, k, v, plan.kv_ids, plan.n_kv,
                                 softcap=softcap, seq=s - 7)
    assert block_sparse_attention.launches == before + 1
    assert got.dtype == dtype
    want = block_sparse_attention_plain(
        q, k, v, *_ids(cuda, plan.kv_ids, plan.n_kv), softcap=softcap,
        scale=d ** -0.5, seq=s - 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[:, :, -bs:].any()        # the empty q block: exact zeros


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("bs,d", [(16, 64), (32, 128), (64, 256), (128, 128),
                                  (128, 256)])
def test_k3_holds_cancelling_sums(cuda, bs, d, softcap):
    # kv blocks 4..7 repeat the keys of blocks 0..3 with V stacked as
    # -V (1 + 1e-3 r), and every q block sees a block and its twin, so each
    # output is -1e-3 sum p v r / (2 sum p): a small difference of large
    # sums, where only the absolute term of the 1e-4 limit holds
    rng = np.random.default_rng(bs + d)
    nb = 4
    vis = rng.random((2 * nb, nb)) < 0.6
    vis[np.arange(2 * nb), rng.integers(0, nb, 2 * nb)] = True
    qb, kb = np.nonzero(np.concatenate([vis, vis], axis=1))
    s = 2 * nb * bs
    mask = P.CSR.from_coo(P.COO(s, s, qb * bs, kb * bs,
                                np.ones(qb.size, np.float32)))
    plan = inspect_block_attention(mask, bs)
    q = rng.standard_normal((1, 4, s, d))
    k0, v0 = (rng.standard_normal((1, 2, s // 2, d)) for _ in range(2))
    k = np.concatenate([k0, k0], axis=2)
    v = np.concatenate(
        [v0, -v0 * (1 + 1e-3 * rng.standard_normal(v0.shape))], axis=2)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda)
               for x in (q, k, v))
    got = block_sparse_attention_plan(q, k, v, plan, softcap=softcap)
    want = block_sparse_attention_plain(
        q, k, v, *_ids(cuda, plan.kv_ids, plan.n_kv), softcap=softcap,
        scale=d ** -0.5, seq=s)
    assert want.abs().max().item() < 0.05       # the sums did cancel
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_k3_warm_call_uploads_no_schedule(cuda):
    mask, q, k, v = _attention_problem(256, 64, seed=12, d=64)
    plan = inspect_block_attention(mask, 64)
    q, k, v = (torch.from_numpy(x).to(cuda) for x in (q, k, v))
    before = block_sparse_attention.uploads
    first = block_sparse_attention_plan(q, k, v, plan)
    assert block_sparse_attention.uploads == before + 1
    second = block_sparse_attention_plan(q, k, v, plan)  # the plan's copy
    assert block_sparse_attention.uploads == before + 1
    assert torch.equal(first, second)
    third = block_sparse_attention(q, k, v, plan.kv_ids, plan.n_kv)
    assert block_sparse_attention.uploads == before + 2  # raw ids: each call
    assert torch.equal(first, third)
    rt = ReapRuntime(device="cuda", block=64)   # the op reuses its plan's
    rt.run("block_attention", q, k, v, mask)
    before = block_sparse_attention.uploads
    for _ in range(3):
        rt.run("block_attention", q, k, v, mask)
    assert block_sparse_attention.uploads == before


def test_k3_rejects_unsupported_shape(cuda):
    q = torch.zeros(1, 1, 64, 48, device=cuda)      # D = 48: no config's
    ids, n = np.zeros((1, 1), np.int32), np.ones(1, np.int32)
    with pytest.raises(ValueError, match="supports"):
        block_sparse_attention(q, q, q, ids, n)


def test_runtime_block_attention_launches_k3(cuda):
    mask, q, k, v = _attention_problem(256, 64, seed=9, d=32)
    rt = ReapRuntime(device="cuda", block=64)
    for hit in (False, True):
        before = block_sparse_attention.launches
        out, st = rt.run("block_attention", q, k, v, mask)
        assert block_sparse_attention.launches == before + 1
        assert st["cache_hit"] is hit
    np.testing.assert_allclose(out, block_attention_ref(q, k, v, mask, 64),
                               rtol=1e-4, atol=1e-4)


def test_runtime_block_attention_at_block_16_launches_k3(cuda):
    mask, q, k, v = _attention_problem(128, 16, seed=10, d=16)
    rt = ReapRuntime(device="cuda", block=16)
    before = block_sparse_attention.launches
    out, st = rt.run("block_attention", q, k, v, mask)
    assert block_sparse_attention.launches == before + 1
    np.testing.assert_allclose(out, block_attention_ref(q, k, v, mask, 16),
                               rtol=1e-4, atol=1e-4)


# -- K5: moe_gemm -------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nb,cap,din,dout,e", [
    (4, 8, 32, 64, 3), (7, 16, 128, 128, 8), (2, 128, 256, 512, 2),
    (5, 24, 96, 200, 6), (3, 131, 36, 260, 4), (16, 40, 64, 132, 16),
    (8, 320, 512, 1024, 4), (4, 1, 64, 64, 4), (6, 32, 128, 264, 3)])
def test_k5_matches_plain(cuda, dtype, tol, nb, cap, din, dout, e):
    rng = np.random.default_rng(nb * cap)
    x = torch.from_numpy(rng.standard_normal((nb, cap, din)).astype(
        np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((e, din, dout)).astype(
        np.float32) / np.sqrt(din)).to(cuda, dtype)
    be = rng.integers(0, e, nb).astype(np.int32)    # not the identity
    before = moe_gemm.launches
    got = moe_gemm(x, w, be, bk=4, bf=4)
    assert moe_gemm.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (nb, cap, dout)
    want = moe_gemm_plain(x, w, torch.from_numpy(be).to(cuda))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_k5_warm_call_uploads_no_schedule(cuda):
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((4, 24, 64)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((4, 64, 128)).astype(
        np.float32)).to(cuda)
    be = np.array([3, 1, 0, 2], np.int32)
    sched = ScheduleBundle("moe_dispatch", {"bundle_expert": be})
    before = moe_gemm.uploads
    first = moe_gemm_schedule(sched, x, w)
    assert moe_gemm.uploads == before + 1
    second = moe_gemm_schedule(sched, x, w)  # the bundle keeps its copy
    assert moe_gemm.uploads == before + 1
    assert torch.equal(first, second)
    third = moe_gemm(x, w, be)              # a bare array uploads each call
    assert moe_gemm.uploads == before + 2
    assert torch.equal(first, third)
    b, s, d, e = 1, 16, 32, 4               # the layer: one per plan
    p = dict(router=rng.standard_normal((d, e)) * 0.1,
             w_gate=rng.standard_normal((e, d, 48)) / np.sqrt(d),
             w_up=rng.standard_normal((e, d, 48)) / np.sqrt(d),
             w_down=rng.standard_normal((e, 48, d)) / np.sqrt(48))
    pt = moe_params_from_numpy(p, cuda)
    xt = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(cuda)
    rt = ReapRuntime(device="cuda")
    kw = dict(n_experts=e, top_k=2, capacity_factor=1.25)
    moe_ffn_host(xt, pt, rt, **kw)
    before = moe_gemm.uploads
    for _ in range(3):
        moe_ffn_host(xt, pt, rt, **kw)
    assert moe_gemm.uploads == before


# ||got - want|| / ||want|| of bfloat16 K5 against its plain version: both sum
# in float32 and round once, 1.8e-4 to 2.8e-4 at dbrx-132b's in-graph shapes
# (chip_smoke.py, phase 16)
K5_BF16_REL_NORM = 5e-4


@pytest.mark.parametrize("nb,cap,din,dout,e,route", [
    (8, 320, 512, 1024, 4, "wgmma_tiles"),     # b*E+e: two bundles an expert
    (6, 131, 256, 520, 3, "wgmma_tiles"),      # ragged rows and columns
    (10, 40, 64, 136, 5, "wgmma_tiles"),       # a unit spans two bundles
    (4, 320, 6144, 10752, 2, "wgmma_tiles"),   # dbrx-132b's gate widths
    (4, 320, 10752, 6144, 2, "wgmma_tiles"),   # ... and down's
    (8, 1, 512, 384, 4, "wgmma_decode"),
    (16, 8, 512, 384, 4, "wgmma_decode"),      # four bundles a unit
    (8, 24, 512, 384, 4, "wgmma_decode"),
    (8, 32, 256, 200, 4, "wgmma_decode"),
    (4, 8, 10752, 6144, 2, "wgmma_decode")])
def test_k5_bf16_tma_routes_match_plain(cuda, nb, cap, din, dout, e, route):
    rng = np.random.default_rng(nb + cap + din)
    x = torch.from_numpy(rng.standard_normal((nb, cap, din)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((e, din, dout)).astype(
        np.float32) / np.sqrt(din)).to(cuda, torch.bfloat16)
    be = np.tile(np.arange(e, dtype=np.int32), -(-nb // e))[:nb]
    before = moe_gemm.routes.get(route, 0)
    got = moe_gemm(x, w, be, bk=8, bf=8)
    again = moe_gemm(x, w, be, bk=8, bf=8)
    assert moe_gemm.routes[route] == before + 2
    assert torch.equal(got, again)              # one fixed order of sums
    want = moe_gemm_plain(x, w, torch.from_numpy(be).to(cuda)).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    assert ((got.float() - want).norm() / want.norm()).item() \
        <= K5_BF16_REL_NORM


@pytest.mark.parametrize("nb,cap,din,dout", [(3, 131, 36, 260),
                                             (16, 8, 64, 132)])
def test_k5_bf16_odd_widths_take_mma_sync(cuda, nb, cap, din, dout):
    rng = np.random.default_rng(cap)
    x = torch.from_numpy(rng.standard_normal((nb, cap, din)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((2, din, dout)).astype(
        np.float32) / np.sqrt(din)).to(cuda, torch.bfloat16)
    be = rng.integers(0, 2, nb).astype(np.int32)
    before = dict(moe_gemm.routes)
    got = moe_gemm(x, w, be)
    assert moe_gemm.routes.get("mma_sync", 0) == before.get("mma_sync", 0) + 1
    assert all(moe_gemm.routes.get(r, 0) == before.get(r, 0)
               for r in ("wgmma_tiles", "wgmma_decode"))
    torch.testing.assert_close(got.float(), moe_gemm_plain(
        x, w, torch.from_numpy(be).to(cuda)).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("cap", [24, 131])
def test_k5_bf16_warm_call_uploads_no_schedule(cuda, cap):
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((8, cap, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((4, 64, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    be = np.array([3, 1, 0, 2, 3, 1, 0, 2], np.int32)
    sched = ScheduleBundle("moe_dispatch", {"bundle_expert": be})
    before = moe_gemm.uploads
    first = moe_gemm_schedule(sched, x, w)
    down = moe_gemm_schedule(sched, x[..., :64].contiguous(),
                             w[:, :, :64].contiguous())  # another width
    assert moe_gemm.uploads == before + 1
    second = moe_gemm_schedule(sched, x, w)
    assert moe_gemm.uploads == before + 1
    assert torch.equal(first, second) and down.shape[-1] == 64
    third = moe_gemm(x, w, be)                  # a bare array uploads
    assert moe_gemm.uploads == before + 2
    assert torch.equal(first, third)


def test_k5_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 8, 30, device=cuda)
    with pytest.raises(ValueError, match="divisible by 4"):
        moe_gemm(x, torch.zeros(2, 30, 64, device=cuda), np.array([0, 1]),
                 bk=30)
    x = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="dtypes differ"):
        moe_gemm(x, torch.zeros(2, 32, 64, device=cuda,
                                dtype=torch.bfloat16), np.array([0, 1]))
    with pytest.raises(ValueError, match="bundle_expert"):
        moe_gemm(x, torch.zeros(2, 32, 64, device=cuda), np.array([0, 2]))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        moe_gemm(x.double(), torch.zeros(2, 32, 64, device=cuda,
                                         dtype=torch.float64),
                 np.array([0, 1]))


def test_moe_ffn_host_launches_k5(cuda):
    b, s, d, e, k, dff = 2, 16, 32, 4, 2, 48
    rng = np.random.default_rng(3)
    p = dict(router=rng.standard_normal((d, e)) * 0.1,
             w_gate=rng.standard_normal((e, d, dff)) / np.sqrt(d),
             w_up=rng.standard_normal((e, d, dff)) / np.sqrt(d),
             w_down=rng.standard_normal((e, dff, d)) / np.sqrt(dff),
             shared_gate=rng.standard_normal((d, 40)) / np.sqrt(d),
             shared_up=rng.standard_normal((d, 40)) / np.sqrt(d),
             shared_down=rng.standard_normal((40, d)) / np.sqrt(40))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=1.25)
    want, _ = moe_ffn_host(torch.from_numpy(x),
                           moe_params_from_numpy(p, "cpu"),
                           ReapRuntime(device="cpu"), **kw)
    rt = ReapRuntime(device="cuda")
    pt = moe_params_from_numpy(p, cuda)
    for hit in (False, True):
        before = moe_gemm.launches
        out, _ = moe_ffn_host(torch.from_numpy(x).to(cuda), pt, rt, **kw)
        assert moe_gemm.launches == before + 3
        per = rt.cache_stats()["per_op"]["moe_dispatch"]
        assert per["hits"] == int(hit)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)


# -- K4: flash_attention --------------------------------------------------------

# ||got - want|| / ||want|| of the bfloat16 kernel against its plain version:
# rounding P and the outputs to bfloat16 gives about 2e-3, dropping a
# window's 63 oldest keys about 1e-1 (chip_smoke.py, phase 12)
K4_BF16_REL_NORM = 5e-3

def _randn(dev, seed, *shape, dtype=torch.float32):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,hkv,d,s,kw", [
    (25, 5, 64, 512, dict(window=128)),           # hymba: window, GQA 5
    (25, 5, 64, 100, dict(window=1024)),          # ragged S
    (16, 8, 128, 384, dict()),                    # qwen3: causal, D 128
    (8, 4, 128, 200, dict(softcap=50.0)),         # softcap, ragged S
    (4, 4, 64, 130, dict(causal=False)),          # full attention
    (4, 2, 64, 96, dict(causal=False, window=16, scale=0.2)),
    (8, 4, 256, 300, dict(window=4096, softcap=50.0)),  # gemma2-2b, ragged
    (4, 1, 256, 130, dict(causal=False)),         # paligemma: D 256, MQA
    (4, 2, 16, 100, dict(window=32)),             # reduced_config: D 16
    (4, 4, 32, 200, dict(causal=False, softcap=5.0)),   # D 32, ragged
    # window 16: the q tiles past the first see kv tiles whose every entry
    # is masked for most of their rows (m = -1e30, l = 0 carried); S = 300
    # is no multiple of any tile
    (4, 2, 16, 300, dict(window=16)),
    (4, 2, 32, 300, dict(window=16)),
    (4, 2, 64, 300, dict(window=16)),
    (4, 2, 128, 300, dict(window=16)),
    (4, 2, 256, 300, dict(window=16)),
    (2, 1, 64, 5, dict()),                        # S below one mma tile
    (2, 2, 256, 1, dict(causal=False)),
])
def test_k4_matches_plain(cuda, dtype, tol, h, hkv, d, s, kw):
    q = _randn(cuda, s, 2, h, s, d, dtype=dtype)
    k = _randn(cuda, s + 1, 2, hkv, s, d, dtype=dtype)
    v = _randn(cuda, s + 2, 2, hkv, s, d, dtype=dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:     # as a whole too: a dropped kv tile shows
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert err <= K4_BF16_REL_NORM, err


def test_k4_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                        q)


# -- K6: rwkv6 ----------------------------------------------------------------

@pytest.mark.parametrize("t,h,kk,vv,chunk,dtype,u_zero,w_val", [
    (2048, 25, 16, 64, 64, torch.bfloat16, True, None),   # hymba's SSM heads
    (256, 3, 16, 64, 64, torch.float32, False, None),     # u != 0
    (128, 2, 16, 24, 32, torch.float32, False, None),     # V tail tile
    (96, 2, 64, 64, 32, torch.bfloat16, False, None),     # K = 64
    (256, 32, 64, 64, 64, torch.bfloat16, False, None),   # rwkv6-1.6b's heads
    (192, 4, 64, 64, 64, torch.float32, False, None),     # K = 64, chunk 64
    (160, 3, 8, 40, 32, torch.float32, False, None),      # K = 8 (reduced)
    (192, 2, 32, 72, 64, torch.bfloat16, False, None),    # K = 32
    (256, 2, 16, 64, 64, torch.float32, False, 1e-6),     # extreme decay
    (256, 2, 16, 64, 64, torch.float32, False, 1 - 1e-6),
    (12, 25, 16, 64, 64, torch.float32, True, None),      # T < chunk
])
def test_k6_matches_plain(cuda, t, h, kk, vv, chunk, dtype, u_zero, w_val):
    r = _randn(cuda, t, 1, h, t, kk, dtype=dtype)
    k = _randn(cuda, t + 1, 1, h, t, kk, dtype=dtype)
    v = _randn(cuda, t + 2, 1, h, t, vv, dtype=dtype)
    if w_val is None:
        w = torch.sigmoid(4 * _randn(cuda, t + 3, 1, h, t, kk)).clamp(
            1e-6, 1 - 1e-6)
    else:
        w = torch.full((1, h, t, kk), w_val, device=cuda)
    u = torch.zeros(h, kk, device=cuda) if u_zero else _randn(cuda, 7, h, kk)
    before = rwkv6.launches
    o, state = rwkv6(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6.launches == before + 1
    assert o.dtype == state.dtype == torch.float32
    assert tuple(state.shape) == (1, h, kk, vv)
    assert torch.isfinite(o).all() and torch.isfinite(state).all()
    o_want, s_want = rwkv6_plain(r, k, v, w, u, chunk=chunk)
    torch.testing.assert_close(o, o_want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, s_want, rtol=2e-4, atol=2e-4)


def test_k6_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 1, 256, 16, device=cuda)
    with pytest.raises(ValueError, match="chunk <= 64"):
        rwkv6(x, x, x, x + 0.5, torch.zeros(1, 16, device=cuda), chunk=128)
    x = torch.zeros(1, 1, 64, 80, device=cuda)
    with pytest.raises(ValueError, match="K <= 64"):
        rwkv6(x, x, x, x + 0.5, torch.zeros(1, 80, device=cuda))


# -- the LM stack: a 2-layer hymba-1.5b prefill launches K4 and K6 per layer ----

def test_hymba_prefill_launches_k4_and_k6_per_layer(cuda):
    import dataclasses
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                              compute_dtype="float32")
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 128),
                         generator=torch.Generator().manual_seed(0))
    k4, k6 = flash_attention.launches, rwkv6.launches
    logits, cache = M.prefill(cfg, params, toks.to(cuda),
                              M.init_cache(cfg, 1, 160, device=cuda))
    torch.cuda.synchronize()
    assert (flash_attention.launches - k4, rwkv6.launches - k6) == (2, 2)
    host = M.prefill(cfg, _to_cpu(params), toks,
                     M.init_cache(cfg, 1, 160, device="cpu"))[0]
    torch.testing.assert_close(logits.cpu(), host, rtol=1e-3, atol=1e-3)
    assert cache["layers"]["pos0"]["ssm_state"].abs().sum() > 0


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


# -- the LM stack: rwkv6 (K6 per layer) and the in-graph MoE FFN (K5 x 3) -----

def test_rwkv6_prefill_launches_k6_per_layer(cuda):
    import dataclasses
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=2,
                              d_model=256, n_heads=4, n_kv_heads=4,
                              d_ff=512, vocab_size=512,
                              compute_dtype="float32")
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(1))
    k6 = rwkv6.launches
    logits, cache = M.prefill(cfg, params, toks.to(cuda),
                              M.init_cache(cfg, 2, 132, device=cuda))
    torch.cuda.synchronize()
    assert rwkv6.launches - k6 == cfg.n_layers
    host, host_cache = M.prefill(cfg, _to_cpu(params), toks,
                                 M.init_cache(cfg, 2, 132, device="cpu"))
    torch.testing.assert_close(logits.cpu(), host, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cache["layers"]["pos0"]["wkv"].cpu(),
                               host_cache["layers"]["pos0"]["wkv"],
                               rtol=1e-3, atol=1e-3)


def test_in_graph_moe_launches_k5_and_decodes_deterministically(cuda):
    b, d, e, k, dff = 4, 64, 8, 2, 96
    rng = np.random.default_rng(5)
    p = dict(router=rng.standard_normal((d, e)) * 0.1,
             w_gate=rng.standard_normal((e, d, dff)) / np.sqrt(d),
             w_up=rng.standard_normal((e, d, dff)) / np.sqrt(d),
             w_down=rng.standard_normal((e, dff, d)) / np.sqrt(dff))
    kw = dict(n_experts=e, top_k=k, capacity_factor=1.25)
    pt = moe_params_from_numpy(p, cuda)
    for s in (32, 1):                          # a prefill, a decode step
        x = rng.standard_normal((b, s, d)).astype(np.float32)
        want, aux_want = moe_ffn(torch.from_numpy(x),
                                 moe_params_from_numpy(p, "cpu"), **kw)
        xc = torch.from_numpy(x).to(cuda)
        before = moe_gemm.launches
        runs = [moe_ffn(xc, pt, **kw) for _ in range(2)]
        assert moe_gemm.launches == before + 6       # 3 per call
        (out, aux), (again, aux_again) = runs
        # the combine gathers and sums in a fixed order: bit-identical
        assert torch.equal(out, again) and torch.equal(aux, aux_again)
        torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(aux.cpu(), aux_want, rtol=1e-4,
                                   atol=1e-4)


# -- the LM stack: paligemma-3b (image prefixes) and whisper-small (enc-dec) --

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,hkv,d,kw", [
    (4, 12, 12, 64, dict(causal=False)),   # whisper-small's encoder
    (2, 8, 1, 256, dict()),                # paligemma-3b's prefill: MQA
])
def test_k4_at_the_encoder_and_image_prefill_shapes(cuda, dtype, tol, b, h,
                                                    hkv, d, kw):
    s = 1024
    q = _randn(cuda, d, b, h, s, d, dtype=dtype)
    k = _randn(cuda, d + 1, b, hkv, s, d, dtype=dtype)
    v = _randn(cuda, d + 2, b, hkv, s, d, dtype=dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert err <= K4_BF16_REL_NORM, err


def _reduced(arch):
    from repro_torch.configs import reduced_config
    return reduced_config(get_config(arch))


def test_paligemma_image_prefill_on_card(cuda):
    cfg = _reduced("paligemma-3b")
    params = M.init_params(cfg, 0, device=cuda)
    host = _to_cpu(params)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(
        np.int32))
    images = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_image_tokens, cfg.d_image)).astype(np.float32))
    n = cfg.n_image_tokens + 24
    k4 = flash_attention.launches
    fwd, _ = M.forward(cfg, params, toks.to(cuda), images=images.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == k4      # prefix-LM: plain attention
    logits, cache = M.prefill(cfg, params, toks.to(cuda),
                              M.init_cache(cfg, 2, n + 1, device=cuda),
                              images=images.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches - k4 == cfg.n_layers
    host_fwd, _ = M.forward(cfg, host, toks, images=images)
    host_logits, host_cache = M.prefill(cfg, host, toks,
                                        M.init_cache(cfg, 2, n + 1,
                                                     device="cpu"),
                                        images=images)
    torch.testing.assert_close(fwd.cpu(), host_fwd, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), host_logits, rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(cache["layers"]["pos0"]["k"].cpu(),
                               host_cache["layers"]["pos0"]["k"],
                               rtol=1e-3, atol=1e-3)


def test_whisper_generate_on_card(cuda):
    from repro_torch.launch.serve import generate
    cfg = _reduced("whisper-small")
    params = M.init_params(cfg, 0, device=cuda)
    host = _to_cpu(params)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)).astype(
        np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 64, cfg.d_frame)).astype(np.float32))
    k4 = flash_attention.launches
    enc, cache = M.encdec_prefill(cfg, params, frames.to(cuda),
                                  M.init_cache(cfg, 2, 8, s_enc=64,
                                               device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches - k4 == cfg.n_enc_layers
    host_enc, host_cache = M.encdec_prefill(
        cfg, host, frames, M.init_cache(cfg, 2, 8, s_enc=64, device="cpu"))
    torch.testing.assert_close(enc.cpu(), host_enc, rtol=1e-3, atol=1e-3)
    k4 = flash_attention.launches
    for i in range(4):
        lg, cache = M.decode_step(cfg, params, cache, toks[:, i:i + 1].to(
            cuda), i)
        host_lg, host_cache = M.decode_step(cfg, host, host_cache,
                                            toks[:, i:i + 1], i)
        torch.testing.assert_close(lg.cpu(), host_lg, rtol=1e-3, atol=1e-3)
    assert flash_attention.launches == k4      # decode runs no K4
    k4 = flash_attention.launches
    seqs, lat = generate(cfg, params, toks, gen=6, max_seq=11,
                         frames=frames, device=cuda)
    assert flash_attention.launches - k4 == cfg.n_enc_layers
    assert tuple(seqs.shape) == (2, 10) and len(lat) == 5
    assert 0 <= int(seqs.min()) and int(seqs.max()) < cfg.vocab_size


# -- sharded execution over a mesh of one card, and the kernel-library store

def _card_mesh(n):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n,), ("data",), ["cuda:0"] * n)


@pytest.mark.parametrize("t", [16, 256])
def test_sharded_spmm_bit_equal_on_one_card(cuda, t):
    """Each shard launches K2 at the whole call's regime: at T = 16 a shard
    of 4 rows takes the 32-row tiles, as the unsharded call does."""
    w = P.random_csr(1000, 768, 0.03, np.random.default_rng(t), "blocky")
    x = np.random.default_rng(t + 1).standard_normal((t, 1000)).astype(
        np.float32)
    y0, _ = ReapRuntime(device="cuda").run("spmm", x, w)
    before = bsr_spmm.launches
    y1, st = ReapRuntime(device="cuda").run("spmm", x, w,
                                            mesh=_card_mesh(4))
    assert bsr_spmm.launches == before + 4
    assert st["method"] == "spmm_sharded" and st["n_shards"] == 4
    assert y0.tobytes() == y1.tobytes()


@pytest.mark.parametrize("t", [16, 256])
def test_k2_rows_do_not_depend_on_their_tile_position(cuda, t):
    w = P.random_csr(700, 600, 0.02, np.random.default_rng(3), "blocky")
    plan = inspect_spmm(w, 128)
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, plan.pat.n_rows)).astype(np.float32)).to(cuda)
    tiles = torch.from_numpy(plan.scatter(w.data)).to(cuda)
    a = bsr_spmm(x, tiles, plan.schedule, n_j_blocks=plan.n_j_blocks)
    for shift in (1, 37):
        xs = torch.cat([x.new_zeros((shift, x.shape[1])), x])
        b = bsr_spmm(xs, tiles, plan.schedule, n_j_blocks=plan.n_j_blocks,
                     regime_t=t)
        assert torch.equal(a, b[shift:])
    part = bsr_spmm(x[:t // 4], tiles, plan.schedule,
                    n_j_blocks=plan.n_j_blocks, regime_t=t)
    assert torch.equal(part, a[:t // 4])


@pytest.mark.parametrize("n,sharded", [(4, True), (3, False)])
def test_sharded_moe_dispatch_bit_equal_on_one_card(cuda, n, sharded):
    rng = np.random.default_rng(n)
    tokens = torch.from_numpy(rng.standard_normal((256, 64)).astype(
        np.float32)).to(cuda)
    ids = np.argsort(rng.random((256, 16)), axis=1)[:, :4]
    (b0, _), _ = ReapRuntime(device="cuda").run("moe_dispatch", tokens, ids,
                                                 n_experts=16)
    (b1, _), st = ReapRuntime(device="cuda").run(
        "moe_dispatch", tokens, ids, n_experts=16, mesh=_card_mesh(n))
    assert st["sharded"] is sharded and b1.is_cuda
    assert torch.equal(b0, b1)


def test_sharded_gather_on_one_card(cuda):
    a = P.random_csr(3000, 3000, 0.003, np.random.default_rng(4))
    c, st = ReapRuntime(device="cuda").run("spgemm_gather", a, a,
                                           mesh=_card_mesh(4))
    ref = P.spgemm_ref_numpy(a, a)
    assert st["method"] == "gather_sharded"
    assert np.array_equal(c.indptr, ref.indptr)
    assert np.array_equal(c.indices, ref.indices)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-4, atol=1e-4)


_STORE_RESTART = r"""
import sys
from repro_torch.runtime.exec_store import ExecCache, ExecStore
cache = ExecCache(ExecStore(sys.argv[1]))
cache.load_many(("bsr_spgemm", "bsr_spmm", "block_sparse_attention",
                 "flash_attention", "moe_gemm", "rwkv6_scan",
                 "flash_attention_bwd", "rwkv6_scan_bwd", "moe_gemm_bwd"))
print("COUNTS", cache.stats.compiles, cache.stats.loads)
"""


def test_store_restart_loads_every_library_without_nvcc(cuda, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                          .parents[1] / "src"))

    def run():
        out = subprocess.run([sys.executable, "-c", _STORE_RESTART,
                              str(tmp_path / "store")], capture_output=True,
                             text=True, env=env, timeout=900)
        assert out.returncode == 0, out.stderr
        line = next(x for x in out.stdout.splitlines()
                    if x.startswith("COUNTS"))
        return tuple(int(v) for v in line.split()[1:])

    assert run() == (9, 0)
    assert run() == (0, 9)


# -- training: K4's backward, the kernels without one, the train step --------

K4_BWD_F32_TOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,s,kw", [
    (8, 16, 8, 128, 256, dict()),                 # qwen3-1.7b training
    (1, 25, 5, 64, 2048, dict(window=1024)),      # hymba-1.5b
    (1, 25, 5, 64, 100, dict(window=1024)),       # ragged S
    (1, 8, 4, 256, 2048, dict(window=4096, softcap=50.0)),   # gemma2-2b
    (2, 4, 2, 16, 300, dict(window=32)),          # reduced_config
    (2, 4, 2, 32, 300, dict(window=16)),
    (1, 8, 4, 128, 1000, dict(window=256, softcap=50.0)),
    (2, 4, 4, 64, 130, dict(causal=False)),
    (2, 2, 1, 256, 130, dict(causal=False, scale=0.2)),
    (2, 25, 5, 64, 2048, dict(window=1024)),      # hymba-1.5b training
    (1, 4, 2, 256, 333, dict(window=100)),        # D 256: both column halves
    (1, 6, 2, 128, 77, dict(softcap=30.0, window=20)),
    (3, 2, 1, 16, 65, dict(causal=False, window=8)),
])
def test_k4_backward_matches_plain_autograd(cuda, dtype, b, h, hkv, d, s,
                                            kw):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    q = _randn(cuda, s, b, h, s, d, dtype=dtype)
    k = _randn(cuda, s + 1, b, hkv, s, d, dtype=dtype)
    v = _randn(cuda, s + 2, b, hkv, s, d, dtype=dtype)
    dout = _randn(cuda, s + 3, b, h, s, d, dtype=dtype)
    with torch.no_grad():
        out = flash_attention(q, k, v, **kw)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))   # no atomics
    want = flash_attention_bwd_plain(q, k, v, dout, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=K4_BWD_F32_TOL,
                                       atol=K4_BWD_F32_TOL)
        else:
            err = (g.float() - w.float()).norm() / w.float().norm()
            assert err <= K4_BF16_REL_NORM, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_autograd_runs_both_kernels(cuda, dtype):
    q, k, v = (_randn(cuda, i, 2, n, 200, 64, dtype=dtype).requires_grad_(
        True) for i, n in ((1, 4), (2, 2), (3, 2)))
    dout = _randn(cuda, 4, 2, 4, 200, 64, dtype=dtype)
    from repro_torch.kernels import flash_attention as FA
    f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    out = flash_attention(q, k, v, window=64)
    with torch.no_grad():            # the forward's bits do not change
        assert torch.equal(out, flash_attention(q, k, v, window=64))
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (FA.flash_attention.launches - f0,
            FA.flash_attention_bwd.launches - b0) == (2, 1)
    want = FA.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                  out.detach(), dout, window=64)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_kernels_without_a_backward_raise_under_grad(cuda):
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w = torch.randn(2, 64, 64, device=cuda)
    tiles = torch.randn(2, 32, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K1"):
        bsr_spgemm_schedule(dict(a_id=np.array([0]), b_id=np.array([1]),
                                 out_id=np.array([0])), tiles, tiles,
                            n_out_blocks=1)
    with pytest.raises(NotImplementedError, match="K2"):
        bsr_spmm(x, w[:, :32, :32].contiguous().requires_grad_(True),
                 dict(w_id=np.array([0]), k_blk=np.array([0]),
                      j_blk=np.array([0])), n_j_blocks=1)
    qq = torch.randn(1, 2, 64, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3"):
        block_sparse_attention(qq, qq, qq, np.zeros((2, 1), np.int32),
                               np.ones(2, np.int32))


# -- training: K5's backward -------------------------------------------------

K5_BWD_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,cap,din,dout,e,be", [
    (4, 24, 64, 64, 4, None), (3, 131, 36, 260, 4, None),
    (6, 8, 7168, 2048, 8, None), (5, 1, 64, 64, 6, [5, 5, 0, 2, 5]),
    (8, 80, 128, 256, 5, [1, 1, 1, 1, 3, 3, 0, 0]),
    (4, 320, 256, 512, 2, [1, 0, 1, 0]),
    (20, 200, 384, 512, 6, None),          # bundles not a multiple of E
    (5, 70, 72, 264, 3, [2, 2, 0, 2, 0]),  # widths ragged against the tiles
    (7, 129, 260, 36, 3, None)])           # d_out not a multiple of 8
def test_k5_backward_matches_plain(cuda, dtype, nb, cap, din, dout, e, be):
    """dx and dw against ``moe_gemm_bwd_plain``: ragged and tiny caps,
    widths not a multiple of 8, kimi-k2's widths, an expert with no bundle
    and repeated experts; two runs bit-identical; a bfloat16 call on
    ``bwd_route``'s kernels (``moe_gemm_bwd.bf16_routes``)."""
    from repro_torch.kernels.moe_gemm import (bwd_route, moe_gemm_bwd,
                                              moe_gemm_bwd_plain)
    rng = np.random.default_rng(nb * cap + din)
    x, dy = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        cuda, dtype) for s in ((nb, cap, din), (nb, cap, dout)))
    w = torch.from_numpy(rng.standard_normal((e, din, dout)).astype(
        np.float32) / np.sqrt(din)).to(cuda, dtype)
    be = rng.integers(0, e, nb).astype(np.int32) if be is None \
        else np.asarray(be, np.int32)
    before = moe_gemm_bwd.launches
    r0 = dict(moe_gemm_bwd.bf16_routes)
    got = moe_gemm_bwd(x, w, be, dy)
    again = moe_gemm_bwd(x, w, be, dy)
    assert moe_gemm_bwd.launches == before + 2
    assert {k: n - r0.get(k, 0) for k, n in moe_gemm_bwd.bf16_routes.items()
            if n - r0.get(k, 0)} == ({bwd_route(din, dout): 2}
                                     if dtype == torch.bfloat16 else {})
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = moe_gemm_bwd_plain(x, w, torch.from_numpy(be).to(cuda), dy)
    for g, ref in zip(got, want):
        assert g.dtype == dtype and g.shape == ref.shape
        err = (g.float() - ref.float()).norm() / ref.float().norm()
        assert err <= K5_BWD_REL_NORM[dtype], err
    for empty in set(range(e)) - set(be.tolist()):
        assert not got[1][empty].any()


def test_k5_autograd_runs_forward_and_backward_kernels(cuda):
    """Under grad K5's forward gives the no-grad call's bits, its gradients
    are the backward entries', and the counts are exact: one forward, one
    backward call (dx and dw); only w needing a gradient launches dw
    alone."""
    from repro_torch.kernels import moe_gemm as K5
    rng = np.random.default_rng(40)
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda, dtype) for s in ((6, 40, 64), (6, 40, 96)))
        w = torch.from_numpy(rng.standard_normal((3, 64, 96)).astype(
            np.float32) / 8).to(cuda, dtype)
        be = np.array([2, 0, 2, 2, 0, 0], np.int32)
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        f0, b0 = K5.moe_gemm.launches, K5.moe_gemm_bwd.launches
        r0 = dict(K5.moe_gemm_bwd.routes)
        t0 = dict(K5.moe_gemm_bwd.bf16_routes)
        out = moe_gemm(xl, wl, be)
        with torch.no_grad():
            assert torch.equal(out, moe_gemm(x, w, be))
        grads = torch.autograd.grad(out, (xl, wl), dy)
        assert (K5.moe_gemm.launches - f0, K5.moe_gemm_bwd.launches - b0) \
            == (2, 1)
        assert {k: v - r0.get(k, 0) for k, v in
                K5.moe_gemm_bwd.routes.items()} == {"dx": 1, "dw": 1}
        assert {k: v - t0.get(k, 0) for k, v in
                K5.moe_gemm_bwd.bf16_routes.items() if v - t0.get(k, 0)} \
            == ({"wgmma": 1} if dtype == torch.bfloat16 else {})
        want = K5.moe_gemm_bwd(x, w, be, dy)
        assert all(torch.equal(g, v) for g, v in zip(grads, want))
        (dw,) = torch.autograd.grad(moe_gemm(x, wl, be), (wl,), dy)
        assert torch.equal(dw, want[1])
        assert K5.moe_gemm_bwd.routes["dx"] == r0.get("dx", 0) + 2


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b", "rwkv6-1.6b",
                                  "hymba-1.5b", "dbrx-132b",
                                  "kimi-k2-1t-a32b"])
def test_train_step_card_against_host(cuda, arch):
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.kernels import rwkv6_scan as RK
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = reduced_config(get_config(arch))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    from repro_torch.models.params import tree_map
    host = M.init_params(cfg, 0, device="cpu")
    card = {"cpu": host, "cuda": tree_map(lambda t: t.to(cuda), host)}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=2))
    losses = {}
    for name, params in card.items():
        opt = adamw.init(opt_cfg, params)
        step = make_train_step(cfg, opt_cfg)
        counters = (FA.flash_attention, FA.flash_attention_bwd, RK.rwkv6,
                    RK.rwkv6_bwd, K5.moe_gemm, K5.moe_gemm_bwd)
        before = [c.launches for c in counters]
        losses[name] = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(name)
                     for k, v in data.get_batch(i).items()}
            params, opt, m = step(params, opt, batch)
            losses[name].append(float(m["loss"]))
        got = [c.launches - n for c, n in zip(counters, before)]
        # two steps; under remat each layer's forward runs twice (an MoE
        # layer's three K5 products each), its backward once
        n = 2 * cfg.n_layers
        att, ssm = cfg.mixer in ("attn", "hymba"), cfg.mixer in ("rwkv",
                                                                 "hymba")
        moe = 3 * (cfg.ffn == "moe")
        assert got == ([0] * 6 if name == "cpu" else
                       [2 * n * att, n * att, 2 * n * ssm, n * ssm,
                        2 * n * moe, n * moe])
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


# -- training: K6's backward -------------------------------------------------

K6_BWD_REL_NORM = 1e-4
K6_BWD_BF16_REL_NORM = 5e-3


def _k6_bwd_problem(dev, seed, b, h, t, kk, vv, dtype, u_zero, w_val=None):
    r, k = (_randn(dev, seed + i, b, h, t, kk, dtype=dtype) for i in (0, 1))
    v = _randn(dev, seed + 2, b, h, t, vv, dtype=dtype)
    w = torch.exp(-torch.exp(_randn(dev, seed + 3, b, h, t, kk) - 0.5)) \
        if w_val is None else torch.full((b, h, t, kk), w_val, device=dev)
    u = torch.zeros(h, kk, device=dev) if u_zero else \
        _randn(dev, seed + 4, h, kk)
    return (r, k, v, w.clamp(1e-6, 1 - 1e-6), u,
            _randn(dev, seed + 5, b, h, t, vv),
            _randn(dev, seed + 6, b, h, kk, vv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,kk,vv,chunk,u_zero,with_ds,w_val", [
    (2, 25, 2048, 16, 64, 64, True, False, None),   # hymba-1.5b's heads
    (2, 32, 2048, 64, 64, 64, False, False, None),  # rwkv6-1.6b's
    (2, 25, 2016, 16, 64, 32, True, True, None),    # T no multiple of 64
    (1, 3, 160, 8, 40, 32, False, True, None),      # K = 8, a V tail tile
    (1, 2, 12, 32, 72, 64, False, True, None),      # T < chunk
    (1, 25, 256, 16, 64, 64, True, True, 1e-6),     # extreme decays at
    (1, 25, 256, 16, 64, 64, True, True, 1 - 1e-6),  # both training heads
    (1, 32, 256, 64, 64, 64, False, True, 1e-6),
    (1, 32, 256, 64, 64, 64, False, True, 1 - 1e-6),
])
def test_k6_backward_matches_plain(cuda, dtype, b, h, t, kk, vv, chunk,
                                   u_zero, with_ds, w_val):
    """Against the plain version's autograd on float64 copies: its float32
    dw divides a difference of two sums of order one by w.  bfloat16 r, k,
    v take the ``"mma"`` route where the shape allows (``bwd_route``),
    float32 the ``"fma"`` route."""
    from repro_torch.kernels.rwkv6_scan import (_chunk, bwd_route,
                                                rwkv6_bwd, rwkv6_bwd_plain)
    r, k, v, w, u, do, ds = _k6_bwd_problem(cuda, t, b, h, t, kk, vv, dtype,
                                            u_zero, w_val)
    ds = ds if with_ds else None
    route = bwd_route(dtype, kk, _chunk(t, chunk))
    assert route == ("mma" if dtype == torch.bfloat16 and t >= chunk
                     else "fma")
    before = rwkv6_bwd.launches
    routes = dict(rwkv6_bwd.routes)
    got = rwkv6_bwd(r, k, v, w, u, do, ds, chunk=chunk)
    again = rwkv6_bwd(r, k, v, w, u, do, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_bwd.launches == before + 2
    assert rwkv6_bwd.routes[route] == routes.get(route, 0) + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))   # no atomics
    want = rwkv6_bwd_plain(*(x.double() for x in (r, k, v, w, u, do)),
                           None if ds is None else ds.double(), chunk=chunk)
    tol = K6_BWD_REL_NORM if dtype == torch.float32 else K6_BWD_BF16_REL_NORM
    for g, x, ref in zip(got, want, (r, k, v, w, u)):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        assert torch.isfinite(g).all()
        err = (g.double() - x).norm() / x.norm()
        assert err <= tol, err


def test_k6_autograd_runs_forward_and_backward_kernels(cuda):
    from repro_torch.kernels import rwkv6_scan as RK
    r, k, v, w, u, do, ds = _k6_bwd_problem(cuda, 1, 2, 3, 256, 16, 64,
                                            torch.bfloat16, False)
    leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u)]
    f0, b0 = RK.rwkv6.launches, RK.rwkv6_bwd.launches
    o, state = rwkv6(*leaves, chunk=64)
    with torch.no_grad():            # the forward's bits do not change
        o2, state2 = rwkv6(r, k, v, w, u, chunk=64)
    assert torch.equal(o, o2) and torch.equal(state, state2)
    grads = torch.autograd.grad((o, state), leaves, (do, ds))
    assert (RK.rwkv6.launches - f0, RK.rwkv6_bwd.launches - b0) == (2, 1)
    want = RK.rwkv6_bwd(r, k, v, w, u, do, ds, chunk=64)
    assert all(torch.equal(g, x) for g, x in zip(grads, want))
    # the final state unused (dstate None), u without a gradient
    leaves = leaves[:4]
    o, _ = rwkv6(*leaves, u, chunk=64)
    grads = torch.autograd.grad(o, leaves, do)
    want = RK.rwkv6_bwd(r, k, v, w, u, do, chunk=64)
    assert all(torch.equal(g, x) for g, x in zip(grads, want))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_two_layer_loss_backward_card_against_host(cuda, arch):
    """Full width, 2 layers, float32 compute, 4 chunks of 64: every param
    leaf's gradient on the card (K6, K4 and their backward kernels) within
    1e-3 of the host's in relative norm; under remat K6 (and hymba's K4)
    runs twice a layer and its backward once."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RK
    from repro_torch.models.params import _walk, tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              compute_dtype="float32")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                   global_batch=1, seed=3)).get_batch(0)
    params = M.init_params(cfg, 2, device="cpu")
    grads = {}
    for dev in ("cpu", cuda):
        tree = tree_map(lambda t: t.detach().to(dev), params)
        leaves = list(_walk(tree))
        for _, p in leaves:
            p.requires_grad_(True)
        counters = (FA.flash_attention, FA.flash_attention_bwd, RK.rwkv6,
                    RK.rwkv6_bwd)
        before = [c.launches for c in counters]
        loss, _ = M.loss_fn(cfg, tree, {k: torch.from_numpy(x).to(dev)
                                        for k, x in batch.items()})
        g = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True, materialize_grads=True)
        got = [c.launches - n for c, n in zip(counters, before)]
        att = int(cfg.mixer == "hymba")
        assert got == ([0] * 4 if dev == "cpu" else [4 * att, 2 * att, 4, 2])
        grads[str(dev)] = {path: x.cpu() for (path, _), x in zip(leaves, g)}
    for path, g in grads["cpu"].items():
        err = (grads["cuda"][path] - g).norm() / g.norm().clamp_min(1e-30)
        assert err <= 1e-3, (path, err)


# -- sharded training over a mesh of one card ---------------------------------

def _train_counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as K5
    return (FA.flash_attention, FA.flash_attention_bwd, K5.moe_gemm,
            K5.moe_gemm_bwd)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b"])
def test_sharded_step_on_one_card_matches_one_device(cuda, arch,
                                                     monkeypatch):
    """A ``(2, 2)`` mesh over ``cuda:0`` x 4: the params, m and v sharded
    on the card, each of the four positions (two data shards x two model
    positions: the tensor-parallel route) runs K4 (dbrx-132b also K5) and
    their backward kernels on its heads (experts) and its data shard's half
    of the batch.  The loss and every gradient leaf within 1e-3 (relative
    norm) of the one-device step on the card, and each kernel launched four
    times as often: once a position."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as PS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import _walk
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    cfg = reduced_config(get_config(arch))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                   global_batch=4)).get_batch(0).items()}
    grads, update = [], adamw.update

    def capture(c, g, state, params):
        grads.append(dict(_walk(S.unshard_tree(g, cuda))))
        return update(c, g, state, params)
    monkeypatch.setattr(PS.adamw, "update", capture)
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    launches, losses = [], []
    for m in (None, mesh):
        params = M.init_params(cfg, 0, device=cuda)
        if m is not None:
            params = S.shard_tree(params, S.params_shardings(cfg, m))
            assert any(isinstance(p, S.ShardedTensor)
                       for _, p in _walk(params))
        opt = adamw.init(opt_cfg, params)
        before = [c.launches for c in _train_counters()]
        _, _, metrics = PS.make_train_step(cfg, opt_cfg, m)(params, opt,
                                                            batch)
        losses.append(float(metrics["loss"]))
        launches.append([c.launches - n
                         for c, n in zip(_train_counters(), before)])
    assert launches[1] == [4 * n for n in launches[0]]
    assert launches[0][:2] == [2 * cfg.n_layers, cfg.n_layers]
    assert (launches[0][2] > 0) is (cfg.ffn == "moe")
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)
    for path, g in grads[0].items():
        err = (grads[1][path] - g).norm() / g.norm().clamp_min(1e-30)
        assert err <= 1e-3, (path, err)


# a leaf's bfloat16 gradient on the mesh against one device's bfloat16
# gradient: within this many times one device's own bfloat16 gap from
# float32 on that leaf (plus the float32 route's 1e-3): each within one
# gap of float32 puts the two within two (an H100 read at most 0.78, 0.86,
# 0.80 and 1.12 of one gap for qwen3, rwkv6, hymba and dbrx)
BF16_LEAF_K = 2.0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b", "hymba-1.5b",
                                  "dbrx-132b"])
def test_tensor_parallel_training_on_card_matches_host(cuda, arch,
                                                       monkeypatch):
    """One training step on the tensor-parallel route over a ``(2, 2)``
    mesh of ``cuda:0`` x 4 (each of the 4 positions on its heads, FFN
    columns or experts and its vocabulary rows), from the same params as
    the same step on a host mesh of 4 ``cpu`` devices and as the
    one-device step on the card.  In float32 compute: K4, K6 and K5 and
    their backward kernels once a layer a position (the forward twice
    under remat), never on the host; the loss within 1e-3 (relative) of
    the host mesh's and every gradient leaf within phase 40's rtol 2e-2 /
    atol 2e-3 of it; the loss and every gradient leaf within 1e-3
    (relative) of the one-device step on the card, as
    ``test_sharded_step_on_one_card_matches_one_device`` holds the routes.
    In bfloat16 compute (``dense_partial``'s backward on the card) the same
    launches, every gradient finite, the gradients within 2e-2 (relative
    norm over every leaf) of the float32 card step's, and each leaf's
    gradient, by its own relative norm, within ``BF16_LEAF_K`` times one
    device's bfloat16 gap from float32 on that leaf, plus 1e-3 (the
    float32 route's tolerance), of the one-device bfloat16 step's.  Each
    run starts from its own copy of the params (AdamW updates them in
    place)."""
    import dataclasses
    import json

    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.kernels import rwkv6_scan as RK
    from repro_torch.launch import steps as PS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import _walk, tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.tensor_parallel import tp_route
    cfg = reduced_config(get_config(arch))
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=4)).get_batch(0)
    host = M.init_params(cfg, 0, device="cpu")
    grads, update = [], adamw.update

    def capture(c, g, state, params):
        grads.append(dict(_walk(S.unshard_tree(g, "cpu"))))
        return update(c, g, state, params)
    monkeypatch.setattr(PS.adamw, "update", capture)
    counters = (FA.flash_attention, FA.flash_attention_bwd, RK.rwkv6,
                RK.rwkv6_bwd, K5.moe_gemm, K5.moe_gemm_bwd)
    runs = {}
    for name, dev, c, shape in (("host", "cpu", cfg, (2, 2)),
                                ("card_one", "cuda:0", cfg, None),
                                ("card", "cuda:0", cfg, (2, 2)),
                                ("card_one_bf16", "cuda:0", bf16, None),
                                ("card_bf16", "cuda:0", bf16, (2, 2))):
        params = tree_map(lambda t: t.to(dev, copy=True), host)
        mesh = None
        if shape is not None:
            mesh = make_mesh(shape, ("data", "model"), [dev] * 4)
            assert tp_route(c, mesh)
            params = S.shard_tree(params, S.params_shardings(c, mesh))
        before = [k.launches for k in counters]
        _, _, metrics = PS.make_train_step(c, opt_cfg, mesh)(
            params, adamw.init(opt_cfg, params),
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[name] = (float(metrics["loss"]), grads[-1],
                      [k.launches - n for k, n in zip(counters, before)])
    n = cfg.n_layers                # layers, one step
    att, ssm = cfg.mixer in ("attn", "hymba"), cfg.mixer in ("rwkv",
                                                             "hymba")
    moe = 3 * (cfg.ffn == "moe")
    one = [2 * n * att, n * att, 2 * n * ssm, n * ssm, 2 * n * moe, n * moe]
    want = [4 * k for k in one]     # four positions
    losses = {k: v[0] for k, v in runs.items()}
    g_host, g_one, g_card, g_bf, g_one_bf = (runs[k][1] for k in (
        "host", "card_one", "card", "card_bf16", "card_one_bf16"))

    def rel(a, b):
        return float((a.float() - b.float()).norm()) / max(
            float(b.float().norm()), 1e-30)
    route_err = max(rel(g_card[p], g) for p, g in g_one.items())
    out_of_tol = [p for p, g in g_host.items() if not bool(
        ((g_card[p].float() - g).abs() <= 2e-3 + 2e-2 * g.abs()).all())]
    diff = sum(float((g_bf[p].float() - g.float()).norm()) ** 2
               for p, g in g_card.items()) ** 0.5
    norm = sum(float(g.float().norm()) ** 2
               for g in g_card.values()) ** 0.5
    finite = all(bool(torch.isfinite(g).all()) for g in g_bf.values())
    # each leaf: the mesh's bfloat16 gradient against one device's, and
    # one device's bfloat16 gap from its float32 gradient (the scale)
    leaves = {"/".join(p): (rel(g_bf[p], g), rel(g, g_one[p]))
              for p, g in g_one_bf.items()}
    past = sorted(p for p, (m, gap) in leaves.items()
                  if m > BF16_LEAF_K * gap + 1e-3)
    seen = dict(arch=arch, losses=losses, route_grad_rel=route_err,
                host_grad_rel=max(rel(g_card[p], g)
                                  for p, g in g_host.items()),
                host_out_of_tol=out_of_tol, bf16_rel_norm=diff / norm,
                bf16_finite=finite, bf16_leaves=leaves, bf16_leaves_past=past,
                launches={k: v[2] for k, v in runs.items()}, want=want)
    print(json.dumps(seen))
    assert runs["host"][2] == [0] * 6, seen
    assert runs["card_one"][2] == one, seen
    assert runs["card"][2] == want and runs["card_bf16"][2] == want, seen
    assert runs["card_one_bf16"][2] == one, seen
    assert abs(losses["card"] - losses["card_one"]) \
        <= 1e-3 * abs(losses["card_one"]), seen
    assert route_err <= 1e-3, seen
    assert abs(losses["card"] - losses["host"]) \
        <= 1e-3 * abs(losses["host"]), seen
    assert not out_of_tol, seen
    assert finite and diff <= 2e-2 * norm, seen
    assert not past, seen


def test_pipeline_apply_on_card(cuda):
    """GPipe over a ``(4, 1)`` ``("pipe", "model")`` mesh of ``cuda:0`` x
    4 against the sequential stages: the output within 1e-5; each
    gradient elementwise as close to the stages run in float64 as the
    float32 sequential run is, within a factor of 2 (its sums over the rows
    run per microbatch, so they round in another order; the card read the
    pipeline's dw 1.51e-5 and the sequential run's 1.15e-5 from float64,
    ``scripts/card_studies.py pipeline-grad``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = (torch.randn(4, 256, 256, generator=gen, device=cuda)
         / 16).requires_grad_(True)
    x = torch.randn(8, 32, 256, generator=gen, device=cuda
                    ).requires_grad_(True)
    ct = torch.randn(8, 32, 256, generator=gen, device=cuda)
    mesh = make_mesh((4, 1), ("pipe", "model"), ["cuda:0"] * 4)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                       mesh=mesh)
    seq = x
    for s in range(4):
        seq = torch.tanh(seq @ w[s])
    got = (y, *torch.autograd.grad((y * ct).sum(), [w, x]))
    want = (seq, *torch.autograd.grad((seq * ct).sum(), [w, x]))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    w64, x64 = (t.detach().double().requires_grad_(True) for t in (w, x))
    exact = x64
    for s in range(4):
        exact = torch.tanh(exact @ w64[s])
    exact = torch.autograd.grad((exact * ct.double()).sum(), [w64, x64])
    for a, b, e in zip(got[1:], want[1:], exact):
        pipe_err = (a.double() - e).abs().max().item()
        seq_err = (b.double() - e).abs().max().item()
        assert pipe_err <= 2 * seq_err, (pipe_err, seq_err)


def _equal_router(params) -> None:
    """Every MoE router's columns made equal to its first: each token ties
    and takes the first ``top_k`` experts."""
    from repro_torch.models.params import _walk
    for path, x in _walk(params):
        if path[-1] == "router":
            x.copy_(x[..., :1].expand_as(x))


def _serve_on(cfg, params, mesh, dev, toks, steps, seq):
    """Prefill and decode steps (``launch.steps``) on ``mesh`` (None: one
    device): the logits of each, the final cache gathered onto ``dev``,
    and K5's launches in the decode steps."""
    from repro_torch.launch import steps as PS
    from repro_torch.models.params import _walk
    from repro_torch.parallel import sharding as S
    p = params if mesh is None else S.shard_tree(
        params, S.params_shardings(cfg, mesh))
    logits, cache = PS.make_prefill_step(cfg, toks.shape[0], seq, mesh)(
        p, toks)
    decode = PS.make_decode_step(cfg, mesh)
    seen, before = [S.gather(logits, dev)], moe_gemm.launches
    for i, tok in enumerate(steps):
        lg, cache = decode(p, cache, tok, toks.shape[1] + i)
        seen.append(S.gather(lg, dev))
    return seen, {path: S.gather(x, dev) for path, x in _walk(cache)}, \
        moe_gemm.launches - before


@pytest.mark.parametrize("routing", ["in_graph", "host"])
def test_moe_mesh_decode_bundles_the_global_batch_on_card(cuda, routing,
                                                          monkeypatch):
    """Reduced dbrx-132b at batch 32 on a ``(4, 2)`` mesh of ``cuda:0`` x
    8, its routers' columns equal, so a decode step over the whole batch
    drops the tokens past an expert's 24 slots: every logit and the final
    cache within 1e-4 of one device on the card, K5 launched 3 times an
    MoE layer a decode step on each of the first data shard's 2 model
    positions, on its 2 experts over the global batch (not once a data
    shard); rows 24-31 decoded alone (their own capacity, no drop) differ,
    so the drop shows.  With a runtime installed the host route runs once
    an MoE layer a decode step."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as PMOE
    cfg = reduced_config(get_config("dbrx-132b"))
    params = M.init_params(cfg, 3, device=cuda)
    _equal_router(params)
    rng = np.random.default_rng(130)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 8)).astype(
        np.int32)).to(cuda)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 1))
                              .astype(np.int32)).to(cuda) for _ in range(3)]
    one = _serve_on(cfg, params, None, cuda, toks, steps, 11)
    tail = _serve_on(cfg, params, None, cuda, toks[24:],
                     [t[24:] for t in steps], 11)
    calls = []
    if routing == "host":
        plan_dest = PMOE._host_plan_dest

        def counted(expert_ids, **kw):
            calls.append(np.asarray(expert_ids).shape[0])
            return plan_dest(expert_ids, **kw)
        monkeypatch.setattr(PMOE, "_host_plan_dest", counted)
        monkeypatch.setattr(PMOE, "_HOST_DISPATCH_RT",
                            ReapRuntime(device="cuda"))
    mesh = make_mesh((4, 2), ("data", "model"), ["cuda:0"] * 8)
    got = _serve_on(cfg, params, mesh, cuda, toks, steps, 11)
    for g, o in zip(got[0], one[0]):
        torch.testing.assert_close(g, o, rtol=1e-4, atol=1e-4)
    for path, x in got[1].items():
        torch.testing.assert_close(x, one[1][path], rtol=1e-4, atol=1e-4)
    assert one[2] == 3 * cfg.n_layers * len(steps)
    assert got[2] == 2 * one[2]
    assert max((g[24:] - t).abs().max().item()
               for g, t in zip(got[0][1:], tail[0][1:])) > 1e-2
    if routing == "host":
        assert calls == [32] * (cfg.n_layers * len(steps))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_tensor_parallel_serving_on_card_matches_host(cuda, arch):
    """Reduced qwen3-1.7b / rwkv6-1.6b (float32) on a ``(2, 2)`` mesh of
    ``cuda:0`` x 4 take the tensor-parallel route: a prefill of 8 x 64 and
    3 decode steps, each model position on its heads, every logit and the
    final cache within 1e-4 of the same steps on the host (one device);
    K4 (K6) once a layer a position in the prefill, on half the heads."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RK
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.tensor_parallel import tp_route
    cfg = reduced_config(get_config(arch))
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    assert tp_route(cfg, mesh)
    params = M.init_params(cfg, 5, device="cpu")
    rng = np.random.default_rng(150)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64))
                            .astype(np.int32))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1))
                              .astype(np.int32)) for _ in range(3)]
    host = _serve_on(cfg, params, None, "cpu", toks, steps, 67)
    kernel = RK.rwkv6 if cfg.mixer == "rwkv" else FA.flash_attention
    before = kernel.launches
    got = _serve_on(cfg, tree_map(lambda x: x.to(cuda), params), mesh, cuda,
                    toks.to(cuda), [t.to(cuda) for t in steps], 67)
    assert kernel.launches - before == 4 * cfg.n_layers
    for g, h in zip(got[0], host[0]):
        torch.testing.assert_close(g.cpu(), h, rtol=1e-4, atol=1e-4)
    for path, x in got[1].items():
        torch.testing.assert_close(x.cpu(), host[1][path], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_expert_parallel_serving_on_card_matches_host(cuda, arch,
                                                      monkeypatch):
    """Reduced dbrx-132b / kimi-k2 (float32; 4 experts top-2, kimi-k2 with
    its shared expert) on a ``(2, 2)`` mesh of ``cuda:0`` x 4 take the
    tensor-parallel route with the experts split over the model axis: a
    prefill of 8 x 64 and 3 decode steps, every logit and the final cache
    within 1e-4 of the same steps on the host (one device).  K5 runs three
    times an MoE layer on each computing position (the prefill: both data
    shards' 2 positions; a decode step: the first shard's 2, over the
    global batch), always on a slice of 2 experts with local ids in [0,
    2), and its plain version never."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import moe_gemm as K5
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as PMOE
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.tensor_parallel import tp_route
    cfg = reduced_config(get_config(arch))
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    assert tp_route(cfg, mesh)
    params = M.init_params(cfg, 5, device="cpu")
    rng = np.random.default_rng(151)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64))
                            .astype(np.int32))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1))
                              .astype(np.int32)) for _ in range(3)]
    host = _serve_on(cfg, params, None, "cpu", toks, steps, 67)
    seen, plain = [], []
    launch, plain_fn = PMOE.moe_gemm, K5.moe_gemm_plain

    def recorded(x, w, bundle_expert, **kw):
        ids = K5._host_ids(bundle_expert)
        seen.append((w.shape[0], int(ids.min()), int(ids.max())))
        return launch(x, w, bundle_expert, **kw)

    def counted(*a, **kw):
        plain.append(1)
        return plain_fn(*a, **kw)
    monkeypatch.setattr(PMOE, "moe_gemm", recorded)
    monkeypatch.setattr(K5, "moe_gemm_plain", counted)
    before = moe_gemm.launches
    got = _serve_on(cfg, tree_map(lambda x: x.to(cuda), params), mesh, cuda,
                    toks.to(cuda), [t.to(cuda) for t in steps], 67)
    n = cfg.n_layers
    assert moe_gemm.launches - before == (4 + 2 * len(steps)) * 3 * n
    assert got[2] == 2 * 3 * n * len(steps)
    assert len(seen) == (4 + 2 * len(steps)) * 3 * n and not plain
    assert all(e == 2 and lo >= 0 and hi < 2 for e, lo, hi in seen), seen
    for g, h in zip(got[0], host[0]):
        torch.testing.assert_close(g.cpu(), h, rtol=1e-4, atol=1e-4)
    for path, x in got[1].items():
        torch.testing.assert_close(x.cpu(), host[1][path], rtol=1e-4,
                                   atol=1e-4)


def _mesh_against_one_card(cfg, params, cuda, x, steps, seq, first):
    """Prefill and decode steps on a ``(2, 2)`` mesh of ``cuda:0`` x 4 and
    on the card alone: (the mesh run's and the card's (logits, cache)),
    the K4 and K6 launches of the mesh's prefill and decode steps, and the
    calls of their plain versions.  Decode step ``i`` is at position
    ``first + i``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RK
    from repro_torch.launch import steps as PS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import _walk
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.tensor_parallel import tp_route
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    assert tp_route(cfg, mesh)
    plain, fns = [], {}
    for mod, name in ((FA, "flash_attention_plain"), (RK, "rwkv6_plain")):
        fns[mod, name] = getattr(mod, name)

        def counted(*a, _fn=fns[mod, name], **kw):
            plain.append(1)
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    try:
        runs, launches = [], []
        for m in (mesh, None):
            p = params if m is None else S.shard_tree(
                params, S.params_shardings(cfg, m))
            before = FA.flash_attention.launches, RK.rwkv6.launches
            logits, cache = PS.make_prefill_step(cfg, x.shape[0], seq, m)(
                p, x)
            mid = FA.flash_attention.launches, RK.rwkv6.launches
            decode = PS.make_decode_step(cfg, m)
            seen = [S.gather(logits, cuda)]
            for i, tok in enumerate(steps):
                lg, cache = decode(p, cache, tok, first + i)
                seen.append(S.gather(lg, cuda))
            after = FA.flash_attention.launches, RK.rwkv6.launches
            runs.append((seen, {path: S.gather(c, cuda)
                                for path, c in _walk(cache)}))
            launches.append({"prefill": [b - a for a, b in zip(before, mid)],
                             "decode": [b - a for a, b in zip(mid, after)]})
    finally:
        for (mod, name), fn in fns.items():
            setattr(mod, name, fn)
    return runs, launches[0], len(plain)


def _held_on_card(mesh_run, one_run, tol):
    for g, h in zip(mesh_run[0], one_run[0]):
        torch.testing.assert_close(g, h, rtol=tol, atol=tol)
    for path, x in mesh_run[1].items():
        torch.testing.assert_close(x, one_run[1][path], rtol=tol, atol=tol)


def test_hymba_tensor_parallel_serving_on_card(cuda):
    """hymba-1.5b at full width (25 / 5 heads of 64, SSM state 16,
    vocabulary 32001, window 1024), 2 layers, float32, on a ``(2, 2)``
    mesh of ``cuda:0`` x 4: the tensor-parallel route, each model position
    on 12.5 of the 25 q heads (its K/V heads repeated one a q head) and
    the SSM heads its columns meet; a prefill of 4 x 256 and 3 decode
    steps within 1e-3 of the same steps on the card alone, every logit and
    the final cache; K4 and K6 once a layer a position in the prefill
    (8 each), neither in a decode step, no plain version."""
    import dataclasses
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                              compute_dtype="float32")
    params = M.init_params(cfg, 7, device=cuda)
    rng = np.random.default_rng(152)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 256))
                            .astype(np.int32)).to(cuda)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))
                              .astype(np.int32)).to(cuda) for _ in range(3)]
    (got, one), launches, plain = _mesh_against_one_card(
        cfg, params, cuda, toks, steps, 259, 256)
    assert launches == {"prefill": [8, 8], "decode": [0, 0]}
    assert plain == 0
    _held_on_card(got, one, 1e-3)


def test_whisper_tensor_parallel_serving_on_card(cuda):
    """whisper-small at full width (12 heads of 64, vocabulary 51865), 2
    encoder and 2 decoder layers, float32, on a ``(2, 2)`` mesh of
    ``cuda:0`` x 4: the encoder on 6 heads a position (K4 once an encoder
    layer a position, 8 in the prefill), each position's cross K/V heads,
    3 decode steps (self- and cross-attention on its heads, no K4); the
    encoder output, every logit and the final cache within 1e-3 of the
    card alone, no plain version."""
    import dataclasses
    cfg = dataclasses.replace(get_config("whisper-small"), n_layers=2,
                              n_enc_layers=2, compute_dtype="float32")
    params = M.init_params(cfg, 8, device=cuda)
    rng = np.random.default_rng(153)
    frames = torch.from_numpy(rng.standard_normal((4, 256, cfg.d_frame))
                              .astype(np.float32)).to(cuda)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1))
                              .astype(np.int32)).to(cuda) for _ in range(3)]
    (got, one), launches, plain = _mesh_against_one_card(
        cfg, params, cuda, frames, steps, 256, 0)
    assert launches == {"prefill": [8, 0], "decode": [0, 0]}
    assert plain == 0
    _held_on_card(got, one, 1e-3)


def test_compressed_step_keeps_each_pods_error_buffer_on_card(
        cuda, monkeypatch):
    """Three int8 compressed steps of reduced qwen3-1.7b on a ``(2, 2,
    2)`` mesh of ``cuda:0`` x 8 against the same steps on the host: the
    params within the reference test's 5e-2 after each step, each pod's
    error buffer within one quantum (the larger of the two runs' payload
    scales for that pod, leaf and step) of the host's pod's, the second
    pod's buffer not the first's, and the buffer read whole the first
    pod's."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import _walk, tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import compression as PCOMP
    cfg = reduced_config(get_config("qwen3-1.7b"))
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=8)).get_batch(0)
    scales, ef = [], PCOMP.ef_compress_leaf

    def recorded(g, e):
        q, scale, new_err = ef(g, e)
        scales[-1].append(float(scale))
        return q, scale, new_err
    monkeypatch.setattr(PCOMP, "ef_compress_leaf", recorded)
    runs = []
    for dev in ("cpu", "cuda:0"):
        params = tree_map(lambda x: x.to(dev),
                          M.init_params(cfg, 0, device="cpu"))
        opt = adamw.init(opt_cfg, params)
        err = PCOMP.init_error_state(params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        step = PCOMP.make_compressed_train_step(cfg, opt_cfg, make_mesh(
            (2, 2, 2), ("pod", "data", "model"), [dev] * 8))
        seen = []
        for _ in range(3):
            scales.append([])
            params, opt, err, _ = step(params, opt, err, b)
            seen.append(({path: x.cpu() for path, x in _walk(params)},
                         {path: ([c.cpu() for c in x.copies],
                                 S.gather(x, "cpu"))
                          for path, x in _walk(err)}))
        runs.append(seen)
    for k, ((hp, he), (cp, ce)) in enumerate(zip(*runs)):
        for path, x in cp.items():
            assert (x - hp[path]).abs().max().item() < 5e-2, path
        n, differs = len(ce), False
        quanta = np.maximum(scales[k], scales[3 + k]) * (1 + 1e-3)
        for j, (path, (copies, whole)) in enumerate(ce.items()):
            assert torch.equal(whole, copies[0]), path
            for i, (c, h) in enumerate(zip(copies, he[path][0])):
                assert (c - h).abs().max().item() <= quanta[i * n + j], \
                    (k, i, path)
            differs |= not torch.allclose(copies[0], copies[1])
        assert differs


def test_purity_replay_on_card_equals_host(cuda):
    """The purity replay of ``repro_torch.analysis`` with
    ``device="cuda"``: every registered op replays bit-identically, and each
    op's plan built under the card's config has the host-built
    fingerprint and serialized payload, bit for bit."""
    from repro_torch.analysis.op_examples import builtin_examples
    from repro_torch.analysis.purity_check import (_payload_diff,
                                                   _plan_payload,
                                                   run_purity_checks)
    from repro_torch.runtime import RuntimeConfig
    from repro_torch.runtime import ops as _ops
    results = run_purity_checks(device="cuda")
    assert sorted(results) == sorted(_ops.list_ops())
    assert all(r["ok"] for r in results.values()), results
    for tag, ex in builtin_examples().items():
        spec = _ops.get_op(tag)
        (fp, payload), (host_fp, host_payload) = (
            _plan_payload(spec, ex.operands(0), RuntimeConfig(
                n_chunks=1, overlap=False, device=dev, **ex.runtime_kw),
                ex.kw) for dev in ("cuda", "cpu"))
        assert fp == host_fp, tag
        assert _payload_diff(payload, host_payload) is None, tag


@pytest.mark.parametrize("tag", ["spgemm_gather", "spgemm_block",
                                 "cholesky", "moe_dispatch", "spmm",
                                 "block_attention", "spmv"])
def test_example_op_on_card_cold_and_warm(cuda, tag):
    """Each example op of the analysis table through one
    ``ReapRuntime(device="cuda")``: a miss, then a hit, both within the
    conformance battery's 1e-4 of the same op on the host."""
    from repro_torch.analysis.op_examples import builtin_examples
    ex = builtin_examples()[tag]
    operands = ex.operands(2)

    def arrays(result):
        if isinstance(result, P.CSR):
            return [result.to_dense()]
        if torch.is_tensor(result):
            return [result.cpu().numpy()]
        if isinstance(result, np.ndarray):
            return [result]
        if isinstance(result, tuple):
            return [a for r in result for a in arrays(r)]
        return []

    want = arrays(ReapRuntime(device="cpu", **ex.runtime_kw).run(
        tag, *operands, **ex.kw)[0])
    rt = ReapRuntime(device="cuda", **ex.runtime_kw)
    for hit in (False, True):
        got, st = rt.run(tag, *operands, **ex.kw)
        assert st["cache_hit"] is hit
        got = arrays(got)
        assert got and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
