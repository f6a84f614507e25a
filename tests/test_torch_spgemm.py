"""Port parity, SpGEMM: kernel K1's plain version against the reference
Pallas kernel (interpret mode), and ``repro_torch.core.spgemm`` on the CPU
against ``repro.core.spgemm`` — exact CSR structure, values within the
reference's own tolerances (``tests/test_spgemm.py``: rtol 1e-4, atol
1e-5; ``tests/test_kernels.py``: 1e-5 for K1)."""
import numpy as np
import pytest
import torch
from _torch_parity import FAMILIES, assert_csr_match, family_csr

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as P
from repro.kernels import ops as rops
from repro.runtime import bucket_block_schedule as ref_bucket
from repro.runtime import build_block_chunkset as ref_chunkset
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bsr_spgemm import (bsr_spgemm_plain,
                                            prepare_schedule)
from repro_torch.runtime import bucket_block_schedule, build_block_chunkset

CPU = "cpu"


def _tiles(n, bs, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, bs, bs)).astype(np.float32)


class TestK1Plain:
    @pytest.mark.parametrize("block", [8, 16, 32])
    @pytest.mark.parametrize("pattern", ["blocky", "uniform"])
    def test_vs_pallas_interpret(self, block, pattern):
        rng = np.random.default_rng(block)
        a = P.random_csr(120, 96, 0.05, rng, pattern)
        b = P.random_csr(96, 88, 0.05, rng, pattern)
        plan = P.inspect_spgemm_block(a, b, block)
        ab = plan.a_pat.scatter(a.data)
        bb = plan.b_pat.scatter(b.data)
        sched = plan.schedule
        out = kops.bsr_spgemm(torch.from_numpy(ab), torch.from_numpy(bb),
                              *(torch.from_numpy(sched[k]) for k in
                                ("a_id", "b_id", "out_id", "is_first",
                                 "is_last")),
                              n_out_blocks=plan.n_out_blocks)
        expect = rops.bsr_spgemm(
            jnp.asarray(ab), jnp.asarray(bb),
            *(jnp.asarray(sched[k]) for k in
              ("a_id", "b_id", "out_id", "is_first", "is_last")),
            n_out_blocks=plan.n_out_blocks)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("chunk", [0, 1, 2])
    def test_bucketed_schedule_with_dead_group(self, chunk):
        a_p = family_csr(P, "blockdiag", 160, 160, 0.05, 3)
        a_r = family_csr(R, "blockdiag", 160, 160, 0.05, 3)
        ch = build_block_chunkset(P.inspect_spgemm_block(a_p, a_p, 16),
                                  3).chunk(chunk)
        sched = bucket_block_schedule(ch)
        ref_sched = ref_bucket(ref_chunkset(
            R.inspect_spgemm_block(a_r, a_r, 16), 3).chunk(chunk))
        for key in ("a_id", "b_id", "out_id", "is_first", "is_last",
                    "pair_cap", "out_cap", "a_cap", "b_cap"):
            assert np.array_equal(sched[key], ref_sched[key]), key
        ab, bb = _tiles(sched["a_cap"], 16, 1), _tiles(sched["b_cap"], 16, 2)
        n_out = sched["out_cap"] + 1
        out = kops.bsr_spgemm_schedule(sched, torch.from_numpy(ab),
                                       torch.from_numpy(bb),
                                       n_out_blocks=n_out).numpy()
        expect = np.asarray(rops.bsr_spgemm_schedule(
            sched, jnp.asarray(ab), jnp.asarray(bb), n_out_blocks=n_out))
        live = ch.n_out_blocks
        np.testing.assert_allclose(out[:live], expect[:live], rtol=1e-5,
                                   atol=1e-5)
        # the dead trailing group lands in tile out_cap only; the tiles
        # between the live ones and it stay zero
        assert not out[live:n_out - 1].any()
        if sched["pair_cap"] > ch.n_pairs:
            dead = ab[0] @ bb[0] * (sched["pair_cap"] - ch.n_pairs)
            np.testing.assert_allclose(out[-1], dead, rtol=1e-5, atol=1e-4)
        # the runtime's memoized K1 schedule runs the live pairs only: the
        # same live tiles, and a zero dummy tile
        live_only = kops.bsr_spgemm_schedule(
            sched["k1"], torch.from_numpy(ab), torch.from_numpy(bb),
            n_out_blocks=n_out).numpy()
        assert sched["k1"].n_pairs == ch.n_pairs
        np.testing.assert_array_equal(live_only[:live], out[:live])
        assert not live_only[live:].any()

    def test_untargeted_tiles_zero_and_plain_twin(self):
        ab, bb = _tiles(3, 16, 4), _tiles(2, 16, 5)
        sched = dict(a_id=np.array([0, 2, 1], np.int32),
                     b_id=np.array([1, 0, 1], np.int32),
                     out_id=np.array([1, 1, 3], np.int32),
                     is_first=np.array([1, 0, 1], np.int32),
                     is_last=np.array([0, 1, 1], np.int32))
        out = kops.bsr_spgemm_schedule(sched, torch.from_numpy(ab),
                                       torch.from_numpy(bb),
                                       n_out_blocks=5).numpy()
        assert not out[[0, 2, 4]].any()
        np.testing.assert_allclose(out[1], ab[0] @ bb[1] + ab[2] @ bb[0],
                                   rtol=1e-5, atol=1e-5)
        plain = bsr_spgemm_plain(
            torch.from_numpy(ab), torch.from_numpy(bb),
            *(torch.from_numpy(sched[k]) for k in ("a_id", "b_id", "out_id")),
            n_out_blocks=5).numpy()
        np.testing.assert_array_equal(out, plain)

    @pytest.mark.parametrize("bad", [
        dict(out_id=[1, 0, 3]),                  # unsorted: tile 1 twice
        dict(b_id=[1, -1, 1]),                   # negative tile id
        dict(a_id=[0, 5, 1]),                    # past the operand tiles
        dict(b_id=[1, 0, 2]),                    # past the operand tiles
        dict(out_id=[1, 1, 9]),                  # past the output tiles
        dict(a_id=[0, 1]),                       # lengths differ
    ])
    def test_rejects_malformed_schedules(self, bad):
        sched = dict(a_id=[0, 2, 1], b_id=[1, 0, 1], out_id=[1, 1, 3],
                     is_first=[1, 0, 1], is_last=[0, 1, 1])
        sched.update(bad)
        sched = {k: np.asarray(v, np.int32) for k, v in sched.items()}
        with pytest.raises(ValueError):
            kops.bsr_spgemm_schedule(sched, torch.zeros(3, 16, 16),
                                     torch.zeros(2, 16, 16), n_out_blocks=5)

    def test_prepare_schedule_groups(self):
        plan = P.inspect_spgemm_block(
            P.random_csr(80, 80, 0.08, np.random.default_rng(9), "blocky"),
            P.random_csr(80, 80, 0.08, np.random.default_rng(10), "blocky"),
            16)
        k1 = prepare_schedule(plan.schedule)
        n = plan.n_pairs
        assert k1.ids.dtype == np.int32 and k1.n_groups == plan.n_out_blocks
        starts = k1.ids[3 * n:]
        assert np.array_equal(starts[:-1], np.flatnonzero(plan.is_first))
        assert starts[-1] == n


class TestSpgemm:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("method", ["gather", "block", "auto"])
    def test_matches_reference(self, family, method):
        a_r, b_r = (family_csr(R, family, 100, 90, 0.05, 11),
                    family_csr(R, family, 90, 80, 0.05, 12))
        a_p, b_p = (family_csr(P, family, 100, 90, 0.05, 11),
                    family_csr(P, family, 90, 80, 0.05, 12))
        c_r, s_r = R.spgemm(a_r, b_r, method=method, block=16,
                            use_pallas=False)
        c_p, s_p = P.spgemm(a_p, b_p, method=method, block=16, device=CPU)
        assert s_p["method"] == s_r["method"]
        assert sorted(s_p) == sorted(s_r)
        assert_csr_match(c_p, c_r)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_block_execute_both_versions(self, use_kernel):
        a_r = family_csr(R, "blockdiag", 96, 96, 0.08, 13)
        a_p = family_csr(P, "blockdiag", 96, 96, 0.08, 13)
        plan_p = P.inspect_spgemm_block(a_p, a_p, 16)
        out = P.spgemm_block_execute(plan_p, a_p.data, a_p.data,
                                     use_kernel=use_kernel, device=CPU)
        ref = R.spgemm_block_execute(R.inspect_spgemm_block(a_r, a_r, 16),
                                     a_r.data, a_r.data, use_pallas=False)
        assert out.dtype == np.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("family", ["banded", "empty_rows"])
    def test_gather_chunk_executor(self, family):
        a_r = family_csr(R, family, 70, 70, 0.08, 14)
        a_p = family_csr(P, family, 70, 70, 0.08, 14)
        plan_r = R.inspect_spgemm_gather(a_r, a_r, 128)
        plan_p = P.inspect_spgemm_gather(a_p, a_p, 128)
        np.testing.assert_allclose(
            P.spgemm_gather_execute_chunk(plan_p, a_p.data, a_p.data, CPU),
            R.spgemm_gather_execute_chunk(plan_r, a_r.data, a_r.data),
            rtol=1e-4, atol=1e-5)

    def test_empty_result(self):
        a = P.CSR.from_dense(np.zeros((4, 4), np.float32))
        b = P.random_csr(4, 4, 0.5, np.random.default_rng(0))
        for method in ("gather", "block"):
            c, _ = P.spgemm(a, b, method=method, block=16, device=CPU)
            assert c.nnz == 0 and c.indptr.shape == (5,)

    def test_planned_reuse_with_fresh_values(self):
        a_p = family_csr(P, "random", 80, 80, 0.06, 15)
        plan = P.inspect_spgemm_gather(a_p, a_p)
        vals = np.random.default_rng(16).standard_normal(a_p.nnz)
        a2 = P.CSR(80, 80, a_p.indptr, a_p.indices, vals.astype(np.float32))
        c, stats = P.spgemm(a2, a2, plan=plan, device=CPU)
        assert stats["inspect_s"] == 0.0
        assert_csr_match(c, P.spgemm_ref_numpy(a2, a2))
