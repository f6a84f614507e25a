"""Port parity, host side: the numpy inspector of ``repro_torch.core`` must
build bit-identical matrices, digests and plans to ``repro.core`` from the
same seeds, across the five pattern families (banded, uniform, power-law,
block-diagonal, empty rows)."""
import dataclasses

import numpy as np
import pytest
from _torch_parity import FAMILIES, assert_same_fields, family_csr

import repro.core as R
import repro_torch.core as P
from repro.core.inspector import _ranges as ref_ranges
from repro.core.inspector import next_pow2 as ref_next_pow2
from repro_torch.core.inspector import _ranges, next_pow2


class TestGenerators:
    @pytest.mark.parametrize("pattern",
                             ["uniform", "powerlaw", "banded", "blocky"])
    def test_random_csr_bit_identical(self, pattern):
        a = R.random_csr(90, 70, 0.06, np.random.default_rng(4), pattern)
        b = P.random_csr(90, 70, 0.06, np.random.default_rng(4), pattern)
        assert_same_fields(a, b)

    @pytest.mark.parametrize("pattern", ["banded", "uniform", "blocky"])
    def test_random_spd_csr_bit_identical(self, pattern):
        a = R.random_spd_csr(60, 0.08, np.random.default_rng(5), pattern)
        b = P.random_spd_csr(60, 0.08, np.random.default_rng(5), pattern)
        assert_same_fields(a, b)

    def test_helpers_match(self):
        for n in (0, 1, 2, 3, 5, 64, 65, 1000):
            assert next_pow2(n) == ref_next_pow2(n)
        starts, counts = np.array([3, 0, 9, 4]), np.array([2, 0, 3, 1])
        assert np.array_equal(_ranges(starts, counts),
                              ref_ranges(starts, counts))


class TestDigests:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_pattern_digest_and_fingerprint_equal(self, family):
        a_r = family_csr(R, family, 80, 70, 0.06, 1)
        a_p = family_csr(P, family, 80, 70, 0.06, 1)
        assert P.csr_pattern_digest(a_p) == R.csr_pattern_digest(a_r)
        fr = R.fingerprint_pattern("spgemm_block_chunked", (a_r, a_r),
                                   block=16, n_chunks=4)
        fp = P.fingerprint_pattern("spgemm_block_chunked", (a_p, a_p),
                                   block=16, n_chunks=4)
        assert dataclasses.astuple(fp) == dataclasses.astuple(fr)


class TestPlans:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_spgemm_plans_bit_identical(self, family):
        a_r, b_r = (family_csr(R, family, 96, 80, 0.05, 2),
                    family_csr(R, family, 80, 72, 0.05, 3))
        a_p, b_p = (family_csr(P, family, 96, 80, 0.05, 2),
                    family_csr(P, family, 80, 72, 0.05, 3))
        assert_same_fields(P.inspect_spgemm_gather(a_p, b_p, 256),
                           R.inspect_spgemm_gather(a_r, b_r, 256))
        bp = P.inspect_spgemm_block(a_p, b_p, 16)
        br = R.inspect_spgemm_block(a_r, b_r, 16)
        assert_same_fields(bp, br)
        for u, v in zip(bp.out_entry_order(), br.out_entry_order()):
            assert np.array_equal(u, v)
        for key in ("a_id", "b_id", "out_id", "is_first", "is_last"):
            assert_same_fields(bp.schedule[key], br.schedule[key])
        assert P.choose_spgemm_path(a_p, b_p, 16) == \
            R.choose_spgemm_path(a_r, b_r, 16)

    @pytest.mark.parametrize("block", [8, 16, 32])
    def test_bsr_pattern_and_scatter(self, block):
        a_r = family_csr(R, "blockdiag", 100, 90, 0.08, 6)
        a_p = family_csr(P, "blockdiag", 100, 90, 0.08, 6)
        pp = P.bsr_pattern_from_csr(a_p, block)
        pr = R.bsr_pattern_from_csr(a_r, block)
        assert_same_fields(pp, pr)
        assert pp.scatter(a_p.data).tobytes() == pr.scatter(a_r.data).tobytes()

    @pytest.mark.parametrize("pattern", ["banded", "uniform", "blocky"])
    def test_cholesky_plan_bit_identical(self, pattern):
        a_r = R.random_spd_csr(70, 0.08, np.random.default_rng(7), pattern)
        a_p = P.random_spd_csr(70, 0.08, np.random.default_rng(7), pattern)
        assert_same_fields(P.inspect_cholesky(a_p), R.inspect_cholesky(a_r))
        assert np.array_equal(P.cholesky_values(a_p), R.cholesky_values(a_r))

    def test_rir_pack_roundtrip_matches(self):
        a_r = family_csr(R, "powerlaw", 60, 50, 0.1, 8)
        a_p = family_csr(P, "powerlaw", 60, 50, 0.1, 8)
        assert_same_fields(P.pack_csr(a_p, 8), R.pack_csr(a_r, 8))
        assert_same_fields(P.unpack_to_csr(P.pack_csr(a_p, 8)), a_r)
