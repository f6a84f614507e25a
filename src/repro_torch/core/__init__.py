"""REAP core: the paper's contribution — inspector-executor sparse algebra.

Host inspector (CPU pass, numpy): formats, rir, inspector, etree.
Device executors (torch): spgemm, cholesky (+ kernel K1 in
repro_torch.kernels).  Plan caching + inspector/executor overlap live one
layer up in repro_torch.runtime.
"""
from .formats import BSR, COO, CSR, random_csr, random_spd_csr  # noqa: F401
from .rir import (DEFAULT_CAPACITY, ElementBundles, ScheduleBundle,  # noqa: F401
                  pack_csr, unpack_to_csr)
from .inspector import (BsrPattern, PatternFingerprint,  # noqa: F401
                        SpGemmBlockPlan, SpGemmGatherPlan,
                        bsr_pattern_from_csr, choose_spgemm_path,
                        csr_pattern_digest, fingerprint_pattern,
                        inspect_spgemm_block, inspect_spgemm_gather)
from .etree import (CholeskyPlan, cholesky_values, etree, etree_levels,  # noqa: F401
                    inspect_cholesky, symbolic)
from .spgemm import (block_result_to_csr, block_result_to_dense,  # noqa: F401
                     spgemm, spgemm_block_execute, spgemm_gather_execute,
                     spgemm_gather_execute_chunk, spgemm_ref_numpy)
from .cholesky import (cholesky, cholesky_baseline_numpy, cholesky_execute,  # noqa: F401
                       emit_level_bundle, init_values, plan_to_dense_l)
