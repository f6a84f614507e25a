"""REAP runtime layer: op registry, plan caching, persistence, overlap.

``ReapRuntime`` (api.py) is a generic dispatcher over the registered
planned-op protocol (ops.py); plan_cache.py, plan_store.py (with the fleet
layout of shared_store.py) and pipeline.py are its mechanisms.  The
executable store and sharding come with later slices.
"""
from .api import (ReapRuntime, RunStats, RuntimeConfig,  # noqa: F401
                  add_runtime_args, configure_default_runtime,
                  default_runtime, set_default_runtime)
from .ops import (OpSpec, get_op, list_ops,  # noqa: F401
                  register_op, register_plan_type, unregister_op)
from .pipeline import (BlockChunk, BlockChunkSet,  # noqa: F401
                       GatherChunkSet, OverlapStats, bucket_block_schedule,
                       build_block_chunkset, cholesky_execute_overlapped,
                       chunk_row_bounds, run_overlapped,
                       spgemm_block_chunked, spgemm_gather_chunked)
from .plan_cache import (CacheStats, PlanCache, deserialize_plan,  # noqa: F401
                         serialize_plan)
from .plan_store import (PlanStore, StoreStats, store_key,  # noqa: F401
                         fingerprint_from_json, fingerprint_to_json)
from .shared_store import SharedBlobs  # noqa: F401
