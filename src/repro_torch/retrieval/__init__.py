"""The online query path: shard layout, device step, engine and serving.

  layout.py   -- pack an index + placement (+ co-occurrence encoding) into
                 per-device, block-aligned arrays; RawStore for the re-rank
  search.py   -- the device step over a leading logical-device axis (LUT
                 build, ADC scan + top-k, merges) and the exact re-rank
  engine.py   -- MemANNSEngine: build + query API, plan / dispatch / collect
  mutation.py -- online inserts, tombstone deletes, compaction
  serving.py  -- ServingEngine: micro-batches, pow2 buckets, warmup, the
                 depth 0 / 1 host/device pipeline, load feedback, mutable
                 serving, metrics and traces, failover, deadlines, admission
  faults.py   -- FaultPlan and the fault types the serving layer handles
"""

from repro_torch.core.delta import DeltaIndex
from repro_torch.retrieval.engine import MemANNSEngine, SearchPlan, round_capacity
from repro_torch.retrieval.faults import (
    DeviceHang,
    FaultError,
    FaultPlan,
    InjectedCrash,
    TransientFault,
)
from repro_torch.retrieval.layout import (
    DeviceShards,
    RawStore,
    build_raw_store,
    build_shards,
    update_raw_store,
    update_shards,
)
from repro_torch.retrieval.mutation import CompactionReport
from repro_torch.retrieval.search import InFlightSearch
from repro_torch.retrieval.serving import (
    DEGRADE_REASONS,
    HEALTH_STATES,
    PHASES,
    RETRY_PHASES,
    ServingEngine,
    ServingResult,
    ServingStats,
)

__all__ = [
    "PHASES",
    "DEGRADE_REASONS",
    "RETRY_PHASES",
    "HEALTH_STATES",
    "FaultPlan",
    "FaultError",
    "TransientFault",
    "DeviceHang",
    "InjectedCrash",
    "ServingResult",
    "MemANNSEngine",
    "SearchPlan",
    "InFlightSearch",
    "round_capacity",
    "DeviceShards",
    "RawStore",
    "build_raw_store",
    "update_raw_store",
    "build_shards",
    "update_shards",
    "DeltaIndex",
    "CompactionReport",
    "ServingEngine",
    "ServingStats",
]
