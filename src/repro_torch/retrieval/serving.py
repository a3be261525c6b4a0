"""Batched serving on top of MemANNSEngine: micro-batching, shape buckets,
a host/device pipeline with load feedback, online mutation, observability
and fault tolerance (the reference's `repro.retrieval.serving`).

  * incoming queries are grouped into fixed-size micro-batches (ragged
    tails padded with a copy of the first query and sliced off the results,
    so padding never changes any real query's top-k);
  * per-device pair capacities are rounded up to power-of-two buckets
    (`default_buckets`), and `warmup()` runs the path once, so that
    steady-state batches build nothing: in the port a "compile" is an nvcc
    build of the kernel library or a CUDA-graph capture
    (`kernels._build.compile_events`), whatever the shapes, and
    `stats.compiles` counts those that happen while serving;
  * micro-batches flow through a depth-`pipeline_depth` in-flight queue:
    with depth 1 batch i is dispatched on the server's own CUDA stream and
    batch i+1 is planned on the host (its cluster filter and its delta scan
    on the default stream) while the card still runs batch i; each dispatch
    records a CUDA event, and the collect makes the default stream wait for
    it (depth 0 is the serial plan -> dispatch -> collect loop, with the
    same results);
  * each dispatched plan's per-device rows-scanned report is folded into an
    EWMA `load_carry` that biases Algorithm 2 for the next batches (the
    paper's dynamic resource management), at dispatch time, so depths 0
    and 1 see the same schedules and give bit-identical results.

With `mutable=True` (or an engine with a delta) the server also takes
inserts and deletes: each micro-batch's delta scan (B1 + B5, and under
the exact re-rank its B3 re-rank) runs at plan time with the batch's
tombstone snapshot, the main path fetches one fixed cascade bucket, the
tombstone filter and the delta merge run at collect time on the card, and
compactions trigger on delta occupancy, on the tombstone count and after
a batch whose tombstones emptied a query's whole fetch window.

Every batch is mirrored into a `repro_torch.obs.metrics.MetricsRegistry`
(`stats.registry`; the catalog of docs/OBSERVABILITY.md) and, with a
`Tracer`, recorded as one span tree.  A `FaultPlan` drives replica
failover, dispatch retries, the collect watchdog, deadlines and admission
control.  `warmup()` first resolves the kernel geometry (`autotune`,
`core.autotune`) and applies it, so a retile lands before anything is
warmed and tuned serving builds nothing after warmup either.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.delta import DeltaIndex, delta_topk_rows, merge_results
from repro_torch.kernels import _build
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.retrieval.engine import MemANNSEngine, SearchPlan, round_capacity
from repro_torch.retrieval.faults import DeviceHang, FaultError, TransientFault
from repro_torch.retrieval.mutation import (
    compact_engine,
    delete_from,
    delta_prune_bound,
    ensure_delta,
    insert_into,
    rerank_rows,
)
from repro_torch.retrieval.search import InFlightSearch

# per-batch latency samples kept for the deque fallback of the percentiles
LATENCY_WINDOW = 4096

# per-batch lifecycle phases (the `phase` label of `upanns_phase_seconds`,
# registered eagerly): the reference's five, and `merge`, the collect-time
# tombstone filter + delta merge of a mutable batch
PHASES = ("plan", "delta", "dispatch", "dispatch_wait", "collect_wait", "merge")

# why a query can come back degraded (the `reason` label of
# `upanns_degraded_queries_total`): "coverage" = some probed cluster had no
# live replica, "deadline" = the batch was planned after the deadline
DEGRADE_REASONS = ("coverage", "deadline")

# where a transient fault is retried (the `phase` label of `upanns_retries_total`)
RETRY_PHASES = ("dispatch", "collect")

# health states, in degradation order
HEALTH_STATES = ("ok", "degraded", "overloaded")


@dataclasses.dataclass
class ServingStats:
    """Counters accumulated across `ServingEngine` batches (the reference's
    fields; see `repro.retrieval.serving.ServingStats` for each one).

    Throughput / pipeline: `batches`, `queries` (real, unpadded),
    `compiles` (nvcc builds and CUDA-graph captures while serving: 0 after
    `warmup()` is the contract), `host_s` (planning and the plan-time
    delta scans), `device_s` (dispatch + blocked collect), `overlap_s`
    (planning while a batch was in flight), `dispatch_wait_s`,
    `collect_wait_s`, `latencies_s` (plan -> collect per micro-batch, last
    `LATENCY_WINDOW`: the fallback of the percentiles when metrics are
    off), `bucket_hits` ({pairs_per_dev bucket: dispatches}).  Scan
    telemetry: `rows_scanned`, `tiles_dispatched`, `tiles_skipped`,
    `rows_pruned`, `warm_bound_queries`, `prune_fracs`.  Re-rank:
    `reranked_queries`, `rerank_candidates`.  Mutation: `inserts`,
    `deletes`, `compactions`, `starved_batches`, `delta_occupancy`,
    `tombstones`, `compaction_s`.  Faults: `failovers`,
    `degraded_queries`, `rejected_queries`, `retries`.

    `registry` is the `MetricsRegistry` every field is mirrored into
    (`NULL_REGISTRY` turns the mirrors off); its catalog is
    docs/OBSERVABILITY.md's, checked by tools/check_metrics_torch.py.
    """

    batches: int = 0
    queries: int = 0
    compiles: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    overlap_s: float = 0.0
    dispatch_wait_s: float = 0.0
    collect_wait_s: float = 0.0
    rows_scanned: int = 0
    tiles_dispatched: int = 0
    tiles_skipped: int = 0
    rows_pruned: int = 0
    warm_bound_queries: int = 0
    reranked_queries: int = 0
    rerank_candidates: int = 0
    inserts: int = 0
    deletes: int = 0
    compactions: int = 0
    starved_batches: int = 0
    failovers: int = 0
    degraded_queries: int = 0
    rejected_queries: int = 0
    retries: int = 0
    delta_occupancy: float = 0.0
    tombstones: int = 0
    compaction_s: list[float] = dataclasses.field(default_factory=list)
    latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )
    prune_fracs: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )
    bucket_hits: dict[int, int] = dataclasses.field(default_factory=dict)
    registry: object = None

    def __post_init__(self):
        if self.registry is None:
            self.registry = MetricsRegistry()
        r = self.registry
        # the whole catalog registers up front, so exposition is the same
        # whatever paths the traffic took
        self.m_batches = r.counter(
            "upanns_serving_batches_total", "Micro-batches collected, by scan variant", ("scan",))
        self.m_queries = r.counter("upanns_serving_queries_total", "Real (unpadded) queries served")
        self.m_compiles = r.counter(
            "upanns_serving_compiles_total",
            "Cold executable compiles (0 after warmup is the contract)")
        self.m_host = r.counter(
            "upanns_host_seconds_total",
            "Host-side planning seconds (cluster filter + Algorithm 2 + "
            "densify + plan-time delta scans)")
        self.m_device = r.counter(
            "upanns_device_seconds_total", "Dispatch + blocked-collect seconds (incl. transfers)")
        self.m_overlap = r.counter(
            "upanns_overlap_seconds_total", "Host planning seconds hidden behind in-flight device work")
        self.m_latency = r.histogram(
            "upanns_batch_latency_seconds", "Per-micro-batch plan->collect latency")
        self.m_phase = r.histogram(
            "upanns_phase_seconds", "Per-micro-batch seconds by lifecycle phase", ("phase",))
        for p in PHASES:
            self.m_phase.labels(phase=p)
        self.m_rows_scanned = r.counter(
            "upanns_rows_scanned_total", "Code rows visited, per device", ("device",))
        self.m_tiles_dispatched = r.counter(
            "upanns_tiles_dispatched_total", "Non-empty code tiles handed to the kernels")
        self.m_tiles_skipped = r.counter(
            "upanns_tiles_skipped_total",
            "Tile bodies the pruning-bound check skipped whole, per device", ("device",))
        self.m_rows_pruned = r.counter(
            "upanns_rows_pruned_total", "Valid rows inside skipped tiles, per device", ("device",))
        self.m_prune_frac = r.histogram(
            "upanns_prune_fraction", "Per-batch skipped/dispatched tile fraction")
        self.m_warm_bound = r.counter(
            "upanns_warm_bound_queries_total",
            "Real queries dispatched with a finite warm-start bound")
        self.m_bucket_hits = r.counter(
            "upanns_bucket_hits_total", "Dispatches per pairs-per-device capacity bucket",
            ("bucket",))
        self.m_rerank_queries = r.counter(
            "upanns_rerank_queries_total", "Queries re-scored by the exact cascade", ("rerank",))
        self.m_rerank_candidates = r.counter(
            "upanns_rerank_candidates_total",
            "Overfetched candidates re-scored at full precision", ("rerank",))
        self.m_inserts = r.counter(
            "upanns_mutation_inserts_total", "Vectors appended to the delta buffer")
        self.m_deletes = r.counter("upanns_mutation_deletes_total", "Ids tombstoned")
        self.m_compactions = r.counter(
            "upanns_compactions_total", "Delta->main merges triggered (auto or explicit)")
        self.m_starved = r.counter(
            "upanns_starved_batches_total",
            "Batches where tombstones ate a query's whole overfetch window")
        self.m_delta_occupancy = r.gauge("upanns_delta_occupancy", "Delta buffer fill fraction")
        self.m_tombstones = r.gauge("upanns_tombstones", "Live tombstone count")
        self.m_compaction_s = r.histogram("upanns_compaction_seconds", "Per-compaction latency")
        self.m_failovers = r.counter(
            "upanns_failovers_total",
            "Devices failed over (death, exhausted retries, hung collect), per device",
            ("device",))
        self.m_degraded = r.counter(
            "upanns_degraded_queries_total",
            "Queries answered best-effort, by degradation reason", ("reason",))
        for reason in DEGRADE_REASONS:
            self.m_degraded.labels(reason=reason)
        self.m_rejected = r.counter(
            "upanns_rejected_queries_total",
            "Queries shed by admission control (ingress queue full)")
        self.m_retries = r.counter(
            "upanns_retries_total", "Transient-fault retries before escalation, by phase",
            ("phase",))
        for p in RETRY_PHASES:
            self.m_retries.labels(phase=p)
        self.m_device_health = r.gauge(
            "upanns_device_health", "Per-device liveness (1 live, 0 failed over)", ("device",))
        self.m_queue_depth = r.gauge(
            "upanns_queue_depth", "Queries pending in the ingress queue (admission control)")

    # each helper updates the field and its registry mirror together

    def note_compile(self, n: int = 1) -> None:
        self.compiles += n
        self.m_compiles.inc(n)

    def note_bucket_hit(self, bucket: int) -> None:
        self.bucket_hits[bucket] = self.bucket_hits.get(bucket, 0) + 1
        self.m_bucket_hits.inc(bucket=bucket)

    def note_host(self, seconds: float, overlapped: bool) -> None:
        self.host_s += seconds
        self.m_host.inc(seconds)
        if overlapped:
            self.overlap_s += seconds
            self.m_overlap.inc(seconds)

    def observe_phase(self, phase: str, seconds: float) -> None:
        self.m_phase.observe(seconds, phase=phase)

    def note_inserts(self, n: int) -> None:
        self.inserts += n
        self.m_inserts.inc(n)

    def note_deletes(self, n: int) -> None:
        self.deletes += n
        self.m_deletes.inc(n)

    def note_compaction(self, latency_s: float) -> None:
        self.compactions += 1
        self.compaction_s.append(latency_s)
        self.m_compactions.inc()
        self.m_compaction_s.observe(latency_s)

    def set_mutation_gauges(self, occupancy: float, tombstones: int) -> None:
        self.delta_occupancy = occupancy
        self.tombstones = tombstones
        self.m_delta_occupancy.set(occupancy)
        self.m_tombstones.set(tombstones)

    def note_failover(self, device: int) -> None:
        self.failovers += 1
        self.m_failovers.inc(device=int(device))

    def note_degraded(self, n: int, reason: str) -> None:
        self.degraded_queries += n
        self.m_degraded.inc(n, reason=reason)

    def note_rejected(self, n: int) -> None:
        self.rejected_queries += n
        self.m_rejected.inc(n)

    def note_retry(self, phase: str) -> None:
        self.retries += 1
        self.m_retries.inc(phase=phase)

    def set_device_health(self, device: int, live: bool) -> None:
        self.m_device_health.set(1.0 if live else 0.0, device=int(device))

    def set_queue_depth(self, depth: int) -> None:
        self.m_queue_depth.set(depth)

    def snapshot(self) -> dict:
        """JSON-able dump of every registered metric."""
        return self.registry.snapshot()

    # derived views

    def host_fraction(self) -> float:
        total = self.host_s + self.device_s
        return self.host_s / total if total > 0 else 0.0

    def prune_fraction(self) -> float:
        """Lifetime fraction of dispatched tile bodies the bounds skipped."""
        return self.tiles_skipped / self.tiles_dispatched if self.tiles_dispatched > 0 else 0.0

    def prune_percentile(self, q: float) -> float:
        """Per-batch prune-fraction percentile (the histogram; the deque
        window when metrics are off)."""
        h = self.m_prune_frac.labels()
        if h.count:
            return h.quantile(q)
        return float(np.percentile(np.asarray(self.prune_fracs), q)) if self.prune_fracs else 0.0

    def overlap_fraction(self) -> float:
        """Fraction of host planning time hidden behind in-flight batches."""
        return self.overlap_s / self.host_s if self.host_s > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        """Per-micro-batch latency percentile in seconds (plan -> collect),
        from the `upanns_batch_latency_seconds` histogram (relative error
        <= sqrt(GROWTH) - 1); the deque window when metrics are off."""
        h = self.m_latency.labels()
        if h.count:
            return h.quantile(q)
        return float(np.percentile(np.asarray(self.latencies_s), q)) if self.latencies_s else 0.0

    def phase_percentile(self, phase: str, q: float) -> float:
        """Per-batch percentile of one lifecycle phase (see `PHASES`)."""
        return self.m_phase.labels(phase=phase).quantile(q)

    def phase_seconds(self, phase: str) -> float:
        """Total seconds spent in one lifecycle phase (see `PHASES`)."""
        return float(self.m_phase.labels(phase=phase).sum)

    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    def p99_s(self) -> float:
        return self.latency_percentile(99.0)

    def p999_s(self) -> float:
        return self.latency_percentile(99.9)

    def compaction_mean_s(self) -> float:
        return float(np.mean(self.compaction_s)) if self.compaction_s else 0.0


@dataclasses.dataclass
class ServingResult:
    """One `ServingEngine.search_result` answer with degradation accounting.

    dists (Q, k) f32, ids (Q, k) int32; `degraded` (Q,) bool, for any
    reason; `deadline_degraded` (Q,) bool, planned after the deadline at
    `degrade_nprobe`; `coverage_lost` (L, 2) int32 [query, cluster] pairs
    whose every replica was on a dead device.  A query that is not
    degraded equals the fault-free run bit for bit.
    """

    dists: np.ndarray
    ids: np.ndarray
    degraded: np.ndarray
    deadline_degraded: np.ndarray
    coverage_lost: np.ndarray

    def coverage_degraded(self) -> np.ndarray:
        """(Q,) bool: queries with at least one unreachable cluster."""
        mask = np.zeros(self.dists.shape[0], bool)
        if self.coverage_lost.size:
            mask[self.coverage_lost[:, 0]] = True
        return mask


@dataclasses.dataclass
class _Flight:
    """One in-flight micro-batch and what its collect or refire needs."""

    handle: InFlightSearch | None
    q_n: int                 # real (unpadded) queries in this chunk
    offset: int              # chunk start within the search() query array
    t_start: float
    mut: tuple | None        # plan-time (delta dists, delta ids, tombstones)
    t_dispatched: float | None
    bspan: object
    seq: int                 # micro-batch sequence number (fault plans key on it)
    padded: np.ndarray
    nprobe_eff: int
    k_fetch: int
    skip_rerank: bool        # deadline-degraded immutable cascade
    deadline_late: bool


class ServingEngine:
    """Steady-state serving around one `MemANNSEngine`.

    Args (the reference's; see `repro.retrieval.serving.ServingEngine`):
      engine: a built MemANNSEngine.
      nprobe, k: clusters probed and neighbours returned per query.
      micro_batch: queries per device step (requests are padded / split).
      capacity_floor: smallest pairs-per-device bucket.
      pipeline_depth: in-flight micro-batches; 1 (default) plans batch i+1
        while the card runs batch i, 0 is the serial loop.  Bit-identical
        results at every depth.
      load_feedback, load_alpha: the EWMA of per-device rows scanned fed
        back into Algorithm 2 as `load_carry` (alpha 1.0: the last batch).
      mutable: serve inserts / deletes (also when the engine has a delta);
        `compact_occupancy` (auto-compact at this delta fill fraction),
        `tombstone_limit` (auto-compact at this many tombstones; default
        max(64, delta capacity // 4)), `overfetch` (extra main-path
        candidates for the tombstone filter, default k; under
        rerank="exact" the fetch is the fixed bucket round_capacity(k' +
        overfetch)), `replace_threshold` (compaction's re-placement
        threshold), `delta_capacity` (the buffer's initial rows).
      autotune: kernel-geometry autotuning, resolved once at `warmup()`
        (`core.autotune.autotune_engine`): "off" serves the engine's
        geometry; "cache" (default) applies the cached geometry for this
        card and config, else the in-repo default (keep the geometry);
        "sweep" also times the candidates on a cache miss (`block_n` on
        searches of `micro_batch` queries at `nprobe`) and persists the
        pick.  A changed `block_n` retiles the engine's shards (results
        bit-identical) and drops their device copies.
      autotune_cache_dir: the autotune cache's directory (default
        ~/.cache/repro_torch).
      metrics: mirror the stats into a `MetricsRegistry` (False: the null
        registry; the percentiles fall back to the deque windows).
      tracer: a `repro_torch.obs.trace.Tracer` recording one span tree per
        micro-batch (installed on the engine too, for its child spans).
      deadline_ms, degrade_nprobe: micro-batches planned after `deadline_ms`
        of a `search` are served at `degrade_nprobe` (default nprobe // 2)
        and, on an immutable cascade, without the re-rank.
      retry_limit, retry_backoff_s, retry_backoff_max_s: transient dispatch
        faults retried with capped exponential backoff, then failed over.
      queue_limit: admission control of `submit` (None: unbounded).
      collect_timeout_s: the collect watchdog (None: blocking collect).
      faults: a `retrieval.faults.FaultPlan` of injected faults.

    The re-rank cascade is the engine's (`rerank="exact"`, `k_overfetch`):
    serving dispatches the scan at one fixed fetch bucket (`_k_fetch`)
    and the re-rank to k (to the whole bucket when mutable, so the
    tombstone filter has rows to absorb).
    """

    def __init__(
        self,
        engine: MemANNSEngine,
        *,
        nprobe: int,
        k: int,
        micro_batch: int = 32,
        capacity_floor: int = 8,
        pipeline_depth: int = 1,
        load_feedback: bool = True,
        load_alpha: float = 0.5,
        mutable: bool = False,
        compact_occupancy: float = 0.75,
        tombstone_limit: int | None = None,
        overfetch: int | None = None,
        replace_threshold: float = 0.25,
        delta_capacity: int = 4096,
        autotune: str = "cache",
        autotune_cache_dir: str | None = None,
        metrics: bool = True,
        tracer=None,
        deadline_ms: float | None = None,
        degrade_nprobe: int | None = None,
        retry_limit: int = 2,
        retry_backoff_s: float = 0.05,
        retry_backoff_max_s: float = 1.0,
        queue_limit: int | None = None,
        collect_timeout_s: float | None = None,
        faults=None,
    ):
        if autotune not in ("off", "cache", "sweep"):
            raise ValueError(f"autotune must be 'off', 'cache' or 'sweep', got {autotune!r}")
        self.engine = engine
        self.nprobe = int(nprobe)
        self.k = int(k)
        self.micro_batch = int(micro_batch)
        self.capacity_floor = int(capacity_floor)
        self.pipeline_depth = int(pipeline_depth)
        self.load_feedback = bool(load_feedback)
        self.load_alpha = float(load_alpha)
        self.mutable = bool(mutable) or engine.delta is not None
        self.compact_occupancy = float(compact_occupancy)
        self.overfetch = int(overfetch) if overfetch is not None else self.k
        self.replace_threshold = float(replace_threshold)
        self.autotune = autotune
        self.autotune_cache_dir = autotune_cache_dir
        self.autotune_report: dict | None = None
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            engine.tracer = tracer
        self.stats = ServingStats(registry=MetricsRegistry() if metrics else NULL_REGISTRY)
        self.deadline_ms = float(deadline_ms) if deadline_ms is not None else None
        self.degrade_nprobe = (
            int(degrade_nprobe) if degrade_nprobe is not None else max(1, self.nprobe // 2)
        )
        if not 1 <= self.degrade_nprobe <= self.nprobe:
            raise ValueError(f"degrade_nprobe {self.degrade_nprobe} not in [1, {self.nprobe}]")
        self.retry_limit = int(retry_limit)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self.queue_limit = int(queue_limit) if queue_limit is not None else None
        self.collect_timeout_s = float(collect_timeout_s) if collect_timeout_s is not None else None
        self.faults = faults
        self._pending: list[np.ndarray] = []
        self._starved = False
        self._load_ewma = np.zeros(engine.shards.ndev, np.float64)
        self._live = np.ones(engine.shards.ndev, bool)
        self._batch_seq = 0
        self._deadline_hit = False
        for dev in range(engine.shards.ndev):
            self.stats.set_device_health(dev, True)
        if self.mutable:
            ensure_delta(engine, delta_capacity)
        self.tombstone_limit = (
            int(tombstone_limit) if tombstone_limit is not None
            else max(64, (engine.delta.capacity if engine.delta else delta_capacity) // 4)
        )
        # the server's own stream: its dispatches queue behind each other,
        # while the next batch's cluster filter and delta scan run on the
        # default stream
        dv = engine.device
        self._stream = torch.cuda.Stream(dv) if dv.type == "cuda" else None

    # ------------------------------------------------------------------ #

    def _k_fetch(self) -> int:
        """The main path's fetch for this config: under the exact re-rank
        one fixed bucket for the whole stream (k', or round_capacity(k' +
        overfetch) when mutable); else k, or k + overfetch while
        tombstones exist."""
        if self.engine.rerank == "exact":
            kp = self.engine.k_prime(self.k)
            return round_capacity(kp + self.overfetch, floor=kp) if self.mutable else kp
        d = self.engine.delta
        if d is not None and d.tombstone_count > 0:
            return self.k + self.overfetch
        return self.k

    def _delta_k(self) -> int:
        """Rows the delta scan of a mutable server returns per query."""
        if self.engine.rerank == "exact":
            return min(self._k_fetch(), self.engine.delta.capacity)
        return self.k

    def load_carry(self) -> np.ndarray:
        """Current (ndev,) EWMA of per-device rows scanned (a copy)."""
        return self._load_ewma.copy()

    def default_buckets(self, nprobe: int | None = None) -> list[int]:
        """Power-of-two pair capacities from the balanced share
        (micro_batch * nprobe / ndev) to the worst case (every pair on one
        device, which also covers failover re-routing)."""
        total = self.micro_batch * (self.nprobe if nprobe is None else nprobe)
        ndev = self.engine.shards.ndev
        lo = round_capacity(math.ceil(total / ndev), floor=self.capacity_floor)
        hi = round_capacity(total, floor=self.capacity_floor)
        return [lo << i for i in range(int(math.log2(hi // lo)) + 1)]

    def _dummy_plan(self, pairs_per_dev: int) -> SearchPlan:
        """A shape-exact plan with no valid pair: runs the path, scans
        nothing (on the tiles scan, one tile a pair, each pointing past the
        last pair)."""
        eng = self.engine
        ndev = eng.shards.ndev
        dim = eng.index.centroids.shape[1]
        tiles = pairs_per_dev if eng.scan == "tiles" else 0
        tile_pair = tile_block = tile_row0 = None
        if tiles:
            tile_pair = np.full((ndev, tiles), pairs_per_dev, np.int32)
            tile_block = np.zeros((ndev, tiles), np.int32)
            tile_row0 = np.zeros((ndev, tiles), np.int32)
        return SearchPlan(
            qmc_pairs=torch.zeros((ndev, pairs_per_dev, dim), dtype=torch.float32,
                                  device=eng.device),
            pair_q=np.zeros((ndev, pairs_per_dev), np.int32),
            pair_slot=np.zeros((ndev, pairs_per_dev), np.int32),
            pair_valid=np.zeros((ndev, pairs_per_dev), bool), schedule=None,
            n_queries=self.micro_batch, pairs_per_dev=pairs_per_dev, tile_pair=tile_pair,
            tile_block=tile_block, tile_row0=tile_row0, tiles_per_dev=tiles,
        )

    def apply_autotune(self) -> dict:
        """Resolve and apply the tuned kernel geometry, once (see `autotune`).

        Called by `warmup()` before anything is warmed.  The first call
        resolves through `core.autotune.autotune_engine` and applies the
        pick with `MemANNSEngine.apply_geometry` (a changed `block_n`
        retiles the shards and drops their device copies, `retiled` in the
        report); later calls return the stored report.
        """
        if self.autotune_report is None:
            from repro_torch.core.autotune import autotune_engine

            geo, report = autotune_engine(self.engine, self.k, mode=self.autotune,
                                          cache_dir=self.autotune_cache_dir,
                                          nprobe=self.nprobe, batch=self.micro_batch)
            if geo is not None:
                report["retiled"] = self.engine.apply_geometry(geo)
            report["applied"] = self.tuned_geometry()
            self.autotune_report = report
        return self.autotune_report

    def tuned_geometry(self) -> dict:
        """The engine's kernel geometry now (`KernelGeometry.as_dict`)."""
        return self.engine.geometry().as_dict()

    def warmup(self, buckets: list[int] | None = None) -> list[int]:
        """Make every steady-state batch of this config build nothing.

        The port builds all its kernels into one library on the first
        launch, whatever the shapes, so one dummy step of the smallest
        bucket (no valid pair: the whole path runs and scans nothing) and
        its re-rank build it, and a planned batch of zeros runs the host
        path (also at `degrade_nprobe` under a deadline).  A mutable
        server also runs the delta path once, on a one-row scratch buffer
        (B1 + B5, and B3 under the exact re-rank).  Returns the pair
        buckets (`default_buckets`) the schedules land on.
        """
        self.apply_autotune()
        buckets = sorted(buckets or self.default_buckets())
        if self.deadline_ms is not None:
            buckets = sorted(set(buckets) | set(self.default_buckets(self.degrade_nprobe)))
        dim = self.engine.index.centroids.shape[1]
        zeros = np.zeros((self.micro_batch, dim), np.float32)
        k_fetch = self._k_fetch()
        k_out = self._k_out(k_fetch) if self.engine.rerank == "exact" else None
        self._collect(self._dispatch(self._dummy_plan(buckets[0]), k_fetch, zeros, k_out))
        self.engine.plan_batch(zeros, self.nprobe)
        if self.deadline_ms is not None:
            self.engine.plan_batch(zeros, self.degrade_nprobe)
        if self.mutable:
            scratch = DeltaIndex.create(self.engine.index.m, self.engine.delta.capacity)
            scratch.insert(self.engine.index.centroids, self.engine.index.codebook,
                           np.zeros(1, np.int32), zeros[:1], rotation=self.engine.index.rotation,
                           device=self.engine.device)
            self._delta_topk(scratch, zeros, None)[1].cpu()
        return buckets

    # ------------------------------------------------------------------ #

    def _pad_chunk(self, queries: np.ndarray) -> np.ndarray:
        """Pad one chunk to the micro-batch size (rows sliced off later)."""
        q_n = queries.shape[0]
        if q_n < self.micro_batch:
            pad = np.broadcast_to(queries[:1], (self.micro_batch - q_n, queries.shape[1]))
            queries = np.concatenate([queries, pad], axis=0)
        return queries

    def _live_arg(self) -> np.ndarray | None:
        """Live mask for the scheduler: None while every device is live."""
        return None if self._live.all() else self._live

    def _plan_micro_batch(self, queries: np.ndarray, nprobe: int | None = None) -> SearchPlan:
        """Plan one padded micro-batch (host side), with the load carry and
        the live mask (only once a device has failed over)."""
        return self.engine.plan_batch(
            queries, self.nprobe if nprobe is None else nprobe,
            capacity_floor=self.capacity_floor,
            load_carry=self._load_ewma if self.load_feedback else None,
            live=self._live_arg(),
        )

    def _delta_topk(self, delta: DeltaIndex, padded: np.ndarray,
                    bound: np.ndarray | None) -> tuple[torch.Tensor, torch.Tensor]:
        """The delta's top-k of one padded micro-batch on the engine's
        device: B1 + B5 (`delta_topk_rows`), then under the exact re-rank B3
        over the buffered vectors (`rerank_rows`, keyed by buffer row).
        Returns (dists, ids) tensors."""
        eng = self.engine
        q = np.asarray(eng.index.rotate(padded), np.float32)
        dd, rows = delta_topk_rows(delta, eng.index.centroids, eng.index.codebook, q,
                                   self.nprobe, self._delta_k(), bound, eng.device)
        if eng.rerank == "exact":
            dd, rows = rerank_rows(delta, torch.as_tensor(padded, device=eng.device), rows)
        return dd, delta.ids_of(rows)

    def _delta_micro_batch(self, padded: np.ndarray, plan: SearchPlan, k_fetch: int) -> tuple:
        """Delta top-k + tombstone snapshot of one padded micro-batch, at
        plan time (so later mutations never change a planned batch: depth
        invariance).  Returns (delta dists, delta ids, tombstones), the
        first two tensors on the engine's device (None with no live row).
        The delta scan runs unbounded under the exact re-rank (the prune
        bound is an ADC bound), else under `delta_prune_bound`."""
        delta = self.engine.delta
        if delta is None or not delta.active:
            return None, None, np.zeros(0, np.int64)
        tomb = delta.tombstone_array()
        if delta.live_count == 0:
            return None, None, tomb
        bound = None
        if self.engine.rerank != "exact":
            bound = delta_prune_bound(self.engine, plan, self.k, k_fetch, tomb.size)
        before = _build.compile_count()
        dd, di = self._delta_topk(delta, padded, bound)
        built = _build.compile_count() - before
        if built:
            self.stats.note_compile(built)
        return dd, di, tomb

    def _k_out(self, k_fetch: int) -> int:
        """The re-rank's output: the whole fetch when mutable (the tombstone
        filter has rows to absorb), else k."""
        return k_fetch if self.mutable else self.k

    def _dispatch(self, plan: SearchPlan, k_fetch: int, queries: np.ndarray,
                  k_out: int | None) -> InFlightSearch:
        """Enqueue the scan (and the re-rank to `k_out`, None: none) on the
        server's stream, after the default stream's planning work; the
        handle's event marks its end."""
        eng = self.engine

        def run():
            handle = eng.dispatch_plan(plan, k_fetch)
            if k_out is not None:
                handle = eng.dispatch_rerank(handle, queries, k_out)
            return handle

        if self._stream is None:
            return run()
        self._stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(self._stream):
            return run()

    def _wait(self, handle: InFlightSearch) -> None:
        """Make the default stream wait for a dispatched step; its outputs,
        made on the server's stream, are then read on the default one."""
        if handle.event is not None:
            cur = torch.cuda.current_stream(self.engine.device)
            cur.wait_event(handle.event)
            handle.out_d.record_stream(cur)
            handle.out_i.record_stream(cur)

    def _collect(self, handle: InFlightSearch) -> tuple[np.ndarray, np.ndarray]:
        """Host results of a dispatched step (after `_wait`)."""
        self._wait(handle)
        return self.engine.collect(handle)

    def _dispatch_micro_batch(self, plan: SearchPlan, k_fetch: int | None = None,
                              queries: np.ndarray | None = None,
                              skip_rerank: bool = False) -> InFlightSearch:
        """Dispatch a planned micro-batch; count builds, fold the plan's
        rows into the load EWMA now (not at collect, so every depth plans
        alike), count the bucket.  With rerank="exact" pass the padded
        `queries`; `skip_rerank` (deadline degradation) serves the ADC
        top-k at `k_fetch` = k instead."""
        k_fetch = self._k_fetch() if k_fetch is None else k_fetch
        rerank = self.engine.rerank == "exact" and not skip_rerank
        before = _build.compile_count()
        handle = self._dispatch(plan, k_fetch, queries, self._k_out(k_fetch) if rerank else None)
        built = _build.compile_count() - before
        if built:
            self.stats.note_compile(built)
        if self.load_feedback:
            self._load_ewma = (self.load_alpha * handle.dev_rows.astype(np.float64)
                               + (1.0 - self.load_alpha) * self._load_ewma)
        self.stats.note_bucket_hit(plan.pairs_per_dev)
        return handle

    # --------------------- fault tolerance ----------------------------- #

    def live_devices(self) -> np.ndarray:
        """(ndev,) bool live-device mask (a copy)."""
        return self._live.copy()

    def _mark_dead(self, device: int) -> None:
        """Fail a device over: later plans route its replicas elsewhere (its
        pair and tile slots stay, all invalid, so no shape changes);
        clusters with no other replica degrade with coverage accounting."""
        device = int(device)
        if 0 <= device < self._live.shape[0] and self._live[device]:
            self._live[device] = False
            self.stats.note_failover(device)
            self.stats.set_device_health(device, False)
            if self.faults is not None:
                self.faults.note("failover", device=device)

    def _apply_fault_deaths(self, seq: int) -> None:
        """Fold the fault plan's scheduled device deaths into the mask."""
        if self.faults is None:
            return
        for dev in self.faults.dead_devices(seq):
            self._mark_dead(dev)

    def _dispatch_with_retry(self, fl: _Flight, plan: SearchPlan) -> SearchPlan:
        """Dispatch with capped-backoff retries, escalating to failover.

        Transient faults retry up to `retry_limit` times, the backoff
        doubling up to `retry_backoff_max_s`; then an attributable fault
        fails its device over, the batch is replanned on the survivors and
        the budget resets (at most once per device); an unattributable one
        propagates.  Sets `fl.handle`; returns the plan dispatched."""
        attempts = 0
        backoff = self.retry_backoff_s
        escalations = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.on_dispatch(fl.seq, live=self._live)
                fl.handle = self._dispatch_micro_batch(plan, fl.k_fetch, fl.padded,
                                                       skip_rerank=fl.skip_rerank)
                return plan
            except TransientFault as e:
                if attempts < self.retry_limit:
                    attempts += 1
                    self.stats.note_retry("dispatch")
                    if backoff > 0:
                        time.sleep(min(backoff, self.retry_backoff_max_s))
                    backoff = min(backoff * 2.0, self.retry_backoff_max_s)
                    continue
                if e.device is None or escalations >= self._live.shape[0]:
                    raise
                self._mark_dead(e.device)
                plan = self._plan_micro_batch(fl.padded, nprobe=fl.nprobe_eff)
                attempts = 0
                backoff = self.retry_backoff_s
                escalations += 1

    def _await_handle(self, fl: _Flight) -> None:
        """The collect watchdog.  A no-op (the collect blocks) unless a
        collect timeout or a fault plan is set; otherwise polls the
        handle's CUDA event (`InFlightSearch.is_ready`).  An injected hang
        raises `DeviceHang` (failover + refire upstream); a result still
        not ready at `collect_timeout_s` raises `FaultError`.  An injected
        slow device reads as not ready for its delay."""
        f = self.faults
        delay = 0.0
        if f is not None:
            hang_dev = f.hang_device(fl.seq)
            if hang_dev is not None:
                raise DeviceHang(f"collect of batch {fl.seq} hung on device {hang_dev}",
                                 device=hang_dev)
            delay = f.collect_delay(fl.seq)
        timeout = self.collect_timeout_s
        if timeout is None and delay <= 0.0:
            return
        t0 = fl.t_dispatched if fl.t_dispatched is not None else time.perf_counter()
        while True:
            now = time.perf_counter()
            if now - t0 >= delay and fl.handle.is_ready():
                return
            if timeout is not None and now - t0 > timeout:
                raise FaultError(
                    f"collect of batch {fl.seq} timed out after {timeout:.3f}s "
                    "(unattributable; no failover target)"
                )
            time.sleep(0.0005)

    def _refire(self, fl: _Flight) -> None:
        """Replan + re-dispatch a flight whose collect hung, under the
        post-failover live mask at the same nprobe, reusing its plan-time
        mutation snapshot (`fl.mut`)."""
        plan = self._plan_micro_batch(fl.padded, nprobe=fl.nprobe_eff)
        self._dispatch_with_retry(fl, plan)
        fl.t_dispatched = time.perf_counter()

    def _collect_flight(self, fl: _Flight) -> tuple[np.ndarray, np.ndarray]:
        """Await + collect one flight, refiring on attributed hangs (each
        fails one more device over, so at most ndev refires)."""
        while True:
            try:
                self._await_handle(fl)
                break
            except DeviceHang as e:
                self.stats.note_retry("collect")
                self._mark_dead(e.device)
                self._refire(fl)
        return self._collect_micro_batch(
            fl.handle, fl.q_n, fl.t_start, fl.mut, fl.t_dispatched, fl.bspan,
            deadline_late=fl.deadline_late, skip_rerank=fl.skip_rerank,
        )

    def health(self) -> dict:
        """The `/healthz` payload: "overloaded" while the ingress queue is at
        `queue_limit`, "degraded" once a device failed over or a deadline
        forced degraded service, else "ok"."""
        ndev = int(self._live.shape[0])
        live = int(self._live.sum())
        depth = self.pending()
        overloaded = self.queue_limit is not None and depth >= self.queue_limit
        degraded = live < ndev or self._deadline_hit
        return {
            "state": "overloaded" if overloaded else "degraded" if degraded else "ok",
            "queue_depth": depth,
            "queue_limit": self.queue_limit,
            "live_devices": live,
            "n_devices": ndev,
            "dead_devices": [int(d) for d in np.flatnonzero(~self._live)],
            "degraded_queries": self.stats.degraded_queries,
            "rejected_queries": self.stats.rejected_queries,
            "failovers": self.stats.failovers,
            "retries": self.stats.retries,
        }

    # ------------------------------------------------------------------ #

    def _merge(self, handle: InFlightSearch, mut: tuple, q_n: int
               ) -> tuple[np.ndarray, np.ndarray, bool]:
        """The tombstone filter + delta merge of a mutable batch, on the
        engine's device (after `_wait`).  Returns host (dists, ids) and
        whether the batch starved: a real query's result holds an empty
        lane where the tombstone filter emptied one of its main-path
        candidates.  Under the exact re-rank every empty lane counts, as
        there the reference's own empty lanes carry -1 too; on the ADC path
        a query that is merely short (its probed clusters hold fewer than k
        rows) does not starve (ROADMAP.md C3)."""
        dd, di, tomb = mut
        md, mi = handle.out_d, handle.out_i
        tomb_t = torch.as_tensor(tomb, device=md.device)
        emptied = None
        if tomb.size and self.engine.rerank != "exact":
            emptied = torch.isin(mi[:q_n].long(), tomb_t).any(dim=1)
        d, i = merge_results(md, mi, dd, di, tomb_t, self.k)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        starved = False
        if tomb.size:
            short = (i[:q_n] < 0).any(axis=1)
            if emptied is not None:
                short &= emptied.cpu().numpy()
            starved = bool(short.any())
        return d, i, starved

    def _collect_micro_batch(self, handle: InFlightSearch, q_n: int, t_start: float,
                             mut: tuple | None = None, t_dispatched: float | None = None,
                             bspan=NULL_SPAN, *, deadline_late: bool = False,
                             skip_rerank: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Block on one in-flight micro-batch; merge its plan-time mutation
        snapshot `mut`, slice the padding, record stats.  `t_dispatched`
        splits the pipelined latency: collect start minus dispatch end is
        `dispatch_wait`, the blocked collect itself `collect_wait`.
        Coverage degradation is read off the plan (`lost_q`)."""
        st = self.stats
        tr = self.tracer
        t0 = time.perf_counter()
        if t_dispatched is not None:
            wait = max(t0 - t_dispatched, 0.0)
            st.dispatch_wait_s += wait
            st.observe_phase("dispatch_wait", wait)
            bspan.add("dispatch_wait", t_dispatched, t0)
        with tr.span("collect", parent=bspan):
            if mut is None:
                d, i = self._collect(handle)
            else:
                self._wait(handle)
                if handle.event is not None:
                    handle.event.synchronize()
        t1 = time.perf_counter()
        st.device_s += t1 - t0
        st.m_device.inc(t1 - t0)
        st.collect_wait_s += t1 - t0
        st.observe_phase("collect_wait", t1 - t0)
        st.latencies_s.append(t1 - t_start)
        st.m_latency.observe(t1 - t_start)
        st.batches += 1
        st.m_batches.inc(scan=handle.plan.scan)
        st.queries += q_n
        st.m_queries.inc(q_n)
        dev_rows = np.asarray(handle.dev_rows)
        st.rows_scanned += int(dev_rows.sum())
        for dev in np.flatnonzero(dev_rows):
            st.m_rows_scanned.inc(float(dev_rows[dev]), device=int(dev))
        tiles = self.engine.plan_tile_count(handle.plan)
        skipped = rows = 0
        if handle.prune_stats is not None:
            ps = handle.prune_stats.cpu().numpy()
            for dev in range(ps.shape[0]):
                if ps[dev, 0]:
                    st.m_tiles_skipped.inc(float(ps[dev, 0]), device=dev)
                if ps[dev, 1]:
                    st.m_rows_pruned.inc(float(ps[dev, 1]), device=dev)
            skipped, rows = (int(x) for x in ps.sum(axis=0))
        st.tiles_dispatched += tiles
        st.m_tiles_dispatched.inc(tiles)
        st.tiles_skipped += skipped
        st.rows_pruned += rows
        frac = skipped / tiles if tiles else 0.0
        st.prune_fracs.append(frac)
        st.m_prune_frac.observe(frac)
        if handle.plan.pruned and handle.query_bound is not None:
            n_warm = int(np.isfinite(handle.query_bound[:q_n]).sum())
            st.warm_bound_queries += n_warm
            st.m_warm_bound.inc(n_warm)
        if self.engine.rerank == "exact" and not skip_rerank:
            st.reranked_queries += q_n
            st.rerank_candidates += q_n * self._k_fetch()
            st.m_rerank_queries.inc(q_n, rerank="exact")
            st.m_rerank_candidates.inc(q_n * self._k_fetch(), rerank="exact")
        plan = handle.plan
        if plan.lost_q is not None and plan.lost_q.size:
            n_cov = int(plan.degraded_mask()[:q_n].sum())
            if n_cov:
                st.note_degraded(n_cov, "coverage")
        if deadline_late and q_n:
            self._deadline_hit = True
            st.note_degraded(q_n, "deadline")
        if mut is not None:
            t2 = time.perf_counter()
            with tr.span("merge", parent=bspan, tombstones=int(mut[2].size)):
                d, i, starved = self._merge(handle, mut, q_n)
            st.observe_phase("merge", time.perf_counter() - t2)
            if starved:
                # compact as soon as the drain finishes (no batch in flight)
                self._starved = True
                st.starved_batches += 1
                st.m_starved.inc()
        tr.end_batch(bspan)
        # a mutable cascade re-ranks to its whole fetch bucket: with no delta
        # to merge, its first k columns are the answer (ROADMAP.md C6)
        return d[:q_n, : self.k], i[:q_n, : self.k]

    def search(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Serve a query array of any length through pipelined
        micro-batches; results in input order at every depth.  Returns
        (dists (Q, k), ids (Q, k))."""
        res = self.search_result(queries)
        return res.dists, res.ids

    def search_result(self, queries: np.ndarray) -> ServingResult:
        """`search` with fault / degradation accounting (`ServingResult`).

        Each micro-batch plans around the live-device mask, dispatches with
        retry and backoff (persistent attributable faults fail over), and
        collects under the watchdog (an attributed hang fails its device
        over and refires the batch).  Under a deadline, batches planned
        after it are served at `degrade_nprobe`.  Every accepted query
        returns, exact or flagged degraded.  A batch whose tombstones
        emptied a query's fetch window triggers a compaction after the
        drain.
        """
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        q_total = queries.shape[0]
        if q_total == 0:
            return ServingResult(
                dists=np.zeros((0, self.k), np.float32), ids=np.zeros((0, self.k), np.int32),
                degraded=np.zeros(0, bool), deadline_degraded=np.zeros(0, bool),
                coverage_lost=np.zeros((0, 2), np.int32),
            )
        depth = max(0, self.pipeline_depth)
        inflight: collections.deque = collections.deque()
        outs_d, outs_i = [], []
        degraded = np.zeros(q_total, bool)
        deadline_deg = np.zeros(q_total, bool)
        lost_pairs: list[np.ndarray] = []
        deadline_s = self.deadline_ms / 1e3 if self.deadline_ms is not None else None
        t_admit = time.perf_counter()

        def collect_one():
            fl = inflight.popleft()
            d, i = self._collect_flight(fl)
            outs_d.append(d)
            outs_i.append(i)
            plan = fl.handle.plan
            if plan.lost_q is not None and plan.lost_q.size:
                keep = plan.lost_q < fl.q_n  # padding rows don't count
                if keep.any():
                    lq = plan.lost_q[keep].astype(np.int64) + fl.offset
                    lost_pairs.append(np.stack(
                        [lq, plan.lost_c[keep].astype(np.int64)], axis=1).astype(np.int32))
                    degraded[lq] = True
            if fl.deadline_late:
                deadline_deg[fl.offset : fl.offset + fl.q_n] = True
                degraded[fl.offset : fl.offset + fl.q_n] = True

        mutating = self.engine.mutation_active
        k_fetch_full = self._k_fetch()
        st = self.stats
        tr = self.tracer
        for s in range(0, q_total, self.micro_batch):
            chunk = queries[s : s + self.micro_batch]
            seq = self._batch_seq
            self._batch_seq += 1
            self._apply_fault_deaths(seq)
            late = deadline_s is not None and time.perf_counter() - t_admit > deadline_s
            # deadline degradation shrinks nprobe; an immutable cascade also
            # skips the re-rank, a mutable one keeps its fetch shape
            skip_rerank = late and self.engine.rerank == "exact" and not self.mutable
            nprobe_eff = self.degrade_nprobe if late else self.nprobe
            k_fetch = self.k if skip_rerank else k_fetch_full
            bspan = tr.begin_batch(queries=int(chunk.shape[0]), scan=self.engine.scan)
            t0 = time.perf_counter()
            padded = self._pad_chunk(chunk)
            with tr.span("plan", parent=bspan, nprobe=nprobe_eff):
                plan = self._plan_micro_batch(padded, nprobe=nprobe_eff)
            t1a = time.perf_counter()
            mut = None
            if mutating:
                with tr.span("delta", parent=bspan):
                    mut = self._delta_micro_batch(padded, plan, k_fetch)
            t1 = time.perf_counter()
            st.note_host(t1 - t0, overlapped=bool(inflight))
            st.observe_phase("plan", t1a - t0)
            if mutating:
                st.observe_phase("delta", t1 - t1a)
            fl = _Flight(
                handle=None, q_n=chunk.shape[0], offset=s, t_start=t0, mut=mut,
                t_dispatched=None, bspan=bspan, seq=seq, padded=padded,
                nprobe_eff=nprobe_eff, k_fetch=k_fetch, skip_rerank=skip_rerank,
                deadline_late=late,
            )
            with tr.span("dispatch", parent=bspan, pairs_per_dev=plan.pairs_per_dev):
                self._dispatch_with_retry(fl, plan)
            t2 = time.perf_counter()
            st.device_s += t2 - t1
            st.m_device.inc(t2 - t1)
            st.observe_phase("dispatch", t2 - t1)
            fl.t_dispatched = t2
            inflight.append(fl)
            while len(inflight) > depth:
                collect_one()
        while inflight:
            collect_one()
        if self._starved:  # after the drain: no batch in flight
            self._starved = False
            self.compact()
        return ServingResult(
            dists=np.concatenate(outs_d), ids=np.concatenate(outs_i), degraded=degraded,
            deadline_degraded=deadline_deg,
            coverage_lost=(np.concatenate(lost_pairs) if lost_pairs
                           else np.zeros((0, 2), np.int32)),
        )

    # ------------------------------------------------------------------ #

    def submit(self, queries: np.ndarray) -> int:
        """Enqueue queries for the next `flush()`.  With `queue_limit`, the
        queries past the room left are rejected (counted, not queued);
        returns how many were admitted."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        n = int(queries.shape[0])
        if n == 0:
            return 0
        if self.queue_limit is not None:
            room = self.queue_limit - self.pending()
            if room <= 0:
                self.stats.note_rejected(n)
                return 0
            if n > room:
                self.stats.note_rejected(n - room)
                queries = queries[:room]
                n = room
        self._pending.append(queries)
        self.stats.set_queue_depth(self.pending())
        return n

    def pending(self) -> int:
        return sum(q.shape[0] for q in self._pending)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Serve everything submitted since the last flush, in order."""
        res = self.flush_result()
        return res.dists, res.ids

    def flush_result(self) -> ServingResult:
        """`flush`'s answer as a `ServingResult`."""
        queries = (np.concatenate(self._pending) if self._pending
                   else np.zeros((0, 1), np.float32))
        self._pending = []
        self.stats.set_queue_depth(0)
        return self.search_result(queries)

    # ----------------------- online mutation -------------------------- #

    def _require_mutable(self) -> None:
        if not self.mutable:
            raise RuntimeError(
                "this ServingEngine was built with mutable=False; "
                "construct with mutable=True to serve inserts/deletes"
            )

    def _mutation_gauges(self) -> None:
        d = self.engine.delta
        self.stats.set_mutation_gauges(d.occupancy if d is not None else 0.0,
                                       d.tombstone_count if d is not None else 0)

    def insert(self, ids: np.ndarray, vectors: np.ndarray) -> int:
        """Insert vectors (encoded on the engine's device); the next search
        sees them.  Auto-compacts at `compact_occupancy`."""
        self._require_mutable()
        n = insert_into(self.engine, ids, vectors)
        self.stats.note_inserts(n)
        self._maybe_compact()
        self._mutation_gauges()
        return n

    def delete(self, ids: np.ndarray) -> int:
        """Tombstone ids; auto-compacts at `tombstone_limit`."""
        self._require_mutable()
        n = delete_from(self.engine, ids)
        self.stats.note_deletes(n)
        self._maybe_compact()
        self._mutation_gauges()
        return n

    def _maybe_compact(self) -> None:
        d = self.engine.delta
        if d is not None and (d.occupancy >= self.compact_occupancy
                              or d.tombstone_count >= self.tombstone_limit):
            self.compact()

    def compact(self):
        """Merge the delta into the main index (incremental re-placement +
        shard repack on the engine's device); returns the
        `CompactionReport`.  Runs between searches only: it frees the
        engine's device arrays."""
        self._require_mutable()
        with self.tracer.span("compaction"):
            report = compact_engine(self.engine, replace_threshold=self.replace_threshold)
        if report.latency_s > 0.0:
            self.stats.note_compaction(report.latency_s)
        self._mutation_gauges()
        return report
