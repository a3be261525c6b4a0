"""Batched serving on top of MemANNSEngine: micro-batching, shape buckets
and a host/device pipeline with load feedback (the reference's
`repro.retrieval.serving`, for immutable engines).

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
    batch i+1 is planned on the host (its cluster filter on the default
    stream) while the card still runs batch i; each dispatch records a CUDA
    event, and the collect makes the default stream wait for it (depth 0
    is the serial plan -> dispatch -> collect loop, with the same results);
  * each dispatched plan's per-device rows-scanned report is folded into an
    EWMA `load_carry` that biases Algorithm 2 for the next batches (the
    paper's dynamic resource management), at dispatch time, so depths 0
    and 1 see the same schedules and give bit-identical results.

`ServingStats` keeps the reference's fields that this path fills.  The
metrics registry, the tracer, fault injection, failover, deadlines and
admission control are ROADMAP queue A item 12 and raise
NotImplementedError when configured; so do the mutable serving path
(`mutable=True`, an engine with a delta: queue A item 7) and the autotune
sweep (queue A item 13).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.retrieval.engine import MemANNSEngine, SearchPlan, round_capacity
from repro_torch.retrieval.search import InFlightSearch

# per-batch latency samples kept for the percentile estimators
LATENCY_WINDOW = 4096


def _not_ported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine({knob}) is not ported to repro_torch yet; see ROADMAP.md {item}"
    )


@dataclasses.dataclass
class ServingStats:
    """Counters accumulated across `ServingEngine` batches (the reference's
    fields that the immutable path fills; see
    `repro.retrieval.serving.ServingStats` for each one).

    Throughput / pipeline: `batches`, `queries` (real, unpadded),
    `compiles` (nvcc builds and CUDA-graph captures while serving: 0 after
    `warmup()` is the contract), `host_s` (planning), `device_s` (dispatch
    + blocked collect), `overlap_s` (planning while a batch was in flight),
    `dispatch_wait_s`, `collect_wait_s`, `latencies_s` (plan -> collect per
    micro-batch, last `LATENCY_WINDOW`), `bucket_hits` ({pairs_per_dev
    bucket: dispatches}).  Scan telemetry: `rows_scanned`,
    `tiles_dispatched`, `tiles_skipped`, `rows_pruned`,
    `warm_bound_queries`, `prune_fracs`.  Re-rank: `reranked_queries`,
    `rerank_candidates`.  The mutation counters come with the mutable path
    (queue A item 7), the fault counters and the metrics registry with
    failover (queue A item 12).
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
    latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )
    prune_fracs: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )
    bucket_hits: dict[int, int] = dataclasses.field(default_factory=dict)

    def host_fraction(self) -> float:
        total = self.host_s + self.device_s
        return self.host_s / total if total > 0 else 0.0

    def prune_fraction(self) -> float:
        """Lifetime fraction of dispatched tile bodies the bounds skipped."""
        return self.tiles_skipped / self.tiles_dispatched if self.tiles_dispatched > 0 else 0.0

    def prune_percentile(self, q: float) -> float:
        """Per-batch prune-fraction percentile over the sample window."""
        return float(np.percentile(np.asarray(self.prune_fracs), q)) if self.prune_fracs else 0.0

    def overlap_fraction(self) -> float:
        """Fraction of host planning time hidden behind in-flight batches."""
        return self.overlap_s / self.host_s if self.host_s > 0 else 0.0

    def latency_percentile(self, q: float) -> float:
        """Per-micro-batch latency percentile in seconds (plan -> collect)."""
        return float(np.percentile(np.asarray(self.latencies_s), q)) if self.latencies_s else 0.0

    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    def p99_s(self) -> float:
        return self.latency_percentile(99.0)


@dataclasses.dataclass
class ServingResult:
    """One `ServingEngine.search_result` answer: dists (Q, k) f32, ids
    (Q, k) int32.  The reference's degradation arrays (`degraded`,
    `deadline_degraded`, `coverage_lost`) come with failover and deadlines
    (queue A item 12)."""

    dists: np.ndarray
    ids: np.ndarray


@dataclasses.dataclass
class _Flight:
    """One in-flight micro-batch: its handle and what its collect needs."""

    handle: InFlightSearch
    q_n: int                    # real (unpadded) queries in this chunk
    t_start: float
    t_dispatched: float


class ServingEngine:
    """Steady-state serving around one immutable `MemANNSEngine`.

    Args (the reference's; see `repro.retrieval.serving.ServingEngine`):
      engine: a built MemANNSEngine without a delta.
      nprobe, k: clusters probed and neighbours returned per query.
      micro_batch: queries per device step (requests are padded / split).
      capacity_floor: smallest pairs-per-device bucket.
      pipeline_depth: in-flight micro-batches; 1 (default) plans batch i+1
        while the card runs batch i, 0 is the serial loop.  Bit-identical
        results at every depth.
      load_feedback, load_alpha: the EWMA of per-device rows scanned fed
        back into Algorithm 2 as `load_carry` (alpha 1.0: the last batch).
      autotune: "off" serves the engine's geometry; "cache" (default)
        applies a cached tuned geometry when one exists -- the port has no
        autotune cache until ROADMAP queue A item 13, so it serves the
        engine's own and says so in `autotune_report`; "sweep" raises
        NotImplementedError (queue A item 13).
      mutable (and an engine with a delta), tracer, deadline_ms,
      degrade_nprobe, retry_limit / retry_backoff_s / retry_backoff_max_s
      away from their defaults, queue_limit, collect_timeout_s, faults:
        raise NotImplementedError naming their ROADMAP items (7, 12).  The
        reference's other knobs (the mutable path's compaction settings,
        `autotune_cache_dir`, `metrics`) are not taken until the items
        that read them land.

    The re-rank cascade is the engine's (`rerank="exact"`, `k_overfetch`):
    serving dispatches the scan at k' and the re-rank to k.
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
        autotune: str = "cache",
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
        if autotune == "sweep":
            raise _not_ported('autotune="sweep"', "queue A item 13")
        if mutable or engine.delta is not None:
            raise _not_ported("mutable=True, or an engine with a delta", "queue A item 7")
        for name, value, default in (
            ("tracer", tracer, None), ("deadline_ms", deadline_ms, None),
            ("degrade_nprobe", degrade_nprobe, None), ("retry_limit", retry_limit, 2),
            ("retry_backoff_s", retry_backoff_s, 0.05),
            ("retry_backoff_max_s", retry_backoff_max_s, 1.0),
            ("queue_limit", queue_limit, None), ("collect_timeout_s", collect_timeout_s, None),
            ("faults", faults, None),
        ):
            if value != default:
                raise _not_ported(f"{name}={value!r}", "queue A item 12")
        self.engine = engine
        self.nprobe = int(nprobe)
        self.k = int(k)
        self.micro_batch = int(micro_batch)
        self.capacity_floor = int(capacity_floor)
        self.pipeline_depth = int(pipeline_depth)
        self.load_feedback = bool(load_feedback)
        self.load_alpha = float(load_alpha)
        self.autotune = autotune
        self.autotune_report: dict | None = None
        self.stats = ServingStats()
        self._pending: list[np.ndarray] = []
        self._load_ewma = np.zeros(engine.shards.ndev, np.float64)
        # the server's own stream: its dispatches queue behind each other,
        # while the next batch's cluster filter runs on the default stream
        dv = engine.device
        self._stream = torch.cuda.Stream(dv) if dv.type == "cuda" else None

    # ------------------------------------------------------------------ #

    def _k_fetch(self) -> int:
        """The scan's k: k' under the exact re-rank, else k."""
        return self.engine.k_prime(self.k) if self.engine.rerank == "exact" else self.k

    def load_carry(self) -> np.ndarray:
        """Current (ndev,) EWMA of per-device rows scanned (a copy)."""
        return self._load_ewma.copy()

    def default_buckets(self, nprobe: int | None = None) -> list[int]:
        """Power-of-two pair capacities from the balanced share
        (micro_batch * nprobe / ndev) to the worst case (every pair on one
        device): every schedule this config can produce lands on one."""
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
        """Resolve the kernel geometry once (see `autotune`).  The port has
        no autotune cache until ROADMAP queue A item 13, so "cache" finds
        none and the engine's own geometry serves."""
        if self.autotune_report is None:
            report = {"mode": self.autotune, "source": "off", "swept": 0}
            if self.autotune == "cache":
                report.update(source="miss", device_kind=(
                    torch.cuda.get_device_name(self.engine.device)
                    if self.engine.device.type == "cuda" else "cpu"),
                    note="no autotune cache in repro_torch until ROADMAP.md queue A item 13; "
                         "the engine's own geometry serves")
            report["applied"] = {"block_n": self.engine.shards.block_n}
            self.autotune_report = report
        return self.autotune_report

    def warmup(self, buckets: list[int] | None = None) -> list[int]:
        """Make every steady-state batch of this config build nothing.

        The port builds all its kernels into one library on the first
        launch, whatever the shapes, so one dummy step of the smallest
        bucket (no valid pair: the whole path runs and scans nothing) and
        its re-rank build it, and a planned batch of zeros runs the host
        path.  Returns the pair buckets (`default_buckets`) the schedules
        land on.
        """
        self.apply_autotune()
        buckets = sorted(buckets or self.default_buckets())
        dim = self.engine.index.centroids.shape[1]
        zeros = np.zeros((self.micro_batch, dim), np.float32)
        self._collect(self._dispatch(self._dummy_plan(buckets[0]), self._k_fetch(), zeros))
        self.engine.plan_batch(zeros, self.nprobe)
        return buckets

    # ------------------------------------------------------------------ #

    def _pad_chunk(self, queries: np.ndarray) -> np.ndarray:
        """Pad one chunk to the micro-batch size (rows sliced off later)."""
        q_n = queries.shape[0]
        if q_n < self.micro_batch:
            pad = np.broadcast_to(queries[:1], (self.micro_batch - q_n, queries.shape[1]))
            queries = np.concatenate([queries, pad], axis=0)
        return queries

    def _plan_micro_batch(self, queries: np.ndarray) -> SearchPlan:
        """Plan one padded micro-batch (host side), with the load carry."""
        return self.engine.plan_batch(
            queries, self.nprobe, capacity_floor=self.capacity_floor,
            load_carry=self._load_ewma if self.load_feedback else None,
        )

    def _dispatch(self, plan: SearchPlan, k_fetch: int, queries: np.ndarray) -> InFlightSearch:
        """Enqueue the scan (and the re-rank to k) on the server's stream,
        after the default stream's planning work; the handle's event marks
        its end."""
        eng = self.engine

        def run():
            handle = eng.dispatch_plan(plan, k_fetch)
            if eng.rerank == "exact":
                handle = eng.dispatch_rerank(handle, queries, self.k)
            return handle

        if self._stream is None:
            return run()
        self._stream.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(self._stream):
            return run()

    def _collect(self, handle: InFlightSearch) -> tuple[np.ndarray, np.ndarray]:
        """Host results of a dispatched step: the default stream waits for
        its event first."""
        if handle.event is not None:
            torch.cuda.current_stream(self.engine.device).wait_event(handle.event)
        return self.engine.collect(handle)

    def _dispatch_micro_batch(self, plan: SearchPlan, k_fetch: int | None = None,
                              queries: np.ndarray | None = None) -> InFlightSearch:
        """Dispatch a planned micro-batch; count compiles, fold the plan's
        rows into the load EWMA now (not at collect, so every depth plans
        alike), count the bucket.  With rerank="exact" pass the padded
        `queries`."""
        k_fetch = self._k_fetch() if k_fetch is None else k_fetch
        before = _build.compile_count()
        handle = self._dispatch(plan, k_fetch, queries)
        built = _build.compile_count() - before
        self.stats.compiles += built
        if self.load_feedback:
            self._load_ewma = (self.load_alpha * handle.dev_rows.astype(np.float64)
                               + (1.0 - self.load_alpha) * self._load_ewma)
        hits = self.stats.bucket_hits
        hits[plan.pairs_per_dev] = hits.get(plan.pairs_per_dev, 0) + 1
        return handle

    def health(self) -> dict:
        """Health summary (the reference's `/healthz` payload): every
        device live, no admission limit."""
        ndev = self.engine.shards.ndev
        return {
            "state": "ok", "queue_depth": self.pending(), "queue_limit": None,
            "live_devices": ndev, "n_devices": ndev, "dead_devices": [],
        }

    def _collect_micro_batch(self, handle: InFlightSearch, q_n: int, t_start: float,
                             t_dispatched: float | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Block on one in-flight micro-batch; slice the padding, record
        stats.  `t_dispatched` splits the pipelined latency: collect start
        minus dispatch end is `dispatch_wait` (queued behind earlier
        batches), the blocked collect itself `collect_wait`."""
        st = self.stats
        t0 = time.perf_counter()
        if t_dispatched is not None:
            wait = max(t0 - t_dispatched, 0.0)
            st.dispatch_wait_s += wait
        d, i = self._collect(handle)
        t1 = time.perf_counter()
        st.device_s += t1 - t0
        st.collect_wait_s += t1 - t0
        st.latencies_s.append(t1 - t_start)
        st.batches += 1
        st.queries += q_n
        dev_rows = np.asarray(handle.dev_rows)
        st.rows_scanned += int(dev_rows.sum())
        tiles = self.engine.plan_tile_count(handle.plan)
        skipped = rows = 0
        if handle.prune_stats is not None:
            ps = handle.prune_stats.cpu().numpy()
            skipped, rows = (int(x) for x in ps.sum(axis=0))
        st.tiles_dispatched += tiles
        st.tiles_skipped += skipped
        st.rows_pruned += rows
        frac = skipped / tiles if tiles else 0.0
        st.prune_fracs.append(frac)
        if handle.plan.pruned and handle.query_bound is not None:
            n_warm = int(np.isfinite(handle.query_bound[:q_n]).sum())
            st.warm_bound_queries += n_warm
        if self.engine.rerank == "exact":
            st.reranked_queries += q_n
            st.rerank_candidates += q_n * self._k_fetch()
        return d[:q_n], i[:q_n]

    def search(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Serve a query array of any length through pipelined
        micro-batches; results in input order at every depth.  Returns
        (dists (Q, k), ids (Q, k))."""
        res = self.search_result(queries)
        return res.dists, res.ids

    def search_result(self, queries: np.ndarray) -> ServingResult:
        """`search`'s answer as a `ServingResult`."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        q_total = queries.shape[0]
        if q_total == 0:
            return ServingResult(dists=np.zeros((0, self.k), np.float32),
                                 ids=np.zeros((0, self.k), np.int32))
        depth = max(0, self.pipeline_depth)
        inflight: collections.deque = collections.deque()
        outs_d, outs_i = [], []
        st = self.stats
        k_fetch = self._k_fetch()

        def collect_one():
            fl = inflight.popleft()
            d, i = self._collect_micro_batch(fl.handle, fl.q_n, fl.t_start, fl.t_dispatched)
            outs_d.append(d)
            outs_i.append(i)

        for s in range(0, q_total, self.micro_batch):
            chunk = queries[s : s + self.micro_batch]
            t0 = time.perf_counter()
            padded = self._pad_chunk(chunk)
            plan = self._plan_micro_batch(padded)
            t1 = time.perf_counter()
            st.host_s += t1 - t0
            if inflight:
                st.overlap_s += t1 - t0
            handle = self._dispatch_micro_batch(plan, k_fetch, padded)
            t2 = time.perf_counter()
            st.device_s += t2 - t1
            inflight.append(_Flight(handle=handle, q_n=chunk.shape[0], t_start=t0,
                                    t_dispatched=t2))
            while len(inflight) > depth:
                collect_one()
        while inflight:
            collect_one()
        return ServingResult(dists=np.concatenate(outs_d), ids=np.concatenate(outs_i))

    # ------------------------------------------------------------------ #

    def submit(self, queries: np.ndarray) -> int:
        """Enqueue queries for the next `flush()`; returns how many."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[0]:
            self._pending.append(queries)
        return int(queries.shape[0])

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
        return self.search_result(queries)
