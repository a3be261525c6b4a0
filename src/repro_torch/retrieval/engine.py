"""MemANNSEngine: the end-to-end system of paper Fig. 5 behind one object.

Offline (build): IVF+PQ index -> frequency estimation from a historical query
log -> Algorithm-1 placement (with replication + co-location) -> per-device
packed shards (+ the raw-vector store for the exact re-rank).

Online (search): cluster filtering on the card, Algorithm-2 scheduling
(and, for `scan="tiles"`, the tile queue) on the host, then one device step
over a leading logical-device axis (LUT build, extended tables for
co-occurrence shards, pruned scan, hierarchical merge) and, with
`rerank="exact"`, the re-rank of the overfetched candidates.

Ported knobs: `scan` "tiles" | "windows", `path` "gather" | "flat" |
"onehot", `use_cooc` (§4.3 co-occurrence shards, with `n_combos`,
`combo_len`, `mine_rows`, `min_length_reduction`), `prune`, `rerank` "off"
| "exact", `k_overfetch`, `mutable` (online inserts, tombstone deletes and
compaction, `retrieval.mutation`, with `delta_capacity`), `opq_iters` (an
OPQ rotation trained before PQ; queries are rotated on entry to the ADC
path, the exact re-rank stays in the original space), and the tuned
kernel geometry (`block_n` via `retile`, `rerank_block`, `tile_floor`;
`geometry` / `apply_geometry`, which `core.autotune` resolves).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.delta import DeltaIndex
from repro_torch.core.index import IVFPQIndex, StageClock, build_index, filter_clusters
from repro_torch.core.placement import Placement, estimate_frequencies, place_clusters
from repro_torch.core.scheduling import (
    ArraySchedule,
    count_tiles,
    densify_schedule,
    emit_tiles,
    residual_bounds,
    schedule_queries,
    subspace_code_norms,
    warm_start_bounds,
)
from repro_torch.device import resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.layout import (
    DeviceShards,
    RawStore,
    build_raw_store,
    build_shards,
    default_slack,
)
from repro_torch.retrieval.search import InFlightSearch, sharded_rerank, sharded_search


def round_capacity(max_pairs: int, floor: int = 8) -> int:
    """Round a count up to the next power-of-two capacity bucket."""
    return max(floor, 1 << math.ceil(math.log2(max(max_pairs, 1))))


def _check_knobs(scan: str, path: str, rerank: str) -> None:
    """Refuse, before any expensive work, what the port does not take.

    `path` is the reference's: "gather" and "flat" (the addressing of raw
    codes and of direct addresses; the kernels follow the shards' codes
    either way) add each row's table entries in column order, "onehot" in
    ascending table-address order (`kernels.ops`).
    """
    if scan not in ("tiles", "windows"):
        raise ValueError(f"scan must be 'tiles' or 'windows', got {scan!r}")
    if path not in ("gather", "flat", "onehot"):
        raise ValueError(f"path must be 'gather', 'flat' or 'onehot', got {path!r}")
    if rerank not in ("off", "exact"):
        raise ValueError(f"rerank must be 'off' or 'exact', got {rerank!r}")


@dataclasses.dataclass
class SearchPlan:
    """Densified host-side plan for one device step.

    Produced by `MemANNSEngine.plan_batch` (cluster filtering + Algorithm 2
    + densify + the tile queue on the tiles scan); consumed by
    `dispatch_plan`.  `qmc_pairs` is a tensor on the engine's device (the
    residuals never leave the card); the index arrays are host numpy, as
    the reference's.
    """

    qmc_pairs: torch.Tensor  # (ndev, P, D) f32 per-pair query - centroid
    pair_q: np.ndarray       # (ndev, P) int32 query index
    pair_slot: np.ndarray    # (ndev, P) int32 local cluster slot
    pair_valid: np.ndarray   # (ndev, P) bool
    schedule: ArraySchedule
    n_queries: int
    pairs_per_dev: int
    # tile queue (scan="tiles" only; None on the windows scan)
    tile_pair: np.ndarray | None = None   # (ndev, T) int32, P marks dummies
    tile_block: np.ndarray | None = None  # (ndev, T) int32 code-block index
    tile_row0: np.ndarray | None = None   # (ndev, T) int32 window-relative row
    tiles_per_dev: int = 0
    # early-pruning bounds (None = the plan runs unpruned)
    pair_lb: np.ndarray | None = None       # (ndev, P) f32
    probed_ub: np.ndarray | None = None     # (Q, nprobe) f32
    probed_sizes: np.ndarray | None = None  # (Q, nprobe) int64
    # coverage under a live-device mask: probed (query, cluster) pairs whose
    # every replica is on a dead device (None: planned with all devices live)
    lost_q: np.ndarray | None = None        # (L,) int32 query index
    lost_c: np.ndarray | None = None        # (L,) int32 cluster id

    @property
    def scan(self) -> str:
        """The scan this plan was built for."""
        return "tiles" if self.tile_pair is not None else "windows"

    @property
    def pruned(self) -> bool:
        """True when this plan carries early-pruning bounds."""
        return self.pair_lb is not None

    def degraded_mask(self) -> np.ndarray:
        """(Q,) bool: queries with at least one unreachable probed cluster
        (they still return their best-effort top-k over the reachable ones)."""
        mask = np.zeros(self.n_queries, bool)
        if self.lost_q is not None and self.lost_q.size:
            mask[self.lost_q] = True
        return mask

    def query_bounds(self, k: int) -> np.ndarray:
        """(Q,) strict warm-start upper bounds on the k-th output distance."""
        if self.probed_ub is None or self.probed_sizes is None:
            return np.full(self.n_queries, np.inf, np.float32)
        return warm_start_bounds(self.probed_ub, self.probed_sizes, k)


@dataclasses.dataclass
class MemANNSEngine:
    """End-to-end engine state + the host half of the online path.

    Knobs: `scan` ("tiles": a flat queue of the probed code tiles, kernel
    B2; "windows": each filled pair scans its cluster slot, kernel B5; the
    two give bit-identical results), `path` ("gather" / "flat": each row's
    entries added in column order; "onehot": in ascending table-address
    order, the reference's multi-hot contraction; the same bits on raw
    codes), `prune`
    (exact whole-tile pruning; False plans the unpruned reference scan),
    `rerank` ("off" | "exact": overfetch `k_prime(k)` ADC candidates and
    re-score them exactly against `raw`), `k_overfetch` (k'; 0 = 4k,
    pow2-bucketed), `rerank_block` (B3's candidates per thread block, 0 =
    the kernel's own choice; `kernels.rerank.launch_plan`) and `tile_floor`
    (the least tiles-per-device capacity of an auto-sized tile queue, 0 =
    pairs_per_dev, clamped to the tile-bucket ladder).  The tuned geometry
    (`block_n` via `retile`, `rerank_block`, `tile_floor`) is applied as a
    unit by `apply_geometry` and read by `geometry()`; no value of it
    changes a bit of any result.  Co-occurrence encoding is a property of
    the shards (`build(use_cooc=True)`).  An index with an OPQ rotation
    rotates the queries in `schedule_batch`; `dispatch_rerank` takes the
    original-space queries against the original-space raw store.

    `device` is where the packed arrays live and the kernels run; the
    index, placement and shard metadata stay host numpy.  `delta` is the
    `core.delta.DeltaIndex` buffer of a mutable engine (`insert`,
    `delete`, `compact`); while it is active, `search` goes through
    `retrieval.mutation.mutable_search`.

    `tracer` records the engine's sub-phases (schedule / densify /
    emit_tiles in `plan_batch`, rerank_dispatch, the compaction's stages)
    as child-only spans: they record under a sampled serving batch span
    and evaporate otherwise.  `ServingEngine(tracer=...)` installs its
    tracer here.
    """

    index: IVFPQIndex
    placement: Placement
    shards: DeviceShards
    device: torch.device
    scan: str = "tiles"
    path: str = "gather"
    prune: bool = True
    rerank: str = "off"
    k_overfetch: int = 0
    rerank_block: int = 0
    tile_floor: int = 0
    freqs: np.ndarray | None = None
    raw: RawStore | None = None
    delta: DeltaIndex | None = None
    tracer: object = NULL_TRACER
    _dev_arrays: dict | None = None
    _code_norms: np.ndarray | None = None

    @classmethod
    def build(
        cls,
        xs,
        n_clusters: int,
        m: int,
        ndev: int = 8,
        history_queries: np.ndarray | None = None,
        nprobe_history: int = 32,
        block_n: int = 1024,
        kmeans_iters: int = 15,
        pq_iters: int = 10,
        train_subsample: int | None = None,
        pq_train_subsample: int | None = None,
        path: str = "gather",
        scan: str = "tiles",
        prune: bool = True,
        rerank: str = "off",
        k_overfetch: int = 0,
        rerank_block: int = 0,
        tile_floor: int = 0,
        raw_dtype: str = "float32",
        use_cooc: bool = False,
        n_combos: int = 256,
        combo_len: int = 3,
        mine_rows: int = 50_000,
        min_length_reduction: float = 0.0,
        mutable: bool = False,
        delta_capacity: int = 4096,
        opq_iters: int = 0,
        seed: int = 0,
        device: torch.device | str | None = None,
        stats: dict | None = None,
    ) -> "MemANNSEngine":
        """Offline build on `device` (default cuda).

        `xs` is a numpy array or a tensor (a bf16 corpus on the card is
        trained on, encoded and packed there chunk by chunk).  `seed` seeds
        the CPU `torch.Generator` behind the training samples and k-means
        seeding.  `ndev` is the number of logical devices.  With
        `rerank="exact"` the raw vectors are packed into a `RawStore` of
        `raw_dtype`.  `use_cooc=True` packs co-occurrence shards (§4.3;
        `n_combos`, `combo_len`, `mine_rows`, `min_length_reduction` as in
        `retrieval.layout.build_shards`).  `mutable=True` allocates a
        delta buffer of `delta_capacity` rows (pow2-bucketed) and packs the
        shards and the raw store with the reference's growth slack
        (`layout.default_slack`: 50 % rows, 4 slots, 2+ window blocks; the
        raw store 50 % rows), so compactions usually keep every shape.
        `opq_iters > 0` trains an OPQ rotation before PQ
        (`core.index.build_index`); the history queries are rotated before
        they meet the rotated centroids (the reference compares them
        unrotated, ROADMAP C7), and the raw store stays in the original
        space.  `rerank_block` and `tile_floor` are the tuned geometry's
        (class docstring).  `stats`, when given, receives the seconds of
        each stage: `build_index`'s, then `placement` (frequencies and
        Algorithm 1), `shards` and `raw_store`.
        """
        _check_knobs(scan, path, rerank)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        index = build_index(
            xs, n_clusters, m, kmeans_iters=kmeans_iters, pq_iters=pq_iters,
            train_subsample=train_subsample,
            pq_train_subsample=pq_train_subsample, opq_iters=opq_iters, generator=gen,
            device=dev, stats=stats,
        )
        clock = StageClock(stats, dev)
        if history_queries is not None and len(history_queries):
            probed, _ = filter_clusters(
                torch.as_tensor(index.centroids, device=dev),
                torch.as_tensor(index.rotate(np.asarray(history_queries, np.float32)),
                                device=dev),
                min(nprobe_history, n_clusters),
            )
            freqs = estimate_frequencies(probed.cpu().numpy(), n_clusters)
        else:
            freqs = np.ones(n_clusters) / n_clusters
        placement = place_clusters(
            index.cluster_sizes().astype(np.float64), freqs, ndev,
            centroids=index.centroids,
        )
        clock.lap("placement")
        return cls._assemble(
            index, placement, dev, xs if rerank == "exact" else None,
            block_n=block_n, raw_dtype=raw_dtype,
            cooc=dict(use_cooc=use_cooc, n_combos=n_combos, combo_len=combo_len,
                      mine_rows=mine_rows, min_length_reduction=min_length_reduction),
            freqs=freqs, scan=scan, path=path, prune=prune, rerank=rerank,
            k_overfetch=k_overfetch, rerank_block=rerank_block, tile_floor=tile_floor,
            mutable=mutable, delta_capacity=delta_capacity, clock=clock,
        )

    @classmethod
    def from_reference(
        cls,
        index,
        placement,
        xs=None,
        *,
        block_n: int = 1024,
        raw_dtype: str = "float32",
        path: str = "gather",
        scan: str = "tiles",
        prune: bool = True,
        rerank: str = "off",
        k_overfetch: int = 0,
        rerank_block: int = 0,
        tile_floor: int = 0,
        use_cooc: bool = False,
        n_combos: int = 256,
        combo_len: int = 3,
        mine_rows: int = 50_000,
        min_length_reduction: float = 0.0,
        freqs: np.ndarray | None = None,
        mutable: bool = False,
        delta_capacity: int = 4096,
        delta=None,
        device: torch.device | str | None = None,
    ) -> "MemANNSEngine":
        """An engine over an already trained index and placement.

        `index` and `placement` may be this package's objects or any objects
        with the same array attributes (the reference's `IVFPQIndex` and
        `Placement`); they are carried over with `repro_torch.convert`.
        `xs` are the raw vectors (ids 0..N-1); they back `rerank="exact"`
        and may be given with `rerank="off"` to switch later.  The number
        of logical devices is the placement's.  The co-occurrence knobs
        and `mutable` / `delta_capacity` are `build`'s.  `delta` (this
        package's `DeltaIndex`, or any object with its arrays, e.g. the
        reference's, as `checkpoint.load_index` returns it) makes the
        engine mutable and carries the buffered inserts and tombstones over.
        An index with an OPQ rotation keeps it (queries are rotated on
        entry); `xs` are original-space vectors.  `rerank_block` and
        `tile_floor` are the tuned geometry's.
        """
        from repro_torch.convert import (
            delta_from_arrays,
            index_from_arrays,
            placement_from_arrays,
        )

        _check_knobs(scan, path, rerank)
        dev = resolve_device(device)
        idx = index_from_arrays(
            index.centroids, index.codebook, index.codes, index.vec_ids,
            index.offsets, getattr(index, "rotation", None),
        )
        plc = placement_from_arrays(
            placement.replicas, placement.dev_load, placement.dev_vectors,
            placement.dev_clusters, placement.w_bar,
        )
        if rerank == "exact" and xs is None:
            raise ValueError("rerank='exact' needs the raw vectors xs")
        if delta is not None:
            delta = delta_from_arrays(
                delta.codes, delta.assign, delta.vec_ids, delta.dead, delta.n,
                delta.tombstones, getattr(delta, "vectors", None),
            )
        return cls._assemble(
            idx, plc, dev, xs, block_n=block_n, raw_dtype=raw_dtype,
            cooc=dict(use_cooc=use_cooc, n_combos=n_combos, combo_len=combo_len,
                      mine_rows=mine_rows, min_length_reduction=min_length_reduction),
            freqs=freqs, scan=scan, path=path, prune=prune, rerank=rerank,
            k_overfetch=k_overfetch, rerank_block=rerank_block, tile_floor=tile_floor,
            mutable=mutable or delta is not None,
            delta_capacity=delta_capacity, delta=delta,
        )

    @classmethod
    def _assemble(cls, index, placement, dev, xs, *, block_n, raw_dtype, cooc,
                  mutable, delta_capacity, delta=None, clock=None, **knobs):
        clock = clock or StageClock(None, dev)
        cap_slack, slot_slack, window_slack = default_slack(block_n, mutable)
        shards = build_shards(index, placement, block_n=block_n, device=dev,
                              cap_slack=cap_slack, slot_slack=slot_slack,
                              window_slack=window_slack, **cooc)
        clock.lap("shards")
        raw = None
        if xs is not None:
            raw = build_raw_store(index, placement, xs, dtype=raw_dtype, device=dev,
                                  cap_slack=0.5 if mutable else 0.0)
            clock.lap("raw_store")
        if mutable and delta is None:
            delta = DeltaIndex.create(index.m, delta_capacity)
        return cls(index=index, placement=placement, shards=shards, device=dev,
                   raw=raw, delta=delta, **knobs)

    # ------------------------- online mutation ------------------------- #

    def insert(self, ids: np.ndarray, vectors: np.ndarray) -> int:
        """Buffer new PQ-encoded vectors; visible to the next search."""
        from repro_torch.retrieval.mutation import insert_into

        return insert_into(self, ids, vectors)

    def delete(self, ids: np.ndarray) -> int:
        """Tombstone ids; filtered from the next search onward."""
        from repro_torch.retrieval.mutation import delete_from

        return delete_from(self, ids)

    def compact(self, replace_threshold: float = 0.25):
        """Merge the delta + drop tombstones; incremental re-place + repack.

        Returns a `retrieval.mutation.CompactionReport`."""
        from repro_torch.retrieval.mutation import compact_engine

        return compact_engine(self, replace_threshold=replace_threshold)

    @property
    def mutation_active(self) -> bool:
        """True when searches must consult the delta layer."""
        return self.delta is not None and self.delta.active

    # ------------------------------------------------------------------ #

    @property
    def ndev(self) -> int:
        return self.shards.ndev

    def _device_put(self) -> dict:
        """The packed arrays on the engine's device (copied once, cached)."""
        if self._dev_arrays is None:
            s, dev = self.shards, self.device
            self._dev_arrays = {
                "codes": torch.as_tensor(s.codes, device=dev),
                "vec_ids": torch.as_tensor(s.vec_ids, device=dev),
                "slot_start": torch.as_tensor(s.slot_start, device=dev),
                "slot_size": torch.as_tensor(s.slot_size, device=dev),
                "combo_addrs": torch.as_tensor(s.combo_addrs, device=dev),
                "codebook": torch.as_tensor(self.index.codebook, device=dev),
                "centroids": torch.as_tensor(self.index.centroids, device=dev),
            }
        return self._dev_arrays

    @property
    def kernel_path(self) -> str:
        """The scans' `path`: "onehot", or "gather" for "gather" / "flat"."""
        return "onehot" if self.path == "onehot" else "gather"

    def k_prime(self, k: int) -> int:
        """Cascade candidate count k' for a final top-`k` (pow2-bucketed):
        `k_overfetch` when set (clamped to >= k), else 4k."""
        want = self.k_overfetch if self.k_overfetch > 0 else 4 * k
        return round_capacity(max(want, k), floor=max(k, 1))

    # ---------------------- tuned kernel geometry ---------------------- #

    def geometry(self):
        """The engine's current `core.autotune.KernelGeometry`."""
        from repro_torch.core.autotune import KernelGeometry

        return KernelGeometry(block_n=self.shards.block_n, rerank_block=self.rerank_block,
                              tile_floor=self.tile_floor)

    def apply_geometry(self, geo) -> bool:
        """Apply a tuned `KernelGeometry` as a unit: set `rerank_block` and
        `tile_floor`, and retile when `geo.block_n` is set and differs from
        the shards' (`block_n=0` keeps the build-time tile height).  No
        result changes a bit.  Returns True when the shards were retiled
        (the device copies are gone then: a cold start for a caller holding
        them)."""
        self.rerank_block = int(getattr(geo, "rerank_block", 0) or 0)
        self.tile_floor = int(getattr(geo, "tile_floor", 0) or 0)
        block_n = int(getattr(geo, "block_n", 0) or 0)
        if block_n and block_n != self.shards.block_n:
            self.retile(block_n)
            return True
        return False

    def retile(self, block_n: int) -> None:
        """Repack the shards at tile height `block_n` (`layout.build_shards`
        with the shards' own co-occurrence knobs and the slack of
        `default_slack(block_n, mutable)`).

        The shards are a function of (index, placement, knobs): slots
        re-align to the new height and the co-occurrence mining is seeded
        by cluster id, so the codes are the same and every search answers
        bit for bit as before (a pair's top-k is the k smallest by
        (distance, row), whichever tiles the rows came in).  The device
        copies and the old shards are dropped before the new ones are
        packed, so the two never share the card; the delta buffer and the
        raw store are untouched.
        """
        s = self.shards
        cooc = s.n_combos > 0
        knobs = dict(
            use_cooc=cooc, n_combos=s.n_combos if cooc else 256,
            combo_len=s.combo_addrs.shape[3] if cooc else 3,
            min_length_reduction=s.min_length_reduction, mine_rows=s.mine_rows,
        )
        cap_slack, slot_slack, window_slack = default_slack(block_n, self.delta is not None)
        self._dev_arrays = None
        self.shards = s = None  # the old packing goes before the new one is built
        self.shards = build_shards(
            self.index, self.placement, block_n=block_n, device=self.device,
            cap_slack=cap_slack, slot_slack=slot_slack, window_slack=window_slack, **knobs,
        )

    def attach_raw_store(self, xs, xs_ids: np.ndarray | None = None,
                         dtype: str = "float32") -> RawStore:
        """Build and attach the raw-vector store of an existing engine.

        `xs` are ORIGINAL-space vectors (numpy or a tensor); `xs_ids[i]` is
        the global id of row i (default 0..N-1).  Every id of the index
        must be covered.  A mutable engine's store takes its 50 % row slack.
        """
        self.raw = build_raw_store(
            self.index, self.placement, xs, xs_ids=xs_ids, dtype=dtype, device=self.device,
            cap_slack=0.5 if self.delta is not None else 0.0,
        )
        return self.raw

    def code_norms(self) -> np.ndarray:
        """(M,) cached per-subspace max codeword norms (bound inputs)."""
        if self._code_norms is None:
            self._code_norms = subspace_code_norms(self.index.codebook)
        return self._code_norms

    def schedule_batch(
        self,
        queries: np.ndarray,
        nprobe: int,
        load_carry: np.ndarray | None = None,
        live: np.ndarray | None = None,
    ) -> tuple[ArraySchedule, np.ndarray, torch.Tensor]:
        """Cluster filtering (stage a, on the card) + Algorithm 2 (host).

        `load_carry` ((ndev,) carried load) and `live` ((ndev,) live-device
        mask) are `schedule_queries`' own.  With an OPQ rotation the
        queries are rotated here (`IVFPQIndex.rotate`, numpy f32 on the
        host), as the reference's `schedule_batch` does: centroids and codes
        live in the rotated space, so the residuals, tables and ADC scan
        downstream are rotated too.  Returns (schedule, probed (Q, nprobe)
        int32 host, qmc (Q, nprobe, D) f32 tensor on the engine's device).
        """
        dev = self._device_put()
        q = torch.as_tensor(np.asarray(self.index.rotate(np.asarray(queries, np.float32)),
                                       np.float32), device=self.device)
        probed_t, qmc = filter_clusters(dev["centroids"], q, nprobe)
        probed = probed_t.cpu().numpy().astype(np.int32)
        schedule = schedule_queries(probed, self.index.cluster_sizes(), self.placement,
                                    load_carry=load_carry, live=live)
        return schedule, probed, qmc

    def plan_batch(
        self,
        queries: np.ndarray,
        nprobe: int,
        pairs_per_dev: int | None = None,
        capacity_floor: int = 8,
        tiles_per_dev: int | None = None,
        load_carry: np.ndarray | None = None,
        prune: bool | None = None,
        live: np.ndarray | None = None,
    ) -> SearchPlan:
        """Host-side online phase: filter + schedule + densify (+ tile queue).

        The reference's `plan_batch` with its arguments (plan arrays equal):
        the pair capacity is `pairs_per_dev`, else a pow2 bucket from
        `capacity_floor`; the tile capacity `tiles_per_dev`, else a pow2
        bucket from the pair capacity (at least the tuned `tile_floor`,
        clamped to the reachable ladder pairs_per_dev * 2^i up to
        pow2(window / block_n), so warmup still covers every capacity).
        `load_carry` biases Algorithm 2
        toward cold devices and `live` plans around dead ones (their
        unreachable pairs land in `lost_q` / `lost_c`, and leave the
        warm-start sizes).  With pruning (`prune`, default `self.prune`)
        the plan carries per-pair lower bounds and per-query probed upper
        bounds and sizes, and the tile queue runs best-first (ascending
        lower bound).  On `scan="windows"` no tile queue is built: the
        windows kernel reads each pair's slot directly.
        """
        queries = np.asarray(queries, np.float32)
        q_n = queries.shape[0]
        ndev = self.ndev
        prune = self.prune if prune is None else prune
        tr = self.tracer
        with tr.span("schedule", root=False):
            schedule, probed, qmc = self.schedule_batch(
                queries, nprobe, load_carry=load_carry, live=live)
        max_pairs = int(schedule.counts_per_dev().max(initial=0))
        if pairs_per_dev is None:
            pairs_per_dev = round_capacity(max_pairs, floor=capacity_floor)

        with tr.span("densify", root=False):
            pair_q, pair_slot, pair_valid = densify_schedule(
                schedule, self.shards.local_slot, pairs_per_dev
            )
            order, d_sorted, pos = schedule.device_positions()
            pq, pc = schedule.pair_q[order], schedule.pair_c[order]
            cols = np.argmax(probed[pq] == pc[:, None], axis=1)
            qmc_pairs = torch.zeros(
                (ndev, pairs_per_dev, queries.shape[1]), dtype=torch.float32,
                device=self.device,
            )
            dst = torch.as_tensor(d_sorted * pairs_per_dev + pos, device=self.device)
            src = torch.as_tensor(pq.astype(np.int64) * nprobe + cols, device=self.device)
            qmc_pairs.view(-1, queries.shape[1])[dst] = qmc.reshape(-1, queries.shape[1])[src]

            pair_lb = probed_ub = probed_sizes = None
            if prune:
                lb, ub = residual_bounds(qmc.cpu().numpy(), self.code_norms())
                pair_lb = np.full((ndev, pairs_per_dev), np.inf, np.float32)
                pair_lb[d_sorted, pos] = lb[pq, cols]
                probed_ub = ub
                probed_sizes = self.index.cluster_sizes()[probed]
                if schedule.lost_c is not None and schedule.lost_c.size:
                    # a bound may count only rows the scan will visit
                    unreach = np.zeros(self.index.cluster_sizes().shape[0], bool)
                    unreach[schedule.lost_c] = True
                    probed_sizes = np.where(unreach[probed], 0, probed_sizes)

        tile_pair = tile_block = tile_row0 = None
        tiles_cap = 0
        if self.scan == "tiles":
            s = self.shards
            if tiles_per_dev is None:
                nv = np.take_along_axis(s.slot_size, pair_slot, axis=1)
                max_tiles = int(count_tiles(pair_valid, nv, s.block_n).max(initial=0))
                floor = pairs_per_dev
                if self.tile_floor > 0:
                    wb2 = 1 << math.ceil(math.log2(max(s.window // s.block_n, 1)))
                    floor = min(round_capacity(self.tile_floor, floor=pairs_per_dev),
                                pairs_per_dev * wb2)
                tiles_per_dev = round_capacity(max_tiles, floor=floor)
            tiles_cap = tiles_per_dev
            with tr.span("emit_tiles", root=False):
                tile_pair, tile_block, tile_row0 = emit_tiles(
                    pair_slot, pair_valid, s.slot_start, s.slot_size, s.block_n,
                    tiles_per_dev, pair_key=pair_lb,
                )
        return SearchPlan(
            qmc_pairs=qmc_pairs, pair_q=pair_q, pair_slot=pair_slot,
            pair_valid=pair_valid, schedule=schedule, n_queries=q_n,
            pairs_per_dev=pairs_per_dev, tile_pair=tile_pair,
            tile_block=tile_block, tile_row0=tile_row0,
            tiles_per_dev=tiles_cap, pair_lb=pair_lb, probed_ub=probed_ub,
            probed_sizes=probed_sizes, lost_q=schedule.lost_q, lost_c=schedule.lost_c,
        )

    def _plan_n_valid(self, plan: SearchPlan) -> np.ndarray:
        nv = np.take_along_axis(self.shards.slot_size, plan.pair_slot, axis=1)
        return np.where(plan.pair_valid, nv, 0)

    def plan_dev_rows(self, plan: SearchPlan) -> np.ndarray:
        """(ndev,) code rows the scan visits per device: real tiles x block_n
        on the tiles scan, the scheduled pairs' valid rows on windows."""
        if plan.scan == "tiles":
            real = (plan.tile_pair != plan.pairs_per_dev).sum(axis=1)
            return real.astype(np.int64) * self.shards.block_n
        return self._plan_n_valid(plan).sum(axis=1).astype(np.int64)

    def plan_tile_count(self, plan: SearchPlan) -> int:
        """Non-empty code tiles `plan` scans (all devices): the real tiles
        of the queue, or the window tiles holding a valid row."""
        if plan.scan == "tiles":
            return int((plan.tile_pair != plan.pairs_per_dev).sum())
        bn = self.shards.block_n
        return int(((self._plan_n_valid(plan) + bn - 1) // bn).sum())

    def scanned_rows(self, plan: SearchPlan) -> int:
        """The reference's row count of one execution of `plan` (all
        devices): the tile queue including dummy tiles (ndev *
        tiles_per_dev * block_n), or on the windows scan every pair slot
        padded to the window (ndev * pairs_per_dev * window) -- what the
        TPU kernel streams; the windows kernel here reads only the filled
        pairs' valid blocks (`plan_tile_count` tiles)."""
        if plan.scan == "tiles":
            return self.ndev * plan.tiles_per_dev * self.shards.block_n
        return self.ndev * plan.pairs_per_dev * self.shards.window

    def dispatch_plan(self, plan: SearchPlan, k: int) -> InFlightSearch:
        """Enqueue the device step without waiting for its results."""
        dev = self._device_put()
        ndev = self.ndev

        def put(a):
            return None if a is None else torch.as_tensor(a, device=self.device)

        pair_lb = (
            plan.pair_lb if plan.pair_lb is not None
            else np.full((ndev, plan.pairs_per_dev), -np.inf, np.float32)
        )
        query_bound = plan.query_bounds(k)
        out_d, out_i, prune_stats = sharded_search(
            dev["codes"], dev["vec_ids"], dev["slot_start"], dev["slot_size"],
            dev["combo_addrs"], dev["codebook"], plan.qmc_pairs, put(plan.pair_q),
            put(plan.pair_slot), put(plan.pair_valid),
            put(np.flatnonzero(plan.pair_valid).astype(np.int32)), put(plan.tile_pair),
            put(plan.tile_block), put(plan.tile_row0), put(pair_lb),
            put(query_bound), n_queries=plan.n_queries, k=k,
            block_n=self.shards.block_n, scan=plan.scan, path=self.kernel_path,
        )
        return InFlightSearch(
            out_d=out_d, out_i=out_i, plan=plan,
            dev_rows=self.plan_dev_rows(plan), prune_stats=prune_stats,
            query_bound=query_bound,
        ).record()

    def dispatch_rerank(
        self, handle: InFlightSearch, queries: np.ndarray, k_out: int
    ) -> InFlightSearch:
        """Chain the exact re-rank onto an in-flight ADC search (no host wait).

        ADC lanes with +inf distance are masked to -1 before re-scoring, as
        the reference does (they would otherwise come back as duplicates).
        `queries` are original-space (the raw store is never rotated); B3
        takes `rerank_block` candidates a thread block.
        """
        if self.raw is None:
            raise ValueError(
                "rerank='exact' needs a raw-vector store: build with "
                "rerank='exact' or pass xs to from_reference"
            )
        with self.tracer.span("rerank_dispatch", root=False, k_out=k_out):
            q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
            cand = torch.where(torch.isfinite(handle.out_d), handle.out_i, -1)
            out_d, out_i = sharded_rerank(
                self.raw, q, cand.to(torch.int32).contiguous(), k_out=k_out,
                block_k=self.rerank_block,
            )
            return dataclasses.replace(handle, out_d=out_d, out_i=out_i).record()

    def collect(self, handle: InFlightSearch) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched step; return host (dists, ids)."""
        return handle.out_d.cpu().numpy(), handle.out_i.cpu().numpy()

    def execute_plan(self, plan: SearchPlan, k: int) -> tuple[np.ndarray, np.ndarray]:
        """`dispatch_plan` + `collect`."""
        return self.collect(self.dispatch_plan(plan, k))

    def search(
        self, queries: np.ndarray, nprobe: int, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Full online path.  Returns (dists (Q, k), ids (Q, k)).

        With `rerank="exact"` the ADC scan overfetches `k_prime(k)`
        candidates and the re-rank re-selects the top k by exact f32
        distance (the distances returned are then exact).  With an active
        mutation layer (buffered inserts or tombstones) the main results
        are overfetched, filtered and merged with the delta's top-k
        (`retrieval.mutation.mutable_search`); otherwise this is the
        immutable path.
        """
        if self.mutation_active:
            from repro_torch.retrieval.mutation import mutable_search

            return mutable_search(self, queries, nprobe, k)
        plan = self.plan_batch(queries, nprobe)
        if self.rerank == "exact":
            handle = self.dispatch_plan(plan, self.k_prime(k))
            return self.collect(self.dispatch_rerank(handle, queries, k))
        return self.execute_plan(plan, k)
