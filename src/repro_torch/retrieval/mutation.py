"""Online mutation glue: delta inserts / deletes and incremental compaction,
threaded through the engine.

`repro_torch.core.delta` owns the index-level pieces (the `DeltaIndex`
buffer, the delta scan on kernels B1 + B5, `compact_index`); this module
wires them into the engine:

  insert / delete  ->  DeltaIndex (host buffer; codes from the index's own
                       assignment and encoding, on the engine's device)
  search           ->  the main device step (overfetched when tombstones
                       exist) merged with the delta top-k; with
                       rerank="exact" both run the cascade (B3) first
  compact          ->  `compact_index` (equal to a from-scratch re-encode)
                       + `update_placement` (Algorithm 1 for the clusters
                       that moved past the threshold) + `update_shards`
                       (affected device regions only; co-occurrence shards
                       re-mine and re-encode the changed clusters) +
                       `update_raw_store`

Delta rows always scan with plain codes (address m * 256 + code), even
when the main shards are co-occurrence encoded: re-encoding happens only at
compaction.
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch.core.delta import (
    DeltaIndex,
    compact_index,
    delta_topk,
    delta_topk_rows,
    merge_results,
)
from repro_torch.core.placement import update_placement
from repro_torch.kernels import ops
from repro_torch.retrieval.layout import update_raw_store, update_shards

if typing.TYPE_CHECKING:  # circular at runtime (the engine imports this module)
    from repro_torch.retrieval.engine import MemANNSEngine

# the compaction's stages, in order (`CompactionReport.stage_seconds`)
STAGES = ("compact_index", "update_placement", "update_shards", "update_raw_store")


@dataclasses.dataclass
class CompactionReport:
    """What one compaction did (and what it cost).

    `stage_seconds` holds the wall seconds of each of `STAGES` (the device
    synchronised at each boundary); a stage that did not run reads 0.0.
    """

    merged: int                 # live delta rows merged into the main index
    dropped: int                # tombstoned rows removed (main + delta)
    clusters_changed: int       # clusters whose rows changed
    clusters_replaced: int      # clusters Algorithm 1 re-placed
    devices_rewritten: int      # device regions repacked by update_shards
    shapes_changed: bool        # any shard or raw-store array grew
    latency_s: float
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"compaction: +{self.merged}/-{self.dropped} rows, "
            f"{self.clusters_changed} clusters changed "
            f"({self.clusters_replaced} re-placed), "
            f"{self.devices_rewritten} devices rewritten, "
            f"shapes_changed={self.shapes_changed}, "
            f"{1e3 * self.latency_s:.1f}ms"
        )


def ensure_delta(engine: "MemANNSEngine", capacity: int = 4096) -> DeltaIndex:
    """Allocate the engine's delta buffer on first use (idempotent)."""
    if engine.delta is None:
        engine.delta = DeltaIndex.create(engine.index.m, capacity)
    return engine.delta


def insert_into(engine: "MemANNSEngine", ids: np.ndarray, vectors: np.ndarray) -> int:
    """PQ-encode (on the engine's device) and buffer new vectors; visible
    to the very next search."""
    delta = ensure_delta(engine)
    return delta.insert(
        engine.index.centroids, engine.index.codebook, ids, vectors,
        rotation=engine.index.rotation, device=engine.device,
    )


def delete_from(engine: "MemANNSEngine", ids: np.ndarray) -> int:
    """Tombstone ids (main-index or delta); filtered from the next search."""
    return ensure_delta(engine).delete(ids)


def engine_delta_topk(
    engine: "MemANNSEngine", queries: np.ndarray, nprobe: int, k: int,
    bound: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Delta-buffer top-k under the engine's probe semantics, on the
    engine's device (B1 + B5); `bound` as `delta_topk`'s."""
    return delta_topk(
        engine.delta, engine.index.centroids, engine.index.codebook,
        np.asarray(engine.index.rotate(queries), np.float32), nprobe, k,
        bound=bound, device=engine.device,
    )


def rerank_rows(delta: DeltaIndex, queries: torch.Tensor, rows: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank of delta candidates given as buffer rows (kernel
    B3 over `delta.device_store`): (dists, rows) tensors, each query's
    candidates sorted by exact distance (stable: ties by candidate
    position), (+inf, -1) where the row is -1."""
    dists = ops.rerank_dists(queries, rows.to(torch.int32).contiguous(),
                             *delta.device_store(queries.device))
    sel = torch.sort(dists, dim=1, stable=True).indices
    out_d = dists.gather(1, sel)
    return out_d, torch.where(torch.isfinite(out_d), rows.gather(1, sel), -1)


def delta_prune_bound(
    engine: "MemANNSEngine", plan, k: int, k_fetch: int, tombstones: int
) -> np.ndarray | None:
    """Sound (Q,) distance cutoff for the delta scan, or None when unsafe.

    The merged-and-filtered k-th distance is bounded by the value at which
    the probed clusters hold `k + tombstones` rows -- while the fetch window
    holds that many (`k_fetch >= k + tombstones`); past it (potential
    starvation) the delta scan runs unbounded.
    """
    if not plan.pruned or k_fetch < k + tombstones:
        return None
    bound = plan.query_bounds(k + tombstones)
    return bound if np.isfinite(bound).any() else None


def fetch_depth(engine: "MemANNSEngine", k: int, tombstones: int,
                overfetch: int | None = None) -> int:
    """The main path's candidate count under mutation (the reference's
    rule): k + overfetch (default k) when tombstones exist, else k; with
    rerank="exact", the pow2 bucket of k' + tombstones (floor k').  Any
    depth: past `ops.SCAN_K_MAX` the scans run their WIDE block."""
    from repro_torch.retrieval.engine import round_capacity

    over = k + (overfetch if overfetch is not None else k)
    if engine.rerank == "exact":
        kp = engine.k_prime(k)
        base = kp + tombstones if tombstones else kp
        k_fetch = round_capacity(max(base, over if tombstones else 0), floor=kp)
    else:
        k_fetch = over if tombstones else k
    return k_fetch


def mutable_search(
    engine: "MemANNSEngine",
    queries: np.ndarray,
    nprobe: int,
    k: int,
    pairs_per_dev: int | None = None,
    overfetch: int | None = None,
    live: np.ndarray | None = None,
    timings: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The online path over (main index - tombstones) + delta buffer.

    `pairs_per_dev` and `live` go to `plan_batch` (a fixed pair capacity;
    the live-device mask of replica failover).  The delta scan does not
    depend on the devices, so under a mask only the main path loses
    coverage.

    Fetches `fetch_depth` candidates from the main path, so the tombstone
    filter can absorb the deleted rows, merges the delta top-k, and returns
    (dists (Q, k), ids (Q, k)).  A query whose whole fetch window is
    tombstoned comes back padded with (+inf, -1); compaction restores
    exact results.  With `rerank="exact"` both sources run the cascade
    before the merge: the main path re-ranks all its k_fetch candidates,
    and the delta's (an unbounded ADC scan: the pruning bound is an ADC
    bound, which a row can beat on exact distance) are re-scored by B3
    against the delta's vectors.  Everything stays on the engine's device
    until the merged (Q, k) result.  `timings`, when given, receives the
    wall ms of the main step (`main_ms`), the delta scan
    (`delta_scan_ms`), its re-rank (`delta_rerank_ms`) and the merge
    (`merge_ms`), the device synchronised at each boundary, and under
    `launches` the kernel launches of each of those stages.
    """
    delta = engine.delta
    dev = engine.device
    tomb = delta.tombstone_array() if delta is not None else np.zeros(0, np.int64)
    k_fetch = fetch_depth(engine, k, tomb.size, overfetch)
    rerank = engine.rerank == "exact"
    clock = _Clock(dev, timings)
    plan = engine.plan_batch(queries, nprobe, pairs_per_dev=pairs_per_dev, live=live)
    handle = engine.dispatch_plan(plan, k_fetch)
    if rerank:
        handle = engine.dispatch_rerank(handle, queries, k_fetch)
    clock.lap("main_ms")
    delta_d = delta_i = None
    if delta is not None and delta.live_count > 0:
        cent, cb = engine.index.centroids, engine.index.codebook
        q = np.asarray(engine.index.rotate(queries), np.float32)
        if rerank:
            kd = min(k_fetch, delta.capacity)
            delta_d, rows = delta_topk_rows(delta, cent, cb, q, nprobe, kd, device=dev)
            clock.lap("delta_scan_ms")
            delta_d, rows = rerank_rows(
                delta, torch.as_tensor(np.asarray(queries, np.float32), device=dev), rows)
            clock.lap("delta_rerank_ms")
        else:
            bound = delta_prune_bound(engine, plan, k, k_fetch, tomb.size)
            delta_d, rows = delta_topk_rows(delta, cent, cb, q, nprobe, k, bound, dev)
            clock.lap("delta_scan_ms")
        delta_i = delta.ids_of(rows)
    out_d, out_i = merge_results(handle.out_d, handle.out_i, delta_d, delta_i,
                                 torch.as_tensor(tomb, device=dev), k)
    out = out_d.cpu().numpy(), out_i.cpu().numpy()
    clock.lap("merge_ms")
    return out


class _Clock:
    """Lap timer of `mutable_search` and `compact_engine` (a no-op without a
    `timings` dict): each lap records its wall ms under its name and, under
    `timings["launches"][name]`, the kernel launches counted in it
    (`ops.launches`, the non-zero changes)."""

    def __init__(self, device: torch.device, timings: dict | None):
        self.device, self.timings = device, timings
        if timings is not None:
            timings.setdefault("launches", {})
            self.t, self.counts = self._now(), dict(ops.launches)

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is not None:
            t, counts = self._now(), dict(ops.launches)
            self.timings[name] = 1e3 * (t - self.t)
            self.timings["launches"][name] = {
                k: n - self.counts.get(k, 0) for k, n in counts.items()
                if n != self.counts.get(k, 0)}
            self.t, self.counts = t, counts


def compact_engine(engine: "MemANNSEngine", replace_threshold: float = 0.25) -> CompactionReport:
    """Merge the delta into the main index and refresh placement + shards.

    A cluster goes back through Algorithm 1 only when its size moved by
    more than `replace_threshold` of its old size; the others keep their
    devices, so `update_shards` leaves those regions as they are.  The
    device copies of the packed arrays are dropped (re-uploaded on the
    next search); the raw store is updated in place on its device.
    """
    t0 = time.perf_counter()
    delta = engine.delta
    if delta is None or not delta.active:
        return CompactionReport(0, 0, 0, 0, 0, False, 0.0, dict.fromkeys(STAGES, 0.0))
    clock = _Clock(engine.device, {})
    tr = engine.tracer  # child-only spans: they record under a compaction span

    with tr.span("compact_index", root=False):
        new_index, info = compact_index(engine.index, delta)
    clock.lap("compact_index")
    grew = np.abs(info.new_sizes - info.old_sizes)
    replace = info.content_changed & (grew > replace_threshold * np.maximum(info.old_sizes, 1))
    freqs = (
        engine.freqs if engine.freqs is not None
        else np.ones(new_index.n_clusters) / new_index.n_clusters
    )
    with tr.span("update_placement", root=False):
        new_placement = update_placement(
            engine.placement, new_index.cluster_sizes().astype(np.float64), freqs, replace,
            centroids=new_index.centroids,
        )
    clock.lap("update_placement")
    old = engine.shards
    old_shapes = (old.codes.shape, old.slot_start.shape, old.window)
    engine._dev_arrays = None  # free the old device copies before the repack
    with tr.span("update_shards", root=False):
        new_shards, rewritten = update_shards(
            new_index, new_placement, old, info.content_changed, device=engine.device
        )
    clock.lap("update_shards")
    shapes_changed = old_shapes != (
        new_shards.codes.shape, new_shards.slot_start.shape, new_shards.window
    )
    engine.index, engine.placement, engine.shards = new_index, new_placement, new_shards
    if engine.raw is not None:
        live = delta.live_mask()[: delta.n]
        add_ids = delta.vec_ids[: delta.n][live].astype(np.int64)
        if add_ids.size and delta.vectors is None:
            raise RuntimeError(
                "raw store attached but the delta kept no vectors; inserts must go "
                "through insert_into / DeltaIndex.insert"
            )
        add_vecs = (
            delta.vectors[: delta.n][live] if delta.vectors is not None
            else np.zeros((0, engine.raw.dim), np.float32)
        )
        home = np.array([r[0] if r else 0 for r in new_placement.replicas], np.int64)
        with tr.span("update_raw_store", root=False):
            engine.raw, raw_changed = update_raw_store(
                engine.raw, add_ids, add_vecs, delta.tombstone_array(),
                add_home=home[delta.assign[: delta.n][live]],
            )
        shapes_changed = shapes_changed or raw_changed
        clock.lap("update_raw_store")
    delta.reset()
    return CompactionReport(
        merged=info.merged,
        dropped=info.dropped,
        clusters_changed=int(info.content_changed.sum()),
        clusters_replaced=int(replace.sum()),
        devices_rewritten=int(rewritten.size),
        shapes_changed=shapes_changed,
        latency_s=time.perf_counter() - t0,
        stage_seconds={s: clock.timings.get(s, 0.0) / 1e3 for s in STAGES},
    )
