"""DeltaIndex: the host-side mutation buffer of the online mutation path.

The main `IVFPQIndex` is immutable (cluster-sorted CSR storage packed into
device shards); live traffic mutates the corpus.  The delta layer takes the
mutations without touching the frozen index:

  * **inserts** are PQ-encoded at once with the index's own assignment and
    encoding (`core.index.assign_clusters` / `encode_vectors`, on the
    caller's device), so a later compaction equals a from-scratch re-encode,
    and appended to a buffer whose capacity grows in power-of-two buckets;
  * **deletes** become tombstones: a global id set filtered out of the main
    results at merge time, plus a dead-row mask for ids still buffered;
  * **search** (`delta_topk`) scans the buffer under the main index's probe
    semantics with the device kernels: B1 builds one table per (query,
    probed cluster) pair, and B5 scans a cluster-sorted view of the live
    rows, one window per pair (`DeltaView`);
  * **compaction** (`compact_index`) merges the live rows into the CSR
    storage and drops the tombstoned rows: within a cluster the surviving
    rows keep their order and the inserts follow in insertion order, the
    order `encode_index` gives (survivors, then inserts).

Everything here is index level; placement, shard and raw-store updates live
in `repro_torch.retrieval.mutation`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.index import IVFPQIndex, assign_clusters, encode_vectors, filter_clusters
from repro_torch.device import resolve_device
from repro_torch.kernels import adc_topk as _topk
from repro_torch.kernels import lut_build as _lut
from repro_torch.kernels import ops

# smallest delta capacity bucket
DELTA_FLOOR = 64
# rows per tile of the delta view: each cluster's run of live rows starts on
# a multiple of it (B5 scans whole tiles from a block-aligned start)
VIEW_BLOCK_N = 64
NCODES = 256


def _pow2(n: int, floor: int = DELTA_FLOOR) -> int:
    return max(floor, 1 << math.ceil(math.log2(max(n, 1))))


@dataclasses.dataclass
class DeltaView:
    """The live buffer rows sorted by cluster, as B5 scans them.

    Live rows are stably sorted by `assign` (insertion order within a
    cluster); cluster c's run starts at `starts[c]` (a multiple of
    `block_n`) and holds `counts[c]` rows.  Tensors live on `device`.

    Attributes:
      codes: (1, cap, M) uint8 codes, zero past each run.
      buf_row: (cap,) int64 buffer index of each view row, -1 on padding.
      starts: (C,) int32 first view row of each cluster's run.
      counts: (C,) int32 live rows of each cluster.
      max_count: the largest run.
    """

    codes: torch.Tensor
    buf_row: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    max_count: int
    block_n: int


@dataclasses.dataclass
class DeltaIndex:
    """Append buffer of PQ-encoded inserts + tombstone set for deletes.

    Rows [0, n) are occupied, in insertion order; arrays are padded to
    `capacity` (a power of two).  `dead[i]` marks a buffered row whose id
    was deleted again before compaction; `tombstones` is the global id set
    (main-index ids and dead buffered ids both appear there).  `version`
    counts the changes of the buffer, so that the device view and the
    re-rank store are rebuilt only when it changed.

    Attributes:
      codes: (capacity, M) uint8 PQ codes (residual vs assigned centroid).
      assign: (capacity,) int32 nearest coarse centroid per row.
      vec_ids: (capacity,) int32 global ids, -1 on unused rows.
      dead: (capacity,) bool, True where the row was tombstoned.
      n: occupied row count.
      tombstones: set of deleted global ids (cleared by compaction).
      vectors: (capacity, D) f32 original-space vectors of the inserts,
        allocated on the first insert (the exact re-rank and the raw-store
        update at compaction read them).
    """

    codes: np.ndarray
    assign: np.ndarray
    vec_ids: np.ndarray
    dead: np.ndarray
    n: int = 0
    tombstones: set[int] = dataclasses.field(default_factory=set)
    vectors: np.ndarray | None = None
    version: int = 0
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def create(cls, m: int, capacity: int = 4096) -> "DeltaIndex":
        cap = _pow2(capacity)
        return cls(
            codes=np.zeros((cap, m), np.uint8),
            assign=np.zeros(cap, np.int32),
            vec_ids=np.full(cap, -1, np.int32),
            dead=np.zeros(cap, bool),
        )

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]

    @property
    def occupancy(self) -> float:
        return self.n / self.capacity

    def live_mask(self) -> np.ndarray:
        """(capacity,) bool: occupied and not tombstoned."""
        mask = np.zeros(self.capacity, bool)
        mask[: self.n] = ~self.dead[: self.n]
        return mask

    @property
    def live_count(self) -> int:
        return int(self.n - self.dead[: self.n].sum())

    @property
    def tombstone_count(self) -> int:
        return len(self.tombstones)

    def tombstone_array(self) -> np.ndarray:
        """Sorted int64 view of the tombstone set (for vectorized isin)."""
        if not self.tombstones:
            return np.zeros(0, np.int64)
        return np.fromiter(sorted(self.tombstones), np.int64, count=len(self.tombstones))

    @property
    def active(self) -> bool:
        """True when searches must consult the delta layer at all."""
        return self.live_count > 0 or bool(self.tombstones)

    def _changed(self) -> None:
        self.version += 1
        self._cache.clear()

    def _grow(self, need: int) -> None:
        cap = _pow2(need, floor=self.capacity)
        if cap == self.capacity:
            return
        pad = cap - self.capacity
        self.codes = np.concatenate([self.codes, np.zeros((pad, self.codes.shape[1]), np.uint8)])
        self.assign = np.concatenate([self.assign, np.zeros(pad, np.int32)])
        self.vec_ids = np.concatenate([self.vec_ids, np.full(pad, -1, np.int32)])
        self.dead = np.concatenate([self.dead, np.zeros(pad, bool)])
        if self.vectors is not None:
            self.vectors = np.concatenate(
                [self.vectors, np.zeros((pad, self.vectors.shape[1]), np.float32)]
            )

    def insert(
        self,
        centroids: np.ndarray,
        codebook: np.ndarray,
        ids: np.ndarray,
        vectors: np.ndarray,
        rotation: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ) -> int:
        """Encode + append a batch of new vectors; returns rows appended.

        Ids must be fresh: re-using a tombstoned id would make the
        tombstone filter eat the new row, so it raises until a compaction.
        Assignment and encoding run on `device` (default cuda) with the
        index's own functions.  An OPQ `rotation` is refused (not ported,
        ROADMAP queue A item 11).
        """
        if rotation is not None:
            raise NotImplementedError(
                "inserts into an OPQ-rotated index are not ported to repro_torch yet; "
                "see ROADMAP.md queue A item 11"
            )
        dev = resolve_device(device)
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        b = ids.shape[0]
        if b == 0:
            return 0
        if vectors.shape[0] != b:
            raise ValueError(f"{b} ids vs {vectors.shape[0]} vectors")
        clash = self.tombstones.intersection(ids.tolist())
        if clash:
            raise ValueError(
                f"ids {sorted(clash)[:8]} were deleted earlier; re-inserting "
                "a tombstoned id is unsupported until after a compaction"
            )
        assign = assign_clusters(centroids, vectors, dev)
        codes = encode_vectors(codebook, centroids, vectors, assign, dev)
        if self.vectors is None:
            self.vectors = np.zeros((self.capacity, vectors.shape[1]), np.float32)
        self._grow(self.n + b)
        s = self.n
        self.codes[s : s + b] = codes.cpu().numpy()
        self.assign[s : s + b] = assign.cpu().numpy()
        self.vec_ids[s : s + b] = ids
        self.dead[s : s + b] = False
        self.vectors[s : s + b] = vectors
        self.n += b
        self._changed()
        return b

    def delete(self, ids: np.ndarray) -> int:
        """Tombstone a batch of global ids; returns newly tombstoned count.

        Ids living in the buffer are also marked dead, so the delta scan
        skips them without a set lookup; unknown ids are recorded too (they
        may name main-index rows).
        """
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        new = 0
        for i in ids.tolist():
            if int(i) not in self.tombstones:
                self.tombstones.add(int(i))
                new += 1
        if self.n:
            self.dead[: self.n] |= np.isin(self.vec_ids[: self.n], ids)
        self._changed()
        return new

    def reset(self) -> None:
        """Empty the buffer + tombstones, keeping capacity (post-compaction)."""
        self.n = 0
        self.dead[:] = False
        self.vec_ids[:] = -1
        self.tombstones = set()
        self._changed()

    # ------------------------------------------------------------------ #

    def view(self, n_clusters: int, device: torch.device,
             block_n: int = VIEW_BLOCK_N) -> DeltaView:
        """The cluster-sorted view of the live rows on `device` (cached
        until the buffer changes)."""
        key = ("view", str(device), n_clusters, block_n)
        if key in self._cache:
            return self._cache[key]
        live = np.flatnonzero(self.live_mask())
        a = self.assign[live].astype(np.int64)
        rows = live[np.argsort(a, kind="stable")]
        counts = np.bincount(a, minlength=n_clusters).astype(np.int64)
        span = (counts + block_n - 1) // block_n * block_n
        starts = np.zeros(n_clusters, np.int64)
        np.cumsum(span[:-1], out=starts[1:])
        cap = max(int(span.sum()), block_n)
        within = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
        dest = np.repeat(starts, counts) + within
        codes = np.zeros((cap, self.codes.shape[1]), np.uint8)
        codes[dest] = self.codes[rows]
        buf_row = np.full(cap, -1, np.int64)
        buf_row[dest] = rows
        v = DeltaView(
            codes=torch.as_tensor(codes, device=device)[None],
            buf_row=torch.as_tensor(buf_row, device=device),
            starts=torch.as_tensor(starts.astype(np.int32), device=device),
            counts=torch.as_tensor(counts.astype(np.int32), device=device),
            max_count=int(counts.max(initial=0)),
            block_n=block_n,
        )
        self._cache[key] = v
        return v

    def device_store(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The buffered vectors as a one-device store on `device` for B3
        (cached until the buffer changes): (vectors (n, D) f32, id_dev (n,)
        int32 zeros, id_row (n,) int32 the buffer row, row_base (1,) int64
        zero), so that a candidate is its buffer row."""
        key = ("store", str(device))
        if key not in self._cache:
            n = self.n
            self._cache[key] = (
                torch.as_tensor(np.ascontiguousarray(self.vectors[:n]), device=device),
                torch.zeros(n, dtype=torch.int32, device=device),
                torch.arange(n, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int64, device=device),
            )
        return self._cache[key]

    def ids_of(self, rows: torch.Tensor) -> torch.Tensor:
        """int32 global ids of buffer rows (a tensor, -1 where -1)."""
        key = ("ids", str(rows.device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.vec_ids, device=rows.device)
        return torch.where(rows >= 0, self._cache[key][rows.long().clamp_min(0)], -1)


# ---------------------------------------------------------------------- #
# delta search: the main index's probe semantics, on kernels B1 + B5
# ---------------------------------------------------------------------- #


def _merge_pairs(vals: torch.Tensor, buf: torch.Tensor, k: int):
    """Per query, the k smallest of its pairs' entries by (distance, buffer
    index): vals / buf (Q, E), buf -1 where empty.  Returns (dists (Q, k),
    buffer rows (Q, k) int64), (+inf, -1) past the entries."""
    big = torch.iinfo(torch.int64).max
    key = torch.where(buf >= 0, buf, big)
    by_buf = torch.sort(key, dim=1, stable=True).indices
    v1 = vals.gather(1, by_buf)
    by_val = torch.sort(v1, dim=1, stable=True).indices[:, :k]
    sel = by_buf.gather(1, by_val)
    d = vals.gather(1, sel)
    r = torch.where(torch.isfinite(d), buf.gather(1, sel), -1)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.nn.functional.pad(d, (0, pad), value=torch.inf)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    return d, r


def _probe(centroids, queries, nprobe: int, dev: torch.device):
    cent = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    return filter_clusters(cent, q, nprobe)


def _check_k(delta: DeltaIndex, k: int) -> None:
    if k > delta.capacity:
        raise ValueError(
            f"k={k} > delta capacity {delta.capacity}; create the delta "
            f"with capacity >= k"
        )


@dataclasses.dataclass
class DeltaScan:
    """The inputs of one delta scan (B5 over the view), as `delta_topk`
    launches it: one pair per (query, probe slot), pair `q * nprobe + j`.

    Attributes:
      view: the buffer's `DeltaView`.
      tables: (R, M * 256) f32 B1 tables of the filled pairs (a probed
        cluster holding live rows), R >= 0.
      lut_row: (1, P) int32 table row of each pair, -1 unfilled.
      starts, n_valid: (1, P) int32 each pair's run in the view.
      pair_q: (1, P) int32 the pair's query.
      bound: (Q,) f32 the drop bound (+inf: none).
      k_pair: each pair's list length.
    """

    view: DeltaView
    tables: torch.Tensor
    lut_row: torch.Tensor
    starts: torch.Tensor
    n_valid: torch.Tensor
    pair_q: torch.Tensor
    bound: torch.Tensor
    k_pair: int

    @property
    def filled(self) -> int:
        return self.tables.shape[0]


def plan_delta_scan(
    delta: DeltaIndex,
    centroids: np.ndarray,
    codebook: np.ndarray,
    queries: np.ndarray,
    nprobe: int,
    k: int,
    bound: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> DeltaScan:
    """Probe the queries (`filter_clusters`), build the tables of the
    filled (query, probe) pairs (B1) and lay out B5's pair arrays over the
    cluster-sorted view (`delta_topk`'s first half)."""
    _check_k(delta, k)
    dev = resolve_device(device)
    q_n = np.asarray(queries).shape[0]
    probed, qmc = _probe(centroids, queries, nprobe, dev)
    view = delta.view(centroids.shape[0], dev)
    cb = torch.as_tensor(np.asarray(codebook, np.float32), device=dev)
    m, _, dsub = cb.shape
    n_valid = view.counts[probed].reshape(1, -1)
    starts = view.starts[probed].reshape(1, -1)
    filled = torch.nonzero(n_valid[0] > 0).flatten().to(torch.int32)
    lut_row = torch.full_like(n_valid, -1)
    lut_row[0, filled.long()] = torch.arange(filled.shape[0], dtype=torch.int32, device=dev)
    if filled.shape[0]:
        tables = ops.build_luts(cb, qmc.reshape(q_n * nprobe, m, dsub), filled)
    else:
        tables = torch.zeros((0, m, NCODES), dtype=torch.float32, device=dev)
    bnd = torch.full((q_n,), torch.inf, dtype=torch.float32, device=dev)
    if bound is not None:
        bnd = torch.as_tensor(np.asarray(bound, np.float32), device=dev)
    # a pair holds at most max_count rows, so a list of max_count + 1 never
    # fills: its k-th stays +inf and B5's per-query bound (the least k-th
    # of a query's pairs) never drops a row the query's merged top-k needs
    return DeltaScan(
        view=view, tables=tables.reshape(filled.shape[0], m * NCODES), lut_row=lut_row,
        starts=starts, n_valid=n_valid,
        pair_q=torch.arange(q_n, dtype=torch.int32, device=dev).repeat_interleave(nprobe)[None],
        bound=bnd, k_pair=max(1, min(k, view.max_count + 1)),
    )


def delta_topk_rows(
    delta: DeltaIndex,
    centroids: np.ndarray,
    codebook: np.ndarray,
    queries: np.ndarray,
    nprobe: int,
    k: int,
    bound: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`delta_topk` on the device, by buffer row: (dists (Q, k) f32 with
    +inf padding, buffer rows (Q, k) int64 with -1) tensors on `device`."""
    scan = plan_delta_scan(delta, centroids, codebook, queries, nprobe, k, bound, device)
    dev = scan.tables.device
    q_n = scan.bound.shape[0]
    if scan.filled:
        vals, rows, _ = ops.adc_topk_windows(
            scan.tables, scan.view.codes, scan.starts, scan.n_valid, scan.k_pair,
            lut_row=scan.lut_row, block_n=scan.view.block_n, pair_q=scan.pair_q,
            bound=scan.bound,
        )
    else:
        shape = (1, scan.lut_row.shape[1], scan.k_pair)
        vals = torch.full(shape, torch.inf, device=dev)
        rows = torch.full(shape, -1, dtype=torch.int32, device=dev)
    vrow = scan.starts[0, :, None].long() + rows[0].long()
    buf = torch.where(rows[0] >= 0, scan.view.buf_row[vrow.clamp_min(0)], -1)
    return _merge_pairs(vals[0].reshape(q_n, -1), buf.reshape(q_n, -1), k)


def delta_topk(
    delta: DeltaIndex,
    centroids: np.ndarray,
    codebook: np.ndarray,
    queries: np.ndarray,
    nprobe: int,
    k: int,
    bound: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k of the delta buffer under the main index's probe semantics.

    A live buffered row competes for query q iff its cluster is among q's
    `nprobe` probed clusters, and its distance is the ADC sum over the
    table of (q, that cluster) -- the value the main scan gives the same
    codes after compaction, from the same kernel (B5) in the same order.
    `bound` ((Q,) or None = +inf) drops rows whose distance is above it.
    Ties go to the lower buffer index.  Runs on `device` (default cuda):
    B1 builds the tables of the (query, probe) pairs whose cluster holds
    live rows, B5 scans each pair's run of the cluster-sorted view
    (`DeltaIndex.view`, `plan_delta_scan`), and the per-pair lists are
    merged per query by (distance, buffer index) (`delta_topk_rows`).  On
    the CPU both kernels run their plain versions.  Returns (dists (Q, k)
    f32 with +inf padding, ids (Q, k) int32 with -1).
    """
    d, r = delta_topk_rows(delta, centroids, codebook, queries, nprobe, k, bound, device)
    return d.cpu().numpy(), delta.ids_of(r).cpu().numpy()


def delta_topk_plain(
    delta: DeltaIndex,
    centroids: np.ndarray,
    codebook: np.ndarray,
    queries: np.ndarray,
    nprobe: int,
    k: int,
    bound: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """`delta_topk`'s function written as the reference's formula, in plain
    PyTorch: plain tables of every (query, probe) pair, each live row
    matched against its query's probe list, its entries added in column
    order (the kernels' order), masked top-k by (distance, buffer index).
    The check the kernel route is held to (bit-equal); nothing on the query
    path calls it."""
    _check_k(delta, k)
    dev = resolve_device(device)
    q_n = np.asarray(queries).shape[0]
    probed, qmc = _probe(centroids, queries, nprobe, dev)
    cb = torch.as_tensor(np.asarray(codebook, np.float32), device=dev)
    m, _, dsub = cb.shape
    luts = _lut.build_luts_plain(cb, qmc.reshape(q_n * nprobe, m, dsub))
    luts = luts.reshape(q_n, nprobe * m * NCODES)
    cap = delta.capacity
    assign = torch.as_tensor(delta.assign, device=dev).long()
    alive = torch.as_tensor(delta.live_mask(), device=dev)
    addr = (torch.arange(m, device=dev) * NCODES)[None] + torch.as_tensor(
        delta.codes, device=dev).long()                                  # (cap, M)
    match = probed[:, :, None] == assign[None, None, :]                    # (Q, nprobe, cap)
    found = match.any(dim=1) & alive[None]
    col = match.int().argmax(dim=1)                                        # (Q, cap)
    idx = col[:, :, None] * (m * NCODES) + addr[None]                      # (Q, cap, M)
    g = luts.gather(1, idx.reshape(q_n, -1)).reshape(q_n, cap, m)
    d = _topk.sum_columns(g)
    if bound is not None:
        bnd = torch.as_tensor(np.asarray(bound, np.float32), device=dev)
        found &= d <= bnd[:, None]
    d = torch.where(found, d, torch.inf)
    sel = torch.sort(d, dim=1, stable=True).indices[:, :k]
    out_d = d.gather(1, sel)
    ids = torch.as_tensor(delta.vec_ids, device=dev)[sel]
    out_i = torch.where(torch.isfinite(out_d), ids, -1)
    return out_d.cpu().numpy(), out_i.cpu().numpy().astype(np.int32)


def merge_results(main_d, main_i, delta_d, delta_i, tombstones, k: int):
    """Compose tombstone filtering with the top-k merge.

    Tombstoned main-path hits are masked to (+inf, -1), the encoding of a
    pruned lane; surviving candidates keep their order and main-path rows
    win ties against delta rows (the post-compaction layout, where old rows
    precede inserted rows within a cluster).  `main_d` / `main_i` are
    (Q, k_fetch) with k_fetch >= k; `delta_d` / `delta_i` (Q, kd),
    tombstone-free, or None; `tombstones` the deleted ids.  numpy arrays
    in, numpy out (the reference's host merge), or tensors of one device
    in, tensors out (the mutable search merges on the card).  Returns
    (dists (Q, k), ids (Q, k)).
    """
    host = not isinstance(main_d, torch.Tensor)
    md, mi = torch.as_tensor(main_d), torch.as_tensor(main_i)
    tomb = torch.as_tensor(np.asarray(tombstones) if host else tombstones, device=md.device)
    if tomb.numel():
        hit = torch.isin(mi.long(), tomb.long())
        md = torch.where(hit, torch.inf, md)
        mi = torch.where(hit, -1, mi)
    if delta_d is not None:
        md = torch.cat([md, torch.as_tensor(delta_d, device=md.device)], dim=1)
        mi = torch.cat([mi, torch.as_tensor(delta_i, device=md.device).to(mi.dtype)], dim=1)
    if not (md.shape[1] == k and tomb.numel() == 0 and delta_d is None):
        sel = torch.sort(md, dim=1, stable=True).indices[:, :k]
        md, mi = md.gather(1, sel), mi.gather(1, sel)
    return (md.numpy(), mi.numpy()) if host else (md, mi)


# ---------------------------------------------------------------------- #
# compaction (index level)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class CompactionDelta:
    """What a compaction changed, per cluster (consumed by re-placement)."""

    old_sizes: np.ndarray        # (C,) rows per cluster before
    new_sizes: np.ndarray        # (C,) rows per cluster after
    content_changed: np.ndarray  # (C,) bool: any row added or removed
    merged: int                  # live delta rows merged in
    dropped: int                 # tombstoned rows removed (main + delta)


def isin_ids(ids: np.ndarray, values: np.ndarray) -> np.ndarray:
    """`np.isin(ids, values)` through a table over ids' range: one pass,
    where isin sorts ids and values together (seconds at 100M ids)."""
    if ids.size == 0 or values.size == 0:
        return np.zeros(ids.shape, bool)
    lo, hi = int(ids.min()), int(ids.max())
    table = np.zeros(hi - lo + 1, bool)
    table[values[(values >= lo) & (values <= hi)] - lo] = True
    return table[ids - lo if lo else ids]


def compact_index(index: IVFPQIndex, delta: DeltaIndex) -> tuple[IVFPQIndex, CompactionDelta]:
    """Merge the delta buffer into the CSR index, dropping tombstoned rows.

    Within each cluster the output keeps the surviving rows in their stored
    order, then the live inserts in insertion order: the row order
    `encode_index` gives (survivors, then inserts), so the compacted index
    equals a from-scratch re-encode of the surviving vectors.  The order of
    the reference's stable argsort is built without a sort: the survivors
    keep their global order, and each insert goes after its cluster's
    survivors.  Does not mutate its inputs.
    """
    c_n = index.n_clusters
    old_sizes = index.cluster_sizes().astype(np.int64)
    keep = ~isin_ids(index.vec_ids, delta.tombstone_array())
    live = delta.live_mask()[: delta.n]
    d_assign = delta.assign[: delta.n][live].astype(np.int64)

    starts = index.offsets[:-1]
    kept_before = np.zeros(index.n_vectors + 1, np.int64)  # kept rows before row i
    np.cumsum(keep, out=kept_before[1:])
    kept = kept_before[index.offsets[1:]] - kept_before[starts]
    added = np.bincount(d_assign, minlength=c_n).astype(np.int64)
    new_sizes = kept + added
    offsets = np.zeros(c_n + 1, np.int64)
    np.cumsum(new_sizes, out=offsets[1:])
    n_new = int(offsets[-1])

    # live inserts: after their cluster's survivors, in insertion order
    order = np.argsort(d_assign, kind="stable")
    rank = np.empty(d_assign.size, np.int64)
    rank[order] = np.arange(d_assign.size) - np.repeat(np.cumsum(added) - added, added)
    dst_delta = offsets[d_assign] + kept[d_assign] + rank
    main_pos = np.ones(n_new, bool)
    main_pos[dst_delta] = False

    codes = np.empty((n_new, index.m), np.uint8)
    vec_ids = np.empty(n_new, np.int32)
    codes[main_pos] = index.codes[keep]
    vec_ids[main_pos] = index.vec_ids[keep]
    codes[dst_delta] = delta.codes[: delta.n][live]
    vec_ids[dst_delta] = delta.vec_ids[: delta.n][live]
    new_index = IVFPQIndex(
        centroids=index.centroids, codebook=index.codebook, codes=codes,
        vec_ids=vec_ids, offsets=offsets, rotation=index.rotation,
    ).validate()

    removed = old_sizes - kept
    return new_index, CompactionDelta(
        old_sizes=old_sizes,
        new_sizes=new_sizes,
        content_changed=(removed > 0) | (added > 0),
        merged=int(live.sum()),
        dropped=int(removed.sum() + (delta.n - live.sum())),
    )
