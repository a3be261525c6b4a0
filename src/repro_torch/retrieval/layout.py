"""Pack an IVFPQ index + Algorithm-1 placement into per-device storage.

Every array carries a leading `ndev` dimension: the JAX package shards it
over its `"dpu"` mesh axis; here it is a logical-device axis on one card.
Cluster slots are block-aligned so the scan kernel's tiles never straddle
two clusters.

Code storage:
  * plain shards (default): the paper's raw uint8 codes; the scan kernels
    add the column offset m * 256 themselves (`add_offsets`);
  * co-occurrence shards (`use_cooc=True`, paper §4.3): every cluster's
    mined combos re-encode its rows as direct addresses into the pair's
    [LUT (M*256) | combo sums | 0] table, stored as uint16 (int32 with
    `compact_dtype=False`) at the width of the longest re-encoded row and
    padded with the sentinel address (the table's final 0.0).  Mining,
    re-encoding and packing run batched on the build device
    (`core.cooc.mine_clusters` / `reencode_rows`);
  * plain shards with `compact_dtype=False`: int32 direct addresses
    m * 256 + code.

Table layout per (query, cluster) pair: [LUT (M*256) | combo sums | 0].
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.cooc import mine_clusters, reencode_rows
from repro_torch.core.index import IVFPQIndex
from repro_torch.core.placement import Placement
from repro_torch.device import resolve_device

NCODES = 256
# replicated rows per packing chunk of the co-occurrence codes
_PACK_CHUNK = 1 << 24


@dataclasses.dataclass
class DeviceShards:
    """Device-sharded MemANNS code storage (leading dim = ndev everywhere).

    Host numpy arrays, except the codes of co-occurrence shards, which are
    built on the card and stay there as a tensor; the engine keeps a
    device copy of the rest.
    """

    codes: np.ndarray | torch.Tensor  # (ndev, cap, W): uint8 raw codes
                             # (add_offsets) or uint16 / int32 direct
                             # addresses; co-occurrence codes are a tensor
                             # on the build device
    vec_ids: np.ndarray      # (ndev, cap) int32, -1 on padding
    slot_start: np.ndarray   # (ndev, S) int32 block-aligned row starts
    slot_size: np.ndarray    # (ndev, S) int32 valid rows per slot
    slot_cluster: np.ndarray # (ndev, S) int32 cluster id, -1 for empty slot
    combo_addrs: np.ndarray  # (ndev, S, n_combos, L) int32 flat combo item
                             # addresses col * 256 + code (n_combos = 0
                             # for plain shards)
    local_slot: np.ndarray   # (ndev, C) int32 slot of cluster c on dev d, -1
    m_subspaces: int
    n_combos: int
    block_n: int
    window: int              # per-pair scan window (largest cluster, aligned)
    add_offsets: bool = True  # codes are raw uint8; the kernel adds offsets
    # co-occurrence knobs the shards were built with
    min_length_reduction: float = 0.0
    mine_rows: int = 50_000

    @property
    def ndev(self) -> int:
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        return self.codes.shape[2]

    @property
    def table_size(self) -> int:
        return self.m_subspaces * NCODES + self.n_combos + 1

    @property
    def sentinel(self) -> int:
        return self.table_size - 1

    def bytes_per_device(self) -> int:
        itemsize = (self.codes.element_size() if isinstance(self.codes, torch.Tensor)
                    else self.codes.dtype.itemsize)
        return int(self.codes.shape[1] * self.width * itemsize)


def _align(x: int, b: int) -> int:
    return (x + b - 1) // b * b


# minimum row headroom the mutable window slack must cover regardless of
# the tuned tile height (same constant as the reference layout)
WINDOW_SLACK_ROWS = 512


def default_slack(block_n: int, mutable: bool) -> tuple[float, int, int]:
    """(cap_slack, slot_slack, window_slack) derived from the tile height.

    Immutable builds take no slack (exact packing); mutable builds reserve
    50% row capacity, 4 spare cluster slots, and at least 2 blocks /
    `WINDOW_SLACK_ROWS` rows of window headroom.
    """
    if not mutable:
        return 0.0, 0, 0
    window_blocks = max(2, -(-WINDOW_SLACK_ROWS // max(block_n, 1)))
    return 0.5, 4, window_blocks


def _tick(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _encode_clusters(
    index: IVFPQIndex, clusters: np.ndarray, n_combos: int, combo_len: int,
    min_length_reduction: float, mine_rows: int, dev: torch.device,
    stats: dict | None = None,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
    """The stored co-occurrence rows of the given clusters, each cluster
    mined (seeded by its id) and re-encoded as the reference's
    `_mine_cluster` / `_encode_cluster` do.

    Returns (rows (n, M) int32 tensor on `dev`: the clusters' rows one
    cluster after another, each in CSR order, sentinel past its length;
    combo addresses (len(clusters), n_combos, L) int32; plain (len,) bool:
    the cluster keeps plain direct addresses (empty, or its mean length
    reduction below `min_length_reduction`); natural width (len,) int64:
    M for a plain cluster, else its longest row, at least 1).
    """
    m = index.m
    clusters = np.asarray(clusters, np.int64)
    sizes = index.cluster_sizes()[clusters].astype(np.int64)
    n_sel = len(clusters)
    t0 = _tick(dev)
    if n_sel == index.n_clusters and (clusters == np.arange(n_sel)).all():
        codes = torch.as_tensor(index.codes, device=dev)
        offsets = index.offsets
    else:
        lo = index.offsets[clusters]
        first = np.repeat(np.cumsum(sizes) - sizes, sizes)
        sel = np.repeat(lo, sizes) + np.arange(int(sizes.sum())) - first
        codes = torch.as_tensor(index.codes[sel], device=dev)
        offsets = np.zeros(n_sel + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
    cols, cods, _, _ = mine_clusters(
        codes, offsets, np.arange(n_sel), n_combos=n_combos, combo_len=combo_len,
        max_rows=mine_rows, seeds=clusters,
    )
    combo_addrs = (cols * NCODES + cods).to(torch.int32)
    t1 = _tick(dev)
    row_set = torch.repeat_interleave(
        torch.arange(n_sel, device=dev), torch.as_tensor(sizes, device=dev)
    )
    addrs, lengths = reencode_rows(codes, row_set, cols, cods)
    # §4.3 fallback: a cluster whose mean length reduction is below the
    # threshold (and an empty one) keeps plain direct addresses; the
    # reduction is computed as the reference's numpy does (f64 mean)
    len_sum = torch.zeros(n_sel, dtype=torch.int64, device=dev)
    len_sum.index_add_(0, row_set, lengths.long())
    len_max = torch.zeros(n_sel, dtype=torch.int64, device=dev)
    len_max.scatter_reduce_(0, row_set, lengths.long(), "amax")
    len_sum, len_max = len_sum.cpu().numpy(), len_max.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        red = 1.0 - (len_sum.astype(np.float64) / sizes) / m
    plain = (sizes == 0) | (red < min_length_reduction)
    coded_row = torch.as_tensor(~plain, device=dev)[row_set]
    if plain.any():
        direct = codes.int() + torch.arange(m, device=dev, dtype=torch.int32) * NCODES
        addrs = torch.where(coded_row[:, None], addrs, direct)
    t2 = _tick(dev)
    if stats is not None:
        coded = lengths[coded_row].double()
        stats.update(
            mine_seconds=t1 - t0, reencode_seconds=t2 - t1,
            mean_length_reduction=(1.0 - float(coded.mean()) / m) if coded.numel() else 0.0,
            plain_clusters=int(plain.sum()),
        )
    nat = np.where(plain, m, np.maximum(len_max, 1)).astype(np.int64)
    return addrs, combo_addrs.cpu().numpy(), plain, nat


def build_shards(
    index: IVFPQIndex,
    placement: Placement,
    use_cooc: bool = False,
    n_combos: int = 256,
    combo_len: int = 3,
    block_n: int = 1024,
    min_length_reduction: float = 0.0,
    mine_rows: int = 50_000,
    compact_dtype: bool = True,
    cap_slack: float = 0.0,
    slot_slack: int = 0,
    window_slack: int = 0,
    device: torch.device | str | None = None,
    stats: dict | None = None,
) -> DeviceShards:
    """Offline packing: re-encode (optionally), align, replicate, pad.

    Each device holds a copy of every cluster Algorithm 1 placed on it, in
    its `dev_clusters` order, each slot starting on a block boundary.  The
    packed arrays equal the reference's `build_shards` with the same
    arguments.  With `use_cooc` each cluster mines its own combos (seeded
    by its id, `mine_rows` rows at most), re-encodes its rows unless its
    mean length reduction is below `min_length_reduction`, and the codes
    are built on `device` (default cuda).  `stats`, when given, receives
    the seconds of each co-occurrence stage (mine, reencode, pack), the
    width and the mean length reduction.  `cap_slack` / `slot_slack` /
    `window_slack` reserve growth headroom for the mutable path
    (`update_shards`): row capacity, spare cluster slots, spare window
    blocks; co-occurrence shards with slack are stored at the full plain
    width M, since a re-encoding after churn may need any length up to M.
    """
    dev = resolve_device(device) if use_cooc else None
    ndev = len(placement.dev_clusters)
    m = index.m
    c_n = index.n_clusters
    sizes = index.cluster_sizes()
    s_max = max((len(cl) for cl in placement.dev_clusters), default=1)
    s_max = max(s_max, 1) + max(int(slot_slack), 0)
    window = _align(int(max(sizes.max(initial=1), 1)), block_n)
    window += max(int(window_slack), 0) * block_n

    caps = [
        sum(_align(int(sizes[c]), block_n) for c in placement.dev_clusters[d])
        for d in range(ndev)
    ]
    cap = max(max(caps, default=block_n), block_n)
    if cap_slack > 0.0:
        cap = _align(int(np.ceil(cap * (1.0 + cap_slack))), block_n)

    n_c = n_combos if use_cooc else 0
    sentinel = m * NCODES + n_c
    add_offsets = bool(compact_dtype) and not use_cooc
    if use_cooc and compact_dtype and m * NCODES + n_combos + 1 > 65536:
        raise ValueError(
            "build_shards: co-occ table size m*256 + n_combos + 1 = "
            f"{m * NCODES + n_combos + 1} exceeds the uint16 direct-address space "
            "(§4.3); lower n_combos or m, or pass compact_dtype=False"
        )

    vec_ids = np.full((ndev, cap), -1, np.int32)
    slot_start = np.zeros((ndev, s_max), np.int32)
    slot_size = np.zeros((ndev, s_max), np.int32)
    slot_cluster = np.full((ndev, s_max), -1, np.int32)
    local_slot = np.full((ndev, c_n), -1, np.int32)
    for d in range(ndev):
        cursor = 0
        for s, c in enumerate(placement.dev_clusters[d]):
            n_rows = int(sizes[c])
            vec_ids[d, cursor : cursor + n_rows] = index.cluster_ids(c)
            slot_start[d, s] = cursor
            slot_size[d, s] = n_rows
            slot_cluster[d, s] = c
            local_slot[d, c] = s
            cursor += _align(n_rows, block_n)

    filled = slot_cluster >= 0
    if use_cooc:
        rows, cluster_combos, plain, nat = _encode_clusters(
            index, np.arange(c_n), n_combos, combo_len, min_length_reduction, mine_rows,
            dev, stats,
        )
        width = m if plain.any() else max(1, int(nat.max(initial=1)))
        if cap_slack > 0.0 or slot_slack > 0 or window_slack > 0:
            width = m
        if stats is not None:
            stats["width"] = width
        t0 = time.perf_counter()
        dtype = torch.uint16 if compact_dtype else torch.int32
        out = _alloc_codes(ndev, cap, width, sentinel, dtype, dev)
        _pack_rows(rows[:, :width], index.offsets[:-1], sizes, slot_start, slot_cluster,
                   out, cap)
        del rows
        codes = _as_codes(out, ndev, cap, dtype)
        _tick(dev)
        if stats is not None:
            stats["pack_seconds"] = time.perf_counter() - t0
        combo_addrs = np.zeros((ndev, s_max, n_combos, combo_len), np.int32)
        combo_addrs[filled] = cluster_combos[slot_cluster[filled]]
    else:
        width = m
        codes = np.full((ndev, cap, m), 0 if add_offsets else sentinel,
                        np.uint8 if add_offsets else np.int32)
        offs = np.arange(m, dtype=np.int32) * NCODES
        for d in range(ndev):
            for s, c in enumerate(placement.dev_clusters[d]):
                lo = slot_start[d, s]
                cc = index.cluster_codes(c)
                codes[d, lo : lo + len(cc)] = cc if add_offsets else cc.astype(np.int32) + offs
        combo_addrs = np.zeros((ndev, s_max, 0, combo_len), np.int32)
    return DeviceShards(
        codes=codes,
        vec_ids=vec_ids,
        slot_start=slot_start,
        slot_size=slot_size,
        slot_cluster=slot_cluster,
        combo_addrs=combo_addrs,
        local_slot=local_slot,
        m_subspaces=m,
        n_combos=n_c,
        block_n=block_n,
        window=window,
        add_offsets=add_offsets,
        min_length_reduction=min_length_reduction,
        mine_rows=mine_rows,
    )


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """uint16 storage is written through an int16 view (torch's uint16 has
    few kernels); values are computed in int32 and cast once."""
    return torch.int16 if dtype == torch.uint16 else dtype


def _narrow(x: torch.Tensor, work: torch.dtype) -> torch.Tensor:
    if work == torch.int16:
        x = torch.where(x >= 1 << 15, x - (1 << 16), x)
    return x.to(work)


def _alloc_codes(ndev: int, cap: int, width: int, fill: int, dtype: torch.dtype,
                 dev: torch.device) -> torch.Tensor:
    """A (ndev * cap, width) code buffer of `dtype`'s work type, all `fill`."""
    work = _work_dtype(dtype)
    fill_bits = fill - (1 << 16) if work == torch.int16 and fill >= 1 << 15 else fill
    return torch.full((ndev * cap, width), fill_bits, dtype=work, device=dev)


def _as_codes(out: torch.Tensor, ndev: int, cap: int, dtype: torch.dtype) -> torch.Tensor:
    out = out.reshape(ndev, cap, out.shape[1])
    return out.view(torch.uint16) if dtype == torch.uint16 else out


def _pack_rows(
    rows: torch.Tensor, src0: np.ndarray, sizes: np.ndarray, slot_start: np.ndarray,
    slot_cluster: np.ndarray, out: torch.Tensor, cap: int, devs=None,
) -> None:
    """Scatter int32 rows into the slots of `out` ((ndev * cap, W), from
    `_alloc_codes`): cluster c's `sizes[c]` rows start at row `src0[c]` of
    `rows`.  Only the devices in `devs` (default all) are written."""
    dev = rows.device
    d_idx, s_idx = np.nonzero(slot_cluster >= 0)
    if devs is not None:
        on = np.isin(d_idx, devs)
        d_idx, s_idx = d_idx[on], s_idx[on]
    cl = slot_cluster[d_idx, s_idx].astype(np.int64)
    n = np.asarray(sizes)[cl].astype(np.int64)
    dst0 = d_idx.astype(np.int64) * cap + slot_start[d_idx, s_idx]
    ends = np.cumsum(n)
    total = int(ends[-1]) if len(ends) else 0
    dst0_t = torch.as_tensor(dst0, device=dev)
    src0_t = torch.as_tensor(np.asarray(src0, np.int64)[cl], device=dev)
    ends_t = torch.as_tensor(ends, device=dev)
    begin_t = ends_t - torch.as_tensor(n, device=dev)
    for s0 in range(0, total, _PACK_CHUNK):
        pos = torch.arange(s0, min(s0 + _PACK_CHUNK, total), device=dev)
        slot = torch.searchsorted(ends_t, pos, right=True)
        within = pos - begin_t[slot]
        out[dst0_t[slot] + within] = _narrow(rows[src0_t[slot] + within], out.dtype)


# ---------------------------------------------------------------------- #
# raw-vector store (exact re-rank cascade)
# ---------------------------------------------------------------------- #


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << math.ceil(math.log2(max(n, 1))))


@dataclasses.dataclass
class RawStore:
    """Raw vectors by home device, backing the exact re-rank cascade.

    Every vector has exactly one home device -- the first replica holder of
    its cluster -- so each candidate's exact distance is computed once, by
    its owner.  The shards of all devices live in one allocation on the
    engine's device: device d's rows are `vectors[row_base[d] :
    row_base[d] + used[d]]`, filled in cluster-id order, and its shard
    reserves `capacity[d]` rows (`used[d]`, or that times 1 + `cap_slack`
    for a mutable engine, so that compactions append in place).  (The
    reference pads every shard to one power-of-two row capacity; at 100M
    rows that padding alone would not fit the card, so each shard here
    holds its own rows and its own slack.)

    Attributes:
      vectors: (rows, D) f32 or bf16 tensor on the engine's device.
      row_base: (ndev,) int64 tensor, first row of each device's shard.
      used: (ndev,) int64 rows per device.
      id_dev: (ids_cap,) int32 tensor, home device per global id, -1 absent
        (never stored, or deleted: a deleted id's row stays until a rebuild).
      id_row: (ids_cap,) int32 tensor, row of each id within its shard.
      dtype: "float32" or "bfloat16".
      capacity: (ndev,) int64 rows reserved per device (default `used`).
      cap_slack: growth headroom an overflowing shard is re-reserved with.
    """

    vectors: torch.Tensor
    row_base: torch.Tensor
    used: np.ndarray
    id_dev: torch.Tensor
    id_row: torch.Tensor
    dtype: str = "float32"
    capacity: np.ndarray | None = None
    cap_slack: float = 0.0

    def __post_init__(self):
        if self.capacity is None:
            self.capacity = np.asarray(self.used, np.int64).copy()

    @property
    def ndev(self) -> int:
        return self.used.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def device_rows(self, d: int) -> torch.Tensor:
        """The filled rows of device d's shard, (used[d], D)."""
        b = int(self.row_base[d])
        return self.vectors[b : b + int(self.used[d])]

    def nbytes(self) -> int:
        return self.vectors.numel() * self.vectors.element_size()


def _slack_rows(rows: np.ndarray, cap_slack: float) -> np.ndarray:
    return np.ceil(np.asarray(rows, np.int64) * (1.0 + cap_slack)).astype(np.int64)


def _row_base(capacity: np.ndarray) -> np.ndarray:
    base = np.zeros(capacity.shape[0], np.int64)
    np.cumsum(capacity[:-1], out=base[1:])
    return base


def reserve_raw_store(store: RawStore, cap_slack: float) -> RawStore:
    """A copy of `store` whose shards reserve `cap_slack` growth headroom
    (each device `ceil(used * (1 + cap_slack))` rows, never less than it
    has), the same rows under the same ids.  This is how an immutable
    engine's store becomes a mutable engine's without the corpus."""
    cap = np.maximum(store.capacity, _slack_rows(store.used, cap_slack))
    return _repack_raw(store, cap, cap_slack)


def _repack_raw(store: RawStore, capacity: np.ndarray, cap_slack: float) -> RawStore:
    dev = store.vectors.device
    base = _row_base(capacity)
    vectors = torch.zeros((int(capacity.sum()), store.dim), dtype=store.vectors.dtype,
                          device=dev)
    for d in range(store.ndev):
        n = int(store.used[d])
        vectors[base[d] : base[d] + n] = store.device_rows(d)
    return RawStore(
        vectors=vectors, row_base=torch.as_tensor(base, device=dev),
        used=store.used.copy(), id_dev=store.id_dev.clone(), id_row=store.id_row.clone(),
        dtype=store.dtype, capacity=capacity, cap_slack=cap_slack,
    )


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_raw_store(
    index: IVFPQIndex,
    placement: Placement,
    xs,
    xs_ids: np.ndarray | None = None,
    dtype: str = "float32",
    device: torch.device | str | None = None,
    chunk: int = 1 << 22,
    cap_slack: float = 0.0,
) -> RawStore:
    """Pack raw vectors by home device (first replica of each cluster).

    Args:
      xs: (N, D) raw vectors in any order -- a numpy array, or a tensor
        already on the target device (a 100M-row bf16 corpus on the card is
        packed there, chunk by chunk, never passing through a host copy).
      xs_ids: (N,) global id of each xs row; defaults to 0..N-1.
      dtype: storage precision, "float32" or "bfloat16".
      device: target device (defaults to xs's device for a tensor, else
        cuda, which raises without a GPU unless "cpu" is asked for).
      cap_slack: each shard reserves `ceil(rows * (1 + cap_slack))` rows,
        headroom for compaction appends (0.5 for a mutable engine, as the
        reference's store).

    Every id in `index.vec_ids` must appear in `xs_ids`.
    """
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"unsupported raw-store dtype {dtype!r}")
    if isinstance(xs, torch.Tensor):
        dev = resolve_device(device) if device is not None else xs.device
        xs = xs.to(dev)
    else:
        dev = resolve_device(device)
        xs = torch.as_tensor(np.asarray(xs, np.float32), device=dev)
    ndev = len(placement.dev_clusters)
    c_n = index.n_clusters
    sizes = index.cluster_sizes().astype(np.int64)
    vec_ids = torch.as_tensor(index.vec_ids, device=dev).long()
    if xs_ids is None:
        if int(index.vec_ids.max(initial=-1)) >= xs.shape[0]:
            raise ValueError("build_raw_store: index ids missing from xs_ids")
        xs_row = vec_ids
    else:
        ids = torch.as_tensor(np.asarray(xs_ids, np.int64), device=dev)
        srt, order = torch.sort(ids)
        pos = torch.searchsorted(srt, vec_ids).clamp_max(max(ids.numel() - 1, 0))
        if ids.numel() == 0 or bool((srt[pos] != vec_ids).any()):
            raise ValueError("build_raw_store: index ids missing from xs_ids")
        xs_row = order[pos]

    home = np.array([r[0] if r else 0 for r in placement.replicas], np.int64)
    used = np.bincount(home, weights=sizes, minlength=ndev).astype(np.int64)
    capacity = _slack_rows(used, cap_slack)
    row_base_np = _row_base(capacity)
    # start of each cluster within its home shard: clusters append in id order
    start = np.zeros(c_n, np.int64)
    for d in range(ndev):
        on_d = home == d
        start[on_d] = np.cumsum(sizes[on_d]) - sizes[on_d]

    row_cluster = torch.repeat_interleave(
        torch.arange(c_n, device=dev), torch.as_tensor(sizes, device=dev)
    )
    offsets = torch.as_tensor(index.offsets[:-1], device=dev)
    shard_row = (
        torch.as_tensor(start, device=dev)[row_cluster]
        + torch.arange(row_cluster.shape[0], device=dev)
        - offsets[row_cluster]
    )
    row_home = torch.as_tensor(home, device=dev)[row_cluster]
    row_base = torch.as_tensor(row_base_np, device=dev)

    vectors = torch.zeros(
        (int(capacity.sum()), xs.shape[1]), dtype=_TORCH_DTYPES[dtype], device=dev
    )
    dest = row_base[row_home] + shard_row
    for s in range(0, dest.shape[0], chunk):
        vectors[dest[s : s + chunk]] = xs[xs_row[s : s + chunk]].to(vectors.dtype)

    ids_cap = _pow2(int(index.vec_ids.max(initial=0)) + 1)
    id_dev = torch.full((ids_cap,), -1, dtype=torch.int32, device=dev)
    id_row = torch.zeros((ids_cap,), dtype=torch.int32, device=dev)
    id_dev[vec_ids] = row_home.to(torch.int32)
    id_row[vec_ids] = shard_row.to(torch.int32)
    return RawStore(
        vectors=vectors, row_base=row_base, used=used,
        id_dev=id_dev, id_row=id_row, dtype=dtype, capacity=capacity,
        cap_slack=cap_slack,
    )


def update_raw_store(
    store: RawStore,
    add_ids: np.ndarray,
    add_vectors: np.ndarray,
    remove_ids: np.ndarray,
    add_home: np.ndarray,
) -> tuple[RawStore, bool]:
    """Incremental raw-store update after a compaction.

    Removed ids are unmapped (`id_dev = -1`; their rows stay until a
    rebuild).  New rows append to their home device's shard (`add_home`,
    the first replica of each row's cluster), inside the reserved slack;
    the reference fills the freest shards instead, and the re-rank reads a
    row wherever the id map points, so only the layout differs.  The allocation grows only when a shard overflows
    (that shard is re-reserved with `cap_slack` headroom) or when an id
    passes the id map (a power-of-two step); either returns
    `shapes_changed`.  The store is updated in place unless it grows.

    Returns (updated store, shapes_changed).
    """
    add_ids = np.atleast_1d(np.asarray(add_ids, np.int64))
    remove_ids = np.atleast_1d(np.asarray(remove_ids, np.int64))
    add_vectors = np.asarray(add_vectors, np.float32)
    dev = store.vectors.device
    shapes_changed = False
    ids_cap = store.id_dev.shape[0]
    if remove_ids.size:
        gone = torch.as_tensor(remove_ids[remove_ids < ids_cap], device=dev)
        store.id_dev[gone] = -1
    if add_ids.size == 0:
        return store, shapes_changed

    if int(add_ids.max()) >= ids_cap:
        new_cap = _pow2(int(add_ids.max()) + 1, floor=ids_cap)
        pad = new_cap - ids_cap
        store.id_dev = torch.cat([store.id_dev, torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)])
        store.id_row = torch.cat([store.id_row, torch.zeros(
            (pad,), dtype=torch.int32, device=dev)])
        shapes_changed = True

    ndev = store.ndev
    add_home = np.asarray(add_home, np.int64)
    need = store.used + np.bincount(add_home, minlength=ndev)
    if (need > store.capacity).any():
        cap = np.where(need > store.capacity, _slack_rows(need, store.cap_slack),
                       store.capacity)
        store = _repack_raw(store, cap, store.cap_slack)
        shapes_changed = True

    order = np.argsort(add_home, kind="stable")
    homes = add_home[order]
    counts = np.bincount(homes, minlength=ndev)
    rank = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts, counts)
    shard_row = store.used[homes] + rank
    base = store.row_base.cpu().numpy()
    dest = torch.as_tensor(base[homes] + shard_row, device=dev)
    store.vectors[dest] = torch.as_tensor(add_vectors[order], device=dev).to(store.vectors.dtype)
    ids_t = torch.as_tensor(add_ids[order], device=dev)
    store.id_dev[ids_t] = torch.as_tensor(homes, device=dev).to(torch.int32)
    store.id_row[ids_t] = torch.as_tensor(shard_row, device=dev).to(torch.int32)
    store.used = store.used + counts
    return store, shapes_changed


def update_shards(
    index: IVFPQIndex,
    placement: Placement,
    old: DeviceShards,
    changed: np.ndarray,
    device: torch.device | str | None = None,
) -> tuple[DeviceShards, np.ndarray]:
    """Delta rebuild of the device shards after a compaction.

    Only affected devices are repacked: a device whose cluster list changed
    or that holds a cluster whose rows changed.  Every other device's
    region -- codes, vec_ids, slot tables, local_slot row -- is copied
    through.  Shapes (row capacity, slot count, window, width) are kept
    whenever the new packing fits, and grow only on overflow.  The result
    equals the reference's `update_shards` (and so a from-scratch
    `build_shards` over the compacted index).

    Co-occurrence shards (`n_combos > 0`) re-mine and re-encode each
    changed cluster with the build-time knobs carried on the shards,
    seeded by the cluster id (`_encode_clusters`, on `device`, default
    cuda); unchanged clusters copy their packed rows and combo tables from
    any old holder.  The width can only grow, to at most M (mutable builds
    reserve M).

    Args:
      index: the compacted IVFPQIndex.
      placement: the updated Placement (unchanged clusters keep their
        position in each device's list, as `update_placement` guarantees).
      old: the shards being updated.
      changed: (C,) bool mask of clusters whose rows changed.

    Returns (new DeviceShards, (A,) int array of repacked device ids).
    """
    ndev = old.ndev
    m = index.m
    c_n = index.n_clusters
    block_n = old.block_n
    use_cooc = old.n_combos > 0
    n_combos = old.n_combos
    combo_len = old.combo_addrs.shape[3]
    sizes = index.cluster_sizes()
    changed = np.asarray(changed, bool)

    old_lists = [[int(c) for c in old.slot_cluster[d] if c >= 0] for d in range(ndev)]
    affected = np.array([
        placement.dev_clusters[d] != old_lists[d]
        or any(changed[c] for c in placement.dev_clusters[d])
        for d in range(ndev)
    ], bool)
    aff = np.flatnonzero(affected)

    need_slots = max((len(cl) for cl in placement.dev_clusters), default=1)
    s_max = max(old.slot_start.shape[1], max(need_slots, 1))
    window = max(old.window, _align(int(max(sizes.max(initial=1), 1)), block_n))
    need_cap = max(
        (sum(_align(int(sizes[c]), block_n) for c in placement.dev_clusters[d]) for d in aff),
        default=block_n,
    )
    cap = max(old.codes.shape[1], need_cap)
    old_cap = old.codes.shape[1]
    old_smax = old.slot_start.shape[1]

    vec_ids = np.full((ndev, cap), -1, np.int32)
    slot_start = np.zeros((ndev, s_max), np.int32)
    slot_size = np.zeros((ndev, s_max), np.int32)
    slot_cluster = np.full((ndev, s_max), -1, np.int32)
    combo_addrs = np.zeros((ndev, s_max, n_combos, combo_len), np.int32)
    local_slot = np.full((ndev, c_n), -1, np.int32)
    for d in range(ndev):
        if not affected[d]:
            vec_ids[d, :old_cap] = old.vec_ids[d]
            slot_start[d, :old_smax] = old.slot_start[d]
            slot_size[d, :old_smax] = old.slot_size[d]
            slot_cluster[d, :old_smax] = old.slot_cluster[d]
            combo_addrs[d, :old_smax] = old.combo_addrs[d]
            local_slot[d] = old.local_slot[d]
            continue
        cursor = 0
        for s, c in enumerate(placement.dev_clusters[d]):
            n_rows = int(sizes[c])
            vec_ids[d, cursor : cursor + n_rows] = index.cluster_ids(c)
            slot_start[d, s] = cursor
            slot_size[d, s] = n_rows
            slot_cluster[d, s] = c
            local_slot[d, c] = s
            cursor += _align(n_rows, block_n)

    if use_cooc:
        codes, width = _update_cooc_codes(
            index, old, changed, aff, slot_start, slot_cluster, combo_addrs, cap,
            resolve_device(device),
        )
    else:
        width = m
        fill = 0 if old.add_offsets else old.sentinel
        codes = np.full((ndev, cap, width), fill, old.codes.dtype)
        offs = np.arange(m, dtype=np.int32) * NCODES
        for d in range(ndev):
            if not affected[d]:
                codes[d, :old_cap] = old.codes[d]
                continue
            for s, c in enumerate(placement.dev_clusters[d]):
                lo = slot_start[d, s]
                cc = index.cluster_codes(c)
                codes[d, lo : lo + len(cc)] = (
                    cc if old.add_offsets else cc.astype(np.int32) + offs
                )
    return (
        DeviceShards(
            codes=codes, vec_ids=vec_ids, slot_start=slot_start, slot_size=slot_size,
            slot_cluster=slot_cluster, combo_addrs=combo_addrs, local_slot=local_slot,
            m_subspaces=m, n_combos=n_combos, block_n=block_n, window=window,
            add_offsets=old.add_offsets, min_length_reduction=old.min_length_reduction,
            mine_rows=old.mine_rows,
        ),
        aff,
    )


def _update_cooc_codes(
    index: IVFPQIndex, old: DeviceShards, changed: np.ndarray, aff: np.ndarray,
    slot_start: np.ndarray, slot_cluster: np.ndarray, combo_addrs: np.ndarray,
    cap: int, dev: torch.device,
) -> tuple[torch.Tensor, int]:
    """The co-occurrence codes of `update_shards` on `dev`: unaffected
    devices copied, affected ones packed from the clusters' rows (changed
    clusters re-encoded, unchanged ones gathered from an old holder).
    Fills the affected devices' rows of `combo_addrs` in place."""
    ndev, m = old.ndev, index.m
    sizes = index.cluster_sizes().astype(np.int64)
    old_codes = torch.as_tensor(old.codes, device=dev)
    dtype = old_codes.dtype
    on_aff = slot_cluster[aff]
    need = np.unique(on_aff[on_aff >= 0]).astype(np.int64)
    holder = np.where(old.local_slot[:, need] >= 0, np.arange(ndev)[:, None], ndev).min(axis=0)
    fresh = changed[need] | (holder == ndev)
    enc = need[fresh]
    rows_enc, combos_enc, plain, nat = _encode_clusters(
        index, enc, old.n_combos, old.combo_addrs.shape[3], old.min_length_reduction,
        old.mine_rows, dev,
    )
    width = max([old.width] + [int(w) for w, n in zip(nat, sizes[enc]) if n])

    # the rows of every needed cluster, one after another, at `width` (<= M)
    n_need = sizes[need]
    src0 = np.zeros(index.n_clusters, np.int64)
    src0[need] = np.cumsum(n_need) - n_need
    rows = torch.full((int(n_need.sum()), width), old.sentinel, dtype=torch.int32, device=dev)

    def spread(clusters):  # rows positions of `clusters` in `rows`, in order
        n = sizes[clusters]
        within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        return np.repeat(src0[clusters], n) + within, within

    dst, _ = spread(enc)
    rows[torch.as_tensor(dst, device=dev)] = rows_enc[:, :width]
    keep = need[~fresh]
    if keep.size:
        d0 = holder[~fresh]
        s0 = old.local_slot[d0, keep]
        lo = d0 * old.codes.shape[1] + old.slot_start[d0, s0]
        dst, within = spread(keep)
        src = torch.as_tensor(np.repeat(lo, sizes[keep]) + within, device=dev)
        flat = old_codes.reshape(-1, old.width)
        got = (flat.view(torch.int16)[src].int() & 0xFFFF if dtype == torch.uint16
               else flat[src].int())
        rows[torch.as_tensor(dst, device=dev), : old.width] = got
    combo_of = {}
    for i, c in enumerate(enc.tolist()):
        combo_of[c] = combos_enc[i]
    for c, d0 in zip(keep.tolist(), holder[~fresh].tolist()):
        combo_of[c] = old.combo_addrs[d0, old.local_slot[d0, c]]
    for d in aff.tolist():
        for s, c in enumerate(slot_cluster[d].tolist()):
            if c >= 0:
                combo_addrs[d, s] = combo_of[c]

    out = _alloc_codes(ndev, cap, width, old.sentinel, dtype, dev)
    view = out.view(ndev, cap, width)
    old_w = old_codes.view(torch.int16) if dtype == torch.uint16 else old_codes
    for d in np.setdiff1d(np.arange(ndev), aff).tolist():
        view[d, : old_codes.shape[1], : old.width] = old_w[d]
    _pack_rows(rows, src0, sizes, slot_start, slot_cluster, out, cap, devs=aff)
    return _as_codes(out, ndev, cap, dtype), width
