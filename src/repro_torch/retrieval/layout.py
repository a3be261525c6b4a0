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


def _cooc_rows(
    index: IVFPQIndex, n_combos: int, combo_len: int, min_length_reduction: float,
    mine_rows: int, dev: torch.device, stats: dict | None,
) -> tuple[torch.Tensor, np.ndarray, int]:
    """Every index row's stored co-occurrence row, in index (CSR) order.

    Returns (rows (N, M) int32 tensor on `dev`, trimmed to the width by the
    caller; combo addresses (C, n_combos, L) int32; width W).
    """
    m, c_n = index.m, index.n_clusters
    sizes = index.cluster_sizes().astype(np.int64)

    def tick():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = tick()
    codes = torch.as_tensor(index.codes, device=dev)
    cols, cods, _, _ = mine_clusters(
        codes, index.offsets, np.arange(c_n), n_combos=n_combos, combo_len=combo_len,
        max_rows=mine_rows,
    )
    combo_addrs = (cols * NCODES + cods).to(torch.int32)
    t1 = tick()
    row_set = torch.repeat_interleave(
        torch.arange(c_n, device=dev), torch.as_tensor(sizes, device=dev)
    )
    addrs, lengths = reencode_rows(codes, row_set, cols, cods)
    # §4.3 fallback: a cluster whose mean length reduction is below the
    # threshold (and an empty one) keeps plain direct addresses; the
    # reduction is computed as the reference's numpy does (f64 mean)
    len_sum = torch.zeros(c_n, dtype=torch.int64, device=dev)
    len_sum.index_add_(0, row_set, lengths.long())
    len_sum = len_sum.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        red = 1.0 - (len_sum.astype(np.float64) / sizes) / m
    plain = (sizes == 0) | (red < min_length_reduction)
    coded_row = torch.as_tensor(~plain, device=dev)[row_set]
    width = int(lengths[coded_row].max()) if bool(coded_row.any()) else 0
    width = m if plain.any() else max(width, 1)
    if plain.any():
        direct = codes.int() + torch.arange(m, device=dev, dtype=torch.int32) * NCODES
        addrs = torch.where(coded_row[:, None], addrs, direct)
    t2 = tick()
    if stats is not None:
        coded = lengths[coded_row].double()
        stats.update(
            mine_seconds=t1 - t0, reencode_seconds=t2 - t1, width=width,
            mean_length_reduction=(1.0 - float(coded.mean()) / m) if coded.numel() else 0.0,
            plain_clusters=int(plain.sum()),
        )
    return addrs, combo_addrs.cpu().numpy(), width


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
    `window_slack` reserve growth headroom for plain shards; co-occurrence
    shards with slack (the mutable path) are ROADMAP queue A item 9.
    """
    if use_cooc and (cap_slack > 0.0 or slot_slack > 0 or window_slack > 0):
        raise NotImplementedError(
            "co-occurrence shards with mutable slack are not ported to repro_torch "
            "yet; see ROADMAP.md queue A item 9"
        )
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
        rows, cluster_combos, width = _cooc_rows(
            index, n_combos, combo_len, min_length_reduction, mine_rows, dev, stats
        )
        t0 = time.perf_counter()
        codes = _pack_rows(rows[:, :width], index, slot_start, slot_cluster, cap,
                           sentinel, torch.uint16 if compact_dtype else torch.int32)
        del rows
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
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


def _pack_rows(
    rows: torch.Tensor, index: IVFPQIndex, slot_start: np.ndarray,
    slot_cluster: np.ndarray, cap: int, fill: int, dtype: torch.dtype,
) -> torch.Tensor:
    """Scatter the (N, W) rows (index CSR order, int32) into the (ndev, cap,
    W) slots on rows' device, padding with `fill`.  uint16 storage is
    written through an int16 view (torch's uint16 has few kernels), so
    values are computed in int32 and cast once."""
    dev = rows.device
    ndev = slot_start.shape[0]
    width = rows.shape[1]
    work = torch.int16 if dtype == torch.uint16 else dtype

    def narrow(x):
        if work == torch.int16:
            x = torch.where(x >= 1 << 15, x - (1 << 16), x)
        return x.to(work)

    fill_bits = fill - (1 << 16) if work == torch.int16 and fill >= 1 << 15 else fill
    out = torch.full((ndev * cap, width), fill_bits, dtype=work, device=dev)
    d_idx, s_idx = np.nonzero(slot_cluster >= 0)
    cl = slot_cluster[d_idx, s_idx].astype(np.int64)
    n = index.cluster_sizes()[cl].astype(np.int64)
    dst0 = d_idx.astype(np.int64) * cap + slot_start[d_idx, s_idx]
    src0 = index.offsets[cl].astype(np.int64)
    ends = np.cumsum(n)
    total = int(ends[-1]) if len(ends) else 0
    dst0_t, src0_t = torch.as_tensor(dst0, device=dev), torch.as_tensor(src0, device=dev)
    ends_t = torch.as_tensor(ends, device=dev)
    begin_t = ends_t - torch.as_tensor(n, device=dev)
    for s0 in range(0, total, _PACK_CHUNK):
        pos = torch.arange(s0, min(s0 + _PACK_CHUNK, total), device=dev)
        slot = torch.searchsorted(ends_t, pos, right=True)
        within = pos - begin_t[slot]
        out[dst0_t[slot] + within] = narrow(rows[src0_t[slot] + within])
    out = out.reshape(ndev, cap, width)
    return out.view(torch.uint16) if dtype == torch.uint16 else out


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
    row_base[d] + used[d]]`, filled in cluster-id order.  (The reference
    pads every shard to one power-of-two row capacity; at 100M rows that
    padding alone would not fit the card, so each shard here holds exactly
    its own rows.)

    Attributes:
      vectors: (rows, D) f32 or bf16 tensor on the engine's device.
      row_base: (ndev,) int64 tensor, first row of each device's shard.
      used: (ndev,) int64 rows per device.
      id_dev: (ids_cap,) int32 tensor, home device per global id, -1 absent.
      id_row: (ids_cap,) int32 tensor, row of each id within its shard.
      dtype: "float32" or "bfloat16".
    """

    vectors: torch.Tensor
    row_base: torch.Tensor
    used: np.ndarray
    id_dev: torch.Tensor
    id_row: torch.Tensor
    dtype: str = "float32"

    def device_rows(self, d: int) -> torch.Tensor:
        """The filled rows of device d's shard, (used[d], D)."""
        b = int(self.row_base[d])
        return self.vectors[b : b + int(self.used[d])]

    def nbytes(self) -> int:
        return self.vectors.numel() * self.vectors.element_size()


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_raw_store(
    index: IVFPQIndex,
    placement: Placement,
    xs,
    xs_ids: np.ndarray | None = None,
    dtype: str = "float32",
    device: torch.device | str | None = None,
    chunk: int = 1 << 22,
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
    row_base_np = np.zeros(ndev, np.int64)
    np.cumsum(used[:-1], out=row_base_np[1:])
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
        (int(used.sum()), xs.shape[1]), dtype=_TORCH_DTYPES[dtype], device=dev
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
        id_dev=id_dev, id_row=id_row, dtype=dtype,
    )
