"""Pack an IVFPQ index + Algorithm-1 placement into per-device storage.

Every array carries a leading `ndev` dimension: the JAX package shards it
over its `"dpu"` mesh axis; here it is a logical-device axis on one card.
Cluster slots are block-aligned so the scan kernel's tiles never straddle
two clusters.  Codes are stored as the paper's raw uint8 codes; the scan
kernel adds the column offset m * 256 itself.

The port packs the plain encoding only: co-occurrence re-encoding
(`use_cooc=True`, paper §4.3) is a later slice (ROADMAP queue A item 8).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.index import IVFPQIndex
from repro_torch.core.placement import Placement
from repro_torch.device import resolve_device

NCODES = 256


@dataclasses.dataclass
class DeviceShards:
    """Device-sharded MemANNS code storage (leading dim = ndev everywhere).

    Host numpy arrays; the engine keeps a device copy.
    """

    codes: np.ndarray        # (ndev, cap, M) uint8 raw codes
    vec_ids: np.ndarray      # (ndev, cap) int32, -1 on padding
    slot_start: np.ndarray   # (ndev, S) int32 block-aligned row starts
    slot_size: np.ndarray    # (ndev, S) int32 valid rows per slot
    slot_cluster: np.ndarray # (ndev, S) int32 cluster id, -1 for empty slot
    local_slot: np.ndarray   # (ndev, C) int32 slot of cluster c on dev d, -1
    m_subspaces: int
    block_n: int
    window: int              # per-pair scan window (largest cluster, aligned)

    @property
    def ndev(self) -> int:
        return self.codes.shape[0]


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


def build_shards(
    index: IVFPQIndex,
    placement: Placement,
    use_cooc: bool = False,
    block_n: int = 1024,
    cap_slack: float = 0.0,
    slot_slack: int = 0,
    window_slack: int = 0,
) -> DeviceShards:
    """Offline packing: align, replicate, pad (plain uint8 codes).

    Each device holds a copy of every cluster Algorithm 1 placed on it, in
    its `dev_clusters` order, each slot starting on a block boundary.  The
    packed arrays equal the reference's `build_shards(use_cooc=False)`.
    `cap_slack` / `slot_slack` / `window_slack` reserve growth headroom.
    """
    if use_cooc:
        raise NotImplementedError(
            "co-occurrence shards (use_cooc=True) are not ported to repro_torch "
            "yet; see ROADMAP.md queue A item 8"
        )
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

    codes = np.zeros((ndev, cap, m), np.uint8)
    vec_ids = np.full((ndev, cap), -1, np.int32)
    slot_start = np.zeros((ndev, s_max), np.int32)
    slot_size = np.zeros((ndev, s_max), np.int32)
    slot_cluster = np.full((ndev, s_max), -1, np.int32)
    local_slot = np.full((ndev, c_n), -1, np.int32)
    for d in range(ndev):
        cursor = 0
        for s, c in enumerate(placement.dev_clusters[d]):
            n_rows = int(sizes[c])
            codes[d, cursor : cursor + n_rows] = index.cluster_codes(c)
            vec_ids[d, cursor : cursor + n_rows] = index.cluster_ids(c)
            slot_start[d, s] = cursor
            slot_size[d, s] = n_rows
            slot_cluster[d, s] = c
            local_slot[d, c] = s
            cursor += _align(n_rows, block_n)
    return DeviceShards(
        codes=codes,
        vec_ids=vec_ids,
        slot_start=slot_start,
        slot_size=slot_size,
        slot_cluster=slot_cluster,
        local_slot=local_slot,
        m_subspaces=m,
        block_n=block_n,
        window=window,
    )


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
