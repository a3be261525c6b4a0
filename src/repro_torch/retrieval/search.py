"""The online device step over a leading logical-device axis.

The JAX package runs this step under `shard_map` over a `"dpu"` mesh axis;
here the same per-device arrays are stacked on a leading `ndev` axis of
one card and each stage runs for all logical devices at once:

  1. build LUTs for the (query, cluster) pairs Algorithm 2 assigned to each
     logical device, one table per filled pair slot (kernel B1);
  2. for direct-address codes (co-occurrence shards, §4.3), extend each
     table with its cluster's combo partial sums (kernel B4);
  3. fused ADC scan + per-pair running top-k with exact whole-tile
     pruning, over each device's flat tile queue (`scan="tiles"`, kernel
     B2) or over each filled pair's window of its cluster slot
     (`scan="windows"`, kernel B5), each row's entries added in the
     engine's `path` order ("gather" or "onehot", `kernels.ops`);
  4. per-query merge of each device's pair results;
  5. merge across logical devices (the reference's all-gather + top-k
     becomes a reshape + top-k).

The exact re-rank (`sharded_rerank`) gathers each candidate's raw row from
its home device's shard inside kernel B3.  Every selection is a stable sort
and a slice, so ties keep the lower flat index as the reference's
`jax.lax.top_k` does.  One deliberate difference: lanes with distance
+inf carry id -1 here, where the reference leaves an arbitrary id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops


@dataclasses.dataclass
class InFlightSearch:
    """Handle for one dispatched (asynchronous) device step.

    The kernels are enqueued on the current CUDA stream and the host returns
    at once; `collect` (or `.cpu()` on the outputs) waits.  `event` is
    recorded after the step so `is_ready()` can poll without blocking.

    Attributes:
      out_d: (Q, k) f32 tensor of merged distances (in flight).
      out_i: (Q, k) int32 tensor of merged global ids (in flight).
      plan: the `SearchPlan` this step executes.
      dev_rows: (ndev,) int64 rows the scan visits per device (load report).
      prune_stats: (ndev, 2) int32 tensor: per device, [tiles whose body
        the bound check skipped, valid rows in them].
      query_bound: (Q,) f32 warm-start bounds this dispatch ran with.
      event: CUDA event recorded after the step (None on the CPU).
    """

    out_d: torch.Tensor
    out_i: torch.Tensor
    plan: object
    dev_rows: np.ndarray
    prune_stats: torch.Tensor | None = None
    query_bound: np.ndarray | None = None
    event: "torch.cuda.Event | None" = None

    def is_ready(self) -> bool:
        """True when the dispatched step has finished on the device."""
        return True if self.event is None else bool(self.event.query())

    def record(self) -> "InFlightSearch":
        """Record the completion event on the current stream (CUDA only)."""
        if self.out_d.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()
        return self


# entries one round of the per-device merge may sort (`sharded_search`)
MERGE_ENTRIES = 1 << 25


def _group_topk(
    vals: torch.Tensor, ids: torch.Tensor, group: torch.Tensor, n_groups: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of (B, N) entries, the k smallest of each group (B, G, k).

    Entries of group g (0 <= g < n_groups; other values are dropped) are
    ordered by (value, position): a stable sort by value, then a stable sort
    by group.  Missing lanes read (+inf, -1).
    """
    b, n = vals.shape
    by_v = torch.sort(vals, dim=1, stable=True).indices
    g_sorted, by_g = torch.sort(group.gather(1, by_v), dim=1, stable=True)
    order = by_v.gather(1, by_g)
    targets = torch.arange(n_groups + 1, device=vals.device).expand(b, -1).contiguous()
    edges = torch.searchsorted(g_sorted.contiguous(), targets)
    first, count = edges[:, :-1], edges[:, 1:] - edges[:, :-1]
    lane = torch.arange(k, device=vals.device)
    pos = (first[:, :, None] + lane).clamp_max(max(n - 1, 0)).reshape(b, -1)
    sel = order.gather(1, pos).reshape(b, n_groups, k)
    ok = lane < count[:, :, None]
    out_v = torch.where(ok, vals.gather(1, sel.reshape(b, -1)).reshape(sel.shape), torch.inf)
    out_i = torch.where(ok, ids.gather(1, sel.reshape(b, -1)).reshape(sel.shape), -1)
    return out_v, out_i


def sharded_search(
    codes: torch.Tensor,        # (ndev, cap, W) uint8 / uint16 / int32
    vec_ids: torch.Tensor,      # (ndev, cap) int32
    slot_start: torch.Tensor,   # (ndev, S) int32
    slot_size: torch.Tensor,    # (ndev, S) int32
    combo_addrs: torch.Tensor,  # (ndev, S, n_combos, L) int32
    codebook: torch.Tensor,     # (M, 256, dsub) f32
    qmc: torch.Tensor,          # (ndev, P, D) f32 per-pair residuals
    pair_q: torch.Tensor,       # (ndev, P) int32
    pair_slot: torch.Tensor,    # (ndev, P) int32
    pair_valid: torch.Tensor,   # (ndev, P) bool
    pair_rows: torch.Tensor,    # (R,) int32 flat dev * P + p of each valid pair
    tile_pair: torch.Tensor | None,   # (ndev, T) int32 (scan="tiles")
    tile_block: torch.Tensor | None,  # (ndev, T) int32
    tile_row0: torch.Tensor | None,   # (ndev, T) int32
    pair_lb: torch.Tensor,      # (ndev, P) f32
    query_bound: torch.Tensor,  # (Q,) f32
    *,
    n_queries: int,
    k: int,
    block_n: int,
    scan: str = "tiles",
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One search step for every logical device.

    `pair_rows` lists the valid pairs (ascending), so tables are built for
    them alone and not for the padding of the pair capacity.  uint8 codes
    are raw PQ codes scanned against the (R, M*256) LUTs; uint16 / int32
    codes are direct addresses scanned against [LUT | combo sums | 0]
    tables, each pair's combos being those of its cluster slot
    (`combo_addrs[dev, pair_slot]`; n_combos may be 0).  `scan` picks the
    tile queue (B2; `tile_*` given) or the per-pair windows (B5; no
    queue), and `path` the kernels' addition order.  `pair_lb` /
    `query_bound` drive the whole-tile pruning; (-inf, +inf) sentinels run
    the scan unpruned.  Returns (out_d (Q, k)
    f32, out_i (Q, k) int32 global ids, prune_stats (ndev, 2) int32).
    """
    ndev, p, d_dim = qmc.shape
    m, _, dsub = codebook.shape
    dev = qmc.device

    # stage (b): one LUT per valid pair; lut_row maps a pair slot to its table
    luts = ops.build_luts(codebook, qmc.reshape(ndev * p, m, dsub), pair_rows)
    lut_row = torch.full((ndev * p,), -1, dtype=torch.int32, device=dev)
    lut_row[pair_rows.long()] = torch.arange(pair_rows.shape[0], dtype=torch.int32, device=dev)
    pair_slot = pair_slot.long()
    if codes.dtype == torch.uint8:
        tables = luts.flatten(1)
    else:
        # §4.3: [LUT | this pair's cluster's combo sums | 0], one row per table
        s_n, n_combos, combo_len = combo_addrs.shape[1:]
        rows = pair_rows.long()
        set_idx = (rows // p) * s_n + pair_slot.reshape(-1)[rows]
        tables = ops.build_ext_luts_pairs(
            luts, combo_addrs.reshape(ndev * s_n, n_combos, combo_len),
            set_idx.to(torch.int32),
        )

    # stages (c)+(d): pruned scan, per-pair top-k
    starts = slot_start.gather(1, pair_slot)
    n_valid = torch.where(pair_valid, slot_size.gather(1, pair_slot), 0)
    if scan == "tiles":
        tv, ti, prune = ops.adc_topk_tiles(
            tables, codes, tile_pair, tile_block, tile_row0, n_valid, k,
            block_n=block_n, pair_q=pair_q, pair_lb=pair_lb, bound=query_bound,
            lut_row=lut_row.reshape(ndev, p), path=path,
        )
    elif scan == "windows":
        tv, ti, prune = ops.adc_topk_windows(
            tables, codes, starts, n_valid, k, lut_row=lut_row.reshape(ndev, p),
            block_n=block_n, pair_q=pair_q, pair_lb=pair_lb, bound=query_bound, path=path,
        )
    else:
        raise ValueError(f"scan must be 'tiles' or 'windows', got {scan!r}")
    prune_dev = prune.sum(dim=1, dtype=torch.int32)

    # per-query merge on each logical device, as many devices a round as keep
    # the sort temporaries (~60 B an entry) under MERGE_ENTRIES: with 32,768
    # pair slots a device, all eight in one round at k' 64, one a round at a
    # mutable fetch depth of 2048 (all eight at once would take ~16 GB)
    group = torch.where(pair_valid, pair_q.long(), n_queries)
    step = max(1, min(ndev, MERGE_ENTRIES // max(p * k, 1)))
    parts = []
    for d0 in range(0, ndev, step):
        sl = slice(d0, min(d0 + step, ndev))
        nd = sl.stop - d0
        rows = starts[sl, :, None].long() + ti[sl].long()
        gids = torch.where(
            ti[sl] >= 0,
            vec_ids[sl].gather(1, rows.clamp_min(0).reshape(nd, -1)).reshape(rows.shape), -1,
        )
        tvd = torch.where(pair_valid[sl, :, None], tv[sl], torch.inf)
        parts.append(_group_topk(
            tvd.reshape(nd, -1), gids.reshape(nd, -1),
            group[sl, :, None].expand(nd, p, k).reshape(nd, -1), n_queries, k,
        ))
    local_d, local_i = parts[0] if len(parts) == 1 else map(torch.cat, zip(*parts))

    # merge across logical devices
    all_d = local_d.permute(1, 0, 2).reshape(n_queries, ndev * k)
    all_i = local_i.permute(1, 0, 2).reshape(n_queries, ndev * k)
    sel = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
    out_d = all_d.gather(1, sel)
    out_i = torch.where(torch.isfinite(out_d), all_i.gather(1, sel), -1)
    return out_d, out_i.to(torch.int32), prune_dev


def sharded_rerank(
    raw,
    queries: torch.Tensor,
    cand: torch.Tensor,
    *,
    k_out: int,
    block_k: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of ADC candidates against the raw-vector store.

    `cand` ((Q, Kc) int32) holds the global ids the overfetched ADC scan
    surfaced (-1 = absent).  Kernel B3 gathers each candidate's raw row from
    its home device's shard of `raw` (a `RawStore`) and sums its exact f32
    squared distance; a stable sort by that distance, ties by candidate
    position, selects the top `k_out`.  Unmapped or -1 candidates read
    (+inf, -1) and sort last.  Returns (out_d (Q, k_out), out_i (Q, k_out)).
    """
    dists = ops.rerank_dists(
        queries, cand, raw.vectors, raw.id_dev, raw.id_row, raw.row_base,
        block_k=block_k,
    )
    sel = torch.sort(dists, dim=1, stable=True).indices[:, :k_out]
    out_d = dists.gather(1, sel)
    out_i = torch.where(torch.isfinite(out_d), cand.gather(1, sel), -1)
    return out_d, out_i
