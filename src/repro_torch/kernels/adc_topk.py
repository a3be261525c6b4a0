"""Kernel B2 (pruned tile scan): run planning, plain version, CUDA launcher.

The CUDA source is `csrc/adc_topk_tiles.cu`; `ops.adc_topk_tiles` is the
wrapper.  Arrays carry a leading logical-device axis `ndev` (the JAX
`"dpu"` mesh axis): codes (ndev, cap, M) raw uint8 codes, the tile queue
(ndev, T) from `core.scheduling.emit_tiles`, and the per-pair arrays
(ndev, P).  A flat pair id is `dev * P + p`; its table is row
`lut_row[pair]` of the (R, M, 256) tables (-1: none, the pair is not
scanned).

Soundness of the pruning (why the merged per-query output does not depend
on the order pairs run in) is set out in the CUDA source; in short, every
skipped tile and every dropped row lies strictly beyond the query's final
k-th distance.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# rows scored per step of the plain version: bounds its gather temporaries
_PLAIN_ROWS = 1 << 22


def pair_runs(
    tile_pair: torch.Tensor, pairs_per_dev: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per flat pair, its run [t0, t1) in the flattened tile queue, and an order.

    `emit_tiles` keeps each pair's tiles contiguous (ascending rows), so a
    pair's run is [first tile, last tile + 1); pairs with no tiles get
    t0 >= t1.  The order lists flat pairs by the rank of their run within
    its device, devices interleaved, so the best-first order of every
    device's queue is also the order in which blocks start.  Dummy tiles
    (pair id == P) belong to no run.

    Returns (t0 (ndev*P,) int32, t1 (ndev*P,) int32, order (ndev*P,) int32).
    """
    ndev, t_n = tile_pair.shape
    p = pairs_per_dev
    dv = tile_pair.device
    tp = tile_pair.long()
    real = tp < p
    # a run starts where the pair id changes and ends before the next change;
    # each start / end writes its own slot, every other tile a slot of its
    # own past the pairs, so the scatters never collide (no atomics)
    new = torch.ones_like(real)
    new[:, 1:] = tp[:, 1:] != tp[:, :-1]
    last = torch.ones_like(real)
    last[:, :-1] = new[:, 1:]
    flat = (torch.arange(ndev, device=dv)[:, None] * p + tp).reshape(-1)
    pos = torch.arange(ndev * t_n, device=dv)
    big = ndev * t_n
    spare = ndev * p + pos
    t0 = torch.full((ndev * p + big,), big, dtype=torch.int64, device=dv)
    t1 = torch.zeros((ndev * p + big,), dtype=torch.int64, device=dv)
    t0.scatter_(0, torch.where((real & new).reshape(-1), flat, spare), pos)
    t1.scatter_(0, torch.where((real & last).reshape(-1), flat, spare), pos + 1)
    t0, t1 = t0[: ndev * p], t1[: ndev * p]
    pair_dev = torch.arange(ndev * p, device=dv) // p
    local = torch.where(t0 < t1, t0 - pair_dev * t_n, big)
    order = torch.sort(local * ndev + pair_dev, stable=True).indices
    return t0.to(torch.int32), t1.to(torch.int32), order.to(torch.int32)


def adc_topk_tiles_plain(
    luts: torch.Tensor,
    lut_row: torch.Tensor,
    codes: torch.Tensor,
    tile_block: torch.Tensor,
    tile_row0: torch.Tensor,
    n_valid: torch.Tensor,
    pair_q: torch.Tensor,
    pair_lb: torch.Tensor,
    bound: torch.Tensor,
    t0: torch.Tensor,
    t1: torch.Tensor,
    k: int,
    block_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain tensor code, every run in lockstep.

    Step s advances every pair run by its s-th tile at once -- one valid
    execution order of the kernel's blocks.  Per tile: skip it when
    `lb >= pair k-th` or `lb > min(b0, sq)` (and count it); otherwise score
    its valid rows (table entries added in column order, as the kernel
    does), keep rows with d < k-th and d <= the query bound, and merge
    them into the pair's top-k by a stable sort (current entries, whose
    rows are lower, before the tile's).  After the step, `sq` takes the
    least k-th of each query's pairs.  Inputs are flat over (dev, pair)
    except `luts` (R, M, 256), `codes` (ndev, cap, M) and `bound` (Q,).

    Returns (vals (ndev*P, k) f32, rows (ndev*P, k) int32, stats (ndev*P, 2)
    int32); pairs with no tiles or no table keep (+inf, -1, 0).
    """
    dev_t = luts.device
    n_pairs = lut_row.shape[0]
    ndev, cap, m = codes.shape
    p = n_pairs // ndev
    lut_flat = luts.reshape(luts.shape[0], -1)
    lut_row = lut_row.long()
    codes_flat = codes.reshape(ndev * cap, m)
    top_v = torch.full((n_pairs, k), torch.inf, dtype=torch.float32, device=dev_t)
    top_i = torch.full((n_pairs, k), -1, dtype=torch.int32, device=dev_t)
    stats = torch.zeros((n_pairs, 2), dtype=torch.int32, device=dev_t)
    sq = bound.float().clone()
    ntiles = torch.where(lut_row >= 0, (t1.long() - t0.long()).clamp_min(0), 0)
    cols = torch.arange(m, device=dev_t) * 256
    lane = torch.arange(block_n, device=dev_t)
    for s in range(int(ntiles.max()) if n_pairs else 0):
        act = torch.nonzero(ntiles > s).flatten()
        t = t0.long()[act] + s
        row0 = tile_row0.reshape(-1).long()[t]
        blk = tile_block.reshape(-1).long()[t]
        qi = pair_q.long()[act]
        lb = pair_lb[act]
        nv = n_valid.long()[act]
        qb = torch.minimum(bound[qi], sq[qi])
        kth = top_v[act, k - 1]
        skip = (lb >= kth) | (lb > qb)
        rows = (nv - row0).clamp(0, block_n).to(torch.int32)
        stats[act[skip], 0] += (rows[skip] > 0).to(torch.int32)
        stats[act[skip], 1] += rows[skip]
        keep = torch.nonzero(~skip).flatten()
        per = max(1, _PLAIN_ROWS // block_n)
        for c0 in range(0, keep.shape[0], per):
            sel = keep[c0 : c0 + per]
            pr = act[sel]
            dev = pr // p
            code_rows = dev[:, None] * cap + blk[sel, None] * block_n + lane
            addr = codes_flat[code_rows].long() + cols             # (R, bn, M)
            g = lut_flat[lut_row[pr]].gather(1, addr.reshape(pr.shape[0], -1))
            g = g.reshape(addr.shape)
            d = torch.zeros(addr.shape[:2], dtype=torch.float32, device=dev_t)
            for j in range(m):
                d = d + g[..., j]
            ok = (
                (lane[None, :] < (nv[sel] - row0[sel])[:, None])
                & (d < kth[sel, None])
                & (d <= qb[sel, None])
            )
            d = torch.where(ok, d, torch.inf)
            ridx = (row0[sel, None] + lane).to(torch.int32)
            allv = torch.cat([top_v[pr], d], dim=1)
            alli = torch.cat([top_i[pr], ridx], dim=1)
            order = torch.sort(allv, dim=1, stable=True).indices[:, :k]
            top_v[pr] = allv.gather(1, order)
            top_i[pr] = alli.gather(1, order)
        sq.scatter_reduce_(0, qi, top_v[act, k - 1], "amin")
    return top_v, top_i, stats


def launch(
    luts, lut_row, codes, order, t0, t1, tile_block, tile_row0, n_valid, pair_q,
    pair_lb, bound, sq, out_v, out_i, stats, k: int, block_n: int,
) -> None:
    """Enqueue `csrc/adc_topk_tiles.cu` on the current stream (checked inputs)."""
    ndev, cap, m = codes.shape
    n_pairs = lut_row.shape[0]
    err = _build.library().adc_topk_tiles_launch(
        luts.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order.data_ptr(),
        t0.data_ptr(), t1.data_ptr(), tile_block.data_ptr(), tile_row0.data_ptr(),
        n_valid.data_ptr(), pair_q.data_ptr(), pair_lb.data_ptr(),
        bound.data_ptr(), sq.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        stats.data_ptr(), n_pairs, n_pairs // ndev, cap, m, k, block_n,
        torch.cuda.current_stream(luts.device).cuda_stream,
    )
    _build.check(err, "adc_topk_tiles")
