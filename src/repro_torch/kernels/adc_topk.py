"""The top-k ADC scans: kernels B2 (pruned tile scan), B5 (pruned windows
scan), B6 (many tables over one code array) and B7 (materialised per-pair
windows): run planning, plain versions, CUDA launchers.

The CUDA sources are `csrc/adc_topk_tiles.cu`, `csrc/adc_topk_windows.cu`,
`csrc/adc_topk.cu` and `csrc/adc_topk_pairs.cu` (their common device code
in `csrc/adc_topk_common.cuh`, B6 / B7's block in `csrc/adc_topk_multi.cuh`,
its in-place instantiations for all four in `csrc/adc_topk_wide.cu`, B6 /
B7 past k = 4096 in `csrc/adc_topk_select.cu`, and B2 / B5 past it too);
`ops.adc_topk_tiles`, `ops.adc_topk_windows`, `ops.adc_topk` /
`ops.adc_topk_flat` / `ops.adc_topk_grouped` and `ops.adc_topk_pairs` are
the wrappers.  Every scan takes any k >= 1 and any table width:
`scan_plan` (B2 / B5) and `topk_plan` (B6 / B7: G, tables per block, too)
keep the shared-memory blocks wherever their lists (k <= `SCAN_K_MAX`) and
tables fit, else pick the in-place block, whose tables are read where they
lie (`gtab`; B6 at G = 1, 2 or 4 interleaved tables a unit, B2 / B5's pairs
as units whose tiles are cut over the grid), and past `SCAN_K_MAX` the
select kernels, which select each unit's k-th key and sort its k winners
(`select` plans, `wide_layout`, `select_scratch`).  B6 / B7 are planned
here on every device: `topk_plan`, `topk_units`, and `run_plan` (the
Python twin of how the kernels cut tiles into runs; B2 / B5's units for it
from `scan_unit_tiles`).  For B2 and B5, arrays
carry a leading logical-device axis `ndev` (the JAX `"dpu"` mesh axis):
codes (ndev, cap, W), the tile queue (ndev, T) from
`core.scheduling.emit_tiles`, and the per-pair arrays (ndev, P).  A flat
pair id is `dev * P + p`; its table is row `lut_row[pair]` of the (R, A)
tables (-1: none, the pair is not scanned).

Codes are raw uint8 PQ codes (the column offset m * 256 is added when a
row is scored, the reference's `add_offsets`; A >= M * 256) or uint16 /
int32 direct addresses into [LUT | combo sums | 0] tables (§4.3; the
sentinel address reads the table's final 0.0).

Every scan takes the reference's `path`: "gather" adds a row's W table
entries in column order, "onehot" in ascending table-address order -- the
order of the reference's multi-hot x table contraction
(`src/repro/kernels/adc_scan.py` `_onehot_dists`), each occurrence once,
each sum rounded on its own.  On raw codes the two orders are one (the
address m * 256 + code grows with m), so there the paths agree bit for
bit; on direct addresses (§4.3) a combo's address sits at its anchor
column, and the onehot path sorts the row's addresses first
(`table_addresses`).

Soundness of the pruning (why the merged per-query output does not depend
on the order pairs run in) is set out in the CUDA header; in short, every
skipped tile and every dropped row lies strictly beyond the query's final
k-th distance.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
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


def code_format(codes: torch.Tensor) -> int:
    """The kernels' code format: 0 raw uint8 (+ column offsets), 1 uint16
    direct addresses, 2 int32 direct addresses."""
    fmt = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}.get(codes.dtype)
    if fmt is None:
        raise TypeError(f"codes: expected uint8, uint16 or int32, got {codes.dtype}")
    return fmt


# largest k of the shared-memory blocks of B2 / B5 / B6 / B7, whose top-k
# lists and merge buffer (4k floats) live in shared memory beside the
# tables; a larger k runs the select kernels, which keep no list
SCAN_K_MAX = 4096
# shared memory one H100 block may use (227 KB), and what the scan blocks
# declare statically beside the dynamic part
SMEM_BUDGET = 232_448
_STATIC_SMEM = 64
# rows a B2 / B5 block scores per merge (csrc/adc_topk_common.cuh PASS)
_SCAN_PASS = 1024


def scan_smem(k: int, table_width: int) -> int:
    """Dynamic shared memory of the shared-memory B2 / B5 block (csrc
    `scan_smem_bytes`): the table, the top-k list and its merge buffer
    (4k), the candidates."""
    return (table_width + 4 * k + 2 * _SCAN_PASS) * 4


def wide_layout(k: int, table_width: int, static: int) -> dict:
    """What runs past a shared-memory block: `select` (k past SCAN_K_MAX:
    the select kernels, whose shared memory holds the table and a
    histogram of `_SELECT_BINS` words in place of the lists) and `gtab`
    (the table read where it lies, when it does not fit in `SMEM_BUDGET`
    beside what stays); `smem` the dynamic shared memory that is left
    (csrc `select_smem_bytes`, or the in-place block's `multi_smem_bytes`
    at G = 1)."""
    select = k > SCAN_K_MAX
    rest = 2 * _SCAN_PASS + (0 if select else 4 * k)
    gtab = (table_width + rest) * 4 + static > SMEM_BUDGET
    return dict(gtab=gtab, select=select, smem=((0 if gtab else table_width) + rest) * 4)


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k={k} < 1")


def scan_plan(k: int, table_width: int) -> dict:
    """How a B2 / B5 launch holds a pair of `table_width` table entries at
    this k: {"gtab", "select", "smem"}.  The shared-memory block (`gtab`
    and `select` False, `smem` from `scan_smem`) when k <= SCAN_K_MAX and
    everything fits `SMEM_BUDGET`; else, at k <= SCAN_K_MAX, the in-place
    block (`gtab`: the pairs as G = 1 units of csrc/adc_topk_wide.cu, each
    pair's tiles cut over the grid); past SCAN_K_MAX the select
    kernels (`select`; `gtab` and `smem` from `wide_layout`, as B6 / B7's
    `topk_plan`).  Raises ValueError for k < 1, which the reference does
    not serve either."""
    _check_k(k)
    smem = scan_smem(k, table_width)
    if k <= SCAN_K_MAX and smem + _STATIC_SMEM <= SMEM_BUDGET:
        return dict(gtab=False, select=False, smem=smem)
    return wide_layout(k, table_width, _MULTI_STATIC_SMEM if k > SCAN_K_MAX else _STATIC_SMEM)


def wide(plan: dict) -> bool:
    """Whether a plan leaves the shared-memory block (the in-place block or
    the select kernels)."""
    return plan["gtab"] or plan["select"]


def gatherable(codes: torch.Tensor) -> torch.Tensor:
    """`codes` as a tensor torch can index rows of: uint16 through an int16
    view (torch's uint16 has few kernels), masked back by `table_addresses`."""
    return codes.view(torch.int16) if codes.dtype == torch.uint16 else codes


def table_addresses(rows: torch.Tensor, fmt: int, path: str = "gather") -> torch.Tensor:
    """int64 table addresses of code rows (..., W) taken from `gatherable`
    codes of format `fmt`, in the order the `path` adds them: m * 256 +
    code for raw uint8 codes (already ascending), the value itself (0..65535
    for uint16, masked before any sort) for direct addresses, sorted along
    the row on the onehot path."""
    addr = rows.long()
    if fmt == 0:
        return addr + torch.arange(rows.shape[-1], device=rows.device) * 256
    addr = addr & 0xFFFF if fmt == 1 else addr
    return torch.sort(addr, dim=-1).values if path == "onehot" else addr


def sort_network_size(w: int) -> int:
    """Compare-exchanges of the sorting network the onehot kernels run on
    a row of compile-time width w (Batcher's odd-even merge sort,
    csrc/adc_topk_common.cuh `sort_network`): 19 for 8, 63 for 16."""
    n = 0
    p = 1
    while p < w:
        k = p
        while k >= 1:
            for j in range(k % p, w - k, 2 * k):
                n += sum(1 for i in range(k) if i + j + k < w
                         and (i + j) // (2 * p) == (i + j + k) // (2 * p))
            k //= 2
        p *= 2
    return n


def sum_columns(g: torch.Tensor) -> torch.Tensor:
    """Table entries (..., W) added in column order from 0.0, each sum
    rounded on its own: the kernels' `__fadd_rn` order, bit for bit."""
    d = torch.zeros(g.shape[:-1], dtype=torch.float32, device=g.device)
    for j in range(g.shape[-1]):
        d = d + g[..., j]
    return d


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
    path: str = "gather",
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
    except `luts` (R, A) tables, `codes` (ndev, cap, W) and `bound` (Q,).
    uint8 codes get the column offset m * 256; uint16 / int32 codes are
    the table addresses themselves, added in `path` order.

    Returns (vals (ndev*P, k) f32, rows (ndev*P, k) int32, stats (ndev*P, 2)
    int32); pairs with no tiles or no table keep (+inf, -1, 0).
    """
    dev_t = luts.device
    n_pairs = lut_row.shape[0]
    ndev, cap, m = codes.shape
    p = n_pairs // ndev
    lut_flat = luts.flatten(1)
    lut_row = lut_row.long()
    fmt = code_format(codes)
    codes_flat = gatherable(codes.reshape(ndev * cap, m))
    top_v = torch.full((n_pairs, k), torch.inf, dtype=torch.float32, device=dev_t)
    top_i = torch.full((n_pairs, k), -1, dtype=torch.int32, device=dev_t)
    stats = torch.zeros((n_pairs, 2), dtype=torch.int32, device=dev_t)
    sq = bound.float().clone()
    ntiles = torch.where(lut_row >= 0, (t1.long() - t0.long()).clamp_min(0), 0)
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
            addr = table_addresses(codes_flat[code_rows], fmt, path)  # (R, bn, W)
            g = lut_flat[lut_row[pr]].gather(1, addr.reshape(pr.shape[0], -1))
            d = sum_columns(g.reshape(addr.shape))
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
    pair_lb, bound, sq, out_v, out_i, stats, k: int, block_n: int, path: str = "gather",
    plan: dict | None = None, split_ms: dict | None = None,
) -> None:
    """Enqueue `csrc/adc_topk_tiles.cu` on the current stream (checked inputs;
    `luts` (R, A) contiguous; `path` picks the instantiation, `plan` from
    `scan_plan` (default: the plan of this k and width) the block), or for a
    `gtab` plan the in-place block of `csrc/adc_topk_wide.cu`, or for a
    `select` plan the chain of `csrc/adc_topk_select.cu`, over the pairs of
    `order` (`split_ms` as `_launch_wide`'s)."""
    ndev, cap, w = codes.shape
    n_pairs = lut_row.shape[0]
    plan = plan or scan_plan(k, luts.shape[1])
    tiles = (t0, t1, tile_block, tile_row0)
    if wide(plan):
        launch_wide = _launch_scan_select if plan["select"] else _launch_scan_wide
        launch_wide(luts, lut_row, codes, order, n_valid, pair_q, pair_lb, bound, sq, out_v,
                    out_i, stats, k, block_n, path, plan, split_ms, tiles=tiles)
        return
    err = _build.library().adc_topk_tiles_launch(
        luts.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order.data_ptr(),
        t0.data_ptr(), t1.data_ptr(), tile_block.data_ptr(), tile_row0.data_ptr(),
        n_valid.data_ptr(), pair_q.data_ptr(), pair_lb.data_ptr(),
        bound.data_ptr(), sq.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        stats.data_ptr(), n_pairs, n_pairs // ndev, cap, w, luts.shape[1],
        code_format(codes), int(path == "onehot"), k, block_n,
        torch.cuda.current_stream(luts.device).cuda_stream,
    )
    _build.check(err, "adc_topk_tiles")


def window_runs(
    starts: torch.Tensor, n_valid: torch.Tensor, lut_row: torch.Tensor, block_n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The windows scan written as tile runs: pair i's tiles are the blocks
    0 .. ceil(n_valid[i] / block_n) - 1 of its window (row0 = t * block_n,
    block = starts[i] / block_n + t); pairs without a table or rows get
    none.  All inputs flat (n_pairs,).  Returns (t0, t1, tile_block,
    tile_row0) int32 over the concatenated runs."""
    nt = torch.where(lut_row >= 0, (n_valid.long() + block_n - 1) // block_n, 0)
    nt = nt.clamp_min(0)
    t1 = torch.cumsum(nt, 0)
    t0 = t1 - nt
    pair = torch.repeat_interleave(torch.arange(nt.numel(), device=nt.device), nt)
    t = torch.arange(pair.numel(), device=nt.device) - t0[pair]
    blk = starts.long()[pair] // block_n + t
    i32 = torch.int32
    return t0.to(i32), t1.to(i32), blk.to(i32), (t * block_n).to(i32)


def adc_topk_windows_plain(
    luts, lut_row, codes, starts, n_valid, pair_q, pair_lb, bound, k: int,
    block_n: int, path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5's contract in plain tensor code: each filled pair's window blocks
    as a tile run (`window_runs`), scanned by `adc_topk_tiles_plain` in
    lockstep -- one valid execution order of the kernel's blocks.  Inputs
    flat over (dev, pair) as there; returns the same triple."""
    t0, t1, blk, row0 = window_runs(starts, n_valid, lut_row, block_n)
    return adc_topk_tiles_plain(
        luts, lut_row, codes, blk, row0, n_valid, pair_q, pair_lb, bound, t0, t1,
        k, block_n, path,
    )


def launch_windows(
    luts, lut_row, codes, order, starts, n_valid, pair_q, pair_lb, bound, sq,
    out_v, out_i, stats, k: int, block_n: int, path: str = "gather",
    plan: dict | None = None, split_ms: dict | None = None,
) -> None:
    """Enqueue `csrc/adc_topk_windows.cu` on the current stream (checked
    inputs): one block per entry of `order` (the filled pairs), or for a
    `gtab` / `select` plan the in-place block / the select chain over them
    (`plan` and `split_ms` as `launch`)."""
    ndev, cap, w = codes.shape
    n_pairs = lut_row.shape[0]
    plan = plan or scan_plan(k, luts.shape[1])
    if wide(plan):
        launch_wide = _launch_scan_select if plan["select"] else _launch_scan_wide
        launch_wide(luts, lut_row, codes, order, n_valid, pair_q, pair_lb, bound, sq, out_v,
                    out_i, stats, k, block_n, path, plan, split_ms, starts=starts)
        return
    err = _build.library().adc_topk_windows_launch(
        luts.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order.data_ptr(),
        starts.data_ptr(), n_valid.data_ptr(), pair_q.data_ptr(),
        pair_lb.data_ptr(), bound.data_ptr(), sq.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), stats.data_ptr(), order.shape[0], n_pairs // ndev, cap,
        w, luts.shape[-1], code_format(codes), int(path == "onehot"), k, block_n,
        torch.cuda.current_stream(luts.device).cuda_stream,
    )
    _build.check(err, "adc_topk_windows")


def scan_unit_starts(order, lut_row, n_valid, block_n: int, t0=None, t1=None) -> torch.Tensor:
    """B2 / B5's units under a `gtab` or `select` plan: unit u is pair
    order[u], with its tiles t1 - t0 of the queue (B2: `t0` / `t1` from
    `pair_runs`) or its window's ceil(n_valid / block_n) blocks (B5), none
    without a table (lut_row < 0) -- csrc `pair_tiles` (the select's
    `unit_tiles`).  All inputs flat over the pairs; returns the units'
    first tiles and then their total, (n_units + 1,) int64: the twin of the
    in-place launcher's plan kernel (`ustart`)."""
    pair = torch.as_tensor(order).long()
    if t0 is not None:
        nt = (t1.long()[pair] - t0.long()[pair]).clamp_min(0)
    else:
        nt = (n_valid.long()[pair].clamp_min(0) + block_n - 1) // block_n
    nt = torch.where(lut_row.long()[pair] >= 0, nt, 0)
    return torch.cat([nt.new_zeros(1), torch.cumsum(nt, 0)])


def scan_unit_tiles(order, lut_row, n_valid, block_n: int, t0=None, t1=None) -> np.ndarray:
    """The tile counts of B2 / B5's units (`scan_unit_starts`), the
    `unit_tiles` of `run_plan`, as int64 numpy."""
    def dev(x):
        return None if x is None else torch.as_tensor(x)

    ustart = scan_unit_starts(dev(order), dev(lut_row), dev(n_valid), block_n, dev(t0), dev(t1))
    return np.diff(ustart.cpu().numpy()).astype(np.int64)


# -- B6 / B7: the multi-table block (csrc/adc_topk_multi.cuh) --------------

# tables a B6 block may hold (G), widest first; B7 holds one
TOPK_GROUPS = (4, 1)
# SM clocks per warp-wide shared-memory lookup of one table's entry at
# random addresses: LDS.32 alone (G = 1), LDS.128 of four interleaved tables
# (G = 4) (tools/bench_smem_lookup.cu on an H100 SXM)
_LOOKUP_CLOCKS = {1: 3.16, 4: 2.54}
# H100 SXM: warp lookups per second at one per SM clock (132 SMs at 1.98
# GHz) and the HBM rate, the two rates of the cost model that picks G
_SM_LOOKUPS_PER_S = 132 * 1.98e9
_HBM_BYTES_PER_S = 3.35e12
# what the multi-table block declares statically beside the dynamic part
_MULTI_STATIC_SMEM = 4096
# tables a unit of the in-place block may hold (G), widest first, and its
# SM clocks (at the model's 1.98 GHz) per warp-wide lookup of one table's
# entry read where it lies (random addresses of a 65,536-entry table: one
# 4-byte load a table at G = 1, one 8- / 16-byte load of the interleaved
# tables at G = 2 / 4), in the role of `_LOOKUP_CLOCKS`: B6 at Q = 4 over
# 2M uint16 rows of W = 16 at each G, tools/probe_inplace.py's `g_sweep`
# on an NVIDIA H100 80GB HBM3, 700.00 W (0.901 / 0.508 / 0.354 ms)
INPLACE_GROUPS = (4, 2, 1)
_INPLACE_CLOCKS = {1: 58.9, 2: 33.2, 4: 23.1}


def topk_table_width(fmt: int, w: int, table_width: int) -> int:
    """Table entries a B6 / B7 block holds per table: raw uint8 codes of
    width W address only the first W * 256, direct addresses all A."""
    return w * 256 if fmt == 0 else table_width


def topk_smem(g: int, k: int, a_used: int) -> int:
    """Dynamic shared memory of a B6 / B7 block (csrc `multi_smem_bytes`):
    G tables of `a_used` entries, G top-k lists and one merge buffer, one
    pass of candidates."""
    return (g * a_used + 2 * g * k + 2 * k + 2 * _SCAN_PASS) * 4


def _least_cost(nq, rows, w: int, item: int, groups, clocks: dict, fits) -> int | None:
    """The G of `groups` that `fits` with the least modelled time: per unit
    of G tables, its rows times the larger of their code bytes over the HBM
    rate and their W * G lookups at `clocks[G]`."""
    best = best_cost = None
    for g in groups:
        if not fits(g):
            continue
        per_row = max(w * item / _HBM_BYTES_PER_S, w * g * clocks[g] / 32 / _SM_LOOKUPS_PER_S)
        cost = sum(-(-int(q) // g) * int(r) for q, r in zip(nq, rows)) * per_row
        if best is None or cost < best_cost:
            best, best_cost = g, cost
    return best


def topk_plan(
    nq, rows, k: int, fmt: int, w: int, table_width: int, groups=TOPK_GROUPS
) -> dict:
    """How one B6 / B7 launch runs, for groups of nq[i] tables over rows[i]
    rows each: {"g", "gtab", "select", "smem"}.

    With k <= SCAN_K_MAX, of the G in `groups` whose shared-memory block
    fits `SMEM_BUDGET` (G tables beside their lists), the one of least
    modelled time (`_least_cost` at `_LOOKUP_CLOCKS`).  When none fits, the
    in-place block (`gtab`: the tables read where they lie) at the G of
    `INPLACE_GROUPS` up to max(groups) of least modelled time at
    `_INPLACE_CLOCKS` (B7's groups=(1,) keeps G = 1); past SCAN_K_MAX the
    select kernels (`select`: no list is kept; `gtab` and `smem` from
    `wide_layout`).  The same on every device; raises ValueError for k < 1
    only.
    """
    _check_k(k)
    a_used = topk_table_width(fmt, w, table_width)
    if k > SCAN_K_MAX:
        return dict(g=1, **wide_layout(k, a_used, _MULTI_STATIC_SMEM))
    item = (1, 2, 4)[fmt]

    def fits(used):
        return lambda g: topk_smem(g, k, used) + _MULTI_STATIC_SMEM <= SMEM_BUDGET

    g = _least_cost(nq, rows, w, item, groups, _LOOKUP_CLOCKS, fits(a_used))
    if g is not None:
        return dict(g=g, gtab=False, select=False, smem=topk_smem(g, k, a_used))
    inplace = [g for g in INPLACE_GROUPS if g <= max(groups)]
    g = _least_cost(nq, rows, w, item, inplace, _INPLACE_CLOCKS, fits(0))
    return dict(g=g, gtab=True, select=False, smem=topk_smem(g, k, 0))


def topk_group_size(
    nq, rows, k: int, fmt: int, w: int, table_width: int, groups=TOPK_GROUPS
) -> int:
    """G, the tables one B6 / B7 block scans together (`topk_plan`)."""
    return topk_plan(nq, rows, k, fmt, w, table_width, groups)["g"]


def topk_units(row_offsets, table_offsets, g: int) -> torch.Tensor:
    """The units of grouped B6: group i (rows [row_offsets[i],
    row_offsets[i+1]) of the code array, table rows [table_offsets[i],
    table_offsets[i+1])) cut into units of at most g tables.  Returns a
    (n_units, 4) int32 CPU tensor {row0, n_rows, q0, nq}; groups without
    rows or tables have none."""
    units = []
    for r0, r1, t0, t1 in zip(row_offsets[:-1], row_offsets[1:], table_offsets[:-1],
                              table_offsets[1:]):
        if r1 > r0:
            units += [(r0, r1 - r0, q, min(g, t1 - q)) for q in range(t0, t1, g)]
    return torch.tensor(units, dtype=torch.int32).reshape(-1, 4)


def run_plan(unit_tiles, n_blocks: int) -> dict:
    """How the B6 / B7 launch cuts the units' tiles into runs (the twin of
    `topk_multi`, csrc/adc_topk_multi.cuh, and of the select kernels'
    `select_pass`, csrc/adc_topk_select.cu, for B2 / B5's units too:
    `scan_unit_tiles`; there a unit with runs in several blocks counts its
    histogram in slot `first`).

    The units' tiles, concatenated, are T tiles; nb = min(n_blocks, T)
    blocks take [b * T // nb, (b + 1) * T // nb) each, and a run is the part
    of one unit in one block.  Returns numpy arrays over the runs, in tile
    order: `block`, `unit`, the unit's tiles [`t0`, `t1`), the scratch
    `slot` (block + unit) and the unit's `first` / `last` blocks as the
    kernel computes them; and `nb`, `T`.
    """
    tiles = np.asarray(unit_tiles, np.int64)
    starts = np.concatenate([[0], np.cumsum(tiles)])
    t_all = int(starts[-1])
    nb = min(int(n_blocks), t_all)
    if nb == 0:
        e = np.zeros(0, np.int64)
        return dict(block=e, unit=e, t0=e, t1=e, slot=e, first=e, last=e, nb=0, T=0)
    bstarts = np.arange(nb + 1, dtype=np.int64) * t_all // nb
    cuts = np.union1d(starts, bstarts)
    s0, s1 = cuts[:-1], cuts[1:]
    unit = np.searchsorted(starts, s0, side="right") - 1
    block = np.searchsorted(bstarts, s0, side="right") - 1
    u_start, u_cnt = starts[unit], tiles[unit]
    return dict(
        block=block, unit=unit, t0=s0 - u_start, t1=s1 - u_start, slot=block + unit,
        first=((u_start + 1) * nb - 1) // t_all, last=((u_start + u_cnt) * nb - 1) // t_all,
        nb=nb, T=t_all,
    )


def adc_topk_plain(
    tables: torch.Tensor, codes: torch.Tensor, bound: torch.Tensor, k: int, block_n: int,
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor]:
    """B6's function in plain tensor code.

    tables (Q, A) f32; codes (N, W) raw uint8 (+ column offsets) or uint16 /
    int32 direct addresses; bound (Q,) f32.  Row r belongs to tile
    r // block_n; a tile is kept iff its smallest distance is <= bound[q].
    Returns the k smallest rows of the kept tiles by (distance, row):
    ((Q, k) f32, (Q, k) int32), (+inf, -1) in lanes without a row.  Rows
    are scored in chunks of whole tiles (entries added in `path` order, as
    the kernel does) and each chunk merged into the running list by a
    stable sort, the list first: its rows are the lower ones.
    """
    q_n, n = tables.shape[0], codes.shape[0]
    dev = tables.device
    fmt = code_format(codes)
    src = gatherable(codes)
    best_v = torch.full((q_n, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_ROWS // max(q_n, 1) // block_n) * block_n
    for s in range(0, n, step):
        addr = table_addresses(src[s : s + step], fmt, path)     # (R, W)
        r = addr.shape[0]
        d = sum_columns(tables[:, addr])                          # (Q, R)
        nt = -(-r // block_n)
        pad = torch.full((q_n, nt * block_n - r), torch.inf, device=dev)
        tmin = torch.cat([d, pad], 1).reshape(q_n, nt, block_n).amin(-1)
        keep = (tmin <= bound[:, None]).repeat_interleave(block_n, 1)[:, :r]
        d = torch.where(keep, d, torch.inf)
        rows = torch.arange(s, s + r, dtype=torch.int32, device=dev).expand(q_n, r)
        allv = torch.cat([best_v, d], 1)
        alli = torch.cat([best_i, rows], 1)
        order = torch.sort(allv, dim=1, stable=True).indices[:, :k]
        best_v, best_i = allv.gather(1, order), alli.gather(1, order)
    return best_v, torch.where(torch.isfinite(best_v), best_i, -1)


def adc_topk_grouped_plain(
    tables: torch.Tensor, codes: torch.Tensor, bound: torch.Tensor, k: int, block_n: int,
    row_offsets, table_offsets, path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped B6 in plain tensor code: for each group, `adc_topk_plain` of
    its table rows over its rows alone (rows numbered from the group's
    first); table rows outside every group, or of a group without rows,
    read (+inf, -1)."""
    q_n = tables.shape[0]
    out_v = torch.full((q_n, k), torch.inf, dtype=torch.float32, device=tables.device)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32, device=tables.device)
    for r0, r1, t0, t1 in zip(row_offsets[:-1], row_offsets[1:], table_offsets[:-1],
                              table_offsets[1:]):
        if t1 > t0 and r1 > r0:
            out_v[t0:t1], out_i[t0:t1] = adc_topk_plain(
                tables[t0:t1], codes[r0:r1], bound[t0:t1], k, block_n, path)
    return out_v, out_i


# per (device, stream): the scratch lists and the zeroed tickets of B6 / B7,
# grown as calls need and kept, so a call allocates nothing
_WORKSPACE: dict = {}


def _workspace(dev: torch.device, entries: int, n_tickets: int):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    part_v, part_i, tickets = _WORKSPACE.get(key, (None, None, None))
    if part_v is None or part_v.numel() < entries:
        entries = max(entries, 1 << 16)
        part_v = torch.empty((entries,), dtype=torch.float32, device=dev)
        part_i = torch.empty((entries,), dtype=torch.int32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros((max(n_tickets, 1 << 12),), dtype=torch.int32, device=dev)
    _WORKSPACE[key] = (part_v, part_i, tickets)
    return part_v, part_i, tickets


# per (device, stream): the select kernels' int32 scratch (`select_scratch`;
# the launcher zeroes what it needs), grown as calls need and kept
_SELECT_WORKSPACE: dict = {}


def _select_workspace(dev: torch.device, entries: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SELECT_WORKSPACE.get(key)
    if buf is None or buf.numel() < entries:
        buf = torch.empty((max(entries, 1 << 16),), dtype=torch.int32, device=dev)
        _SELECT_WORKSPACE[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(name: str, *args: int) -> int:
    n = getattr(_build.library(), name)(*args)
    if n <= 0:
        raise RuntimeError(f"{name}{args}: no resident block (cudaError_t {-n})")
    return n


def _grid(dev: torch.device, name: str, *args: int) -> int:
    """Blocks of a B6 / B7 launch: the SMs times the resident blocks of the
    instantiation `args` name (code format, onehot flag, width, ...)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count * _blocks_per_sm(
        name, *args)


# csrc/adc_topk_select.cu: histogram bins of a digit (the size of the
# candidate buffer it takes the place of, 2 * _SCAN_PASS), int32 fields of a
# unit's state, rows a unit's bucket may hold, bucket pool rows a unit adds,
# keys one sort block holds in shared memory
_SELECT_BINS = 2048
_SELECT_STATE = 12
_SELECT_BUCKET = 8192
_SELECT_POOL_PER_UNIT = 256
_SORT_CHUNK = 16384


def select_scratch(n_units: int, n_blocks: int, n_q: int = 0) -> int:
    """int32 scratch entries of one call of the select kernels (csrc
    `carve`): each unit's state, a histogram for each block's slot (a unit
    whose runs lie in one block counts in shared memory; one cut over blocks
    in the slot of its first), the bucket pool's counter, a tie count for
    each of at most n_blocks + n_units runs, each unit's first tile
    (int64), B2 / B5's n_q query bounds at the call's start, and a pool of
    `_SELECT_POOL_PER_UNIT` 8-byte (key, row) rows a unit (at least one
    `_SELECT_BUCKET`) for the buckets; a bucket the pool cannot hold takes
    the third digit instead.  The k winners go to the output itself, and
    rows are scored again in every pass, so nothing grows with k or the
    rows: 2,108 bytes a unit and 8,196 a block (B2 / B5 also 4 a query)
    beside the outputs' 8k a unit."""
    head = n_units * _SELECT_STATE + n_blocks * _SELECT_BINS + 2 + n_blocks + n_units
    head += head % 2 + 2 * (n_units + 1) + n_q + n_q % 2
    return head + 2 * (n_units * _SELECT_POOL_PER_UNIT + _SELECT_BUCKET)


def select_sort_smem(k: int) -> int:
    """Dynamic shared memory of the select's sort block: 8-byte keys of the
    k winners rounded up to a power of two of at least 8,192 (eight a
    thread of its 1,024) and at most `_SORT_CHUNK` (a larger k sorts its
    long strides in device memory)."""
    n2 = 8192
    while n2 < k and n2 < _SORT_CHUNK:
        n2 *= 2
    return n2 * 8


# the steps of one select call in launch order (csrc `SEL_STEPS`): a
# memset of the states and histograms, the plan (the units' first tiles),
# six scoring passes (the last three empty unless a unit's bucket
# overflows), the bucket pass, the sort
SELECT_STEPS = ("memset", "plan", "hist0", "hist1", "compact", "hist2", "compact2", "ties",
                "bucket", "sort")
# CUDA launches (kernels and memsets) since `ops.reset_launches()`: the
# select chain's, as its launcher counts them, and the in-place block's
# (its plan kernel but for B6 over one code array, the interleave at G >
# 1, the scan)
cuda_launches = {"adc_topk_select": 0, "adc_topk_wide": 0}


# per (device, stream): the in-place block's interleaved tables (B6 at G >
# 1: n_units * A * G floats), grown as calls need and kept
_INTERLEAVE_WORKSPACE: dict = {}


def _interleave_workspace(dev: torch.device, floats: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _INTERLEAVE_WORKSPACE.get(key)
    if buf is None or buf.numel() < floats:
        buf = torch.empty((floats,), dtype=torch.float32, device=dev)
        _INTERLEAVE_WORKSPACE[key] = buf
    return buf


def _unit_starts(dev: torch.device, n_units: int) -> torch.Tensor:
    """The in-place launchers' (n_units + 1,) int64 scratch for the units'
    first tiles (their plan kernel's `ustart`), in the select's workspace."""
    return _select_workspace(dev, 2 * (n_units + 1))[: 2 * (n_units + 1)].view(torch.int64)


def interleave_plain(tables: torch.Tensor, units: torch.Tensor | None, g: int,
                     a_used: int) -> torch.Tensor:
    """The in-place block's interleaved tables in plain tensor code (csrc
    `adc_topk_interleave_kernel`): unit u's nq <= g tables, rows q0 .. q0 +
    nq - 1 of `tables` (units (n_units, 4) {row0, n_rows, q0, nq}, or None:
    ceil(Q / g) units of consecutive tables), entries [0, a_used), as
    (n_units, a_used, g), 0.0 past nq."""
    q_n = tables.shape[0]
    if units is None:
        q0 = torch.arange(0, q_n, g)
        nq = (q_n - q0).clamp(max=g)
    else:
        q0, nq = units[:, 2].long().cpu(), units[:, 3].long().cpu()
    out = torch.zeros((q0.shape[0], a_used, g), dtype=tables.dtype, device=tables.device)
    for j in range(g):
        live = torch.nonzero(nq > j).flatten()
        out[live.to(tables.device), :, j] = tables[(q0[live] + j).to(tables.device), :a_used]
    return out


def _launch_wide(tables, codes, bound, units, n_valid, out_v, out_i, k: int, block_n: int,
                 plan: dict, n_units: int, win_len: int, path: str,
                 split_ms: dict | None = None) -> None:
    """Enqueue B6 (`units` or None, `n_valid` None) or B7 (`n_valid`,
    `win_len`) past the shared-memory block: `csrc/adc_topk_select.cu` for
    a `select` plan (G = 1), else the in-place block of
    `csrc/adc_topk_wide.cu` at the plan's G (at G > 1 its interleave kernel
    first, into `_interleave_workspace`).  Either adds its CUDA launches to
    `cuda_launches`; a select call given a dict `split_ms` waits for its
    steps and fills in each one's ms on the card (`SELECT_STEPS`, timed by
    CUDA events)."""
    q_n = tables.shape[0]
    dev = tables.device
    w, fmt = codes.shape[-1], code_format(codes)
    onehot = int(path == "onehot")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [None if x is None else x.data_ptr() for x in (bound, units, n_valid)]
    if plan["select"]:
        gtab = int(plan["gtab"])
        n_blocks = _grid(dev, "adc_topk_select_blocks_per_sm", fmt, onehot, w, tables.shape[1],
                         gtab, 0)
        scratch = _select_workspace(dev, select_scratch(n_units, n_blocks))
        _select_call(
            _build.library().adc_topk_select_launch, dev, split_ms,
            tables.data_ptr(), codes.data_ptr(), *ptr, out_v.data_ptr(), out_i.data_ptr(),
            scratch.data_ptr(), win_len, n_units, q_n, codes.shape[0], w, tables.shape[1], fmt,
            onehot, k, block_n, gtab, n_blocks)
        return
    g = plan["g"]
    n_blocks = _grid(dev, "adc_topk_wide_blocks_per_sm", fmt, onehot, w, tables.shape[1], k, g, 0)
    buf_v, buf_i, tickets = _workspace(dev, (n_blocks + n_units) * g * k, n_blocks + 2 * n_units)
    ilv = None
    if g > 1:
        ilv = _interleave_workspace(dev, n_units * topk_table_width(fmt, w, tables.shape[1]) * g)
    err = _build.library().adc_topk_wide_launch(
        tables.data_ptr(), codes.data_ptr(), *ptr, out_v.data_ptr(), out_i.data_ptr(),
        buf_v.data_ptr(), buf_i.data_ptr(), tickets.data_ptr(),
        None if ilv is None else ilv.data_ptr(), _unit_starts(dev, n_units).data_ptr(), win_len,
        n_units, q_n, codes.shape[0], w, tables.shape[1], fmt, onehot, k, block_n, g, n_blocks,
        stream,
    )
    _build.check(err, "adc_topk_wide")
    # the plan (grouped units, B7's windows), the interleave (G > 1), the scan
    planned = units is not None or n_valid is not None
    cuda_launches["adc_topk_wide"] += planned + (g > 1) + 1


def _launch_scan_wide(luts, lut_row, codes, order, n_valid, pair_q, pair_lb, bound, sq, out_v,
                      out_i, stats, k: int, block_n: int, path: str, plan: dict,
                      split_ms: dict | None = None, tiles=None, starts=None) -> None:
    """Enqueue B2 (`tiles` = (t0, t1, tile_block, tile_row0)) or B5
    (`starts`) under a `gtab` plan: the in-place block of
    `csrc/adc_topk_wide.cu` over the pairs of `order` as G = 1 units, each
    pair's tiles cut over the grid (its plan kernel's `ustart`, the twin
    of `scan_unit_starts`, in the select's scratch), arguments as `launch`
    / `launch_windows` take them (`split_ms` unused).  Adds its 2 CUDA
    launches (plan, scan) to `cuda_launches`."""
    ndev, cap, w = codes.shape
    dev = luts.device
    fmt, onehot = code_format(codes), int(path == "onehot")
    n_units = order.shape[0]
    t0, t1, tb, tr = (None,) * 4 if tiles is None else tiles
    ustart = _unit_starts(dev, n_units)
    n_blocks = _grid(dev, "adc_topk_wide_blocks_per_sm", fmt, onehot, w, luts.shape[1], k, 1, 1)
    part_v, part_i, tickets = _workspace(dev, (n_blocks + n_units) * k, n_blocks + 5 * n_units)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _build.library().adc_topk_scan_wide_launch(
        luts.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order.data_ptr(),
        ustart.data_ptr(), ptr(t0), ptr(t1), ptr(tb), ptr(tr), ptr(starts), n_valid.data_ptr(),
        pair_q.data_ptr(), pair_lb.data_ptr(), bound.data_ptr(), sq.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), stats.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        tickets.data_ptr(), n_units, lut_row.shape[0] // ndev, cap, w, luts.shape[1], fmt,
        onehot, k, block_n, n_blocks, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "adc_topk_scan_wide")
    cuda_launches["adc_topk_wide"] += 2


def _launch_scan_select(luts, lut_row, codes, order, n_valid, pair_q, pair_lb, bound, sq,
                        out_v, out_i, stats, k: int, block_n: int, path: str, plan: dict,
                        split_ms: dict | None = None, tiles=None, starts=None) -> None:
    """Enqueue B2 (`tiles` = (t0, t1, tile_block, tile_row0)) or B5
    (`starts`) under a `select` plan: `csrc/adc_topk_select.cu` over the
    pairs of `order`, arguments as `launch` / `launch_windows` take them.
    It adds its CUDA launches to `cuda_launches` and fills `split_ms` as
    `_launch_wide` does."""
    ndev, cap, w = codes.shape
    dev = luts.device
    fmt, onehot, gtab = code_format(codes), int(path == "onehot"), int(plan["gtab"])
    n_units, n_q = order.shape[0], bound.shape[0]
    n_blocks = _grid(dev, "adc_topk_select_blocks_per_sm", fmt, onehot, w, luts.shape[1], gtab,
                     1)
    scratch = _select_workspace(dev, select_scratch(n_units, n_blocks, n_q))
    t0, t1, tb, tr = (None,) * 4 if tiles is None else (t.data_ptr() for t in tiles)
    _select_call(
        _build.library().adc_topk_scan_select_launch, dev, split_ms,
        luts.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order.data_ptr(), t0, t1, tb, tr,
        None if starts is None else starts.data_ptr(), n_valid.data_ptr(), pair_q.data_ptr(),
        pair_lb.data_ptr(), bound.data_ptr(), sq.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        stats.data_ptr(), scratch.data_ptr(), n_units, n_q, lut_row.shape[0] // ndev, cap, w,
        luts.shape[1], fmt, onehot, k, block_n, gtab, n_blocks)


def _select_call(fn, dev: torch.device, split_ms: dict | None, *args) -> None:
    """Call a select launcher with `args`, then its step counter, its split
    array (when `split_ms` is a dict) and `dev`'s current stream: add its
    CUDA launches to `cuda_launches`, raise on an error, fill `split_ms`."""
    launched = ctypes.c_int(0)
    split = None if split_ms is None else (ctypes.c_float * len(SELECT_STEPS))()
    err = fn(*args, ctypes.addressof(launched), None if split is None else ctypes.addressof(split),
             torch.cuda.current_stream(dev).cuda_stream)
    cuda_launches["adc_topk_select"] += launched.value
    _build.check(err, "adc_topk_select")
    if split_ms is not None:
        split_ms.update(zip(SELECT_STEPS, split))


def launch_topk(
    tables, codes, bound, out_v, out_i, k: int, block_n: int, g: int, units=None,
    path: str = "gather", plan: dict | None = None, split_ms: dict | None = None,
) -> None:
    """Enqueue `csrc/adc_topk.cu` (or, for a `gtab` / `select` `plan` from
    `topk_plan`, `adc_topk_wide.cu` / `adc_topk_select.cu`; a plan's G
    stands for `g`; None: the shared-memory block at G = g) on the
    current stream (checked inputs: tables (Q, A), codes (N, W), bound (Q,)
    or None, out (Q, k); `units` a (n_units, 4) int32 tensor on the card
    from `topk_units`, or None for ceil(Q / g) units over all N rows): one
    launch, its split lists merged inside it (a `select` plan: the chain of
    `SELECT_STEPS`, `adc_topk_select.cu`, `split_ms` as `_launch_wide`'s)."""
    q_n, n = tables.shape[0], codes.shape[0]
    dev = tables.device
    w, fmt = codes.shape[1], code_format(codes)
    g = g if plan is None else plan["g"]
    n_units = -(-q_n // g) if units is None else units.shape[0]
    if plan is not None and wide(plan):
        _launch_wide(tables, codes, bound, units, None, out_v, out_i, k, block_n, plan,
                     n_units, 0, path, split_ms)
        return
    onehot = int(path == "onehot")
    n_blocks = _grid(dev, "adc_topk_blocks_per_sm", fmt, onehot, w, tables.shape[1], k, g)
    part_v, part_i, tickets = _workspace(dev, (n_blocks + n_units) * g * k,
                                         n_blocks + 2 * n_units)
    err = _build.library().adc_topk_launch(
        tables.data_ptr(), codes.data_ptr(), None if bound is None else bound.data_ptr(),
        None if units is None else units.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), tickets.data_ptr(), n_units, q_n, n, w,
        tables.shape[1], fmt, onehot, k, block_n, g, n_blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "adc_topk")


def adc_topk_pairs_plain(
    tables: torch.Tensor, addrs: torch.Tensor, n_valid: torch.Tensor, k: int,
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor]:
    """B7's function in plain tensor code: tables (P, A) f32, addrs (P, L, W)
    uint16 / int32 direct addresses, n_valid (P,) int32.  Per pair, the k
    smallest of its rows below n_valid by (distance, row), entries added in
    `path` order: ((P, k) f32, (P, k) int32), (+inf, -1) in lanes without
    a row."""
    p, win, _ = addrs.shape
    dev = tables.device
    fmt = code_format(addrs)
    src = gatherable(addrs)
    out_v = torch.full((p, k), torch.inf, dtype=torch.float32, device=dev)
    out_i = torch.full((p, k), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(win, device=dev)
    per = max(1, _PLAIN_ROWS // max(win, 1))
    for s in range(0, p, per):
        addr = table_addresses(src[s : s + per], fmt, path)        # (p', L, W)
        g = tables[s : s + per].gather(1, addr.reshape(addr.shape[0], -1))
        d = sum_columns(g.reshape(addr.shape))                     # (p', L)
        d = torch.where(lane < n_valid[s : s + per, None].long(), d, torch.inf)
        vals, idx = torch.sort(d, dim=1, stable=True)
        kk = min(k, win)
        out_v[s : s + per, :kk] = vals[:, :kk]
        out_i[s : s + per, :kk] = torch.where(torch.isfinite(vals[:, :kk]), idx[:, :kk], -1).int()
    return out_v, out_i


def launch_pairs(tables, addrs, n_valid, out_v, out_i, k: int, block_n: int,
                 path: str = "gather", plan: dict | None = None,
                 split_ms: dict | None = None) -> None:
    """Enqueue `csrc/adc_topk_pairs.cu` (or, for a `gtab` / `select` `plan`
    from `topk_plan`, `adc_topk_wide.cu` / `adc_topk_select.cu`, `split_ms` as
    `_launch_wide`'s) on the current stream (checked inputs:
    tables (P, A), addrs (P, L, W), n_valid (P,) int32, out (P, k)
    pre-filled with (+inf, -1)): one launch, each pair's valid tiles cut
    into runs across the grid and merged inside it."""
    p, win, w = addrs.shape
    dev = tables.device
    if plan is not None and wide(plan):
        _launch_wide(tables, addrs, None, None, n_valid, out_v, out_i, k, block_n, plan, p,
                     win, path, split_ms)
        return
    fmt = code_format(addrs)
    onehot = int(path == "onehot")
    n_blocks = _grid(dev, "adc_topk_pairs_blocks_per_sm", fmt, onehot, w, tables.shape[1], k)
    part_v, part_i, tickets = _workspace(dev, (n_blocks + p) * k, n_blocks + 2 * p)
    err = _build.library().adc_topk_pairs_launch(
        tables.data_ptr(), addrs.data_ptr(), n_valid.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), tickets.data_ptr(), p, win, w,
        tables.shape[1], fmt, onehot, k, block_n, n_blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "adc_topk_pairs")
