"""Wrappers of the query path's kernels: checks, outputs, dispatch, counts.

API:
  build_luts(codebook, qmc, rows=None)                B1: (N or R, M, 256) tables
  build_ext_luts_pairs(luts, combo_addrs, set_idx)    B4: per-row combo sets
  build_ext_luts(luts, combo_cols, combo_codes)       B9: one shared combo set
  adc_topk_tiles(tables, codes, ..., lut_row=, path=) B2: pruned tile scan + top-k
  adc_topk_windows(tables, codes, starts, ..., path=) B5: pruned windows scan + top-k
  rerank_dists(queries, cand, vectors, ...)           B3: exact re-rank, fused gather
  adc_scan(lut, codes) / adc_scan_flat(ext, addrs)    B8: (N,) ADC distances
  adc_topk(luts, codes, k) / adc_topk_flat(...)       B6: many tables, one code array
  adc_topk_grouped(luts, codes, k, rows, tables)      B6: groups of rows, their own tables
  adc_topk_pairs(tables, addrs, n_valid, k)           B7: materialised per-pair windows
  flash_attention_fwd(q, k, v, scale=, ...)           B10: causal GQA attention forward

The five ADC scans take the reference's `path`: "gather" adds a row's
table entries in column order, "onehot" in ascending table-address order,
the order of the reference's multi-hot x table contraction (the same sums
bit for bit on raw uint8 codes; `adc_topk.table_addresses` states it).
B6 / B7 / B8 are the reference's kernel-level API (`repro.kernels.ops`)
and take its `block_n` too.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then either launches its CUDA kernel on the current stream
(tensors on a CUDA device) or runs the kernel's plain PyTorch version
(tensors on the CPU).  There is no fallback: a CUDA tensor either launches
the kernel or raises.  `launches[name]` counts kernel launches only.  B10
also takes tensors on the meta device, for the dry run (`launch.dryrun`):
it returns an empty output of the kernel's shape and adds the kernel's
FLOPs and bytes to `meta_work` (the branch is chosen by `device.type ==
"meta"` alone).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adc_scan as _scan
from repro_torch.kernels import adc_topk as _topk
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import lut_build as _lut
from repro_torch.kernels import rerank as _rerank

NCODES = 256

# kernel launches per wrapper since the last `reset_launches()`
launches = {
    "build_luts": 0, "build_ext_luts_pairs": 0, "build_ext_luts": 0,
    "adc_topk_tiles": 0, "adc_topk_windows": 0, "rerank_dists": 0,
    "adc_scan": 0, "adc_topk": 0, "adc_topk_pairs": 0, "flash_attention_fwd": 0,
}
# the largest k of B2 / B5's shared-memory block (`adc_topk.scan_plan`);
# a larger k runs the select kernels
SCAN_K_MAX = _topk.SCAN_K_MAX
# the same for B6 / B7 (`adc_topk.topk_plan`)
ADC_TOPK_K_MAX = _topk.SCAN_K_MAX


# work of the kernels called on tensors on the meta device since
# `reset_meta_work()`: the dry run's count of what each call would do
# (`launch.dryrun`); nothing runs there and no launch is counted
meta_work = {"flash_attention_fwd": {"calls": 0, "flops": 0, "bytes": 0}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for name in _topk.cuda_launches:
        _topk.cuda_launches[name] = 0


def reset_meta_work() -> None:
    for work in meta_work.values():
        for key in work:
            work[key] = 0


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_gpu(device: torch.device) -> bool:
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def build_luts(
    codebook: torch.Tensor, qmc: torch.Tensor, rows: torch.Tensor | None = None
) -> torch.Tensor:
    """(M, 256, dsub) codebook x (N, M, dsub) residuals -> (N, M, 256) f32.

    With `rows` ((R,) int32 indices into qmc's first axis) the result is
    (R, M, 256): row i is the table of residual `rows[i]`, and no other
    residual is read.
    """
    dev = qmc.device
    _check(codebook, "codebook", torch.float32, 3, dev)
    _check(qmc, "qmc", torch.float32, 3, dev)
    m, ncodes, dsub = codebook.shape
    if ncodes != NCODES or qmc.shape[1:] != (m, dsub):
        raise ValueError(
            f"build_luts: codebook {tuple(codebook.shape)} vs qmc {tuple(qmc.shape)}"
        )
    if rows is not None:
        _check(rows, "rows", torch.int32, 1, dev)
    if not _on_gpu(dev):
        return _lut.build_luts_plain(codebook, qmc if rows is None else qmc[rows.long()])
    n_out = qmc.shape[0] if rows is None else rows.shape[0]
    out = torch.empty((n_out, m, NCODES), dtype=torch.float32, device=dev)
    _lut.launch(codebook, qmc, out, rows)
    launches["build_luts"] += 1
    return out


def _ext_check(luts: torch.Tensor, t_pad: int | None, n_combos: int) -> tuple:
    dev = luts.device
    if luts.dim() == 3:
        luts = luts.flatten(1)
    _check(luts, "luts", torch.float32, 2, dev)
    ma = luts.shape[1]
    if ma % NCODES:
        raise ValueError(f"luts: width {ma} is not M * {NCODES}")
    need = ma + n_combos + 1
    t_pad = need if t_pad is None else t_pad
    if t_pad < need:
        raise ValueError(f"t_pad={t_pad} < M*256 + n_combos + 1 = {need}")
    return luts, t_pad


def build_ext_luts_pairs(
    luts: torch.Tensor,
    combo_addrs: torch.Tensor,
    set_idx: torch.Tensor,
    t_pad: int | None = None,
) -> torch.Tensor:
    """Extended tables, each row with its own combo set (kernel B4).

    luts (R, M, 256) or (R, M*256) f32 (B1's rows); combo_addrs
    (n_sets, n_combos, L) int32 flat addresses col * 256 + code; set_idx
    (R,) int32, the combo set of each row.  Returns (R, t_pad) f32 rows
    [table | combo sums | 0], t_pad >= M*256 + n_combos + 1 (default that).
    """
    dev = luts.device
    _check(combo_addrs, "combo_addrs", torch.int32, 3, dev)
    luts, t_pad = _ext_check(luts, t_pad, combo_addrs.shape[1])
    _check(set_idx, "set_idx", torch.int32, 1, dev)
    if set_idx.shape[0] != luts.shape[0]:
        raise ValueError(f"set_idx: {set_idx.shape[0]} rows, luts {luts.shape[0]}")
    if not _on_gpu(dev):
        return _lut.ext_lut_pairs_plain(luts, combo_addrs, set_idx, t_pad)
    out = torch.empty((luts.shape[0], t_pad), dtype=torch.float32, device=dev)
    _lut.launch_ext(luts, combo_addrs, set_idx, out)
    launches["build_ext_luts_pairs"] += 1
    return out


def build_ext_luts(
    luts: torch.Tensor, combo_cols: torch.Tensor, combo_codes: torch.Tensor
) -> torch.Tensor:
    """Extended tables with one combo set for every row (kernel B9).

    luts (Q, M, 256) f32; combo_cols / combo_codes (n_combos, L) int32.
    Returns (Q, A) f32, A = M*256 + n_combos + 1 exactly (the sentinel is
    the last slot).
    """
    dev = luts.device
    _check(combo_cols, "combo_cols", torch.int32, 2, dev)
    _check(combo_codes, "combo_codes", torch.int32, 2, dev)
    if combo_cols.shape != combo_codes.shape:
        raise ValueError("combo_cols and combo_codes differ in shape")
    caddr = (combo_cols * NCODES + combo_codes).contiguous()
    luts, t_pad = _ext_check(luts, None, caddr.shape[0])
    if not _on_gpu(dev):
        return _lut.ext_lut_plain(luts, caddr, t_pad)
    out = torch.empty((luts.shape[0], t_pad), dtype=torch.float32, device=dev)
    _lut.launch_ext(luts, caddr[None], None, out)
    launches["build_ext_luts"] += 1
    return out


def _tables_2d(tables: torch.Tensor, codes: torch.Tensor, dev) -> torch.Tensor:
    """(R, A) f32 tables, from (R, A) or (R, M, 256); raw uint8 codes need
    A >= M * 256 (their addresses are m * 256 + code)."""
    if tables.dim() == 3:
        tables = tables.flatten(1)
    _check(tables, "luts", torch.float32, 2, dev)
    w = codes.shape[-1]
    if _topk.code_format(codes) == 0 and tables.shape[1] < w * NCODES:
        raise ValueError(
            f"luts: width {tables.shape[1]} < {w} * {NCODES} for raw uint8 codes"
        )
    return tables


def adc_topk_tiles(
    luts: torch.Tensor,
    codes: torch.Tensor,
    tile_pair: torch.Tensor,
    tile_block: torch.Tensor,
    tile_row0: torch.Tensor,
    n_valid: torch.Tensor,
    k: int,
    *,
    lut_row: torch.Tensor,
    block_n: int = 1024,
    pair_q: torch.Tensor | None = None,
    pair_lb: torch.Tensor | None = None,
    bound: torch.Tensor | None = None,
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat work-queue fused ADC scan + per-pair top-k (kernel B2).

    Shapes, with an optional leading logical-device axis (drop it for one
    device): luts (R, A) f32 tables (or (R, M, 256)); lut_row (ndev, P)
    int32, the table row of each pair (-1: none, the pair is not scanned);
    codes (ndev, cap, W): raw uint8 PQ codes (the column offset is added
    in the scan; A >= M * 256), or uint16 / int32 direct addresses into
    the tables (§4.3); tile_pair / tile_block / tile_row0 (ndev, T) from
    `emit_tiles` (pair id P marks dummy tiles, which are never launched);
    n_valid (ndev, P).

    `pair_q` ((ndev, P) query index per pair, given with `bound`, the (Q,)
    strict warm-start bounds; +inf for none) and `pair_lb` ((ndev, P)
    lower bounds) drive the whole-tile pruning; without `pair_q` every
    pair is its own query and the result is each pair's exact top-k by
    (distance, row).  `path` is "gather" or "onehot" (the order each row's
    entries are added in; module docstring).

    Returns ((ndev, P, k) f32 distances, (ndev, P, k) int32 window rows,
    (ndev, P, 2) int32 [tiles skipped, rows avoided]).  Pairs that emitted
    no tiles, or have no table, read (+inf, -1) and (0, 0).

    Any k >= 1 and any table width.  On the card `adc_topk.scan_plan`
    picks the block: the shared-memory block up to k = `SCAN_K_MAX` (4096)
    with a table that fits beside the list in 227 KB (39,664 entries at k
    = 4096, 55,792 at k = 64), else the in-place block (a wider table read
    where it lies, each pair's tiles cut over the grid into runs whose
    lists merge in the launch); past 4096 the select kernels (each pair's tiles cut
    over the grid, its k-th key selected, its winners sorted; a table too
    wide read in place).  The merged per-query answer is the same either
    way; the pairs' tails past the query's k-th and the counters may
    differ.
    """
    _check_path(path, "adc_topk_tiles")
    single = codes.dim() == 2
    if single:
        codes, lut_row = codes[None], lut_row[None]
        tile_pair, tile_block, tile_row0 = tile_pair[None], tile_block[None], tile_row0[None]
        n_valid = n_valid[None]
        pair_q = None if pair_q is None else pair_q[None]
        pair_lb = None if pair_lb is None else pair_lb[None]
    dev = codes.device
    _check(codes, "codes", codes.dtype, 3, dev)
    ndev, cap, _ = codes.shape
    luts = _tables_2d(luts, codes, dev)
    _check(lut_row, "lut_row", torch.int32, 2, dev)
    p = lut_row.shape[1]
    if lut_row.shape[0] != ndev:
        raise ValueError(f"lut_row {tuple(lut_row.shape)}: expected ({ndev}, P)")
    lut_row = lut_row.reshape(-1)
    if cap % block_n:
        raise ValueError(f"code capacity {cap} is not a multiple of block_n={block_n}")
    plan = _topk.scan_plan(k, luts.shape[1])
    for name, t in (("tile_pair", tile_pair), ("tile_block", tile_block),
                    ("tile_row0", tile_row0)):
        if t.dim() != 2 or t.shape[0] != ndev or t.shape != tile_pair.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected (ndev, T)")
    if n_valid.shape != (ndev, p):
        raise ValueError(f"n_valid: shape {tuple(n_valid.shape)} != ({ndev}, {p})")

    def i32(t):
        return t.to(device=dev, dtype=torch.int32).contiguous().reshape(-1)

    if pair_q is None:
        pair_q = torch.arange(ndev * p, dtype=torch.int32, device=dev)
        bound = torch.full((ndev * p,), torch.inf, dtype=torch.float32, device=dev)
    elif bound is None:
        raise ValueError("adc_topk_tiles: pair_q needs the (Q,) query bounds `bound`")
    else:
        pair_q = i32(pair_q)
    if pair_lb is None:
        pair_lb = torch.full((ndev * p,), -torch.inf, dtype=torch.float32, device=dev)
    pair_lb = pair_lb.to(device=dev, dtype=torch.float32).contiguous().reshape(-1)
    bound = bound.to(device=dev, dtype=torch.float32).contiguous()
    n_valid = i32(n_valid)
    tile_block, tile_row0 = i32(tile_block), i32(tile_row0)
    t0, t1, order = _topk.pair_runs(tile_pair.to(dev), p)

    if not _on_gpu(dev):
        vals, idx, stats = _topk.adc_topk_tiles_plain(
            luts, lut_row, codes, tile_block, tile_row0, n_valid, pair_q,
            pair_lb, bound, t0, t1, k, block_n, path,
        )
    else:
        vals = torch.full((ndev * p, k), torch.inf, dtype=torch.float32, device=dev)
        idx = torch.full((ndev * p, k), -1, dtype=torch.int32, device=dev)
        stats = torch.zeros((ndev * p, 2), dtype=torch.int32, device=dev)
        sq = bound.clone()
        _topk.launch(
            luts, lut_row, codes, order, t0, t1, tile_block, tile_row0, n_valid,
            pair_q, pair_lb, bound, sq, vals, idx, stats, k, block_n, path, plan,
        )
        launches["adc_topk_tiles"] += 1
    vals = vals.reshape(ndev, p, k)
    idx = idx.reshape(ndev, p, k)
    stats = stats.reshape(ndev, p, 2)
    if single:
        return vals[0], idx[0], stats[0]
    return vals, idx, stats


def adc_topk_windows(
    luts: torch.Tensor,
    codes: torch.Tensor,
    starts: torch.Tensor,
    n_valid: torch.Tensor,
    k: int,
    *,
    lut_row: torch.Tensor,
    block_n: int = 1024,
    pair_q: torch.Tensor | None = None,
    pair_lb: torch.Tensor | None = None,
    bound: torch.Tensor | None = None,
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused ADC scan + per-pair top-k over per-pair windows (kernel B5).

    Pair p scans rows [starts[p], starts[p] + n_valid[p]) of its device's
    codes (block-aligned starts, the layout's `slot_start`), tile by tile
    of `block_n` rows.  Shapes as `adc_topk_tiles` (leading `ndev` axis
    optional): luts (R, A) f32, lut_row (ndev, P) int32 (-1: not
    scanned), codes (ndev, cap, W) uint8 / uint16 / int32, starts and
    n_valid (ndev, P).  `pair_q` + `bound` and `pair_lb` drive the pruning
    as there, and `path`.  Filled pairs (a table and rows) run best-first by
    `pair_lb`.

    Returns ((ndev, P, k) f32 distances, (ndev, P, k) int32 window rows,
    (ndev, P, 2) int32 [tiles skipped, rows avoided]); other pairs read
    (+inf, -1) and (0, 0).  Any k >= 1 and table width, the block picked
    as for `adc_topk_tiles` (`adc_topk.scan_plan`).
    """
    _check_path(path, "adc_topk_windows")
    single = codes.dim() == 2
    if single:
        codes, lut_row, starts, n_valid = codes[None], lut_row[None], starts[None], n_valid[None]
        pair_q = None if pair_q is None else pair_q[None]
        pair_lb = None if pair_lb is None else pair_lb[None]
    dev = codes.device
    _check(codes, "codes", codes.dtype, 3, dev)
    ndev, cap, _ = codes.shape
    luts = _tables_2d(luts, codes, dev)
    _check(lut_row, "lut_row", torch.int32, 2, dev)
    p = lut_row.shape[1]
    for name, t in (("lut_row", lut_row), ("starts", starts), ("n_valid", n_valid)):
        if t.shape != (ndev, p):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != ({ndev}, {p})")
    if cap % block_n:
        raise ValueError(f"code capacity {cap} is not a multiple of block_n={block_n}")
    plan = _topk.scan_plan(k, luts.shape[1])

    def i32(t):
        return t.to(device=dev, dtype=torch.int32).contiguous().reshape(-1)

    lut_row, starts, n_valid = i32(lut_row), i32(starts), i32(n_valid)
    if pair_q is None:
        pair_q = torch.arange(ndev * p, dtype=torch.int32, device=dev)
        bound = torch.full((ndev * p,), torch.inf, dtype=torch.float32, device=dev)
    elif bound is None:
        raise ValueError("adc_topk_windows: pair_q needs the (Q,) query bounds `bound`")
    else:
        pair_q = i32(pair_q)
    if pair_lb is None:
        pair_lb = torch.full((ndev * p,), -torch.inf, dtype=torch.float32, device=dev)
    pair_lb = pair_lb.to(device=dev, dtype=torch.float32).contiguous().reshape(-1)
    bound = bound.to(device=dev, dtype=torch.float32).contiguous()

    if not _on_gpu(dev):
        vals, idx, stats = _topk.adc_topk_windows_plain(
            luts, lut_row, codes, starts, n_valid, pair_q, pair_lb, bound, k, block_n, path,
        )
    else:
        filled = torch.nonzero((lut_row >= 0) & (n_valid > 0)).flatten()
        order = filled[torch.sort(pair_lb[filled], stable=True).indices].to(torch.int32)
        vals = torch.full((ndev * p, k), torch.inf, dtype=torch.float32, device=dev)
        idx = torch.full((ndev * p, k), -1, dtype=torch.int32, device=dev)
        stats = torch.zeros((ndev * p, 2), dtype=torch.int32, device=dev)
        sq = bound.clone()
        _topk.launch_windows(
            luts, lut_row, codes, order, starts, n_valid, pair_q, pair_lb, bound,
            sq, vals, idx, stats, k, block_n, path, plan,
        )
        launches["adc_topk_windows"] += 1
    vals, idx, stats = vals.reshape(ndev, p, k), idx.reshape(ndev, p, k), stats.reshape(ndev, p, 2)
    if single:
        return vals[0], idx[0], stats[0]
    return vals, idx, stats


def rerank_dists(
    queries: torch.Tensor,
    cand: torch.Tensor,
    vectors: torch.Tensor,
    id_dev: torch.Tensor,
    id_row: torch.Tensor,
    row_base: torch.Tensor,
    *,
    block_k: int = 0,
) -> torch.Tensor:
    """Exact re-rank: (Q, D) f32 queries x (Q, K) int32 candidate ids -> (Q, K) f32.

    Each candidate's raw row is gathered from its home shard of the store
    (`vectors` (rows, D) f32 or bf16, `id_dev`/`id_row` (ids_cap,) int32,
    `row_base` (ndev,) int64) and its squared L2 distance summed in f32.
    Candidates that are -1, beyond the id map or unmapped read +inf.
    `block_k` is the candidate slice per thread block (0 = all K); it
    cannot change a bit of the result.
    """
    dev = queries.device
    _check(queries, "queries", torch.float32, 2, dev)
    _check(cand, "cand", torch.int32, 2, dev)
    if vectors.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vectors: expected float32 or bfloat16, got {vectors.dtype}")
    _check(vectors, "vectors", vectors.dtype, 2, dev)
    _check(id_dev, "id_dev", torch.int32, 1, dev)
    _check(id_row, "id_row", torch.int32, 1, dev)
    _check(row_base, "row_base", torch.int64, 1, dev)
    if cand.shape[0] != queries.shape[0] or vectors.shape[1] != queries.shape[1]:
        raise ValueError(
            f"rerank_dists: queries {tuple(queries.shape)}, cand {tuple(cand.shape)}, "
            f"vectors {tuple(vectors.shape)}"
        )
    if id_row.shape != id_dev.shape:
        raise ValueError("id_dev and id_row differ in length")
    if block_k < 0:
        raise ValueError(f"block_k={block_k} < 0")
    if not _on_gpu(dev):
        return _rerank.rerank_dists_plain(
            queries, cand, vectors, id_dev, id_row, row_base, block_k
        )
    out = torch.empty(cand.shape, dtype=torch.float32, device=dev)
    _rerank.launch(queries, cand, vectors, id_dev, id_row, row_base, out, block_k)
    launches["rerank_dists"] += 1
    return out


def _check_path(path: str, name: str) -> None:
    if path not in ("gather", "onehot"):
        raise ValueError(f"{name}: path must be 'gather' or 'onehot', got {path!r}")


def _check_codes(codes: torch.Tensor, name: str, ndim: int, direct: bool, dev) -> int:
    """Code format of `codes` (raw uint8, or uint16 / int32 direct addresses)."""
    fmt = _topk.code_format(codes)
    if direct and fmt == 0:
        raise TypeError(f"{name}: direct addresses are uint16 or int32, got uint8")
    if not direct and fmt != 0:
        raise TypeError(f"{name}: raw PQ codes are uint8, got {codes.dtype}")
    _check(codes, name, codes.dtype, ndim, dev)
    return fmt


def _check_geometry(block_n: int, n_rows: int) -> None:
    if block_n < 1:
        raise ValueError(f"block_n={block_n} < 1")
    # a B6 / B7 pass forms row indices up to 1024 (its rows) past the last row
    if n_rows + max(block_n, 1024) >= 2**31:
        raise ValueError(f"{n_rows} rows: row indices are int32")


def _run_scan(table: torch.Tensor, codes: torch.Tensor, block_n: int, path: str,
              name: str) -> torch.Tensor:
    _check_path(path, name)
    _check_geometry(block_n, 0)
    if not _on_gpu(table.device):
        return _scan.adc_scan_plain(table, codes, path)
    out = torch.empty((codes.shape[0],), dtype=torch.float32, device=table.device)
    if codes.shape[0]:
        _scan.launch(table, codes, out, path)
        launches["adc_scan"] += 1
    return out


def adc_scan(
    lut: torch.Tensor, codes: torch.Tensor, *, block_n: int = 1024, path: str = "gather"
) -> torch.Tensor:
    """(M, 256) f32 table x (N, M) uint8 PQ codes -> (N,) f32 ADC distances
    (kernel B8; the column offset m * 256 is added in the kernel).
    `block_n` is the reference's tile height; no result depends on it, nor
    on `path` (raw codes are in table order)."""
    dev = lut.device
    _check(lut, "lut", torch.float32, 2, dev)
    _check_codes(codes, "codes", 2, False, dev)
    if lut.shape != (codes.shape[1], NCODES):
        raise ValueError(f"adc_scan: lut {tuple(lut.shape)} vs codes {tuple(codes.shape)}")
    return _run_scan(lut.reshape(-1), codes, block_n, path, "adc_scan")


def adc_scan_flat(
    ext_lut: torch.Tensor, addrs: torch.Tensor, *, block_n: int = 1024,
    path: str = "gather",
) -> torch.Tensor:
    """(A,) f32 table x (N, W) uint16 / int32 direct addresses -> (N,) f32
    (kernel B8): each row's W entries of the table added in column order
    (`path="gather"`) or in ascending address order ("onehot")."""
    dev = ext_lut.device
    _check(ext_lut, "ext_lut", torch.float32, 1, dev)
    _check_codes(addrs, "addrs", 2, True, dev)
    return _run_scan(ext_lut, addrs, block_n, path, "adc_scan_flat")


def _run_topk(tables, codes, k, block_n, path, bound, name, groups=None):
    """B6 over one code array (`groups` None) or over (row_offsets,
    table_offsets) groups: checks, the plan (G, and the refusals, on every
    device), then the plain version or one launch."""
    dev = codes.device
    _check_path(path, name)
    q_n, n = tables.shape[0], codes.shape[0]
    _check_geometry(block_n, n)
    if bound is not None:
        bound = bound.to(device=dev, dtype=torch.float32).contiguous()
        if bound.shape != (q_n,):
            raise ValueError(f"{name}: bound {tuple(bound.shape)}, expected ({q_n},)")
    fmt, w = _topk.code_format(codes), codes.shape[1]
    if groups is None:
        nq, rows = [q_n], [n]
    else:
        r_off, t_off = groups
        nq = [b - a for a, b in zip(t_off[:-1], t_off[1:])]
        rows = [b - a for a, b in zip(r_off[:-1], r_off[1:])]
    plan = _topk.topk_plan(nq, rows, k, fmt, w, tables.shape[1])
    if not _on_gpu(dev):
        if bound is None:
            bound = torch.full((q_n,), torch.inf, dtype=torch.float32, device=dev)
        if groups is None:
            return _topk.adc_topk_plain(tables, codes, bound, k, block_n, path)
        return _topk.adc_topk_grouped_plain(tables, codes, bound, k, block_n, *groups, path)
    out_v = torch.full((q_n, k), torch.inf, dtype=torch.float32, device=dev)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    units = None if groups is None else _topk.topk_units(*groups, plan["g"])
    if q_n and n and (units is None or units.shape[0]):
        if units is not None:
            units = units.to(dev)
        _topk.launch_topk(tables, codes, bound, out_v, out_i, k, block_n, plan["g"], units,
                          path, plan)
        launches["adc_topk"] += 1
    return out_v, out_i


def adc_topk(
    luts: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    *,
    block_n: int = 1024,
    path: str = "gather",
    bound: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + top-k of Q tables over one code array (kernel B6).

    luts (Q, M, 256) or (Q, A >= M * 256) f32; codes (N, M) uint8 PQ codes.
    Row r lies in tile r // block_n.  `bound` ((Q,) f32, optional) is the
    reference's per-query warm start: a tile is merged only if its smallest
    distance is <= bound[q] (+inf: every tile).  Returns the k smallest rows
    of the merged tiles by (distance, row): ((Q, k) f32 ascending, (Q, k)
    int32 row indices), (+inf, -1) in lanes without a row.  One kernel
    launch on the card, for any k >= 1 and table width: `adc_topk.topk_plan`
    picks the shared-memory block (k <= `ADC_TOPK_K_MAX`, tables that fit),
    the in-place one (tables too wide read where they lie, 1, 2 or 4 a
    unit) or past that k the select kernels.
    """
    dev = codes.device
    _check_codes(codes, "codes", 2, False, dev)
    return _run_topk(_tables_2d(luts, codes, dev), codes, k, block_n, path, bound,
                     "adc_topk")


def adc_topk_flat(
    ext_luts: torch.Tensor,
    addrs: torch.Tensor,
    k: int,
    *,
    block_n: int = 1024,
    path: str = "gather",
    bound: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`adc_topk` over direct addresses (kernel B6): ext_luts (Q, A) f32,
    addrs (N, W) uint16 / int32 addresses into each table (a uint16
    address space of 65,536 entries too: the in-place block reads tables
    too wide for shared memory where they lie)."""
    dev = addrs.device
    _check_codes(addrs, "addrs", 2, True, dev)
    _check(ext_luts, "ext_luts", torch.float32, 2, dev)
    return _run_topk(ext_luts, addrs, k, block_n, path, bound, "adc_topk_flat")


def _offsets(x, name: str, end: int) -> list[int]:
    """A host sequence of n_groups + 1 ascending offsets from 0 to <= end."""
    off = [int(v) for v in (x.tolist() if hasattr(x, "tolist") else x)]
    if len(off) < 1 or off[0] != 0 or any(b < a for a, b in zip(off[:-1], off[1:])) \
            or off[-1] > end:
        raise ValueError(f"{name}: expected ascending offsets from 0 to <= {end}")
    return off


def adc_topk_grouped(
    luts: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    row_offsets,
    table_offsets,
    *,
    block_n: int = 1024,
    path: str = "gather",
    bound: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B6 over groups, in one launch: group i is rows [row_offsets[i],
    row_offsets[i+1]) of `codes` and table rows [table_offsets[i],
    table_offsets[i+1]) of `luts`, and each of those table rows gets what
    `adc_topk` (raw uint8 codes) or `adc_topk_flat` (uint16 / int32
    addresses) would give on that group's rows alone: rows numbered from
    the group's first, tiles of `block_n` rows from there, its `bound`
    entry.  The offsets are host sequences (n_groups + 1, from 0);
    table_offsets ends at Q.  Returns ((Q, k) f32, (Q, k) int32), (+inf,
    -1) in lanes without a row.  Domain as `adc_topk`."""
    dev = codes.device
    _topk.code_format(codes)
    _check(codes, "codes", codes.dtype, 2, dev)
    tables = _tables_2d(luts, codes, dev)
    r_off = _offsets(row_offsets, "row_offsets", codes.shape[0])
    t_off = _offsets(table_offsets, "table_offsets", tables.shape[0])
    if len(r_off) != len(t_off) or t_off[-1] != tables.shape[0]:
        raise ValueError(
            f"adc_topk_grouped: {len(r_off) - 1} row groups, {len(t_off) - 1} table groups "
            f"ending at {t_off[-1]} of {tables.shape[0]} tables"
        )
    return _run_topk(tables, codes, k, block_n, path, bound, "adc_topk_grouped",
                     (r_off, t_off))


def adc_topk_pairs(
    tables: torch.Tensor,
    addrs: torch.Tensor,
    n_valid: torch.Tensor,
    k: int,
    *,
    block_n: int = 1024,
    path: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pair fused scan + top-k over materialised windows (kernel B7).

    tables (P, A) f32; addrs (P, L, W) uint16 / int32 direct addresses (L a
    multiple of block_n, as the reference asserts); n_valid (P,) valid rows
    of each window.  Returns per pair the k smallest of its valid rows by
    (distance, row): ((P, k) f32, (P, k) int32 window rows), (+inf, -1) in
    lanes without a row.  One kernel launch on the card, for any k >= 1 and
    table width (`adc_topk.topk_plan` with one table a block).
    """
    dev = addrs.device
    _check_path(path, "adc_topk_pairs")
    _check_codes(addrs, "addrs", 3, True, dev)
    _check(tables, "tables", torch.float32, 2, dev)
    p, win, w = addrs.shape
    _check_geometry(block_n, win)
    if tables.shape[0] != p or n_valid.shape != (p,):
        raise ValueError(
            f"adc_topk_pairs: tables {tuple(tables.shape)}, addrs {tuple(addrs.shape)}, "
            f"n_valid {tuple(n_valid.shape)}"
        )
    if win % block_n:
        raise ValueError(f"window length {win} is not a multiple of block_n={block_n}")
    plan = _topk.topk_plan([1] * p, [win] * p, k, _topk.code_format(addrs), w,
                           tables.shape[1], groups=(1,))
    n_valid = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    if not _on_gpu(dev):
        return _topk.adc_topk_pairs_plain(tables, addrs, n_valid, k, path)
    out_v = torch.full((p, k), torch.inf, dtype=torch.float32, device=dev)
    out_i = torch.full((p, k), -1, dtype=torch.int32, device=dev)
    if p:
        _topk.launch_pairs(tables, addrs, n_valid, out_v, out_i, k, block_n, path, plan)
        launches["adc_topk_pairs"] += 1
    return out_v, out_i


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    q_offset: int = 0,
    kv_valid: int | None = None,
    bq: int = 512,
    bk: int = 512,
) -> torch.Tensor:
    """Causal GQA flash-attention forward (kernel B10).

    q (B, Sq, H, hd) bf16 / f32; k, v (B, Sk, KV, hd) bf16 / f32 (one dtype
    for both, which may differ from q's); H a multiple of KV.  Query row i
    sits at absolute position q_offset + i and sees key j iff j <= q_offset
    + i and j < kv_valid (default Sk).  Returns (B, Sq, H, hd) in q's dtype;
    a row with no live key is 0.  `bq` / `bk` are the reference's block
    sizes: clipped to Sq / Sk, they must divide them, as there; the plain
    version runs on them and the kernel tiles on its own.  Any head dim and
    any element offset: the card runs the fast kernel for the head dims of
    `flash_attn.HEAD_DIMS` on 16-byte aligned tensors and the general one
    for the rest (`flash_attn.kernel_variant`).
    """
    dev = q.device
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats or k.dtype not in floats or v.dtype != k.dtype:
        raise TypeError(f"flash_attention_fwd: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    _check(q, "q", q.dtype, 4, dev)
    _check(k, "k", k.dtype, 4, dev)
    _check(v, "v", v.dtype, 4, dev)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, hd) or v.shape != k.shape or kvh == 0 or h % kvh:
        raise ValueError(
            f"flash_attention_fwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    kv_valid = sk if kv_valid is None else int(kv_valid)
    if not 0 <= kv_valid <= sk or q_offset < 0:
        raise ValueError(f"kv_valid={kv_valid} outside [0, {sk}] or q_offset={q_offset} < 0")
    bq, bk = min(bq, sq), min(bk, sk)
    if bq <= 0 or bk <= 0 or sq % bq or sk % bk:
        raise ValueError(f"blocks (bq={bq}, bk={bk}) do not divide (Sq={sq}, Sk={sk})")
    if hd < 1:
        raise ValueError(f"flash_attention_fwd: head dim {hd} < 1")
    if dev.type == "meta":
        # the dry run: an output of the kernel's shape, and the kernel's own
        # work (its bound's FLOPs, its byte model) in `meta_work`
        work = meta_work["flash_attention_fwd"]
        work["calls"] += 1
        work["flops"] += _flash.flash_flops(b, sq, h, hd, q_offset, kv_valid)
        work["bytes"] += _flash.flash_hbm_bytes_per_layer(
            b, sq, sk, h, kvh, hd, bq, q.element_size(), k.element_size())
        return torch.empty(q.shape, dtype=q.dtype, device=dev)
    if not _on_gpu(dev):
        return _flash.flash_attention_fwd_plain(q, k, v, scale, q_offset, kv_valid, bq, bk)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _flash.launch(q, k, v, out, scale, q_offset, kv_valid)
    launches["flash_attention_fwd"] += 1
    return out
