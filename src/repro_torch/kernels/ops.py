"""Wrappers of the query path's kernels: checks, outputs, dispatch, counts.

API:
  build_luts(codebook, qmc, rows=None)          B1: (N or R, M, 256) f32 tables
  adc_topk_tiles(luts, codes, ..., lut_row=)    B2: pruned tile scan + top-k
  rerank_dists(queries, cand, vectors, ...)     B3: exact re-rank, fused gather

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and then either launches its CUDA kernel on the current stream
(tensors on a CUDA device) or runs the kernel's plain PyTorch version
(tensors on the CPU).  There is no fallback: a CUDA tensor either launches
the kernel or raises.  `launches[name]` counts kernel launches only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import adc_topk as _topk
from repro_torch.kernels import lut_build as _lut
from repro_torch.kernels import rerank as _rerank

NCODES = 256

# kernel launches per wrapper since the last `reset_launches()`
launches = {"build_luts": 0, "adc_topk_tiles": 0, "rerank_dists": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    if dsub not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"build_luts kernel: dsub={dsub} not in (1, 2, 4, 8, 16, 32)")
    n_out = qmc.shape[0] if rows is None else rows.shape[0]
    out = torch.empty((n_out, m, NCODES), dtype=torch.float32, device=dev)
    _lut.launch(codebook, qmc, out, rows)
    launches["build_luts"] += 1
    return out


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat work-queue fused ADC scan + per-pair top-k over raw uint8 codes.

    Shapes, with an optional leading logical-device axis (drop it for one
    device): luts (R, M, 256) f32 tables; lut_row (ndev, P) int32, the
    table row of each pair (-1: none, the pair is not scanned); codes
    (ndev, cap, M) uint8; tile_pair / tile_block / tile_row0 (ndev, T) from
    `emit_tiles` (pair id P marks dummy tiles, which are never launched);
    n_valid (ndev, P).

    `pair_q` ((ndev, P) query index per pair, given with `bound`, the (Q,)
    strict warm-start bounds; +inf for none) and `pair_lb` ((ndev, P)
    lower bounds) drive the whole-tile pruning; without `pair_q` every
    pair is its own query and the result is each pair's exact top-k by
    (distance, row).

    Returns ((ndev, P, k) f32 distances, (ndev, P, k) int32 window rows,
    (ndev, P, 2) int32 [tiles skipped, rows avoided]).  Pairs that emitted
    no tiles, or have no table, read (+inf, -1) and (0, 0).
    """
    single = codes.dim() == 2
    if single:
        codes, lut_row = codes[None], lut_row[None]
        tile_pair, tile_block, tile_row0 = tile_pair[None], tile_block[None], tile_row0[None]
        n_valid = n_valid[None]
        pair_q = None if pair_q is None else pair_q[None]
        pair_lb = None if pair_lb is None else pair_lb[None]
    dev = codes.device
    _check(codes, "codes", torch.uint8, 3, dev)
    ndev, cap, m = codes.shape
    _check(luts, "luts", torch.float32, 3, dev)
    _check(lut_row, "lut_row", torch.int32, 2, dev)
    p = lut_row.shape[1]
    if luts.shape[1:] != (m, NCODES) or lut_row.shape[0] != ndev:
        raise ValueError(
            f"luts {tuple(luts.shape)} / lut_row {tuple(lut_row.shape)}: expected "
            f"(R, {m}, {NCODES}) / ({ndev}, P)"
        )
    lut_row = lut_row.reshape(-1)
    if cap % block_n:
        raise ValueError(f"code capacity {cap} is not a multiple of block_n={block_n}")
    if not 1 <= k <= 4096:
        raise ValueError(f"k={k} outside [1, 4096]")
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
            pair_lb, bound, t0, t1, k, block_n,
        )
    else:
        vals = torch.full((ndev * p, k), torch.inf, dtype=torch.float32, device=dev)
        idx = torch.full((ndev * p, k), -1, dtype=torch.int32, device=dev)
        stats = torch.zeros((ndev * p, 2), dtype=torch.int32, device=dev)
        sq = bound.clone()
        _topk.launch(
            luts, lut_row, codes, order, t0, t1, tile_block, tile_row0, n_valid,
            pair_q, pair_lb, bound, sq, vals, idx, stats, k, block_n,
        )
        launches["adc_topk_tiles"] += 1
    vals = vals.reshape(ndev, p, k)
    idx = idx.reshape(ndev, p, k)
    stats = stats.reshape(ndev, p, 2)
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
