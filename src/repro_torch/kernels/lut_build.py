"""Kernels B1 (LUT build) and B4 / B9 (extended tables of co-occurrence
encoding): their plain PyTorch versions and their CUDA launchers.

The CUDA sources are `csrc/lut_build.cu` and `csrc/ext_lut.cu`;
`ops.build_luts`, `ops.build_ext_luts_pairs` and `ops.build_ext_luts` are
the wrappers that check inputs, count launches and pick between the two.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import SMEM_BUDGET

NCODES = 256
# sub-vector widths with a kernel of their own (`lut_build_kernel<DSUB>`);
# every other width takes `lut_build_wide_kernel`, cut by `wide_plan`
TEMPLATED_DSUB = (1, 2, 4, 8, 16, 32)
WIDE_PG_MAX = 32  # pairs a block
WIDE_ENTRIES_MAX = 256  # (pairs x codewords) a block, one a thread
WIDE_SLICE_MAX = 128  # coordinates a slice
WIDE_STAGES_MAX = 8  # slices in flight
WIDE_SMEM_BUDGET = 100 * 1024  # dynamic shared memory a block: two fit an SM
# bytes of the plain version's (chunk, M, 256, dsub) difference tensor:
# 4096 pairs at SIFT geometry (M = 16, dsub = 8)
_PLAIN_BYTES = 1 << 29
# rows per chunk of the extended-table plain versions
_EXT_CHUNK = 8192


def build_luts_plain(codebook: torch.Tensor, qmc: torch.Tensor) -> torch.Tensor:
    """(M, 256, dsub) x (N, M, dsub) -> (N, M, 256) f32 squared-L2 tables.

    The kernel's arithmetic step for step: per entry, the dsub squared
    differences (r - c)^2 are added in coordinate order, each product and
    sum rounded on its own -- so the result is bit-equal to the kernel.
    """
    n, m, dsub = qmc.shape
    chunk = max(1, _PLAIN_BYTES // (m * NCODES * dsub * 4))
    out = torch.empty((n, m, NCODES), dtype=torch.float32, device=qmc.device)
    for s in range(0, n, chunk):
        diff = qmc[s : s + chunk, :, None, :] - codebook[None]
        acc = torch.zeros(diff.shape[:-1], dtype=torch.float32, device=qmc.device)
        for d in range(dsub):
            acc = acc + diff[..., d] * diff[..., d]
        out[s : s + chunk] = acc
    return out


def _wide_stride(ds: int) -> int:
    """Floats between two rows of a slice in shared memory: ds rounded up
    to whole 16-byte quads, an odd number of them, so that eight
    consecutive rows' LDS.128 reads fall on distinct banks."""
    s4 = -(-ds // 4) * 4
    return s4 if (s4 // 4) % 2 else s4 + 4


@functools.lru_cache(maxsize=256)
def wide_plan(n_pairs: int, m: int, dsub: int, n_sm: int, align: int = 16) -> dict:
    """How `lut_build_wide_kernel` cuts the tables of `n_pairs` residual
    rows, M = `m` sub-spaces of width `dsub`, over a card of `n_sm` SMs,
    when codebook and residuals start at multiples of `align` bytes.

    Block b takes codewords [j0, j0 + cw) of sub-space mi for pairs
    [p0, p0 + pg) (`wide_block`), one entry a thread.  Of the power-of-two
    (pg, cw) with pg <= 32 and pg x cw <= 256 entries, the plan takes the one with the
    least L2 traffic (each residual row is read by 256 / cw blocks, each
    codeword row by ceil(n_pairs / pg)) among those whose grid has at
    least `n_sm` blocks, or the largest grid when none has.  Coordinates
    arrive in `n_slices` slices of `ds` (the last may be shorter), rows
    `stride` floats apart, `stages` slices in flight, in copies of `g`
    bytes; `threads` a block (>= one warp), `smem` bytes of dynamic shared
    memory.  (Cached: callers must not change the dict.)
    """
    if min(n_pairs, m, dsub) <= 0:
        raise ValueError(f"wide lut plan: n_pairs={n_pairs}, m={m}, dsub={dsub}")
    p2 = 1
    while p2 < min(n_pairs, WIDE_PG_MAX):
        p2 *= 2
    shapes = [(pg, cw) for pg in (1, 2, 4, 8, 16, 32) if pg <= p2
              for cw in (1, 2, 4, 8, 16, 32, 64, 128, 256) if pg * cw <= WIDE_ENTRIES_MAX]

    def blocks(pg_cw):
        pg, cw = pg_cw
        return m * (NCODES // cw) * -(-n_pairs // pg)

    def traffic(pg_cw):
        return Fraction(1, pg_cw[0]) + Fraction(1, pg_cw[1])

    fill = [sh for sh in shapes if blocks(sh) >= n_sm]
    if fill:
        pg, cw = min(fill, key=lambda sh: (traffic(sh), blocks(sh)))
    else:
        pg, cw = max(shapes, key=lambda sh: (blocks(sh), -traffic(sh)))
    n_rows = pg + cw
    ds = min(-(-dsub // 4) * 4, WIDE_SLICE_MAX)
    while ds > 4 and n_rows * _wide_stride(ds) * 4 * (1 if ds >= dsub else 2) > WIDE_SMEM_BUDGET:
        ds = -(-(ds // 2) // 4) * 4
    n_slices = -(-dsub // ds)
    stage_bytes = n_rows * _wide_stride(ds) * 4
    stages = max(1, min(n_slices, WIDE_STAGES_MAX, WIDE_SMEM_BUDGET // stage_bytes))
    return dict(
        pg=pg, cw=cw, ncw=NCODES // cw, npg=-(-n_pairs // pg), blocks=blocks((pg, cw)),
        threads=max(32, pg * cw), ds=ds, n_slices=n_slices, stages=stages,
        stride=_wide_stride(ds), g=_build.pow2_dividing(align, dsub * 4), smem=stages * stage_bytes,
    )


def wide_block(plan: dict, b: int, m: int, n_pairs: int) -> tuple[int, int, int, int]:
    """(sub-space, first codeword, first pair, pairs) of block b, as the
    kernel reads them."""
    t, cwi = divmod(b, plan["ncw"])
    p0 = t // m * plan["pg"]
    return t % m, cwi * plan["cw"], p0, min(plan["pg"], n_pairs - p0)


def launch(
    codebook: torch.Tensor, qmc: torch.Tensor, out: torch.Tensor,
    rows: torch.Tensor | None = None,
) -> None:
    """Enqueue `csrc/lut_build.cu` on the current stream (checked inputs):
    `lut_build_kernel<dsub>` for the templated widths, else the wide
    kernel cut by `wide_plan`.

    Output row i is the table of residual `rows[i]` (of row i without
    `rows`)."""
    _, m, dsub = qmc.shape
    n_pairs = out.shape[0]
    stream = torch.cuda.current_stream(qmc.device).cuda_stream
    rows_ptr = None if rows is None else rows.data_ptr()
    if dsub in TEMPLATED_DSUB:
        err = _build.library().lut_build_launch(
            codebook.data_ptr(), qmc.data_ptr(), rows_ptr, out.data_ptr(), n_pairs, m, dsub,
            stream,
        )
    elif n_pairs == 0:
        return
    else:
        plan = wide_plan(n_pairs, m, dsub, _build.sm_count(qmc.device),
                         _build.pow2_dividing(codebook.data_ptr(), qmc.data_ptr()))
        err = _build.library().lut_build_wide_launch(
            codebook.data_ptr(), qmc.data_ptr(), rows_ptr, out.data_ptr(), n_pairs, m, dsub,
            plan["pg"], plan["cw"], plan["ds"], plan["n_slices"], plan["stages"],
            plan["stride"], plan["g"], plan["threads"], plan["smem"], stream,
        )
    _build.check(err, "lut_build")


def _ext_plain(luts, caddr, set_idx, t_pad):
    """[luts row | combo sums | 0] rows; row r sums combo set set_idx[r]
    (set 0 without set_idx) of caddr (n_sets, n_combos, L)."""
    r, ma = luts.shape
    n_combos, combo_len = caddr.shape[1:]
    out = torch.zeros((r, t_pad), dtype=torch.float32, device=luts.device)
    out[:, :ma] = luts
    for s in range(0, r, _EXT_CHUNK):
        lt = luts[s : s + _EXT_CHUNK]
        sets = (caddr[set_idx[s : s + _EXT_CHUNK].long()] if set_idx is not None
                else caddr.expand(lt.shape[0], -1, -1))
        g = lt.gather(1, sets.reshape(lt.shape[0], -1).long())
        g = g.reshape(lt.shape[0], n_combos, combo_len)
        acc = torch.zeros((lt.shape[0], n_combos), dtype=torch.float32, device=luts.device)
        for i in range(combo_len):
            acc = acc + g[..., i]
        out[s : s + _EXT_CHUNK, ma : ma + n_combos] = acc
    return out


def ext_lut_pairs_plain(
    luts: torch.Tensor, combo_addrs: torch.Tensor, set_idx: torch.Tensor, t_pad: int
) -> torch.Tensor:
    """B4's function: (R, M*256) tables, (n_sets, n_combos, L) int32 flat
    combo addresses and (R,) set indices -> (R, t_pad) f32 rows
    [table | combo sums | 0].  Each sum adds its L entries in index order
    from 0, as the kernel does, so the two are bit-equal."""
    return _ext_plain(luts, combo_addrs, set_idx, t_pad)


def ext_lut_plain(luts: torch.Tensor, combo_addrs: torch.Tensor, t_pad: int) -> torch.Tensor:
    """B9's function: every row sums the one (n_combos, L) combo set."""
    return _ext_plain(luts, combo_addrs[None], None, t_pad)


def ext_table_in_place(ma: int) -> bool:
    """Whether B4 / B9 read the row's table of `ma` floats where it lies
    (their GTAB instantiation) instead of a copy in shared memory: M >= 228
    sub-spaces no longer fit a block's 227 KB."""
    return ma * 4 > SMEM_BUDGET


def launch_ext(
    luts: torch.Tensor, combo_addrs: torch.Tensor, set_idx: torch.Tensor | None,
    out: torch.Tensor,
) -> None:
    """Enqueue `csrc/ext_lut.cu` on the current stream (checked inputs):
    luts (R, MA), combo_addrs (n_sets, n_combos, L), set_idx (R,) or None
    (every row reads set 0), out (R, t_pad)."""
    r, ma = luts.shape
    n_combos, combo_len = combo_addrs.shape[-2:]
    err = _build.library().ext_lut_launch(
        luts.data_ptr(), None if set_idx is None else set_idx.data_ptr(),
        combo_addrs.data_ptr(), out.data_ptr(), r, ma, n_combos, combo_len,
        out.shape[1], int(ext_table_in_place(ma)),
        torch.cuda.current_stream(luts.device).cuda_stream,
    )
    _build.check(err, "ext_lut")
