"""Kernels B1 (LUT build) and B4 / B9 (extended tables of co-occurrence
encoding): their plain PyTorch versions and their CUDA launchers.

The CUDA sources are `csrc/lut_build.cu` and `csrc/ext_lut.cu`;
`ops.build_luts`, `ops.build_ext_luts_pairs` and `ops.build_ext_luts` are
the wrappers that check inputs, count launches and pick between the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NCODES = 256
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


def launch(
    codebook: torch.Tensor, qmc: torch.Tensor, out: torch.Tensor,
    rows: torch.Tensor | None = None,
) -> None:
    """Enqueue `csrc/lut_build.cu` on the current stream (checked inputs).

    Output row i is the table of residual `rows[i]` (of row i without
    `rows`)."""
    _, m, dsub = qmc.shape
    err = _build.library().lut_build_launch(
        codebook.data_ptr(), qmc.data_ptr(), None if rows is None else rows.data_ptr(),
        out.data_ptr(), out.shape[0], m, dsub,
        torch.cuda.current_stream(qmc.device).cuda_stream,
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
        out.shape[1], torch.cuda.current_stream(luts.device).cuda_stream,
    )
    _build.check(err, "ext_lut")
