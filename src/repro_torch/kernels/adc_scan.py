"""Kernel B8 (the plain ADC scan): its plain PyTorch version and its CUDA
launcher.

The CUDA source is `csrc/adc_scan.cu` (row loading and the column-order
sum from `csrc/adc_topk_common.cuh`); `ops.adc_scan` and
`ops.adc_scan_flat` are the wrappers.  Codes are raw uint8 PQ codes (the
column offset m * 256 is added when a row is scored) or uint16 / int32
direct addresses into a [LUT | combo sums | 0] table (§4.3).  `path` is the
reference's: "gather" adds a row's entries in column order, "onehot" in
ascending address order (`adc_topk.table_addresses`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.adc_topk import (
    SMEM_BUDGET,
    code_format,
    gatherable,
    sum_columns,
    table_addresses,
)

# rows scored per step of the plain version: bounds its gather temporaries
_PLAIN_ROWS = 1 << 22


def adc_scan_plain(table: torch.Tensor, codes: torch.Tensor, path: str = "gather"
                   ) -> torch.Tensor:
    """(A,) f32 table x (N, W) codes -> (N,) f32: each row's W table
    entries added in `path` order, as the kernel does (bit-equal)."""
    fmt = code_format(codes)
    src = gatherable(codes)
    out = torch.empty((codes.shape[0],), dtype=torch.float32, device=table.device)
    for s in range(0, codes.shape[0], _PLAIN_ROWS):
        out[s : s + _PLAIN_ROWS] = sum_columns(
            table[table_addresses(src[s : s + _PLAIN_ROWS], fmt, path)]
        )
    return out


def table_in_place(table_width: int, fmt: int, w: int) -> bool:
    """Whether the kernel reads the table where it lies (its GTAB
    instantiation): the entries the codes address (W * 256 for raw codes)
    do not fit a block's `SMEM_BUDGET` bytes of shared memory."""
    used = w * 256 if fmt == 0 else table_width
    return used * 4 > SMEM_BUDGET


def launch(table: torch.Tensor, codes: torch.Tensor, out: torch.Tensor,
           path: str = "gather") -> None:
    """Enqueue `csrc/adc_scan.cu` on the current stream (checked inputs:
    table (A,), codes (N, W), out (N,); `path` picks the instantiation, the
    width the table's place, `table_in_place`)."""
    n, w = codes.shape
    fmt = code_format(codes)
    err = _build.library().adc_scan_launch(
        table.data_ptr(), codes.data_ptr(), out.data_ptr(), n, w, table.shape[0],
        fmt, int(path == "onehot"), int(table_in_place(table.shape[0], fmt, w)),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(err, "adc_scan")
