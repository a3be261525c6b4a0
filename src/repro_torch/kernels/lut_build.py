"""Kernel B1 (LUT build): its plain PyTorch version and its CUDA launcher.

The CUDA source is `csrc/lut_build.cu`; `ops.build_luts` is the wrapper
that checks inputs, counts launches and picks between the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NCODES = 256
# pairs per chunk of the plain version: bounds its (chunk, M, 256, dsub)
# difference tensor at about 0.5 GB for SIFT geometry
_PLAIN_CHUNK = 4096


def build_luts_plain(codebook: torch.Tensor, qmc: torch.Tensor) -> torch.Tensor:
    """(M, 256, dsub) x (N, M, dsub) -> (N, M, 256) f32 squared-L2 tables.

    The kernel's arithmetic step for step: per entry, the dsub squared
    differences (r - c)^2 are added in coordinate order, each product and
    sum rounded on its own -- so the result is bit-equal to the kernel.
    """
    n, m, dsub = qmc.shape
    out = torch.empty((n, m, NCODES), dtype=torch.float32, device=qmc.device)
    for s in range(0, n, _PLAIN_CHUNK):
        diff = qmc[s : s + _PLAIN_CHUNK, :, None, :] - codebook[None]
        acc = torch.zeros(diff.shape[:-1], dtype=torch.float32, device=qmc.device)
        for d in range(dsub):
            acc = acc + diff[..., d] * diff[..., d]
        out[s : s + _PLAIN_CHUNK] = acc
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
