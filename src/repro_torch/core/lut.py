"""Lookup-table (LUT) construction -- online stage (b) of IVFPQ.

For a query q and a probed cluster with centroid c, LUT[m, j] is the squared
L2 distance between the m-th subsegment of (q - c) and codeword j of
sub-codebook B_m.  ADC then scores a point with codes e as
    L2(q, x) ~= sum_m LUT[m, e_m].

This is the plain tensor path; the query path builds its tables with the
CUDA kernel behind `kernels.ops.build_luts`.
"""

from __future__ import annotations

import torch


def build_lut(codebook: torch.Tensor, q_minus_c: torch.Tensor) -> torch.Tensor:
    """LUT for one (query, cluster) pair.

    Args:
      codebook: (M, 256, d_sub).
      q_minus_c: (D,) residual of the query w.r.t. the probed centroid.

    Returns:
      (M, 256) float32 table of partial squared distances.
    """
    m, _, dsub = codebook.shape
    diff = codebook - q_minus_c.reshape(m, 1, dsub)
    return (diff * diff).sum(-1)


def build_luts(codebook: torch.Tensor, q_minus_c: torch.Tensor) -> torch.Tensor:
    """Batched LUTs: q_minus_c (B, D) -> (B, M, 256)."""
    m, _, dsub = codebook.shape
    diff = codebook[None] - q_minus_c.reshape(-1, m, 1, dsub)
    return (diff * diff).sum(-1)
