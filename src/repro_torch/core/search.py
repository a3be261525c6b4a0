"""ADC scan + top-k: online stages (c) and (d) of IVFPQ (plain tensor path).

Selections are stable sorts followed by a slice, so equal distances keep
the lower index -- the tie rule of the reference's `jax.lax.top_k`.
"""

from __future__ import annotations

import torch


def adc_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance computation.

    Args:
      lut: (M, 256) float32.
      codes: (N, M) uint8 codeword ids.

    Returns:
      (N,) float32 approximate squared distances.
    """
    cols = torch.arange(lut.shape[0], device=lut.device)
    return lut[cols[None, :], codes.long()].sum(-1)


def topk_smallest(dists: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest distances (values, indices) along the last axis."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def merge_topk(
    vals_a: torch.Tensor,
    ids_a: torch.Tensor,
    vals_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k lists (the paper's DPU-local heap merge, vectorized)."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    mvals, midx = topk_smallest(vals, k)
    return mvals, torch.gather(ids, -1, midx)


def masked_topk_smallest(
    dists: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a padded scan: invalid lanes are pushed to float max."""
    big = torch.finfo(dists.dtype).max
    return topk_smallest(torch.where(valid, dists, big), k)
