"""Product quantization: codebook training and encoding (offline phase).

A D-dim residual vector is split into M subvectors of d_sub = D/M dims; each
subvector is quantized to one of 256 codewords (uint8 id), giving the paper's
4D/M compression (f32 -> M bytes).
"""

from __future__ import annotations

import torch

from repro_torch.core.kmeans import _pairwise_sq_l2, kmeans

NCODES = 256  # uint8 codeword ids, fixed by the paper (and by Faiss)


def train_pq(
    residuals: torch.Tensor,
    m: int,
    iters: int = 20,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Train per-subspace codebooks on residual vectors.

    Args:
      residuals: (N, D) float32 residuals (x - centroid[assign(x)]).
      m: number of subspaces; D % m == 0.

    Returns:
      codebook B: (M, 256, d_sub) float32 on the residuals' device.
    """
    n, d = residuals.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    sub = residuals.float().reshape(n, m, d // m)
    return torch.stack(
        [kmeans(sub[:, i], NCODES, iters=iters, generator=generator)[0]
         for i in range(m)]
    )


def train_opq(*args, **kwargs):
    """OPQ rotation training is not ported yet (ROADMAP queue A, item 11)."""
    raise NotImplementedError(
        "train_opq is not ported to repro_torch yet; see ROADMAP.md queue A "
        "item 11 (offline build)"
    )


def pq_encode(codebook: torch.Tensor, residuals: torch.Tensor) -> torch.Tensor:
    """Encode residuals (N, D) to (N, M) uint8 codes (nearest codeword)."""
    m, _, dsub = codebook.shape
    n = residuals.shape[0]
    sub = residuals.float().reshape(n, m, dsub)
    codes = torch.empty((n, m), dtype=torch.uint8, device=residuals.device)
    for i in range(m):
        codes[:, i] = _pairwise_sq_l2(sub[:, i], codebook[i]).argmin(dim=1)
    return codes


def pq_decode(codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct residuals from codes: (N, M) uint8 -> (N, D)."""
    m = codebook.shape[0]
    cols = torch.arange(m, device=codebook.device)
    vecs = codebook[cols[None, :], codes.long()]  # (N, M, dsub)
    return vecs.reshape(codes.shape[0], -1)
