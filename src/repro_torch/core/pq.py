"""Product quantization: codebook training and encoding (offline phase).

A D-dim residual vector is split into M subvectors of d_sub = D/M dims; each
subvector is quantized to one of 256 codewords (uint8 id), giving the paper's
4D/M compression (f32 -> M bytes).
"""

from __future__ import annotations

import numpy as np
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


def procrustes(x: torch.Tensor, y: torch.Tensor) -> np.ndarray:
    """The orthonormal R minimising ||x R - y||_F: `U Vᵀ` from the SVD of
    `xᵀ y` (OPQ's rotation update).

    The (D, D) product `xᵀ y` over the rows runs on the tensors' device in
    f32 (full f32 on the card: the package keeps TF32 off); the D x D SVD
    runs in numpy on the host, as the reference's does.  Returns (D, D) f32.
    """
    u, _, vt = np.linalg.svd((x.float().T @ y.float()).cpu().numpy())
    return np.ascontiguousarray((u @ vt).astype(np.float32))


def train_opq(
    residuals: torch.Tensor,
    m: int,
    pq_iters: int = 20,
    opq_iters: int = 5,
    generator: torch.Generator | None = None,
) -> tuple[np.ndarray, torch.Tensor]:
    """OPQ-style whole-space rotation + PQ codebooks (alternating descent).

    Learns an orthonormal R that aligns the residual distribution with the
    subspace split (the non-parametric OPQ iteration), on the residuals'
    device:

      repeat opq_iters times (at least once):
        1. train PQ codebooks on the rotated residuals X·R;
        2. decode Y = decode(encode(X·R));
        3. Procrustes update R = U·Vᵀ from SVD(Xᵀ·Y) (`procrustes`);

    then the codebooks are retrained against the final R.  Rotation acts on
    the whole space, so (x - c)·R = x·R - c·R: callers rotate centroids and
    data once (`core.index.rotate_rows`).  Squared L2 is invariant under R,
    so ADC distances still estimate the true ones; only the quantisation
    error shrinks.  The k-means seeding draws from `generator` (the
    reference's from `jax.random`, so the two agree in quality, not bits).

    Returns (rotation (D, D) f32 numpy, codebook (M, 256, d_sub) f32 on the
    residuals' device).
    """
    x = residuals.float()
    r_mat = np.eye(x.shape[1], dtype=np.float32)
    for _ in range(max(int(opq_iters), 1)):
        rot = x @ torch.as_tensor(r_mat, device=x.device)
        codebook = train_pq(rot, m, iters=pq_iters, generator=generator)
        r_mat = procrustes(x, pq_decode(codebook, pq_encode(codebook, rot)))
    codebook = train_pq(x @ torch.as_tensor(r_mat, device=x.device), m, iters=pq_iters,
                        generator=generator)
    return r_mat, codebook


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
