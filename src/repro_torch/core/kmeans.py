"""Lloyd's k-means with random or k-means++ seeding, on tensors.

Used for (a) the IVF coarse quantizer (|C| clusters over full vectors) and
(b) the per-subspace PQ codebooks (256 codewords over d_sub residuals).
Randomness comes only from the caller's `torch.Generator`; the sums are
one-hot products (deterministic on the card, unlike atomic scatter-adds).
"""

from __future__ import annotations

import torch

# rows per (chunk, K) distance block: bounds the temporary at 4 * chunk * K
# bytes (1 GiB at K = 4096) whatever the training-set size
_CHUNK = 1 << 16


def _pairwise_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows of x (N, D) and c (K, D) -> (N, K).

    Uses the ||x||^2 - 2 x.c + ||c||^2 expansion so the (N, K) matrix is
    produced by a single GEMM.
    """
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    return x2 - 2.0 * (x @ c.T) + c2[None, :]


def nearest(x: torch.Tensor, c: torch.Tensor, chunk: int = _CHUNK):
    """(argmin (N,) int64, min squared distance (N,) f32) of x against c."""
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        d2 = _pairwise_sq_l2(x[s : s + chunk].float(), c)
        dmin[s : s + chunk], idx[s : s + chunk] = d2.min(dim=1)
    return idx, dmin


def kmeanspp_init(
    x: torch.Tensor, k: int, generator: torch.Generator | None = None
) -> torch.Tensor:
    """k-means++ seeding: D^2-weighted sampling of k centers from x."""
    n = x.shape[0]
    first = int(torch.randint(n, (1,), generator=generator))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    dmin = _pairwise_sq_l2(x, centers[:1])[:, 0].clamp_min(0.0)
    for i in range(1, k):
        p = dmin / dmin.sum().clamp_min(1e-12)
        idx = int(torch.multinomial(p.cpu().double(), 1, generator=generator))
        centers[i] = x[idx]
        dmin = torch.minimum(dmin, _pairwise_sq_l2(x, centers[i : i + 1])[:, 0])
        dmin.clamp_min_(0.0)
    return centers


def kmeans(
    x: torch.Tensor,
    k: int,
    iters: int = 25,
    init: str = "random",
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm. Returns (centroids (k, D), assignments (N,) int64).

    Empty clusters are re-seeded with the point currently farthest from its
    centroid (standard Faiss-style fixup) so skewed data cannot collapse
    the codebook.  The generator lives on the CPU; the arithmetic runs on
    `x.device`.
    """
    x = x.float()
    n = x.shape[0]
    if init == "kmeans++":
        centers = kmeanspp_init(x, k, generator)
    else:
        idx = torch.randperm(n, generator=generator)[:k].to(x.device)
        centers = x[idx].clone()
    for _ in range(iters):
        assign, dmin = nearest(x, centers)
        counts = torch.bincount(assign, minlength=k).to(x.dtype)
        sums = torch.zeros_like(centers)
        for s in range(0, n, _CHUNK):
            onehot = torch.nn.functional.one_hot(assign[s : s + _CHUNK], k)
            sums += onehot.to(x.dtype).T @ x[s : s + _CHUNK]
        new = sums / counts.clamp_min(1.0)[:, None]
        worst = x[torch.argmax(dmin)]
        centers = torch.where(counts[:, None] > 0, new, worst[None, :])
    assign, _ = nearest(x, centers)
    return centers, assign
