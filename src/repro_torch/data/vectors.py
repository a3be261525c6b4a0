"""Synthetic vector datasets reproducing the paper's skew (Fig. 4):
Zipf-distributed cluster sizes, Zipf query popularity, and co-occurring
residual patterns so §4.3's combo mining has real structure to find.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_clustered_vectors(
    n: int,
    dim: int,
    n_centers: int,
    seed: int = 0,
    size_zipf: float = 1.3,
    center_scale: float = 5.0,
    noise: float = 1.0,
    pattern_pool: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xs (N, D), centers (K, D), assignment (N,)).

    size_zipf > 0 skews cluster sizes (paper Fig. 4b: up to 1e6x).
    pattern_pool > 0 draws residuals from a small pool of shared patterns
    (plus noise) -> PQ codes of co-located points repeat -> frequent combos
    (paper Fig. 10 observation: real data has co-occurring items).
    """
    rng, centers, p = _draw_centers(dim, n_centers, seed, size_zipf, center_scale)
    assign = rng.choice(n_centers, n, p=p)
    if pattern_pool > 0:
        pool = rng.normal(0, noise, (pattern_pool, dim)).astype(np.float32)
        pat = rng.integers(0, pattern_pool, n)
        resid = pool[pat] + rng.normal(0, noise * 0.1, (n, dim)).astype(np.float32)
    else:
        resid = rng.normal(0, noise, (n, dim)).astype(np.float32)
    xs = centers[assign] + resid
    return xs.astype(np.float32), centers, assign


@dataclasses.dataclass
class SkewedVectorDataset:
    """Query stream with Zipf-skewed cluster popularity (paper Fig. 4a)."""

    centers: np.ndarray
    noise: float = 1.0
    popularity_zipf: float = 1.1
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 1)
        k = self.centers.shape[0]
        w = 1.0 / np.arange(1, k + 1) ** self.popularity_zipf
        rng.shuffle(w)
        self.popularity = w / w.sum()

    def queries(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 31 + seed)
        which = rng.choice(self.centers.shape[0], n, p=self.popularity)
        return (
            self.centers[which]
            + rng.normal(0, self.noise, (n, self.centers.shape[1]))
        ).astype(np.float32)


def _draw_centers(
    dim: int, n_centers: int, seed: int, size_zipf: float, center_scale: float
) -> tuple[np.random.Generator, np.ndarray, np.ndarray]:
    """The recipe's first draws: (generator, centers (K, D) f32, cluster
    probabilities (K,) f64); the generator goes on to draw the rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, center_scale, (n_centers, dim)).astype(np.float32)
    if size_zipf > 0:
        w = 1.0 / np.arange(1, n_centers + 1) ** size_zipf
        rng.shuffle(w)
        p = w / w.sum()
    else:
        p = np.full(n_centers, 1.0 / n_centers)
    return rng, centers, p


def clustered_centers(
    dim: int,
    n_centers: int,
    seed: int = 0,
    size_zipf: float = 1.3,
    center_scale: float = 5.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(centers (K, D) f32, cluster probabilities (K,) f64).

    The first draws of `make_clustered_vectors` with the same seed, so a
    dataset generated in chunks by `generate_clustered` has the same
    centres and the same Zipf size skew as the numpy recipe.
    """
    return _draw_centers(dim, n_centers, seed, size_zipf, center_scale)[1:]


def generate_clustered(
    n: int,
    dim: int,
    n_centers: int,
    seed: int = 0,
    size_zipf: float = 1.3,
    center_scale: float = 5.0,
    noise: float = 1.0,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    chunk: int = 1 << 22,
) -> tuple[torch.Tensor, np.ndarray]:
    """`make_clustered_vectors`' recipe, generated chunk by chunk on `device`.

    Centres and size skew come from `clustered_centers` (numpy, seeded);
    cluster draws and Gaussian noise come from a `torch.Generator` on
    `device` (cuda unless "cpu" is asked for) seeded with `seed`, one chunk
    of f32 rows at a time, and each chunk is stored in `dtype`.  So a
    100M-row bf16 corpus is made on the card without ever holding it in
    f32.  The values differ from the numpy
    recipe (another generator), the distribution does not.

    Returns (xs (N, D) `dtype` tensor on `device`, centers (K, D) numpy).
    """
    device = resolve_device(device)
    centers, p = clustered_centers(dim, n_centers, seed, size_zipf, center_scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cent = torch.as_tensor(centers, device=device)
    prob = torch.as_tensor(p, dtype=torch.float64, device=device)
    xs = torch.empty((n, dim), dtype=dtype, device=device)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        assign = torch.multinomial(prob, c, replacement=True, generator=gen)
        noise_c = torch.randn((c, dim), generator=gen, device=device)
        xs[s : s + c] = (cent[assign] + noise * noise_c).to(dtype)
    return xs, centers
