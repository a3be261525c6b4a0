"""The paper's own workloads: SIFT1B / SPACEV1B IVFPQ serving configs
(paper §5.1) plus reduced variants for CPU-scale tests and benchmarks."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    name: str
    n_vectors: int
    dim: int
    m: int                   # PQ subspaces (encoded dims)
    n_clusters: int          # IVF list count
    nprobe: int
    batch_queries: int       # paper processes 1000 queries at a time
    k: int
    n_combos: int = 256      # §4.3 combos per cluster
    block_n: int = 1024      # scan tile height (the MRAM-read-size analogue)

    @property
    def code_bytes(self) -> int:
        """Plain uint8 code storage."""
        return self.n_vectors * self.m


# paper §5.1: SIFT1B = 1e9 x 128d encoded to M=16; IVF4096..16384; k=10
SIFT1B = RetrievalConfig(
    name="sift1b",
    n_vectors=1_000_000_000,
    dim=128,
    m=16,
    n_clusters=4096,
    nprobe=64,
    batch_queries=1000,
    k=10,
)

# SPACEV1B = 1e9 x 100d encoded to M=20
SPACEV1B = RetrievalConfig(
    name="spacev1b",
    n_vectors=1_000_000_000,
    dim=100,
    m=20,
    n_clusters=4096,
    nprobe=64,
    batch_queries=1000,
    k=10,
)


def reduced_retrieval(
    cfg: RetrievalConfig, n_vectors: int = 20_000, n_clusters: int = 64,
    batch_queries: int = 32, dim: int | None = None,
) -> RetrievalConfig:
    return dataclasses.replace(
        cfg,
        n_vectors=n_vectors,
        dim=dim or min(cfg.dim, 32),
        m=min(cfg.m, 8),
        n_clusters=n_clusters,
        nprobe=min(cfg.nprobe, 8),
        batch_queries=batch_queries,
        n_combos=32,
        block_n=256,
    )
