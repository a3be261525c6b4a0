"""Quickstart on the PyTorch/CUDA port: build a MemANNS index over a skewed
synthetic corpus and answer a batch of queries -- the twin of
`examples/quickstart.py`, the whole paper pipeline in ~30 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the card the online path runs the port's kernels: B1 (LUT build), B4
(co-occurrence tables) and B2 (the fused ADC scan + top-k over the tile
queue); with `--device cpu` their plain PyTorch versions.
"""

import argparse

from repro_torch.core.index import brute_force, recall_at_k
from repro_torch.data.vectors import SkewedVectorDataset, make_clustered_vectors
from repro_torch.retrieval import MemANNSEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=20_000, help="corpus vectors")
    ap.add_argument("--queries", type=int, default=32)
    args = ap.parse_args(argv)

    # 1. a corpus with the paper's skew: zipf cluster sizes + co-occurring
    #    residual patterns (Fig. 4 / Fig. 10 structure)
    xs, centers, _ = make_clustered_vectors(
        n=args.n, dim=64, n_centers=64, size_zipf=1.3, pattern_pool=32
    )
    stream = SkewedVectorDataset(centers, popularity_zipf=1.1)

    # 2. offline phase: IVF+PQ, frequency estimation from a historical query
    #    log, Algorithm-1 placement (replicated hot clusters), co-occurrence
    #    re-encoding, per-device packing
    engine = MemANNSEngine.build(
        xs, n_clusters=64, m=8, ndev=1,  # the reference's one device
        history_queries=stream.queries(300, seed=1), use_cooc=True, block_n=256,
        device=args.device,
    )
    imbalance = engine.placement.max_imbalance()
    print(
        f"index: {engine.index.n_vectors} vectors, "
        f"{engine.index.n_clusters} clusters over {engine.shards.ndev} device(s); "
        f"placement imbalance {imbalance:.2f}"
    )

    # 3. online phase: filtering + Algorithm-2 scheduling on the host, LUT
    #    build + fused ADC/top-k kernels on the card, hierarchical merge
    queries = stream.queries(args.queries, seed=2)
    dists, ids = engine.search(queries, nprobe=16, k=10)
    assert ids.shape == (args.queries, 10)

    _, truth = brute_force(xs, queries, 10, device=args.device)
    recall = recall_at_k(ids, truth)
    print(f"recall@10 = {recall:.3f}")
    print("first query neighbours:", ids[0].tolist())
    return {"recall": recall, "imbalance": imbalance, "ids": ids, "dists": dists,
            "device": engine.device}


if __name__ == "__main__":
    main()
