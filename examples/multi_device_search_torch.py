"""Multi-device MemANNS on the PyTorch/CUDA port: shard the index over 8
logical devices per Algorithm 1 (device == DPU) and show balanced
per-device loads under a skewed query stream -- the paper's Fig. 7 live;
the twin of `examples/multi_device_search.py`.

    PYTHONPATH=src python examples/multi_device_search_torch.py [--device cpu]

The reference fakes 8 XLA host devices; here `ndev=8` logical devices
share one card (or the CPU) along a leading tensor axis.  On the card the
tiles scan runs kernel B2 and the windows scan B5, after B1 and B4.
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.core.index import brute_force, recall_at_k
from repro_torch.data.vectors import SkewedVectorDataset, make_clustered_vectors
from repro_torch.retrieval import MemANNSEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=24_000, help="corpus vectors")
    ap.add_argument("--queries", type=int, default=128)
    args = ap.parse_args(argv)

    xs, centers, _ = make_clustered_vectors(
        args.n, 32, 64, size_zipf=1.4, pattern_pool=32
    )
    stream = SkewedVectorDataset(centers, popularity_zipf=1.2)
    # scan="tiles" (default) streams a flat queue of real code tiles; pass
    # scan="windows" for the padded per-pair window scan -- results are
    # bit-identical, the tile queue just skips the padding on skewed data
    engine = MemANNSEngine.build(
        xs, n_clusters=64, m=8, ndev=8,
        history_queries=stream.queries(400, seed=1), use_cooc=True, block_n=256,
        scan="tiles", device=args.device,
    )

    pl = engine.placement
    print(f"devices: {engine.shards.ndev}")
    print(f"replicated clusters: {sum(len(r) > 1 for r in pl.replicas)}")
    print(f"placement imbalance: {pl.max_imbalance():.2f}")
    print("vectors/device:", pl.dev_vectors.tolist())

    queries = stream.queries(args.queries, seed=2)
    schedule, _, _ = engine.schedule_batch(queries, nprobe=16)
    imbalance = schedule.max_imbalance()
    print(f"schedule imbalance: {imbalance:.2f}")
    print("pairs/device:", schedule.counts_per_dev().tolist())

    dists, ids = engine.search(queries, nprobe=16, k=10)
    _, truth = brute_force(xs, queries, 10, device=args.device)
    recall = recall_at_k(ids, truth)
    print(f"recall@10 = {recall:.3f}")

    # tile-list vs padded-window device scan: same results, fewer rows read
    win_engine = dataclasses.replace(engine, scan="windows")
    wd, wi = win_engine.search(queries, nprobe=16, k=10)
    assert np.array_equal(ids, wi), "scan paths must be bit-identical"
    plan_t = engine.plan_batch(queries, 16)
    plan_w = win_engine.plan_batch(queries, 16)
    rows_t, rows_w = engine.scanned_rows(plan_t), win_engine.scanned_rows(plan_w)
    print(f"scanned rows: tiles={rows_t} windows={rows_w} "
          f"ratio={rows_t / rows_w:.2f}")
    return {"recall": recall, "imbalance": imbalance,
            "pairs_per_device": schedule.counts_per_dev().tolist(),
            "rows_ratio": rows_t / rows_w, "ids": ids, "dists": dists,
            "device": engine.device}


if __name__ == "__main__":
    main()
