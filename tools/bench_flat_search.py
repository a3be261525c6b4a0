#!/usr/bin/env python3
"""Time the flat search (`core.index.search`: 16 queries, nprobe 64, k 10)
of this checkout beside another checkout's, in turns.

    python3 tools/bench_flat_search.py [--baseline-root DIR] [--n 100000000] [--reps 5]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
DIR is the root of another checkout, e.g. an earlier commit unpacked into
the ignored build/ directory:

    mkdir -p build/parent && git archive b47ed91 | tar -x -C build/parent

Each turn is a process of its own that imports `repro_torch` from one
root's src/ and builds chip_smoke.py's index on the card (N clustered
vectors from `--seed`, 4096 IVF cells, M = 16, as `MemANNSEngine.build`
trains it).  It searches chip_smoke.py's 16 queries twice to warm up, then
times `--reps` searches by the host's clock, one more under cProfile (host
ms by function) and one under torch.profiler (device busy and idle ms).
Both roots' kernels are built first, in parallel.  The turns run baseline,
port, port, baseline (port alone without `--baseline-root`).  Prints the
card's name and power limit, one JSON line per turn and a summary line;
exits non-zero without a GPU or when a turn fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def worker(root: pathlib.Path, n: int, reps: int, seed: int) -> dict:
    """One turn: `root`'s flat search on chip_smoke.py's index and queries."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.core.index import build_index, filter_clusters, search
    from repro_torch.data.vectors import SkewedVectorDataset, generate_clustered

    dev = torch.device("cuda")
    t = time.perf_counter()
    xs, centers = generate_clustered(n, cs.D, cs.N_CLUSTERS, seed=seed, size_zipf=1.3,
                                     center_scale=5.0, noise=1.0, device=dev,
                                     dtype=torch.bfloat16)
    idx = build_index(xs, cs.N_CLUSTERS, cs.M, kmeans_iters=10, pq_iters=10,
                      train_subsample=262_144, pq_train_subsample=65_536,
                      generator=torch.Generator().manual_seed(seed), device=dev)
    del xs
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t
    # chip_smoke.py's q16: the first 16 of its second 1000-query batch
    ds = SkewedVectorDataset(centers, noise=1.0, popularity_zipf=1.1, seed=seed)
    q16 = ds.queries(cs.BATCH * 6, seed=2)[cs.BATCH : cs.BATCH + 16]
    qrot = torch.as_tensor(idx.rotate(np.asarray(q16, np.float32)), device=dev)
    cids, _ = filter_clusters(torch.as_tensor(idx.centroids, device=dev), qrot, cs.NPROBE)
    probed = np.unique(cids.cpu().numpy())

    def run():
        return search(idx, q16, cs.NPROBE, cs.K, device=dev)

    for _ in range(2):
        d, i = run()
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        wall.append((time.perf_counter() - t) * 1e3)
    host_top = cs.host_by_function(run)
    busy, by_kernel, n_acts, prof_wall = cs.profile_call(torch, run, top=6)
    return dict(root=str(root), module=sys.modules["repro_torch.core.index"].__file__,
                build_seconds=build_s, distinct_clusters=len(probed),
                rows=int(idx.cluster_sizes()[probed].sum()), wall_ms=wall,
                mean_wall_ms=sum(wall) / len(wall), host_ms_by_function_profiled=host_top,
                profiled=dict(wall_ms=prof_wall, device_busy_ms=busy,
                              device_idle_ms=prof_wall - busy, device_activities=n_acts,
                              by_kernel_ms=by_kernel),
                checksum=[float(np.nansum(d[np.isfinite(d)])), int(i.sum())])


def build(root: pathlib.Path) -> str:
    """Build `root`'s kernel library in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; print(_build.library())")
    r = subprocess.run([sys.executable, "-c", code, str(root / "src")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel build failed in {root}:\n{r.stdout}{r.stderr}")
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-root", type=pathlib.Path, default=None,
                    help="root of the checkout to time beside this one")
    ap.add_argument("--n", type=int, default=100_000_000, help="corpus rows")
    ap.add_argument("--reps", type=int, default=5, help="timed searches per turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.n, args.reps, args.seed)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_flat_search: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    roots = {"port": ROOT}
    if args.baseline_root is not None:
        roots["baseline"] = args.baseline_root.resolve()
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:  # nvcc in parallel
        libs = dict(zip(roots, pool.map(build, roots.values())))
    cs.log(phase="build", libraries=libs, nvidia_smi=smi)
    order = ["baseline", "port", "port", "baseline"] if "baseline" in roots else ["port"]
    turns = []
    for label in order:
        r = subprocess.run(
            [sys.executable, __file__, "--worker", str(roots[label]), "--n", str(args.n),
             "--reps", str(args.reps), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if r.returncode != 0:
            print(f"bench_flat_search: the {label} turn failed:\n{r.stdout}{r.stderr}",
                  file=sys.stderr)
            return 1
        got = json.loads(r.stdout.strip().splitlines()[-1])
        cs.log(phase="turn", label=label, **got)
        turns.append((label, got))
    mean = {label: sum(g["mean_wall_ms"] for lb, g in turns if lb == label)
            / order.count(label) for label in roots}
    idle = {label: sum(g["profiled"]["device_idle_ms"] for lb, g in turns if lb == label)
            / order.count(label) for label in roots}
    cs.log(phase="summary", order=order, mean_wall_ms=mean, mean_device_idle_ms=idle,
           same_result=len({json.dumps(g["checksum"]) for _, g in turns}) == 1,
           nvidia_smi=smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
