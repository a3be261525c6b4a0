#!/usr/bin/env python3
"""Time the raw-code ADC scans B2 and B5 alone, at the smoke's main-path shapes.

    python3 tools/bench_scan.py [--n 100000000] [--batches 2] [--seed 0]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the same SIFT1B-geometry engine as `chip_smoke.py` (the same
data, index and placement from the seed), drives the tiles path and the
windows path on plain codes, and runs `chip_smoke.check_scan` for B2 and
B5: each held against its plain version, timed pruned and unpruned, with
the FP32 bound and the lookup bound at the measured SM clock.  It skips every other phase of the smoke (the LM, co-occurrence,
the kernel-level API), so a kernel change is measured in a few minutes.
Prints one JSON line per phase and the kernels' rows; exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000, help="corpus rows")
    ap.add_argument("--batches", type=int, default=2, help="timed 1000-query batches")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_scan: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data.vectors import SkewedVectorDataset, generate_clustered
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import adc_topk as k_topk
    from repro_torch.retrieval.engine import MemANNSEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(phase="gpu", nvidia_smi=smi, torch=torch.__version__)
    t = time.perf_counter()
    _build.library()
    regs = cs.ptxas_summary(_build.ptxas_report())
    cs.log(phase="build_kernels", seconds=time.perf_counter() - t,
           ptxas={k: v for k, v in regs.items() if "tiles" in k or "windows" in k})
    dev = torch.device("cuda")
    xs, centers = generate_clustered(
        args.n, cs.D, cs.N_CLUSTERS, seed=args.seed, size_zipf=1.3, center_scale=5.0,
        noise=1.0, device=dev, dtype=torch.bfloat16,
    )
    ds = SkewedVectorDataset(centers, noise=1.0, popularity_zipf=1.1, seed=args.seed)
    hist = ds.queries(10_000, seed=1)
    queries = ds.queries(cs.BATCH * (args.batches + 1), seed=2)
    eng = MemANNSEngine.build(
        xs, cs.N_CLUSTERS, cs.M, ndev=cs.NDEV, history_queries=hist,
        nprobe_history=cs.NPROBE, block_n=cs.BLOCK_N, kmeans_iters=10, pq_iters=10,
        train_subsample=262_144, pq_train_subsample=65_536, rerank="exact",
        raw_dtype="bfloat16", seed=args.seed, device=dev,
    )
    del xs
    torch.cuda.empty_cache()
    kp = eng.k_prime(cs.K)
    batches = [queries[i * cs.BATCH : (i + 1) * cs.BATCH] for i in range(args.batches + 1)]
    dv = eng._device_put()
    kernels = []
    for scan, name, line in (("tiles", "adc_topk_tiles", "397"),
                             ("windows", "adc_topk_windows", "592")):
        eng.scan = scan
        path = cs.drive_path(torch, np, ops, f"search_{scan}", eng, batches,
                             ("build_luts", name, "rerank_dists"))
        plan = eng.plan_batch(batches[1], cs.NPROBE)
        tables, lut_row, _, _, _ = cs.plan_tables(torch, np, ops, eng, plan)
        kernels.append(cs.check_scan(
            torch, ops, k_topk, name=name, scan=scan,
            source=f"{cs.SRC_ROOT}/csrc/{name}.cu",
            replaces=f"src/repro/kernels/adc_topk.py:{line}",
            launches=path["launches"][name], tables=tables,
            lut_row=lut_row, codes=dv["codes"], plan=plan, dv=dv, kp=kp, regs=regs))
        del tables
        torch.cuda.empty_cache()
    cs.log(phase="done", nvidia_smi=smi)
    print(cs.json.dumps({"kernels": kernels}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
