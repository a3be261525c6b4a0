#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--n 100000000] [--batches 5] [--seed 0]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the three CUDA kernels of the query path from
`src/repro_torch/csrc/`, generates a SIFT1B-geometry corpus on the card
(D = 128, M = 16 uint8 codes, IVF 4096, nprobe 64, k = 10, 1000-query
batches, 8 logical devices, bf16 raw store; N = 100M rows by default, the
paper's 1e9 cut so the raw store fits one card), builds the engine with the
port's own k-means and PQ, and then:

  1. times 1000-query `MemANNSEngine.search` batches (QPS, ms per batch),
     with every kernel's launch count reset just before and read just after;
  2. holds each kernel against its plain PyTorch version at the shapes of
     that path (tolerance: allclose rtol = atol = 1e-5 on distances, rows
     and ids equal) and times kernel, plain version, bound and the one
     PyTorch library call that computes the same function, where one exists;
  3. holds 16 queries' engine output against a plain path (plain LUTs ->
     unpruned ADC over every probed row -> stable top-k' -> plain exact
     re-rank): distances bit-equal, ids equal outside exactly tied groups;
  4. checks that the pruned search equals the unpruned one bit for bit;
  5. prints recall@10 against a chunked brute force (information only).

Every phase that fails raises.  The line before last is the kernels' JSON,
the last line `{"ok": true, "device": {...}}`.  Without a visible GPU, or
outside a checkout, it exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pathlib
import pstats
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM: FP32 outside the tensor cores

D, M, N_CLUSTERS, NPROBE, K, BATCH, NDEV, BLOCK_N = 128, 16, 4096, 64, 10, 1000, 8, 1024
TOL = dict(rtol=1e-5, atol=1e-5)
SRC_ROOT = "src/repro_torch"


def log(**kv) -> None:
    print(json.dumps(kv, default=float), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches (CUDA events), warmed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000_000, help="corpus rows")
    ap.add_argument("--batches", type=int, default=5, help="timed 1000-query batches")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    root = pathlib.Path(__file__).resolve().parent
    if not (root / SRC_ROOT / "csrc").is_dir():
        print(f"chip_smoke: {root / SRC_ROOT} not found; run from a checkout",
              file=sys.stderr)
        return 3
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.index import brute_force, filter_clusters, recall_at_k
    from repro_torch.data.vectors import SkewedVectorDataset, generate_clustered
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import adc_topk as k_topk
    from repro_torch.kernels import lut_build as k_lut
    from repro_torch.kernels import rerank as k_rerank
    from repro_torch.retrieval.engine import MemANNSEngine

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(phase="gpu", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    dev = torch.device("cuda")

    # -- kernels: build from csrc/ (nvcc, one process per source) ----------
    t = time.perf_counter()
    lib = _build.build_library()
    _build.library()
    regs = [ln.strip() for ln in _build.ptxas_report().splitlines()
            if "registers" in ln or "spill" in ln]
    log(phase="build_kernels", seconds=time.perf_counter() - t, lib=str(lib.name),
        ptxas=regs)

    # -- data + engine ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    xs, centers = generate_clustered(
        args.n, D, N_CLUSTERS, seed=args.seed, size_zipf=1.3, center_scale=5.0,
        noise=1.0, device=dev, dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t
    ds = SkewedVectorDataset(centers, noise=1.0, popularity_zipf=1.1, seed=args.seed)
    hist = ds.queries(10_000, seed=1)
    queries = ds.queries(BATCH * (args.batches + 1), seed=2)
    t = time.perf_counter()
    eng = MemANNSEngine.build(
        xs, N_CLUSTERS, M, ndev=NDEV, history_queries=hist, nprobe_history=NPROBE,
        block_n=BLOCK_N, kmeans_iters=10, pq_iters=10, train_subsample=262_144,
        pq_train_subsample=65_536, rerank="exact", raw_dtype="bfloat16",
        seed=args.seed, device=dev,
    )
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    del xs
    torch.cuda.empty_cache()
    sizes = eng.index.cluster_sizes()
    log(phase="build_engine", n=args.n, data_seconds=t_data, build_seconds=t_build,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        cluster_rows_min=int(sizes.min()), cluster_rows_median=float(np.median(sizes)),
        cluster_rows_max=int(sizes.max()),
        replicas=int(sum(len(r) for r in eng.placement.replicas)),
        code_rows_per_device=int(eng.shards.codes.shape[1]),
        raw_store_gb=eng.raw.nbytes() / 1e9)

    # -- the main path: 1000-query search batches ---------------------------
    kp = eng.k_prime(K)
    batches = [queries[i * BATCH : (i + 1) * BATCH] for i in range(args.batches + 1)]
    eng.search(batches[0], NPROBE, K)  # warm-up (allocator, library load)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    batch_ms, results = [], []
    for qb in batches[1:]:
        t = time.perf_counter()
        results.append(eng.search(qb, NPROBE, K))
        batch_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(ops.launches)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} was never launched on the main path")
    for d, i in results:
        if d.shape != (BATCH, K) or not np.isfinite(d).all() or (i < 0).any():
            raise RuntimeError("search returned non-finite distances or missing ids")
        if (np.diff(d, axis=1) < 0).any():
            raise RuntimeError("search distances are not ascending")
    # where a batch's time goes: host planning (profiled by function) and the
    # device step (kernel time summed by the torch profiler)
    plan_ms = []
    for qb in batches[1:]:
        t = time.perf_counter()
        eng.plan_batch(qb, NPROBE)
        plan_ms.append((time.perf_counter() - t) * 1e3)
    prof = cProfile.Profile()
    prof.runcall(eng.plan_batch, batches[1], NPROBE)
    host_top = sorted(
        ((f"{pathlib.Path(f).name}:{fn}", v[3] * 1e3)
         for (f, _, fn), v in pstats.Stats(prof).stats.items()
         if "repro_torch" in f or "numpy" in f),
        key=lambda x: -x[1],
    )[:12]
    plan = eng.plan_batch(batches[1], NPROBE)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as tp:
        t = time.perf_counter()
        eng.collect(eng.dispatch_rerank(eng.dispatch_plan(plan, kp), batches[1], K))
        step_ms = (time.perf_counter() - t) * 1e3
    by_kernel = {}
    for e in tp.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            by_kernel[e.key[:60]] = us / 1e3
    busy = sum(by_kernel.values())
    log(phase="breakdown", host_plan_ms_by_function_profiled=host_top, device_step_wall_ms=step_ms,
        device_busy_ms=busy, device_busy_of_batch=busy / float(np.mean(batch_ms)),
        device_ms_by_kernel=dict(sorted(by_kernel.items(), key=lambda x: -x[1])[:10]))
    handle = eng.dispatch_plan(plan, kp)
    stats = handle.prune_stats.cpu().numpy()
    real_tiles = int((plan.tile_pair != plan.pairs_per_dev).sum())
    log(phase="search", batches=args.batches, queries_per_batch=BATCH,
        batch_ms=batch_ms, mean_batch_ms=float(np.mean(batch_ms)),
        qps=BATCH / (np.mean(batch_ms) / 1e3), host_plan_ms=plan_ms,
        launches=launches, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        pairs_per_dev=plan.pairs_per_dev, tiles_per_dev=plan.tiles_per_dev,
        rows_in_tiles=int(eng.plan_dev_rows(plan).sum()), real_tiles=real_tiles,
        tiles_skipped=int(stats[:, 0].sum()), rows_skipped=int(stats[:, 1].sum()))

    # -- each kernel against its plain version at the path's shapes ---------
    dv = eng._device_put()
    ndev, p = plan.pair_q.shape
    cb = dv["codebook"]
    dsub = cb.shape[2]
    qmc = plan.qmc_pairs.reshape(ndev * p, M, dsub)
    rows = torch.as_tensor(np.flatnonzero(plan.pair_valid).astype(np.int32), device=dev)
    n_rows = rows.shape[0]
    lut_row = torch.full((ndev * p,), -1, dtype=torch.int32, device=dev)
    lut_row[rows.long()] = torch.arange(n_rows, dtype=torch.int32, device=dev)
    pair_slot = torch.as_tensor(plan.pair_slot, device=dev).long()
    pair_valid = torch.as_tensor(plan.pair_valid, device=dev)
    n_valid = torch.where(pair_valid, dv["slot_size"].gather(1, pair_slot), 0).int()
    tiles = [torch.as_tensor(a, device=dev) for a in
             (plan.tile_pair, plan.tile_block, plan.tile_row0)]
    pair_q = torch.as_tensor(plan.pair_q, device=dev)
    pair_lb = torch.as_tensor(plan.pair_lb, device=dev)
    qbound = torch.as_tensor(plan.query_bounds(kp), device=dev)
    kernels = []

    # B1: LUT build, one table per valid pair (the rows the path passes)
    luts = ops.build_luts(cb, qmc, rows)
    qmc_rows = qmc[rows.long()]
    luts_plain = k_lut.build_luts_plain(cb, qmc_rows)
    err = float((luts - luts_plain).abs().max())
    if not torch.allclose(luts, luts_plain, **TOL):
        raise RuntimeError(f"lut_build disagrees with its plain version: {err}")
    out = torch.empty_like(luts)
    b1_ms = cuda_ms(torch, lambda: k_lut.launch(cb, qmc, out, rows), 20)
    n_lut = n_rows * M * 256
    bms, by = bound_ms(4 * (cb.numel() + qmc_rows.numel() + n_rows + n_lut),
                       3 * n_lut * dsub)
    kernels.append(dict(
        name="lut_build", route="cuda", source=f"{SRC_ROOT}/csrc/lut_build.cu",
        replaces="src/repro/kernels/lut_build.py:35", launches=launches["build_luts"],
        max_abs_err=err, ms=b1_ms,
        plain_ms=wall_ms(torch, lambda: k_lut.build_luts_plain(cb, qmc[rows.long()])),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(
            qmc_rows.transpose(0, 1), cb, compute_mode="donot_use_mm_for_euclid_dist"), 5),
        library_call="torch.cdist over the valid pairs' residuals, batched over m "
                     "(Euclidean: adds a sqrt the kernel does not take)",
        shape=dict(pairs=n_rows, pair_slots=ndev * p, m=M, dsub=dsub),
    ))

    # B2: pruned tile scan, as the path calls it and unpruned per pair
    codes = dv["codes"]
    lut_row2 = lut_row.reshape(ndev, p)
    pv, pi, ps = ops.adc_topk_tiles(luts, codes, *tiles, n_valid, kp, block_n=BLOCK_N,
                                    pair_q=pair_q, pair_lb=pair_lb, bound=qbound,
                                    lut_row=lut_row2)
    kv, ki, _ = ops.adc_topk_tiles(luts, codes, *tiles, n_valid, kp, block_n=BLOCK_N,
                                   lut_row=lut_row2)
    t0, t1, order = k_topk.pair_runs(tiles[0], p)
    flat = dict(tb=tiles[1].int().reshape(-1), tr=tiles[2].int().reshape(-1),
                nv=n_valid.reshape(-1))
    plain_args = (luts, lut_row, codes, flat["tb"], flat["tr"], flat["nv"],
                  torch.arange(ndev * p, dtype=torch.int32, device=dev),
                  torch.full((ndev * p,), -torch.inf, device=dev),
                  torch.full((ndev * p,), torch.inf, device=dev), t0, t1, kp, BLOCK_N)
    t = time.perf_counter()
    plv, pli, _ = k_topk.adc_topk_tiles_plain(*plain_args)
    torch.cuda.synchronize()
    b2_plain_ms = (time.perf_counter() - t) * 1e3
    plv, pli = plv.reshape(kv.shape), pli.reshape(ki.shape)
    if not (torch.equal(ki, pli) and torch.allclose(kv, plv, **TOL)):
        raise RuntimeError("adc_topk_tiles disagrees with its plain version")
    fin = torch.isfinite(kv)
    err = float((kv[fin] - plv[fin]).abs().max()) if bool(fin.any()) else 0.0
    sq = qbound.clone()
    ov, oi, os_ = (torch.empty(ndev * p, kp, device=dev),
                   torch.empty(ndev * p, kp, dtype=torch.int32, device=dev),
                   torch.empty(ndev * p, 2, dtype=torch.int32, device=dev))
    flat_q, flat_lb = pair_q.int().reshape(-1), pair_lb.reshape(-1)

    def run_b2(pruned: bool):
        sq.copy_(qbound if pruned else torch.full_like(qbound, torch.inf))
        k_topk.launch(luts, lut_row, codes, order, t0, t1, flat["tb"],
                      flat["tr"], flat["nv"], flat_q,
                      flat_lb if pruned else torch.full_like(flat_lb, -torch.inf),
                      qbound if pruned else torch.full_like(qbound, torch.inf),
                      sq, ov, oi, os_, kp, BLOCK_N)

    b2_ms = cuda_ms(torch, lambda: run_b2(True), 10)
    b2_unpruned_ms = cuda_ms(torch, lambda: run_b2(False), 10)
    valid_rows = int(n_valid.sum())
    scanned = valid_rows - int(ps[..., 1].sum())
    pairs_run = int((t1 > t0).sum())
    bms, by = bound_ms(scanned * M + pairs_run * M * 256 * 4 + ndev * p * (kp * 8 + 8),
                       scanned * M)
    kernels.append(dict(
        name="adc_topk_tiles", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk_tiles.cu",
        replaces="src/repro/kernels/adc_topk.py:397", launches=launches["adc_topk_tiles"],
        max_abs_err=err, ms=b2_ms, plain_ms=b2_plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None, unpruned_ms=b2_unpruned_ms,
        unpruned_bound_ms=bound_ms(valid_rows * M + pairs_run * M * 256 * 4, 0)[0],
        shape=dict(pairs=ndev * p, pairs_with_tiles=pairs_run, k=kp,
                   valid_rows=valid_rows, scanned_rows=scanned,
                   tiles=real_tiles, tiles_skipped=int(ps[..., 0].sum())),
    ))

    # B3: exact re-rank with the fused gather, on this batch's candidates
    raw = eng.raw
    qt = torch.as_tensor(batches[1], device=dev)
    cand = torch.where(torch.isfinite(handle.out_d), handle.out_i, -1).int().contiguous()
    got = ops.rerank_dists(qt, cand, raw.vectors, raw.id_dev, raw.id_row, raw.row_base)
    want = k_rerank.rerank_dists_plain(qt, cand, raw.vectors, raw.id_dev, raw.id_row,
                                       raw.row_base)
    fin = torch.isfinite(want)
    if not (torch.equal(fin, torch.isfinite(got)) and torch.allclose(got, want, **TOL)):
        raise RuntimeError("rerank disagrees with its plain version")
    err = float((got[fin] - want[fin]).abs().max())
    out3 = torch.empty_like(got)
    b3_ms = cuda_ms(torch, lambda: k_rerank.launch(
        qt, cand, raw.vectors, raw.id_dev, raw.id_row, raw.row_base, out3, 0), 50)
    rows, _ = k_rerank.candidate_rows(cand, raw.id_dev, raw.id_row, raw.row_base)
    gathered = raw.vectors[rows].float()
    n_c = cand.numel()
    bms, by = bound_ms(n_c * (D * 2 + 4 + 4 + 4 + 4) + qt.numel() * 4, 3 * n_c * D)
    kernels.append(dict(
        name="rerank", route="cuda", source=f"{SRC_ROOT}/csrc/rerank.cu",
        replaces="src/repro/kernels/rerank.py:74", launches=launches["rerank_dists"],
        max_abs_err=err, ms=b3_ms,
        plain_ms=wall_ms(torch, lambda: k_rerank.rerank_dists_plain(
            qt, cand, raw.vectors, raw.id_dev, raw.id_row, raw.row_base)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(qt[:, None, :], gathered), 20),
        library_call="torch.cdist on rows gathered beforehand (Euclidean: adds a "
                     "sqrt; leaves out the id-map lookup and the gather)",
        shape=dict(queries=qt.shape[0], candidates=kp, dim=D, store="bfloat16"),
    ))
    del gathered, luts_plain, plv, pli

    # -- 16 queries: engine == plain path at full scale ---------------------
    q16 = batches[1][:16]
    e_d, e_i = eng.search(q16, NPROBE, K)
    adc_d, _ = eng.collect(eng.dispatch_plan(eng.plan_batch(q16, NPROBE), kp))
    q16_t = torch.as_tensor(q16, device=dev)
    probed, qmc16 = filter_clusters(dv["centroids"], q16_t, NPROBE)
    l16 = k_lut.build_luts_plain(cb, qmc16.reshape(-1, M, dsub)).reshape(16, NPROBE, -1)
    cols = torch.arange(M, device=dev) * 256
    idx = eng.index
    cand16 = torch.full((16, kp), -1, dtype=torch.int32, device=dev)
    plain_adc = np.full((16, kp), np.inf, np.float32)
    for qi in range(16):
        ds_, ids_ = [], []
        for j, c in enumerate(probed[qi].tolist()):
            lo, hi = int(idx.offsets[c]), int(idx.offsets[c + 1])
            if hi == lo:
                continue
            codes_c = torch.as_tensor(idx.codes[lo:hi], device=dev).long() + cols
            g = l16[qi, j][codes_c]
            dd = torch.zeros(hi - lo, device=dev)
            for mm in range(M):
                dd = dd + g[:, mm]
            ds_.append(dd)
            ids_.append(torch.as_tensor(idx.vec_ids[lo:hi], device=dev))
        dq, iq = torch.cat(ds_), torch.cat(ids_)
        sel = torch.sort(dq, stable=True).indices[:kp]
        plain_adc[qi, : sel.numel()] = dq[sel].cpu().numpy()
        cand16[qi, : sel.numel()] = iq[sel].int()
    if not np.array_equal(np.sort(adc_d, axis=1), plain_adc):
        raise RuntimeError("engine ADC top-k' differs from the plain unpruned scan")
    ex = k_rerank.rerank_dists_plain(q16_t, cand16, raw.vectors, raw.id_dev, raw.id_row,
                                     raw.row_base)
    sel = torch.sort(ex, dim=1, stable=True).indices[:, :K]
    p_d = ex.gather(1, sel).cpu().numpy()
    p_i = torch.where(torch.isfinite(ex.gather(1, sel)), cand16.gather(1, sel), -1)
    p_i = p_i.cpu().numpy()
    if not np.array_equal(e_d, p_d):
        raise RuntimeError(f"engine re-ranked distances differ from the plain path:\n"
                           f"{e_d[:2]}\n{p_d[:2]}")
    for row_d, a, b in zip(e_d, e_i, p_i):
        for v in np.unique(row_d):
            if set(a[row_d == v]) != set(b[row_d == v]):
                raise RuntimeError("engine ids differ from the plain path")
    log(phase="scale_check", queries=16, adc_equal=True, rerank_equal=True)

    # -- pruned == unpruned, bit for bit ------------------------------------
    qb = batches[1]
    pruned = eng.search(qb, NPROBE, K)
    adc_pruned = eng.collect(eng.dispatch_plan(eng.plan_batch(qb, NPROBE), kp))
    eng.prune = False
    unpruned = eng.search(qb, NPROBE, K)
    adc_unpruned = eng.collect(eng.dispatch_plan(eng.plan_batch(qb, NPROBE), kp))
    eng.prune = True
    for a, b in zip(pruned + adc_pruned, unpruned + adc_unpruned):
        if not np.array_equal(a, b):
            raise RuntimeError("pruned search differs from the unpruned search")
    log(phase="prune_check", queries=BATCH, bit_identical=True)

    # -- recall@10 against a chunked brute force (information) ---------------
    n_gt = 200
    ids_of_row = torch.full((raw.vectors.shape[0],), -1, dtype=torch.int64, device=dev)
    mapped = torch.nonzero(raw.id_dev >= 0).flatten()
    ids_of_row[raw.row_base[raw.id_dev[mapped].long()] + raw.id_row[mapped].long()] = mapped
    _, gt_rows = brute_force(raw.vectors, qb[:n_gt], K, device=dev, chunk=1 << 18)
    gt = ids_of_row[torch.as_tensor(gt_rows, device=dev)].cpu().numpy()
    recall = recall_at_k(pruned[1][:n_gt], gt)
    adc_recall = recall_at_k(adc_pruned[1][:n_gt, :K], gt)
    log(phase="recall", queries=n_gt, recall_at_10=recall, adc_only_recall_at_10=adc_recall)

    log(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
