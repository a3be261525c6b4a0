"""Where the card's time goes in B2 / B5 past k = 4096 at the smoke's
`domain` shape: the spilled WIDE block of commit 7f30922 (each pass with
candidates merged into the pair's k-entry list in device memory) against
the port's current kernels on the same inputs.

Usage (on the card, from the repo root):

    mkdir -p build/scan_parent && for f in adc_topk_common.cuh adc_topk_tiles.cu \\
        adc_topk_windows.cu; do git show 7f30922:src/repro_torch/csrc/$f \\
        > build/scan_parent/$f; done
    python3 tools/probe_scan_split.py --parent-dir build/scan_parent [--port]

It builds the smoke's engine from the seed (100M rows by default, about
three minutes on the card), plans the first `DOMAIN_QUERIES` queries of the
smoke's second batch (512 pairs) and builds their tables, as `domain_phase`
does.  The parent's sources are copied with `%globaltimer` stamps in
`scan_pair` (one record a pair: start, end, and the ns spent in
`merge_candidates`, the sort and merge of a pass's candidates into the list)
and built with nvcc into a library of their own C interface.  Per scan
(tiles, windows) it times the parent's pruned call at k = `DOMAIN_K` as the
smoke's row does (CUDA events, the mean of 3 after a warm-up) and reads one
instrumented call: the pairs' summed scan and merge ns, and the longest
pair's chain (one block owns a pair for the whole call).  With `--port` it
also times the port's current launcher on the same inputs (its `split` by
step where the launcher gives one) and checks that both give the same
per-query answer (the k' smallest of each query's pairs' lists); each
`--variant-csrc DIR` (an edited copy of `src/repro_torch/csrc`) is built
beside the port and timed with it in turns, its output held to the port's
bits.  Prints one JSON line per scan.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

STAMP = r'''
__device__ unsigned long long g_rec[4][65536];  // start, end, merge ns, rows
__device__ unsigned long long g_merge[65536];   // a block's merge ns so far
__device__ int g_n;
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''

ANCHORS = {
    "    if (c > 0)\n      merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);\n": (
        "    const unsigned long long t_m = gtimer();\n"
        "    if (c > 0)\n      merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);\n"
        "    if (threadIdx.x == 0) g_merge[blockIdx.x] += gtimer() - t_m;\n"),
    "  int n_skip = 0, n_avoid = 0;\n  __syncthreads();\n": (
        "  int n_skip = 0, n_avoid = 0;\n  __syncthreads();\n"
        "  const unsigned long long t_pair = gtimer();\n"
        "  const unsigned long long m_pair = g_merge[blockIdx.x];\n"),
    "  if (tid == 0) {\n    stats[0] = n_skip;\n": (
        "  if (tid == 0) {\n    const int r = atomicAdd(&g_n, 1);\n"
        "    if (r < 65536) {\n      g_rec[0][r] = t_pair;\n      g_rec[1][r] = gtimer();\n"
        "      g_rec[2][r] = g_merge[blockIdx.x] - m_pair;\n      g_rec[3][r] = nv;\n    }\n"
        "    stats[0] = n_skip;\n"),
}

# each source is its own device module with its own copy of the stamps
READ = r'''
extern "C" int scan_split_read_NAME(unsigned long long* out, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, repro_adc::g_rec, sizeof(unsigned long long) * 4 * 65536);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, repro_adc::g_n, sizeof(int));
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(repro_adc::g_n, &zero, sizeof(int));
  return static_cast<int>(e);
}
'''


def instrument(src: str) -> str:
    """The parent's adc_topk_common.cuh with the stamps."""
    src = src.replace("namespace repro_adc {\n", "namespace repro_adc {\n" + STAMP, 1)
    for old, new in ANCHORS.items():
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once in the parent's scan_pair: {old!r}")
        src = src.replace(old, new)
    return src


def build_parent(parent_dir: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    work = ROOT / "build" / "probe_scan_split"
    work.mkdir(parents=True, exist_ok=True)
    (work / "adc_topk_common.cuh").write_text(
        instrument((parent_dir / "adc_topk_common.cuh").read_text()))
    for scan in ("tiles", "windows"):
        (work / f"adc_topk_{scan}.cu").write_text(
            (parent_dir / f"adc_topk_{scan}.cu").read_text() + READ.replace("NAME", scan))
    lib_path = work / "libscan_split.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                           str(work / "adc_topk_tiles.cu"), str(work / "adc_topk_windows.cu"),
                           "-o", str(lib_path)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(done.stdout + done.stderr)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adc_topk_tiles_launch.argtypes = [P] * 16 + [I, I, L] + [I] * 8 + [P, P, I, P]
    lib.adc_topk_windows_launch.argtypes = [P] * 13 + [I, I, L] + [I] * 8 + [P, P, I, P]
    lib.scan_split_read_tiles.argtypes = [P, P]
    lib.scan_split_read_windows.argtypes = [P, P]
    return lib


def query_merge(torch, v, i, pair_q, n_q, k):
    """Each query's k smallest (distance, pair-row) of its pairs' lists."""
    out = []
    for q in range(n_q):
        sel = (pair_q == q).nonzero().flatten()
        vv = v[sel].reshape(-1)
        ii = (sel[:, None].long() * (1 << 32) + i[sel].long()).reshape(-1)
        order = torch.sort(vv, stable=True).indices[:k]
        out.append((vv[order], ii[order]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-dir", required=True)
    ap.add_argument("--n", type=int, default=100_000_000, help="corpus rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", action="store_true",
                    help="also time the port's current launcher on the same inputs")
    ap.add_argument("--variant-csrc", action="append", default=[],
                    help="with --port: a csrc directory (an edited copy of the port's) built "
                         "beside the port and timed with it in turns")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_scan_split: needs an NVIDIA GPU")
    from repro_torch.data.vectors import SkewedVectorDataset, generate_clustered
    from repro_torch.kernels import _build
    from repro_torch.kernels import adc_topk as k_topk
    from repro_torch.kernels import ops
    from repro_torch.retrieval.engine import MemANNSEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = build_parent(pathlib.Path(args.parent_dir))
    dev = torch.device("cuda")
    xs, centers = generate_clustered(
        args.n, cs.D, cs.N_CLUSTERS, seed=args.seed, size_zipf=1.3, center_scale=5.0,
        noise=1.0, device=dev, dtype=torch.bfloat16)
    ds = SkewedVectorDataset(centers, noise=1.0, popularity_zipf=1.1, seed=args.seed)
    hist = ds.queries(10_000, seed=1)
    queries = ds.queries(cs.BATCH * 3, seed=2)  # the smoke's, at --batches 2
    eng = MemANNSEngine.build(
        xs, cs.N_CLUSTERS, cs.M, ndev=cs.NDEV, history_queries=hist,
        nprobe_history=cs.NPROBE, block_n=cs.BLOCK_N, kmeans_iters=10, pq_iters=10,
        train_subsample=262_144, pq_train_subsample=65_536, rerank="exact",
        raw_dtype="bfloat16", seed=args.seed, device=dev)
    del xs
    torch.cuda.empty_cache()
    plan = eng.plan_batch(queries[cs.BATCH : cs.BATCH + cs.DOMAIN_QUERIES], cs.NPROBE)
    tables, lut_row = cs.plan_tables(torch, np, ops, eng, plan)[:2]
    dv = eng._device_put()
    codes = dv["codes"]
    ndev, cap, w = codes.shape
    k, bn = cs.DOMAIN_K, cs.BLOCK_N
    p = plan.pair_q.shape[1]
    pair_slot = torch.as_tensor(plan.pair_slot, device=dev).long()
    pair_valid = torch.as_tensor(plan.pair_valid, device=dev)
    nv = torch.where(pair_valid, dv["slot_size"].gather(1, pair_slot), 0).int().reshape(-1)
    st = dv["slot_start"].gather(1, pair_slot).int().reshape(-1)
    pair_q = torch.as_tensor(plan.pair_q, device=dev).int().reshape(-1)
    pair_lb = torch.as_tensor(plan.pair_lb, device=dev).reshape(-1).contiguous()
    qbound = torch.as_tensor(plan.query_bounds(k), device=dev)
    tiles = [torch.as_tensor(a, device=dev) for a in
             (plan.tile_pair, plan.tile_block, plan.tile_row0)]
    t0, t1, order_t = k_topk.pair_runs(tiles[0], p)
    tb, tr = tiles[1].int().reshape(-1), tiles[2].int().reshape(-1)
    filled = torch.nonzero((lut_row >= 0) & (nv > 0)).flatten()
    order_w = filled[torch.sort(pair_lb[filled], stable=True).indices].int()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = n_sm * 8  # the parent's `_SCAN_BLOCKS_PER_SM`
    nxt_v = torch.empty(blocks * k, device=dev)
    nxt_i = torch.empty(blocks * k, dtype=torch.int32, device=dev)
    out = {s: (torch.empty(ndev * p, k, device=dev),
               torch.empty(ndev * p, k, dtype=torch.int32, device=dev),
               torch.empty(ndev * p, 2, dtype=torch.int32, device=dev)) for s in ("old", "new")}
    sq = torch.empty_like(qbound)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rec = (ctypes.c_ulonglong * (4 * 65536))()
    n_rec = ctypes.c_int(0)
    n_q = plan.n_queries

    def parent(scan):
        ov, oi, os_ = out["old"]
        sq.copy_(qbound)
        if scan == "tiles":
            err = lib.adc_topk_tiles_launch(
                tables.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order_t.data_ptr(),
                t0.data_ptr(), t1.data_ptr(), tb.data_ptr(), tr.data_ptr(), nv.data_ptr(),
                pair_q.data_ptr(), pair_lb.data_ptr(), qbound.data_ptr(), sq.data_ptr(),
                ov.data_ptr(), oi.data_ptr(), os_.data_ptr(), ndev * p, p, cap, w,
                tables.shape[1], 0, 0, k, bn, 0, 1, nxt_v.data_ptr(), nxt_i.data_ptr(), blocks,
                stream)
        else:
            err = lib.adc_topk_windows_launch(
                tables.data_ptr(), lut_row.data_ptr(), codes.data_ptr(), order_w.data_ptr(),
                st.data_ptr(), nv.data_ptr(), pair_q.data_ptr(), pair_lb.data_ptr(),
                qbound.data_ptr(), sq.data_ptr(), ov.data_ptr(), oi.data_ptr(), os_.data_ptr(),
                order_w.shape[0], p, cap, w, tables.shape[1], 0, 0, k, bn, 0, 1,
                nxt_v.data_ptr(), nxt_i.data_ptr(), blocks, stream)
        if err:
            raise RuntimeError(f"parent {scan}: cudaError_t {err}")

    def port(scan, split_ms=None):
        ov, oi, os_ = out["new"]
        sq.copy_(qbound)
        kw = {} if split_ms is None else dict(split_ms=split_ms)
        if scan == "tiles":
            k_topk.launch(tables, lut_row, codes, order_t, t0, t1, tb, tr, nv, pair_q, pair_lb,
                          qbound, sq, ov, oi, os_, k, bn, **kw)
        else:
            k_topk.launch_windows(tables, lut_row, codes, order_w, st, nv, pair_q, pair_lb,
                                  qbound, sq, ov, oi, os_, k, bn, **kw)

    port_csrc = _build.CSRC

    def use(csrc):  # the kernels built from `csrc` serve the port's launchers
        _build.CSRC = pathlib.Path(csrc)
        _build.library.cache_clear()
        k_topk._blocks_per_sm.cache_clear()

    def variants(scan, port):
        """The port and each --variant-csrc build in turns (A B .. B A),
        each a mean of 5 calls; its split of one more call; the same bits
        as the port's."""
        names = [str(port_csrc)] + args.variant_csrc
        order = names + names[::-1]
        res = {n: dict(ms=[]) for n in names}
        for n in order:
            use(n)
            res[n]["ms"].append(cs.cuda_ms(torch, lambda: port(scan), 5))
        want = None
        for n in names:
            use(n)
            split = {}
            port(scan, split)
            res[n]["split"] = split
            got = [x.clone() for x in out["new"][:2]]
            want = want or got
            res[n]["same_bits"] = all(torch.equal(x, y) for x, y in zip(got, want))
        use(port_csrc)
        return res

    for scan in ("tiles", "windows"):
        read = getattr(lib, f"scan_split_read_{scan}")
        ms = cs.cuda_ms(torch, lambda: parent(scan), 3)
        torch.cuda.synchronize()
        read(rec, ctypes.byref(n_rec))  # drop the timing calls' records
        parent(scan)
        torch.cuda.synchronize()
        err = read(rec, ctypes.byref(n_rec))
        if err:
            raise RuntimeError(f"read: cudaError_t {err}")
        n = min(n_rec.value, 65536)
        r = np.frombuffer(rec, dtype=np.uint64).reshape(4, 65536)[:, :n].astype(np.int64)
        t_first = int(r[0].min())
        total = r[1] - r[0]
        longest = int(total.argmax())
        line = dict(
            probe="scan_split", scan=scan, card=smi, k=k, pairs_run=n,
            rows=int(r[3].sum()), parent_ms=ms,
            pair_ns_sum=int(total.sum()), merge_ns_sum=int(r[2].sum()),
            merge_share=float(r[2].sum() / max(total.sum(), 1)),
            longest_pair_ms=float(total[longest] / 1e6), longest_pair_rows=int(r[3][longest]),
            longest_pair_merge_ms=float(r[2][longest] / 1e6),
            longest_pair_start_ms=float((r[0][longest] - t_first) / 1e6),
            last_end_ms=float((r[1].max() - t_first) / 1e6),
            pairs_over_1ms=int((total > 1_000_000).sum()))
        if args.port:
            line["port_ms"] = cs.cuda_ms(torch, lambda: port(scan), 3)
            split = {}
            port(scan, split)
            line["port_split"] = split or None
            if args.variant_csrc:
                line["variants"] = variants(scan, port)
            torch.cuda.synchronize()
            parent(scan)
            torch.cuda.synchronize()
            pq = pair_q.long()
            a = query_merge(torch, out["old"][0], out["old"][1], pq, n_q, k)
            b = query_merge(torch, out["new"][0], out["new"][1], pq, n_q, k)
            line["same_per_query"] = all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                                         for x, y in zip(a, b))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
