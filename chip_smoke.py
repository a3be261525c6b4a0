#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU, and check them.

    python3 chip_smoke.py [--n 100000000] [--batches 5] [--seed 0]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the CUDA kernels from `src/repro_torch/csrc/`, then first serves
the dense LM (`lm_serve`): full-width qwen3-8b (36 layers, d 4096, GQA 32/8,
head 128, vocab 151,936; random bf16 weights from the seed) through
`repro_torch.launch.serve.serve` with the flash kernel on, batch 4, a
2048-token prompt and 512 greedy decode steps against an f32 KV cache,
then `--retrieval --rerank exact` on a 20,000-vector engine of the model's
width (M = 8, so dsub 512): prefill ms after one warm-up prefill, decode ms
per step and tok/s, peak memory, the first generated tokens; kernel B10's
launches must be 36 in the prefill and 0 in the decode, and the search must
launch B1, B4, B2 and B3 (counts reset just before `serve`).  B1 is held
against its plain version at that search's shapes (the wide-dsub kernel),
and B3 on the same engine's own candidates (D = 4096), each timed warm and
cold (`cold_ms`: the L2 evicted before each launch, as the caller meets
its inputs).  The
same prompt's prefill with the flash kernel off (the chunked scan) must
give last-position logits within `LM_E2E_REL` / `LM_E2E_MAX`, and B10 is
held against its plain version at the prefill's shapes (bf16 q against the
f32 cache within one bf16 ulp, an f32 q at the reference's rtol 1e-4, atol
1e-5), and with q scaled so that the largest live logit is 30 (the peaked
case) against the same function in float64 at those tolerances (there the
f32 plain version's own rounding exceeds the f32 tolerance), and timed
beside the plain version and SDPA, with
its registers, spilled bytes and shared memory, its FP32 bound and its
tensor-core bound (the split scheme's TF32 passes).  The model is freed
before the retrieval engine is built.  Then it generates a SIFT1B-geometry corpus on the card (D = 128, M = 16 uint8
codes, IVF 4096, nprobe 64, k = 10, 1000-query batches, 8 logical devices,
bf16 raw store; N = 100M rows by default, the paper's 1e9 cut so the raw
store fits one card), builds the engine with the port's own k-means and
PQ, and then, on the main path (tiles scan, plain codes, prune, exact
re-rank):

  1. times 1000-query `MemANNSEngine.search` batches (QPS, ms per batch),
     with every kernel's launch count reset just before and read just after;
  2. holds each kernel against its plain PyTorch version at the shapes of
     that path (tolerance: allclose rtol = atol = 1e-5 on distances, rows
     and ids equal; B3 bit-equal) and times kernel (`ms`: launches back
     to back from Python; `queued_ms`: the same launches queued behind a
     device-side spin, so that no host gap between them is timed; for B3
     also cold), plain version, bound and the PyTorch
     expression that computes the same function, where there is one; for
     B2 / B5 it also gives the lookup bound (table lookups over the SMs'
     shared-memory rate at the SM clock read during the timing);
  3. holds 16 queries' engine output against a plain path (plain LUTs ->
     unpruned ADC over every probed row -> stable top-k' -> plain exact
     re-rank): distances bit-equal, ids equal outside exactly tied groups;
  4. checks that the pruned search equals the unpruned one bit for bit;
  5. prints recall@10 against a chunked brute force (information only);

then the co-occurrence slice (paper §4.3) and the windows scan:

  6. `cooc_build`: co-occurrence shards from the same index and placement,
     mined, re-encoded and packed on the card (seconds per stage, width,
     length reduction, bytes, peak memory);
  7. `search_cooc_tiles`, `search_windows_plain`, `search_cooc_windows`:
     each path's batches timed as in 1, its kernels' counts reset just
     before and read just after, plus one profiled batch;
  8. `cooc_global_tables`: the §4.3 online table build for one shared combo
     set (`core.cooc.build_ext_lut`, kernel B9) over the batch's LUTs;
  9. kernel checks of B4, B9, B5 (uint8 and uint16 codes) and B2 on
     uint16 direct addresses, as in 2;
 10. `equivalence`: windows == tiles bit for bit for both encodings,
     co-occurrence pruned == unpruned, 16 queries of the co-occurrence
     engine == a plain path, and co-occurrence vs plain ADC distances
     within rtol 2e-4 (the reference's cross-encoding tolerance);

then the kernel-level ADC API (the reference's `repro.kernels.ops`) over
all N codes of the same index, and the flat baseline search:

 11. `kernel_api_scan`: B8 (`ops.adc_scan`) over every raw uint8 code row
     with one table, and (`ops.adc_scan_flat`) over one device's §4.3
     uint16 addresses;
 12. `kernel_api_topk`: B6 (`ops.adc_topk`) over every code row for
     Q = 1, 4, 8, 16 tables at k = 10 and k = 1, 100, 1024, 4096 at Q = 1,
     plus one launch with a finite per-query bound; each with its lookup
     bound (Q * N * W lookups, one warp lookup per SM clock, at the SM
     clock read while it is timed);
 13. `kernel_api_pairs`: B7 (`ops.adc_topk_pairs`) over the 64 probed
     clusters of one query, materialised as int32 windows;
 14. `flat_search`: `core.index.search` (one B1 and one grouped B6 launch)
     for 16 queries, against the engine with the re-rank off: distances
     bit-equal, ids equal outside exactly tied groups; one search under
     cProfile (host ms by function) and one under torch.profiler (device
     busy and idle, B6's device time), and its grouped B6 call held against
     its plain version and timed beside it and a per-cluster PyTorch
     expression.
Each kernel is held against its plain version and timed as in 2, with a
chunked PyTorch expression of its function as the library yardstick (for
B2 / B5 each filled pair's gather + sum + `torch.topk`, for B4 / B9 a
gather + sum + `torch.cat`; each checked to compute the kernel's function).

The onehot path (PR 21): on the main path's raw codes B2 / B5 / B8 / B6
on onehot equal the gather bit for bit, and one onehot batch
(`search_onehot`) equals the gather's; `serving` drives `ServingEngine`
over the main-path engine (micro-batches of 500, the timed batches as one
stream, pipeline depths 0 and 1 on both paths: bit-identical, equal to
`MemANNSEngine.search`, no build after warmup; QPS, p50 / p99, host and
overlap fractions); `search_cooc_tiles_onehot` / `_windows_onehot` drive
the co-occurrence shards on onehot; and the onehot instantiations over
direct addresses -- B2 and B5 (the cooc plans), B7 (query 0's probed
clusters as uint16 windows), B8 and B6 (one device's uint16 addresses) --
are held bit-equal to their plain onehot versions and within rtol = atol
= 1e-5 of the gather kernels, timed beside them, with bounds that count
the sort's compare-exchanges; `equivalence` adds onehot tiles == windows
and pruned == unpruned bit for bit, and onehot within rtol 1e-5 of the
gather on the co-occurrence shards.  `lm_serve`'s `--retrieval` serves
through `ServingEngine` (two micro-batches, no build after warmup).

Serving's observability, faults and mutation (PR 22):
`serving_obs_faults` (after `serving`, on the immutable engine, micro-batches
of 500 at depth 1) serves the timed stream with a `Tracer` and the metrics
registry against observability off (bit-identical, no build; every batch
tree holds plan > schedule / densify / emit_tiles, dispatch >
rerank_dispatch, dispatch_wait, collect; the Prometheus text passes
tools/check_metrics_torch.py's line check), profiles one micro-batch with
its spans as `torch.profiler` ranges (the kernels launched inside each
span), and drives the fault paths: logical device 3 dead from batch 1
(covered queries bit-identical to the healthy run, the rest flagged, the
lost pairs equal to the plans'), a hung collect at batch 2 (failed over and
refired), two transient dispatch faults (retried), a 1 ms deadline (late
batches equal the ADC search at `degrade_nprobe`) and a queue limit
(shed).  `mutable_serving` (last, on the mutable engine once its delta is
empty) serves 10 churn rounds of 350 inserts, 110 deletes and the 5,000-query
stream through `ServingEngine(mutable=True)` at its defaults (fetch bucket
128, an auto-compaction in round 9) with checks (a)-(f) of its docstring;
it records QPS with the compactions left out, p50 / p99, the host
fraction, the phases' seconds, each compaction's stages, the kernels each
span launched in one profiled micro-batch, and the registry's snapshot.

OPQ, the autotune and checkpoints: `autotune` (after
`flat_search`, on the main engine) sweeps the kernel geometry through
`ServingEngine(autotune="sweep")` with a fresh cache directory, serves the
5,000-query stream tuned (bit-identical to untuned, no build after
warmup), hits the cache from a second server, times one real batch at
each swept `block_n` and restores 1024; `checkpoint` (after
`mutable_cooc_windows`, on its engine with a live delta) round-trips
`save_engine` / `load_engine` (1000 queries bit-identical), crashes the
save at each point and saves and loads the 100M index; `opq` (last)
rebuilds the corpus from the seed with `opq_iters=5` and checks it
against a plain path, pruned against unpruned, and with 1000 inserts.

Every phase that fails raises.  The line before last is the kernels' JSON,
the last line `{"ok": true, "device": {...}}`.  Without a visible GPU, or
outside a checkout, it exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pathlib
import pstats
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3, NVIDIA data sheet
# H100 SXM: 67 TFLOP/s of FP32 outside the tensor cores counts each FMA as
# two flops; the kernels issue unfused adds, subs and muls, one per slot
FP32_INSTR_PER_S = 67e12 / 2
# H100 SXM: dense TF32 tensor-core rate (NVIDIA data sheet)
TF32_FLOPS = 495e12

D, M, N_CLUSTERS, NPROBE, K, BATCH, NDEV, BLOCK_N = 128, 16, 4096, 64, 10, 1000, 8, 1024
TOL = dict(rtol=1e-5, atol=1e-5)
# the LM serving phase: full-width qwen3-8b, random bf16 weights, f32 cache
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "qwen3-8b", 4, 2048, 512
# `--retrieval --rerank exact` with the reference's other defaults
# autotune off: a cache left under ~ by an earlier sweep must never retile
# a phase other than `autotune` (its numbers are the build-time geometry's)
LM_RETRIEVAL = dict(vectors=20_000, rerank="exact", autotune="off")
# B10 vs its plain version: the reference's f32 tolerance
# (tests/test_flash_attn.py); with a bf16 q both outputs round f32 results
# that differ by reassociation to bf16, so they agree to one bf16 ulp
FLASH_F32_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)
# flash-on vs flash-off prefill logits (bf16 weights, 36 layers): the kernel
# rounds each layer's attention output to bf16 (q's dtype), the chunked scan
# keeps it f32 into an f32 output projection, as the reference does.  On
# this seed the relative norm of the difference reads 0.0201 and its largest
# entry 0.0226 of the largest logit (same on two H100 hosts); the bounds
# leave 2.5x and 2.2x for another card's GEMM choices
LM_E2E_REL, LM_E2E_MAX = 0.05, 0.05
# the peaked-score case of B10: q scaled so that its largest live logit is this
FLASH_PEAK_LOGIT = 30.0
SRC_ROOT = "src/repro_torch"
# bytes written between two cold launches (`cold_ms`): five times the L2
FLUSH_BYTES = 256 << 20
# the mutable phase: inserts and deletes below the reference's auto-compaction
# point (0.75 of the default 4096-row delta), and the co-occurrence cell's rows
MUT_INSERTS, MUT_DELETES, MUT_COOC_ROWS = 3000, 1000, 4_000_000
# the serving phase: half the 1000-query batch a micro-batch (the reference's
# `serve --retrieval` choice, micro_batch = batch // 2)
SERVE_MICRO_BATCH = 500
# the mutable serving phase: churn rounds of inserts and deletes, each followed
# by the timed batches as one stream; 9 rounds of inserts pass 0.75 of the
# 4096-row delta, so an auto-compaction lands mid-stream
MUT_SERVE_ROUNDS, MUT_SERVE_INSERTS, MUT_SERVE_DELETES = 10, 350, 110
# the spans whose profiler ranges are read, and the port's kernels by name
PROFILED_SPANS = ("plan", "delta", "dispatch", "rerank_dispatch", "collect", "merge")
PORT_KERNELS = ("adc_topk_tiles", "adc_topk_windows", "adc_topk_pairs", "adc_topk", "adc_scan",
                "lut_build", "ext_lut", "rerank", "flash_fwd")


def log(**kv) -> None:
    print(json.dumps(kv, default=float), flush=True)


def ptxas_summary(report: str) -> dict:
    """{kernel identifier + the start of its mangled template arguments:
    'registers, spill stores'} from nvcc's -Xptxas -v report."""
    import re

    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            full = m.group(1)
            ident = re.search(r"_cu_[0-9a-f]{8}(\d+)", full)  # <length><identifier>
            if ident:
                end = ident.end() + int(ident.group(1))
                name = full[ident.end():end] + full[end:end + 28]
            else:
                name = full[:48]
        elif name and "spill stores" in ln:
            spill = ln.strip().split(",")[1].strip()
        elif name and "registers" in ln:
            out[name] = re.search(r"Used \d+ registers", ln).group(0)[5:] + ", " + spill
            name = None
    return out


def cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean device time of `fn` over `reps` launches back to back (CUDA
    events), warmed.  Each launch is enqueued from Python as the card runs,
    so a kernel shorter than its host launch overhead is timed at the
    host's pace (this is `ms` in every row, as in every run before).  With
    `queued` (`queued_ms` in the rows) the card first spins
    (`torch.cuda._sleep`) for twice the host time of enqueueing them, so
    that all `reps` launches wait in the queue and the events time the
    card alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        # ~2e9 SM clocks a second (H100 boost 1.98 GHz); spinning longer only waits
        torch.cuda._sleep(int(min(2 * reps * host_s + 1e-4, 0.05) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` as a caller meets its inputs in device
    memory: before each launch, outside its own event pair, a write of
    `FLUSH_BYTES` evicts the 50 MB L2 (the write also keeps the card busy
    while the host enqueues the launch), warmed."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    events = []
    for i in range(reps):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    del flush
    return sum(a.elapsed_time(b) for a, b in events) / reps


def clocked_ms(torch, fn, reps: int, min_ms: float = 1000.0) -> tuple[float, float]:
    """(mean device ms of `fn`, the SM clock in MHz under it): `cuda_ms`
    over at least `reps` launches and at least `min_ms` of work, so that
    nvidia-smi's 100 ms samples (`SmClock`) see the card under load.  A
    sampler that read nothing (nvidia-smi had not started sampling when the
    work ended) is retaken, twice at most, each time over twice the work."""
    est = cuda_ms(torch, fn, 2)
    for attempt in range(3):
        n = max(reps, int(min_ms * 2**attempt / max(est, 1e-3)) + 1)
        clocks = SmClock()
        try:
            ms = cuda_ms(torch, fn, n)
        finally:
            sm_mhz = clocks.stop()
        if sm_mhz is not None:
            return ms, sm_mhz
    raise RuntimeError("nvidia-smi gave no SM clock samples in three tries")


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and `n_ops` unfused FP32
    instructions over the FP32 instruction rate, in ms."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_INSTR_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flash_bound_tc_ms(n_bytes: float, fmas: float, passes: tuple[int, int]) -> tuple[float, str]:
    """B10's tensor-core bound: the larger of bytes over the HBM rate and
    the split scheme's TF32 passes (Q.K^T, P.V) over the dense TF32 rate;
    `fmas` counts both products once (an FMA is two flops)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = sum(passes) * fmas / TF32_FLOPS * 1e3  # a pass of one product is fmas flops
    return (tb, "bytes") if tb >= to else (to, "operations")


def peak_queries(torch, q, k, scale: float, kv_valid: int, target: float = FLASH_PEAK_LOGIT):
    """q scaled (in f32, then back to q's dtype) so that its largest live
    logit scale * q.k (causal from position 0, keys < kv_valid) is `target`:
    B10's peaked-score case, where a score error costs the most in exp."""
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    g = h // kvh
    live = (torch.arange(kv_valid, device=q.device)[None, :]
            <= torch.arange(s, device=q.device)[:, None])
    top = -float("inf")
    for bi in range(b):
        for j in range(kvh):
            lg = torch.einsum("sgd,kd->sgk", q[bi, :, j * g:(j + 1) * g].float(),
                              k[bi, :kv_valid, j].float()) * scale
            top = max(top, float(lg.masked_fill(~live[:, None, :], -torch.inf).max()))
    return (q.float() * (target / top)).to(q.dtype)


def flash_inputs(torch, dev, seed: int, h: int, kvh: int, hd: int):
    """B10's inputs at the prefill's shapes: q (LM_BATCH, LM_PROMPT, h, hd)
    bf16, k / v (LM_BATCH, LM_PROMPT + LM_STEPS, kvh, hd) f32 caches with
    the prompt's keys filled and zeros after (as the serving path leaves
    them), random normal from the seed."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    q = torch.randn(LM_BATCH, LM_PROMPT, h, hd, device=dev, generator=g).bfloat16()
    k = torch.zeros(LM_BATCH, LM_PROMPT + LM_STEPS, kvh, hd, device=dev)
    v = torch.zeros_like(k)
    k[:, :LM_PROMPT] = torch.randn(LM_BATCH, LM_PROMPT, kvh, hd, device=dev, generator=g)
    v[:, :LM_PROMPT] = torch.randn(LM_BATCH, LM_PROMPT, kvh, hd, device=dev, generator=g)
    return q, k, v


def flash_work(q, kv_valid: int, kvh: int) -> tuple[int, float, float]:
    """(causal pairs per head, FMAs of both products, bytes: q in and out in
    q's dtype, f32 K and V up to kv_valid read once) of one B10 call from
    position 0."""
    b, s, h, hd = q.shape
    pairs = sum(min(i + 1, kv_valid) for i in range(s))
    n_bytes = q.numel() * q.element_size() * 2 + 2 * b * kv_valid * kvh * hd * 4
    return pairs, 2 * b * h * hd * pairs, n_bytes


def flash_exact(torch, q, k, v, scale: float, kv_valid: int):
    """B10's function in float64 (causal from position 0, keys < kv_valid),
    one (batch, KV head) at a time: the reference of the peaked case, where
    the f32 plain version's own rounding exceeds the f32 tolerance."""
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    g = h // kvh
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    live = (torch.arange(kv_valid, device=q.device)[None, :]
            <= torch.arange(s, device=q.device)[:, None])
    for bi in range(b):
        for j in range(kvh):
            lg = torch.einsum("sgd,kd->sgk", q[bi, :, j * g:(j + 1) * g].double(),
                              k[bi, :kv_valid, j].double()) * scale
            p = torch.softmax(lg.masked_fill(~live[:, None, :], -torch.inf), -1)
            out[bi, :, j * g:(j + 1) * g] = torch.einsum("sgk,kd->sgd", p,
                                                         v[bi, :kv_valid, j].double())
    return out


def tol_ratio(got, want, tol: dict) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 inside the tolerance."""
    d = (got.double() - want.double()).abs() / (tol["atol"] + tol["rtol"] * want.double().abs())
    return float(d.max())


def host_by_function(fn, top: int = 12) -> list:
    """[(function, cumulative ms, own ms)] of the `top` functions of the
    port, numpy and torch by cumulative time in one call of `fn` under
    cProfile.  A wait for the device shows in the call that blocks on it
    (e.g. `.cpu()`); numpy indexing counts in its caller's own time."""
    prof = cProfile.Profile()
    prof.runcall(fn)
    rows = [(name if f == "~" else f"{pathlib.Path(f).name}:{name}", v[3] * 1e3, v[2] * 1e3)
            for (f, _, name), v in pstats.Stats(prof).stats.items()
            if "repro_torch" in f or "numpy" in f or (f == "~" and "torch" in name)]
    return sorted(rows, key=lambda x: -x[1])[:top]


def profile_call(torch, fn, top: int | None = 8) -> tuple[float, dict, int, float]:
    """(device busy ms, ms by kernel (the `top` largest, all if None),
    device activities, wall ms) of
    one call of `fn` under torch.profiler, synchronised at its end.  Busy
    is the union of the device's own activities (kernels, copies, memsets)
    in time; the CPU-side ops that launched them, which `key_averages`
    also credits with device time, are not counted again, nor CUPTI's
    "Command Buffer Full" overhead records (host stalls)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as tp:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    acts = [e for e in tp.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "Command Buffer Full"]
    by_kernel, busy, end = {}, 0.0, -float("inf")
    for e in sorted(acts, key=lambda e: e.time_range.start):
        t0, t1 = e.time_range.start, e.time_range.end
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + (t1 - t0) / 1e3
    ranked = dict(sorted(by_kernel.items(), key=lambda x: -x[1])[:top])
    return busy / 1e3, ranked, len(acts), wall


def check_scan(torch, ops, k_topk, *, name, scan, source, replaces, launches, tables,
               lut_row, codes, plan, dv, kp, regs, path="gather") -> dict:
    """B2 (scan="tiles") or B5 ("windows") at a path's shapes: the pruned
    scan as the path calls it and the unpruned scan per pair against the
    plain version (rows equal, distances allclose), kernel times pruned and
    unpruned, the plain version's time and the bound of what was read.
    Beside the FP32 / byte bound it gives the lookup bound: the scored rows' W
    table lookups each, one warp lookup per SM clock on every SM, at the
    SM clock nvidia-smi reads while the pruned scan is timed.  On
    `path="onehot"` the scans are the onehot instantiations: bit-equal to
    the plain onehot version, and per pair within rtol = atol = 1e-5 of
    the gather kernel on the same input (on direct addresses the sums
    reassociate); the bound counts the sort's compare-exchanges, the
    library expression sums each row's sorted addresses."""
    import numpy as np

    dev = codes.device
    ndev, p = plan.pair_q.shape
    pair_slot = torch.as_tensor(plan.pair_slot, device=dev).long()
    pair_valid = torch.as_tensor(plan.pair_valid, device=dev)
    n_valid = torch.where(pair_valid, dv["slot_size"].gather(1, pair_slot), 0).int()
    starts = dv["slot_start"].gather(1, pair_slot).int()
    pair_q = torch.as_tensor(plan.pair_q, device=dev)
    pair_lb = torch.as_tensor(plan.pair_lb, device=dev)
    qbound = torch.as_tensor(plan.query_bounds(kp), device=dev)
    lut_row2 = lut_row.reshape(ndev, p)
    flat_nv, flat_st = n_valid.reshape(-1), starts.reshape(-1)
    flat_q, flat_lb = pair_q.int().reshape(-1), pair_lb.reshape(-1)
    no_lb = torch.full_like(flat_lb, -torch.inf)
    no_b = torch.full((ndev * p,), torch.inf, device=dev)
    if scan == "tiles":
        tiles = [torch.as_tensor(a, device=dev) for a in
                 (plan.tile_pair, plan.tile_block, plan.tile_row0)]
        _, _, ps = ops.adc_topk_tiles(tables, codes, *tiles, n_valid, kp, block_n=BLOCK_N,
                                        pair_q=pair_q, pair_lb=pair_lb, bound=qbound,
                                        lut_row=lut_row2, path=path)

        def unpruned(pth):
            return ops.adc_topk_tiles(tables, codes, *tiles, n_valid, kp, block_n=BLOCK_N,
                                      lut_row=lut_row2, path=pth)
        t0, t1, order = k_topk.pair_runs(tiles[0], p)
        tb, tr = tiles[1].int().reshape(-1), tiles[2].int().reshape(-1)

        def plain():
            return k_topk.adc_topk_tiles_plain(
                tables, lut_row, codes, tb, tr, flat_nv,
                torch.arange(ndev * p, dtype=torch.int32, device=dev), no_lb, no_b,
                t0, t1, kp, BLOCK_N, path)

        def launch(lb, b, sq, ov, oi, os_):
            k_topk.launch(tables, lut_row, codes, order, t0, t1, tb, tr, flat_nv, flat_q,
                          lb, b, sq, ov, oi, os_, kp, BLOCK_N, path)
    else:
        _, _, ps = ops.adc_topk_windows(tables, codes, starts, n_valid, kp,
                                          block_n=BLOCK_N, pair_q=pair_q, pair_lb=pair_lb,
                                          bound=qbound, lut_row=lut_row2, path=path)

        def unpruned(pth):
            return ops.adc_topk_windows(tables, codes, starts, n_valid, kp, block_n=BLOCK_N,
                                        lut_row=lut_row2, path=pth)
        filled = torch.nonzero((lut_row >= 0) & (flat_nv > 0)).flatten()
        order = filled[torch.sort(flat_lb[filled], stable=True).indices].int()

        def plain():
            return k_topk.adc_topk_windows_plain(
                tables, lut_row, codes, flat_st, flat_nv,
                torch.arange(ndev * p, dtype=torch.int32, device=dev), no_lb, no_b,
                kp, BLOCK_N, path)

        def launch(lb, b, sq, ov, oi, os_):
            k_topk.launch_windows(tables, lut_row, codes, order, flat_st, flat_nv, flat_q,
                                  lb, b, sq, ov, oi, os_, kp, BLOCK_N, path)
    kv, ki, _ = unpruned(path)
    t = time.perf_counter()
    plv, pli, _ = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    plv, pli = plv.reshape(kv.shape), pli.reshape(ki.shape)
    if not (torch.equal(ki, pli) and torch.allclose(kv, plv, **TOL)):
        raise RuntimeError(f"{name} disagrees with its plain version")
    if path == "onehot" and not torch.equal(kv, plv):
        raise RuntimeError(f"{name} is not bit-equal to its plain onehot version")
    fin = torch.isfinite(kv)
    err = float((kv[fin] - plv[fin]).abs().max()) if bool(fin.any()) else 0.0
    del plv, pli
    vs_gather = {}
    if path == "onehot":  # the same pairs' lists on the gather kernel
        gv, gi, _ = unpruned("gather")
        if not torch.allclose(kv, gv, **TOL):
            raise RuntimeError(f"{name}: onehot and gather differ beyond rtol 1e-5")
        differing = onehot_differs(torch, name, codes, kv, gv)
        rel = (kv[fin] - gv[fin]).abs() / gv[fin].abs().clamp_min(1e-30)
        vs_gather = dict(gather_max_rel=float(rel.max()) if bool(fin.any()) else 0.0,
                         gather_bit_equal=bool(torch.equal(kv, gv) and torch.equal(ki, gi)),
                         entries_differing_from_gather=differing)
        del gv, gi
    sq = qbound.clone()
    ov, oi, os_ = (torch.empty(ndev * p, kp, device=dev),
                   torch.empty(ndev * p, kp, dtype=torch.int32, device=dev),
                   torch.empty(ndev * p, 2, dtype=torch.int32, device=dev))
    w, item = codes.shape[2], codes.element_size()

    def run(pruned: bool):
        sq.copy_(qbound if pruned else torch.full_like(qbound, torch.inf))
        launch(flat_lb if pruned else no_lb,
               qbound if pruned else torch.full_like(qbound, torch.inf), sq, ov, oi, os_)

    ms, sm_mhz = clocked_ms(torch, lambda: run(True), 20)
    queued = cuda_ms(torch, lambda: run(True), 20, queued=True)
    lookups = (int(n_valid.sum()) - int(ps[..., 1].sum())) * w
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    extra = dict(
        lookup_bound_ms=lookups / (n_sm * 32 * sm_mhz * 1e6) * 1e3, lookups=lookups,
        sms=n_sm, sm_clock_mhz=sm_mhz,
        registers=scan_registers(regs, scan, k_topk.code_format(codes), w,
                                 sort=path == "onehot"))
    unpruned_ms = cuda_ms(torch, lambda: run(False), 10)
    lib_run, lib_groups = scan_library(torch, tables, lut_row, codes, flat_st, flat_nv, kp,
                                       sort=path == "onehot")
    lib_v = torch.full((ndev * p, kp), torch.inf, device=dev)
    lib_run(lib_v)
    if not torch.allclose(lib_v, kv.reshape(ndev * p, kp), **TOL):
        raise RuntimeError(f"{name}: the library expression computes another function")
    del lib_v
    library_ms = cuda_ms(torch, lib_run, 1)
    valid_rows = int(n_valid.sum())
    scanned = valid_rows - int(ps[..., 1].sum())
    pairs_run = int(((lut_row >= 0) & (flat_nv > 0)).sum())
    table_bytes = pairs_run * tables.shape[1] * 4
    out_bytes = ndev * p * (kp * 8 + 8)
    # inputs read once: the distinct (device, slot) regions the pairs probe
    # (a cluster probed by many queries is one input), every table, and the
    # outputs; operations: one add per entry of every row each pair scored
    s_n = dv["slot_size"].shape[1]
    regions = np.unique(np.nonzero(plan.pair_valid)[0] * s_n
                        + plan.pair_slot[plan.pair_valid])
    distinct = int(dv["slot_size"].reshape(-1)[torch.as_tensor(regions, device=dev)].sum())
    in_bytes = distinct * w * item + table_bytes + out_bytes
    # one add per entry, and on the onehot path's direct addresses the
    # sort's compare-exchanges (a min and a max each)
    per_row = w + (2 * k_topk.sort_network_size(w)
                   if path == "onehot" and k_topk.code_format(codes) else 0)
    bms, by = bound_ms(in_bytes, scanned * per_row)
    tiles_total = int(((flat_nv + BLOCK_N - 1) // BLOCK_N).sum())
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=library_ms,
        library_call="per filled pair, its valid rows' tables[pair][addresses].sum(-1) then "
                     f"torch.topk(k', largest=False), pairs of like length batched "
                     f"({lib_groups} gathers of <= 8M rows; no pruning"
                     + ("; each row's addresses sorted first)" if path == "onehot" else ")"),
        path=path, **vs_gather,
        unpruned_ms=unpruned_ms, unpruned_bound_ms=bound_ms(in_bytes, valid_rows * per_row)[0],
        # what this design reads: every pair's scored rows from memory
        per_pair_read_ms=bound_ms(scanned * w * item + table_bytes + out_bytes, 0)[0],
        shape=dict(pairs=ndev * p, pairs_scanned=pairs_run, k=kp, code_dtype=str(codes.dtype),
                   width=w, table_width=tables.shape[1], valid_rows=valid_rows,
                   distinct_rows=distinct, scanned_rows=scanned, tiles=tiles_total,
                   tiles_skipped=int(ps[..., 0].sum())),
        **extra,
    )


def onehot_differs(torch, name: str, codes, onehot, gather) -> int:
    """The entries where a onehot kernel's output differs from the gather
    kernel's on the same input.  On direct addresses a combo's address sits
    mid-row, so the sorted sum rounds differently on some rows: an output
    bit-equal to the gather's would not show that the sorting instantiation
    ran, and fails here.  Raw codes need no sort and return 0."""
    n = int((onehot != gather).sum())
    if codes.dtype != torch.uint8 and n == 0:
        raise RuntimeError(f"{name}: onehot equals the gather bit for bit on direct "
                           "addresses, so the check cannot tell the paths apart")
    return n


def scan_registers(regs: dict, scan: str, fmt: int, w: int, sort: bool = False) -> str | None:
    """ptxas' registers and spills of B2 / B5 (`scan` tiles | windows) for
    code format `fmt`, width `w` and path (`sort`: the onehot path on
    direct addresses), the instantiation REPRO_ADC_DISPATCH
    (csrc/adc_topk_common.cuh) launches: a compiled width, else 0."""
    ctype = {0: "h", 1: "t", 2: "i"}[fmt]
    wt = w if w in ((8, 16, 32) if fmt == 0 else (8, 16)) else 0
    want = f"adc_topk_{scan}_kernelI{ctype}Lb{int(fmt == 0)}ELi{wt}ELb{int(sort and fmt > 0)}EE"
    hits = [v for k, v in regs.items() if k.startswith(want)]
    return hits[0] if hits else None


def topk_registers(regs: dict, kernel: str, fmt: int, w: int, g: int,
                   sort: bool = False) -> str | None:
    """ptxas' registers and spills of B6 (`adc_topk_kernel`, G tables) or B7
    (`adc_topk_pairs_kernel`) for code format `fmt`, width `w` and path
    (`sort`: the onehot path on direct addresses)."""
    ctype = {0: "h", 1: "t", 2: "i"}[fmt]
    wt = w if w in ((8, 16, 32) if fmt == 0 else (8, 16)) else 0
    want = (f"{kernel}I{ctype}Lb{int(fmt == 0)}ELi{wt}E"
            + (f"Li{g}E" if "pairs" not in kernel else "") + f"Lb{int(sort and fmt > 0)}E")
    hits = [v for k, v in regs.items() if k.startswith(want)]
    return hits[0] if hits else None


class SmClock:
    """nvidia-smi's SM clock (MHz) sampled every 100 ms from construction to
    `stop()`, which ends the sampler and returns the largest sample (the
    clock under load; idle samples before the first launch read lower), or
    None when it read none."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.samples: list[float] = []

    def stop(self) -> float | None:
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = [float(x) for x in out.split() if x.strip().replace(".", "").isdigit()]
        return max(self.samples) if self.samples else None


def scan_library(torch, tables, lut_row, codes, starts, n_valid, kp, max_rows=1 << 23,
                 sort=False):
    """Library yardstick for B2 / B5: each filled pair's k' smallest ADC
    distances over its valid rows as PyTorch expressions.  Pairs sorted by
    length are batched while (pairs x longest) <= `max_rows`; per batch one
    gather of the codes (each row's addresses sorted with `sort`), one of
    the tables, a sum and a `torch.topk`.
    Returns (the closure, the number of batches); the grouping is host
    bookkeeping done here, outside the timing."""
    dev = codes.device
    ndev, cap, w = codes.shape
    wide = codes.dtype == torch.uint16
    flat = (codes.view(torch.int16) if wide else codes).reshape(ndev * cap, w)
    cols = torch.arange(w, device=dev) * 256
    p = lut_row.shape[0] // ndev
    filled = torch.nonzero((lut_row >= 0) & (n_valid > 0)).flatten()
    nv, order = torch.sort(n_valid[filled].long())
    filled = filled[order]
    base = (filled // p) * cap + starts[filled].long()
    trow = lut_row[filled].long()
    nv_h = nv.cpu().numpy()
    groups, i = [], 0
    while i < len(nv_h):
        j = i + 1
        while j < len(nv_h) and (j + 1 - i) * nv_h[j] <= max_rows:
            j += 1
        groups.append((i, j, int(nv_h[j - 1])))
        i = j

    def run(out=None):
        for i, j, width in groups:
            lane = torch.arange(width, device=dev)
            rows = (base[i:j, None] + lane).clamp_max(ndev * cap - 1)
            c = flat[rows].long()
            a = c & 0xFFFF if wide else c + cols
            if sort:
                a = torch.sort(a, dim=-1).values
            d = tables[trow[i:j, None, None], a].sum(-1)
            d = torch.where(lane < nv[i:j, None], d, torch.inf)
            v = torch.topk(d, min(kp, width), dim=1, largest=False).values
            if out is not None:
                out[filled[i:j], : v.shape[1]] = v

    return run, len(groups)


def raw_onehot_equal(torch, np, ops, eng, plan, tables, lut_row, kp) -> None:
    """On raw uint8 codes the onehot path adds a row's entries in column
    order too (the address m * 256 + code grows with m): B2 and B5 on the
    main path's tables and plan, unpruned per pair, onehot == gather bit
    for bit (one instantiation serves both paths)."""
    dv = eng._device_put()
    dev = eng.device
    ndev, p = plan.pair_q.shape
    slot = torch.as_tensor(plan.pair_slot, device=dev).long()
    nv = torch.where(torch.as_tensor(plan.pair_valid, device=dev),
                     dv["slot_size"].gather(1, slot), 0).int()
    starts = dv["slot_start"].gather(1, slot).int()
    tiles = [torch.as_tensor(a, device=dev) for a in
             (plan.tile_pair, plan.tile_block, plan.tile_row0)]
    lr = lut_row.reshape(ndev, p)
    for name, fn, args in (("adc_topk_tiles", ops.adc_topk_tiles, tiles),
                           ("adc_topk_windows", ops.adc_topk_windows, [starts])):
        a = fn(tables, dv["codes"], *args, nv, kp, block_n=BLOCK_N, lut_row=lr, path="onehot")
        b = fn(tables, dv["codes"], *args, nv, kp, block_n=BLOCK_N, lut_row=lr)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise RuntimeError(f"{name}: onehot differs from gather on raw codes")
    log(phase="onehot_raw_equals_gather", kernels=["adc_topk_tiles", "adc_topk_windows"],
        pairs=ndev * p, k=kp, bit_equal=True)


def serving_phase(torch, np, ops, eng, batches) -> dict:
    """PR 21's phase: `ServingEngine` over the main-path engine (the same
    device arrays, no new memory), micro-batches of `SERVE_MICRO_BATCH`, a
    stream of the timed 1000-query batches, at pipeline depths 0 and 1 on
    the gather and the onehot path.  Checks: no nvcc build and no graph
    capture after `warmup()`; B1 / B2 / B3 launched once per micro-batch;
    the four runs bit-identical (raw codes: both paths add in column
    order; depth changes no schedule); equal to `MemANNSEngine.search` on
    the same batches (distances bit-equal, ids outside exact ties).
    Records QPS (stream queries / wall), p50 / p99 micro-batch latency
    (plan -> collect), host and overlap fractions."""
    from repro_torch.kernels import _build
    from repro_torch.retrieval.serving import ServingEngine

    stream = np.concatenate(batches[1:])
    want = [eng.search(qb, NPROBE, K) for qb in batches[1:]]
    want_d = np.concatenate([d for d, _ in want])
    want_i = np.concatenate([i for _, i in want])
    runs, rows = {}, []
    for path in ("gather", "onehot"):
        for depth in (0, 1):
            srv = ServingEngine(dataclasses.replace(eng, path=path), nprobe=NPROBE, k=K,
                                micro_batch=SERVE_MICRO_BATCH, pipeline_depth=depth,
                                autotune="off")
            t = time.perf_counter()
            buckets = srv.warmup()
            warm_s = time.perf_counter() - t
            built = _build.compile_count()
            torch.cuda.synchronize()
            ops.reset_launches()
            t = time.perf_counter()
            d, i = srv.search(stream)
            wall = time.perf_counter() - t
            launches = {k: v for k, v in ops.launches.items() if v}
            st = srv.stats
            if st.compiles or _build.compile_count() != built:
                raise RuntimeError(f"serving ({path}, depth {depth}): {st.compiles} builds "
                                   "after warmup")
            for kname in ("build_luts", "adc_topk_tiles", "rerank_dists"):
                if launches.get(kname) != st.batches:
                    raise RuntimeError(f"serving ({path}, depth {depth}): {kname} launched "
                                       f"{launches.get(kname)} times in {st.batches} batches")
            if d.shape != (len(stream), K) or not np.isfinite(d).all() or (i < 0).any():
                raise RuntimeError(f"serving ({path}, depth {depth}): malformed results")
            runs[path, depth] = (d, i)
            rows.append(dict(
                path=path, pipeline_depth=depth, queries=len(stream),
                micro_batch=SERVE_MICRO_BATCH, micro_batches=st.batches, wall_ms=wall * 1e3,
                qps=len(stream) / wall, p50_ms=st.p50_s() * 1e3, p99_ms=st.p99_s() * 1e3,
                latencies_ms=[x * 1e3 for x in st.latencies_s],
                host_fraction=st.host_fraction(), overlap_fraction=st.overlap_fraction(),
                host_s=st.host_s, device_s=st.device_s, overlap_s=st.overlap_s,
                dispatch_wait_s=st.dispatch_wait_s, collect_wait_s=st.collect_wait_s,
                compiles=st.compiles, launches=launches, warmup_s=warm_s,
                warm_buckets=buckets, bucket_hits=st.bucket_hits,
                load_carry=srv.load_carry().tolist(), autotune=srv.autotune_report))
    base_d, base_i = runs["gather", 0]
    for key, (d, i) in runs.items():
        if not (np.array_equal(d, base_d) and np.array_equal(i, base_i)):
            raise RuntimeError(f"serving {key} differs from gather at depth 0")
    if not same_outside_ties(np, base_d, base_i, want_d, want_i):
        raise RuntimeError("serving differs from MemANNSEngine.search on the same batches")
    out = dict(phase="serving", engine_rows=int(eng.index.n_vectors), ndev=eng.ndev,
               rerank=eng.rerank, scan=eng.scan, runs=rows, bit_identical_runs=len(runs),
               equal_to_engine_search=True)
    log(**out)
    return out


def drive_path(torch, np, ops, name, eng, batches, needed) -> dict:
    """One path's timed batches (after a warm-up), its kernels' counts reset
    just before and read just after; raises if a kernel of `needed` was
    never launched or a result is malformed.  Prints the path's line."""
    kp = eng.k_prime(K)
    eng.search(batches[0], NPROBE, K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    batch_ms, results = [], []
    for qb in batches[1:]:
        t = time.perf_counter()
        results.append(eng.search(qb, NPROBE, K))
        batch_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(ops.launches)
    for kname in needed:
        if launches[kname] <= 0:
            raise RuntimeError(f"{name}: kernel {kname} was never launched on the path")
    for d, i in results:
        if d.shape != (BATCH, K) or not np.isfinite(d).all() or (i < 0).any():
            raise RuntimeError(f"{name}: non-finite distances or missing ids")
        if (np.diff(d, axis=1) < 0).any():
            raise RuntimeError(f"{name}: distances are not ascending")
    peak = torch.cuda.max_memory_allocated() / 1e9
    plan_ms = []
    for qb in batches[1:]:
        t = time.perf_counter()
        eng.plan_batch(qb, NPROBE)
        plan_ms.append((time.perf_counter() - t) * 1e3)
    plan = eng.plan_batch(batches[1], NPROBE)
    busy, by_kernel, _, _ = profile_call(torch, lambda: eng.collect(
        eng.dispatch_rerank(eng.dispatch_plan(plan, kp), batches[1], K)))
    stats = eng.dispatch_plan(plan, kp).prune_stats.cpu().numpy()
    out = dict(
        phase=name, batches=len(batches) - 1, queries_per_batch=BATCH, batch_ms=batch_ms,
        mean_batch_ms=float(np.mean(batch_ms)), qps=BATCH / (np.mean(batch_ms) / 1e3),
        host_plan_ms=plan_ms, launches={k: v for k, v in launches.items() if v},
        peak_memory_gb=peak, device_busy_ms=busy,
        device_busy_of_batch=busy / float(np.mean(batch_ms)), device_ms_by_kernel=by_kernel,
        pairs_per_dev=plan.pairs_per_dev, tiles_per_dev=plan.tiles_per_dev,
        rows_in_scope=int(eng.plan_dev_rows(plan).sum()), tiles=eng.plan_tile_count(plan),
        tiles_skipped=int(stats[:, 0].sum()), rows_skipped=int(stats[:, 1].sum()),
    )
    log(**out)
    return out


def plain_adc_topk(torch, np, k_lut, eng, q, kk):
    """A plain path's ADC candidates: plain LUTs (extended by their
    cluster's combos on direct-address shards) -> unpruned ADC over every
    probed row of the engine's index, entries added in column order ->
    stable top-`kk` per query.  Returns (distances (Q, kk) host, +inf past
    the rows; ids (Q, kk) int32 tensor, -1 there).  Plain codes come from
    the index; re-encoded ones from the shards (the CPU tests hold their
    packing equal to the reference's)."""
    from repro_torch.core.index import filter_clusters

    dev, sh, idx = eng.device, eng.shards, eng.index
    dv = eng._device_put()
    q_code = torch.as_tensor(idx.rotate(q.cpu().numpy()), device=dev)  # OPQ: rotated
    probed, qmc = filter_clusters(dv["centroids"], q_code, NPROBE)
    cb = dv["codebook"]
    m, _, dsub = cb.shape
    luts = k_lut.build_luts_plain(cb, qmc.reshape(-1, m, dsub)).reshape(len(q), NPROBE, -1)
    cols = torch.arange(m, device=dev) * 256
    wide = dv["codes"].dtype == torch.uint16  # gathered through an int16 view
    codes = dv["codes"].view(torch.int16) if wide else dv["codes"]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    cand = torch.full((len(q), kk), -1, dtype=torch.int32, device=dev)
    plain_adc = np.full((len(q), kk), np.inf, np.float32)
    for qi in range(len(q)):
        ds_, ids_ = [], []
        for j, c in enumerate(probed[qi].tolist()):
            lo, hi = int(idx.offsets[c]), int(idx.offsets[c + 1])
            if hi == lo:
                continue
            if sh.add_offsets:
                table = luts[qi, j]
                addr = torch.as_tensor(idx.codes[lo:hi], device=dev).long() + cols
                ids = torch.as_tensor(idx.vec_ids[lo:hi], device=dev)
            else:
                d = eng.placement.replicas[c][0]
                s = int(sh.local_slot[d, c])
                r0 = int(sh.slot_start[d, s])
                table = k_lut.ext_lut_pairs_plain(
                    luts[qi, j][None], dv["combo_addrs"][d, s][None], zero, sh.table_size)[0]
                addr = codes[d, r0 : r0 + hi - lo].long()
                addr = addr & 0xFFFF if wide else addr
                ids = dv["vec_ids"][d, r0 : r0 + hi - lo]
            g = table[addr]
            dd = torch.zeros(hi - lo, device=dev)
            for w in range(addr.shape[1]):
                dd = dd + g[:, w]
            ds_.append(dd)
            ids_.append(ids)
        dq, iq = torch.cat(ds_), torch.cat(ids_)
        sel = torch.sort(dq, stable=True).indices[:kk]
        plain_adc[qi, : sel.numel()] = dq[sel].cpu().numpy()
        cand[qi, : sel.numel()] = iq[sel].int()
    return plain_adc, cand


def plain_rerank(torch, k_rerank, q, cand, raw, kk):
    """Plain exact re-rank of `cand` against a store: stable top-`kk` by
    distance.  Returns host (distances, ids), (+inf, -1) where unmapped."""
    ex = k_rerank.rerank_dists_plain(q, cand, raw.vectors, raw.id_dev, raw.id_row,
                                     raw.row_base)
    sel = torch.sort(ex, dim=1, stable=True).indices[:, :kk]
    d = ex.gather(1, sel)
    i = torch.where(torch.isfinite(d), cand.gather(1, sel), -1)
    return d.cpu().numpy(), i.cpu().numpy()


def same_outside_ties(np, e_d, e_i, p_d, p_i) -> bool:
    """Distances bit-equal and, per distinct distance, the same id set."""
    if not np.array_equal(e_d, p_d):
        return False
    for row_d, a, b in zip(e_d, e_i, p_i):
        for v in np.unique(row_d):
            if set(a[row_d == v]) != set(b[row_d == v]):
                return False
    return True


def same_within_tol(np, a_d, a_i, b_d, b_i, rtol: float) -> dict:
    """Two answers to one search whose distance sums differ by reassociation
    (two encodings): distances allclose at `rtol`, and every id that is not
    at the same place in both lists either is in the other list at a
    distance within `rtol`, or lies within `rtol` of the other list's last
    distance (it crossed the cut).  So ids are equal wherever the distances
    are bit-equal, outside ties within the band.  Raises on a breach;
    returns the counts of moved and crossed ids."""
    if not np.allclose(a_d, b_d, rtol=rtol):
        raise RuntimeError("distances differ beyond the cross-encoding tolerance")
    moved = crossed = 0
    for ad, ai, bd, bi in zip(a_d, a_i, b_d, b_i):
        for x_d, x_i, y_d, y_i in ((ad, ai, bd, bi), (bd, bi, ad, ai)):
            where = {int(v): j for j, v in enumerate(y_i)}
            for j in np.flatnonzero(x_i != y_i).tolist():
                jj = where.get(int(x_i[j]))
                if jj is not None:
                    ok = np.isclose(x_d[j], y_d[jj], rtol=rtol)
                    moved += 1
                else:
                    ok = x_d[j] >= y_d[-1] - rtol * abs(y_d[-1]) - 1e-8
                    crossed += 1
                if not ok:
                    raise RuntimeError(f"id {int(x_i[j])} at distance {x_d[j]} is not in the "
                                       "other answer within the tolerance band")
    return dict(moved=moved // 2, crossed=crossed)


def plain_path_check(torch, np, k_lut, k_rerank, eng, q16) -> None:
    """The engine's answers to a few queries against a plain path
    (`plain_adc_topk` at k' -> plain exact re-rank).  ADC and re-ranked
    distances must be bit-equal, ids equal outside exactly tied groups."""
    kp = eng.k_prime(K)
    e_d, e_i = eng.search(q16, NPROBE, K)
    adc_d, _ = eng.collect(eng.dispatch_plan(eng.plan_batch(q16, NPROBE), kp))
    q = torch.as_tensor(q16, device=eng.device)
    plain_adc, cand = plain_adc_topk(torch, np, k_lut, eng, q, kp)
    if not np.array_equal(np.sort(adc_d, axis=1), plain_adc):
        raise RuntimeError("engine ADC top-k' differs from the plain unpruned scan")
    p_d, p_i = plain_rerank(torch, k_rerank, q, cand, eng.raw, K)
    if not np.array_equal(e_d, p_d):
        raise RuntimeError(f"engine re-ranked distances differ from the plain path:\n"
                           f"{e_d[:2]}\n{p_d[:2]}")
    if not same_outside_ties(np, e_d, e_i, p_d, p_i):
        raise RuntimeError("engine ids differ from the plain path")


def plan_tables(torch, np, ops, eng, plan):
    """The path's tables for `plan`: B1 LUTs of the filled pairs, extended
    by B4 with each pair's cluster combos on direct-address shards.
    Returns (tables (R, A), lut_row (ndev*P,), luts (R, M, 256), combo
    sets (n_sets, n_combos, L) or None, set_idx (R,) or None)."""
    dv = eng._device_put()
    dev = eng.device
    ndev, p = plan.pair_q.shape
    cb = dv["codebook"]
    m, _, dsub = cb.shape
    rows = torch.as_tensor(np.flatnonzero(plan.pair_valid).astype(np.int32), device=dev)
    lut_row = torch.full((ndev * p,), -1, dtype=torch.int32, device=dev)
    lut_row[rows.long()] = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
    luts = ops.build_luts(cb, plan.qmc_pairs.reshape(ndev * p, m, dsub), rows)
    if eng.shards.add_offsets:
        return luts.reshape(rows.shape[0], -1), lut_row, luts, None, None
    s_n, n_combos, combo_len = dv["combo_addrs"].shape[1:]
    slot = torch.as_tensor(plan.pair_slot, device=dev).reshape(-1)
    set_idx = ((rows.long() // p) * s_n + slot[rows.long()]).int()
    combo = dv["combo_addrs"].reshape(ndev * s_n, n_combos, combo_len)
    return ops.build_ext_luts_pairs(luts, combo, set_idx), lut_row, luts, combo, set_idx


def cooc_and_windows(torch, np, ops, k_lut, k_topk, k_rerank, eng, batches, dev,
                     plain_search, plain_adc, regs) -> list[dict]:
    """The second slice's phases: co-occurrence build, its paths and the
    windows scan, the new kernels' checks, and the equivalences.  Returns
    the kernels' rows for the JSON line."""
    from repro_torch.core import cooc
    from repro_torch.core.index import filter_clusters
    from repro_torch.retrieval.layout import build_shards

    kp = eng.k_prime(K)
    qb = batches[1]

    # -- co-occurrence shards from the same index and placement -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    t = time.perf_counter()
    cshards = build_shards(eng.index, eng.placement, use_cooc=True, block_n=BLOCK_N,
                           device=dev, stats=st)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    ceng = dataclasses.replace(eng, shards=cshards, scan="tiles",
                               _dev_arrays=None)
    ceng._device_put()
    log(phase="cooc_build", seconds=t_build, n_combos=cshards.n_combos,
        code_dtype=str(cshards.codes.dtype), code_shape=list(cshards.codes.shape),
        shard_gb=cshards.codes.numel() * cshards.codes.element_size() / 1e9,
        plain_shard_gb=eng.shards.codes.nbytes / 1e9, table_width=cshards.table_size,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **st)

    # -- the new paths: each driven with its counts reset just before -------
    paths = {}
    paths["search_cooc_tiles"] = drive_path(
        torch, np, ops, "search_cooc_tiles", ceng, batches,
        ("build_luts", "build_ext_luts_pairs", "adc_topk_tiles", "rerank_dists"))
    eng.scan = "windows"
    paths["search_windows_plain"] = drive_path(
        torch, np, ops, "search_windows_plain", eng, batches,
        ("build_luts", "adc_topk_windows", "rerank_dists"))
    ceng.scan = "windows"
    paths["search_cooc_windows"] = drive_path(
        torch, np, ops, "search_cooc_windows", ceng, batches,
        ("build_luts", "build_ext_luts_pairs", "adc_topk_windows", "rerank_dists"))
    # the onehot path on the same shards (direct addresses: the sort runs)
    ceng.path = "onehot"
    for scan in ("tiles", "windows"):
        ceng.scan = scan
        paths[f"search_cooc_{scan}_onehot"] = drive_path(
            torch, np, ops, f"search_cooc_{scan}_onehot", ceng, batches,
            ("build_luts", "build_ext_luts_pairs", f"adc_topk_{scan}", "rerank_dists"))
    ceng.path = "gather"

    # -- §4.3 online tables for one shared combo set (kernel B9) ------------
    dv = eng._device_put()
    cb = dv["codebook"]
    dsub = cb.shape[2]
    qt = torch.as_tensor(qb, device=dev)
    _, qmc1 = filter_clusters(dv["centroids"], qt, 1)
    luts9 = ops.build_luts(cb, qmc1.reshape(BATCH, M, dsub).contiguous())
    c_big = int(np.argmax(eng.index.cluster_sizes()))
    d_big = eng.placement.replicas[c_big][0]
    caddr9 = torch.as_tensor(
        cshards.combo_addrs[d_big, cshards.local_slot[d_big, c_big]], device=dev)
    cols9, codes9 = (caddr9 // 256).cpu().numpy(), (caddr9 % 256).cpu().numpy()
    torch.cuda.synchronize()
    ops.reset_launches()
    ext9 = cooc.build_ext_lut(luts9, cols9, codes9)
    torch.cuda.synchronize()
    n9 = ops.launches["build_ext_luts"]
    if n9 <= 0:
        raise RuntimeError("cooc_global_tables: kernel build_ext_luts was never launched")
    log(phase="cooc_global_tables", queries=BATCH, cluster=c_big,
        n_combos=int(caddr9.shape[0]), launches=n9, table_width=int(ext9.shape[1]))

    kernels = []
    # -- B4 at the co-occurrence tiles path's shapes ------------------------
    ceng.scan = "tiles"
    cplan = ceng.plan_batch(qb, NPROBE)
    ext, c_lut_row, cluts, combo, set_idx = plan_tables(torch, np, ops, ceng, cplan)
    r_n, a_w = ext.shape
    cl2 = cluts.reshape(r_n, -1)
    want = k_lut.ext_lut_pairs_plain(cl2, combo, set_idx, a_w)
    if not torch.allclose(ext, want, **TOL):
        raise RuntimeError("ext_lut_pairs disagrees with its plain version")
    err = float((ext - want).abs().max())
    del want
    out4 = torch.empty_like(ext)
    n_sets = int(torch.unique(set_idx).numel())
    nc, cl = combo.shape[1:]
    ma = cl2.shape[1]

    def lib4():
        sums = cl2.gather(1, combo[set_idx.long()].reshape(r_n, -1).long())
        sums = sums.reshape(r_n, nc, cl).sum(-1)
        return torch.cat([cl2, sums, cl2.new_zeros(r_n, a_w - ma - nc)], 1)

    if not torch.allclose(lib4(), ext, **TOL):
        raise RuntimeError("ext_lut_pairs: the library expression computes another function")
    bms, by = bound_ms(4 * (cl2.numel() + r_n + n_sets * nc * cl + ext.numel()),
                       r_n * nc * cl)
    kernels.append(dict(
        name="ext_lut_pairs", route="cuda", source=f"{SRC_ROOT}/csrc/ext_lut.cu",
        replaces="src/repro/kernels/lut_build.py:61",
        launches=paths["search_cooc_tiles"]["launches"]["build_ext_luts_pairs"],
        max_abs_err=err, ms=cuda_ms(torch, lambda: k_lut.launch_ext(cl2, combo, set_idx, out4), 20),
        queued_ms=cuda_ms(torch, lambda: k_lut.launch_ext(cl2, combo, set_idx, out4), 20,
                          queued=True),
        plain_ms=wall_ms(torch, lambda: k_lut.ext_lut_pairs_plain(cl2, combo, set_idx, a_w)),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(torch, lib4, 10),
        library_call="luts.gather(1, combo_addrs[set_idx]).sum over combo items, then "
                     "torch.cat([luts, sums, zeros])",
        shape=dict(rows=r_n, table_width=a_w, n_combos=nc, combo_len=cl, combo_sets=n_sets),
    ))
    del out4

    # -- B9 on the batch's tables with one combo set ------------------------
    l9 = luts9.reshape(BATCH, -1)
    c9 = caddr9.contiguous()
    want = k_lut.ext_lut_plain(l9, c9, ext9.shape[1])
    if not torch.allclose(ext9, want, **TOL):
        raise RuntimeError("ext_lut disagrees with its plain version")
    err = float((ext9 - want).abs().max())
    out9 = torch.empty_like(ext9)
    bms, by = bound_ms(4 * (l9.numel() + c9.numel() + ext9.numel()), BATCH * c9.numel())
    nc9 = c9.shape[0]

    def lib9():
        sums = l9[:, c9.reshape(-1).long()].reshape(BATCH, nc9, -1).sum(-1)
        return torch.cat([l9, sums, l9.new_zeros(BATCH, ext9.shape[1] - l9.shape[1] - nc9)], 1)

    if not torch.allclose(lib9(), ext9, **TOL):
        raise RuntimeError("ext_lut: the library expression computes another function")
    kernels.append(dict(
        name="ext_lut", route="cuda", source=f"{SRC_ROOT}/csrc/ext_lut.cu",
        replaces="src/repro/kernels/lut_build.py:110", launches=n9, max_abs_err=err,
        ms=cuda_ms(torch, lambda: k_lut.launch_ext(l9, c9[None], None, out9), 50),
        queued_ms=cuda_ms(torch, lambda: k_lut.launch_ext(l9, c9[None], None, out9), 50,
                          queued=True),
        plain_ms=wall_ms(torch, lambda: k_lut.ext_lut_plain(l9, c9, ext9.shape[1])),
        bound_ms=bms, bound_by=by, library_ms=cuda_ms(torch, lib9, 50),
        library_call="luts[:, combo_addrs].sum over combo items, then "
                     "torch.cat([luts, sums, zeros]) (one combo set)",
        shape=dict(rows=BATCH, table_width=int(ext9.shape[1]), n_combos=int(c9.shape[0]),
                   combo_len=int(c9.shape[1])),
    ))

    # -- B2 on uint16 direct addresses, B5 on both code types, each on both
    # paths; B7 on onehot over one query's probed clusters of these shards
    for path in ("gather", "onehot"):
        suffix = "" if path == "gather" else "_onehot"
        kernels.append(check_scan(
            torch, ops, k_topk, name="adc_topk_tiles_direct" + suffix, scan="tiles",
            source=f"{SRC_ROOT}/csrc/adc_topk_tiles.cu",
            replaces="src/repro/kernels/adc_topk.py:397",
            launches=paths["search_cooc_tiles" + suffix]["launches"]["adc_topk_tiles"],
            tables=ext, lut_row=c_lut_row, codes=ceng._device_put()["codes"], plan=cplan,
            dv=ceng._device_put(), kp=kp, regs=regs, path=path))
    kernels.append(onehot_pairs_row(torch, np, ops, k_topk, ceng, cplan, ext, c_lut_row, kp,
                                    regs))
    ceng.scan = "windows"
    cwplan = ceng.plan_batch(qb, NPROBE)
    ext_w, cw_lut_row, _, _, _ = plan_tables(torch, np, ops, ceng, cwplan)
    for path in ("gather", "onehot"):
        suffix = "" if path == "gather" else "_onehot"
        kernels.append(check_scan(
            torch, ops, k_topk, name="adc_topk_windows_direct" + suffix, scan="windows",
            source=f"{SRC_ROOT}/csrc/adc_topk_windows.cu",
            replaces="src/repro/kernels/adc_topk.py:592",
            launches=paths["search_cooc_windows" + suffix]["launches"]["adc_topk_windows"],
            tables=ext_w, lut_row=cw_lut_row, codes=ceng._device_put()["codes"], plan=cwplan,
            dv=ceng._device_put(), kp=kp, regs=regs, path=path))
    del ext, ext_w, cluts
    wplan = eng.plan_batch(qb, NPROBE)  # eng.scan is "windows"
    w_tab, w_lut_row, _, _, _ = plan_tables(torch, np, ops, eng, wplan)
    kernels.append(check_scan(
        torch, ops, k_topk, name="adc_topk_windows", scan="windows",
        source=f"{SRC_ROOT}/csrc/adc_topk_windows.cu",
        replaces="src/repro/kernels/adc_topk.py:592",
        launches=paths["search_windows_plain"]["launches"]["adc_topk_windows"],
        tables=w_tab, lut_row=w_lut_row, codes=dv["codes"], plan=wplan, dv=dv, kp=kp,
        regs=regs))
    del w_tab
    torch.cuda.empty_cache()

    # -- equivalence on one 1000-query batch --------------------------------
    def both(e):
        return e.search(qb, NPROBE, K) + e.collect(e.dispatch_plan(e.plan_batch(qb, NPROBE), kp))

    compared = 0
    firsts = {}
    for label, e, path in (("plain", eng, "gather"), ("cooc", ceng, "gather"),
                           ("cooc_onehot", ceng, "onehot")):
        ref_out = plain_search + plain_adc if label == "plain" else None
        e.path = path
        for scan in ("tiles", "windows"):
            for prune in (True, False):
                e.scan, e.prune = scan, prune
                out = both(e)
                if ref_out is None:
                    ref_out = out
                    continue
                for a, b in zip(out, ref_out):
                    if not np.array_equal(a, b):
                        raise RuntimeError(f"{label}: scan={scan} prune={prune} differs "
                                           "from tiles, pruned, bit for bit")
                compared += 1
        firsts[label] = ref_out
        e.scan, e.prune, e.path = "tiles", True, "gather"
    # onehot vs gather on the co-occurrence shards: the re-ranked answers
    # and the ADC top-k' within rtol 1e-5, ids equal outside ties in the band
    onehot_vs_gather = [
        same_within_tol(np, *firsts["cooc_onehot"][j:j + 2], *firsts["cooc"][j:j + 2], 1e-5)
        for j in (0, 2)]
    # cross-encoding: ADC top-k distances agree to f32 reassociation
    p_adc = eng.collect(eng.dispatch_plan(eng.plan_batch(qb, NPROBE), K))[0]
    c_adc = ceng.collect(ceng.dispatch_plan(ceng.plan_batch(qb, NPROBE), K))[0]
    if not np.allclose(c_adc, p_adc, rtol=2e-4, atol=0.0):
        raise RuntimeError("co-occurrence and plain ADC distances differ beyond rtol 2e-4")
    cross_rel = float(np.max(np.abs(c_adc - p_adc) / np.maximum(np.abs(p_adc), 1e-30)))

    # 16 queries: co-occurrence engine == a plain path
    plain_path_check(torch, np, k_lut, k_rerank, ceng, qb[:16])
    log(phase="equivalence", queries=BATCH, bit_identical_runs=compared,
        cross_encoding_max_rel=cross_rel, cooc_plain_path_queries=16, adc_equal=True,
        rerank_equal=True, cooc_onehot_vs_gather=dict(
            searched=onehot_vs_gather[0], adc=onehot_vs_gather[1], rtol=1e-5))
    # for the kernel-level API: device d_big's uint16 addresses and four
    # extended tables (queries 0-3's, with cluster c_big's combos)
    return kernels, cshards.codes[d_big].clone(), ext9[:4].clone()


def onehot_pairs_row(torch, np, ops, k_topk, ceng, cplan, ext, lut_row, kp, regs) -> dict:
    """B7 on the onehot path over direct addresses: the filled pairs of
    query 0 in the co-occurrence tiles plan, each pair's window its
    cluster's uint16 rows of its device's shard (combo addresses at their
    anchor columns, so the sort matters) against its extended table.
    One call counted, held bit-equal to the plain onehot version and within
    rtol = atol = 1e-5 of the gather kernel on the same windows, timed
    beside both, the bound (adds and the sort's compare-exchanges) and the
    library expression on sorted addresses."""
    dv = ceng._device_put()
    dev = ceng.device
    ndev, p = cplan.pair_q.shape
    flat = np.flatnonzero(cplan.pair_valid.reshape(-1) & (cplan.pair_q.reshape(-1) == 0))
    d_of, slot = flat // p, cplan.pair_slot.reshape(-1)[flat]
    starts = dv["slot_start"].cpu().numpy()[d_of, slot]
    sizes = dv["slot_size"].cpu().numpy()[d_of, slot]
    n_pairs, w = len(flat), dv["codes"].shape[2]
    win = max(BLOCK_N, -(-int(sizes.max()) // BLOCK_N) * BLOCK_N)
    wide = torch.zeros((n_pairs, win, w), dtype=torch.int32, device=dev)
    src = dv["codes"].view(torch.int16)
    for j in range(n_pairs):
        seg = src[d_of[j], starts[j]: starts[j] + sizes[j]]
        wide[j, : sizes[j]] = seg.int() & 0xFFFF
    addrs = wide.to(torch.uint16)
    del wide
    tables = ext[lut_row[torch.as_tensor(flat, device=dev)].long()].contiguous()
    n_valid = torch.as_tensor(sizes.astype(np.int32), device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    got = ops.adc_topk_pairs(tables, addrs, n_valid, kp, block_n=BLOCK_N, path="onehot")
    torch.cuda.synchronize()
    n7 = ops.launches["adc_topk_pairs"]
    if n7 != 1:
        raise RuntimeError(f"adc_topk_pairs_onehot: {n7} launches, expected 1")
    t = time.perf_counter()
    want = k_topk.adc_topk_pairs_plain(tables, addrs, n_valid, kp, "onehot")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("adc_topk_pairs_onehot disagrees with its plain version")
    gat = ops.adc_topk_pairs(tables, addrs, n_valid, kp, block_n=BLOCK_N)
    if not torch.allclose(got[0], gat[0], **TOL):
        raise RuntimeError("adc_topk_pairs: onehot and gather differ beyond rtol 1e-5")
    differing = onehot_differs(torch, "adc_topk_pairs_onehot", addrs, got[0], gat[0])
    fin = torch.isfinite(gat[0])
    rel = float(((got[0][fin] - gat[0][fin]).abs() / gat[0][fin].abs().clamp_min(1e-30)).max())
    ov, oi = torch.full_like(got[0], torch.inf), torch.full_like(got[1], -1)

    def run(path):
        k_topk.launch_pairs(tables, addrs, n_valid, ov, oi, kp, BLOCK_N, path)

    ms, sm_mhz = clocked_ms(torch, lambda: run("onehot"), 10)
    queued = cuda_ms(torch, lambda: run("onehot"), 10, queued=True)
    gather_ms = cuda_ms(torch, lambda: run("gather"), 10)
    valid = int(sizes.sum())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bms, by = bound_ms(valid * w * 2 + tables.numel() * 4 + n_pairs * (kp * 8 + 4),
                       valid * (w + 2 * k_topk.sort_network_size(w)))
    lane = torch.arange(win, device=dev)

    def lib():
        for s0 in range(0, n_pairs, 8):
            a = torch.sort(addrs[s0 : s0 + 8].view(torch.int16).long() & 0xFFFF, -1).values
            d = tables[s0 : s0 + 8].gather(1, a.reshape(a.shape[0], -1)).reshape(a.shape)
            d = torch.where(lane < n_valid[s0 : s0 + 8, None], d.sum(-1), torch.inf)
            torch.topk(d, kp, dim=1, largest=False)

    row = dict(
        name="adc_topk_pairs_onehot", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk_pairs.cu",
        replaces="src/repro/kernels/adc_topk.py:642", launches=n7, max_abs_err=0.0,
        ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lib, 3),
        library_call="each row's uint16 addresses sorted, tables.gather(1, windows).sum(-1), "
                     "rows past n_valid at +inf, then torch.topk(largest=False), 8 pairs at "
                     "a time",
        path="onehot", gather_ms=gather_ms, gather_max_rel=rel,
        entries_differing_from_gather=differing,
        lookup_bound_ms=valid * w / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
        registers=topk_registers(regs, "adc_topk_pairs_kernel", 1, w, 1, sort=True),
        shape=dict(pairs=n_pairs, window=win, width=w, k=kp, valid_rows=valid,
                   code_dtype="torch.uint16", table_width=int(tables.shape[1]),
                   sort_compare_exchanges=k_topk.sort_network_size(w)),
    )
    log(phase="kernel_api_pairs_onehot", pairs=n_pairs, window=win, valid_rows=valid, k=kp,
        launches=n7, ms=ms, gather_ms=gather_ms, gather_max_rel=rel)
    del addrs, got, want, gat
    return row


def check_rerank(torch, ops, k_rerank, qt, cand, raw, *, launches: int, shape: dict) -> dict:
    """B3 on a path's own queries and candidates: bit-equal to its plain
    version (+inf where the plain version has it), timed warm (launches
    back to back on the same inputs) and cold (`cold_ms`), beside the
    plain version, the bound and the PyTorch expression of its function."""
    args = (raw.vectors, raw.id_dev, raw.id_row, raw.row_base)
    got = ops.rerank_dists(qt, cand, *args)
    want = k_rerank.rerank_dists_plain(qt, cand, *args)
    fin = torch.isfinite(want)
    if not torch.equal(got, want):
        raise RuntimeError(f"rerank ({shape}) disagrees with its plain version")
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    out = torch.empty_like(got)

    def launch():
        k_rerank.launch(qt, cand, *args, out, 0)

    rows, valid = k_rerank.candidate_rows(cand, raw.id_dev, raw.id_row, raw.row_base)
    n_c, n_v, d = cand.numel(), int(valid.sum()), qt.shape[1]
    n_u = int(torch.unique(rows[valid]).numel())
    # inputs read once, the output written once: every candidate's id and
    # distance, the queries, the row bases, and each distinct row the valid
    # candidates touch with its two id-map entries (an absent id, -1, is
    # skipped); operations per valid candidate
    bms, by = bound_ms(n_c * (4 + 4) + qt.numel() * 4 + raw.row_base.numel() * 8
                       + n_u * (d * raw.vectors.element_size() + 4 + 4), 3 * n_v * d)
    return dict(
        name="rerank", route="cuda", source=f"{SRC_ROOT}/csrc/rerank.cu",
        replaces="src/repro/kernels/rerank.py:74", launches=launches,
        max_abs_err=err, ms=cuda_ms(torch, launch, 50),
        queued_ms=cuda_ms(torch, launch, 50, queued=True), cold_ms=cold_ms(torch, launch, 20),
        plain_ms=wall_ms(torch, lambda: k_rerank.rerank_dists_plain(qt, cand, *args)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(
            torch, lambda: ((raw.vectors[rows].float() - qt[:, None, :]) ** 2).sum(-1), 20),
        library_call="((vectors[rows].float() - queries[:, None, :]) ** 2).sum(-1), the "
                     "gather included (rows from the id map; squared, no sqrt)",
        plan=k_rerank.launch_plan(*cand.shape, d, raw.vectors.element_size(),
                                  torch.cuda.get_device_properties(0).multi_processor_count),
        shape=dict(shape, valid_candidates=n_v, distinct_rows=n_u),
    )


def check_kernel(torch, name, got, want) -> float:
    """Max abs error of `got` against the plain version's `want` (tuples of
    distances and, for the top-k kernels, row indices); raises unless the
    distances are allclose and the indices equal."""
    gv, wv = got[0], want[0]
    if not torch.allclose(gv, wv, **TOL) or (len(got) > 1 and not torch.equal(got[1], want[1])):
        raise RuntimeError(f"{name} disagrees with its plain version")
    fin = torch.isfinite(wv)
    return float((gv[fin] - wv[fin]).abs().max()) if bool(fin.any()) else 0.0


def chunked_topk(torch, tables, addr_of, n_rows, k, chunk):
    """Library yardstick for B6: per chunk of rows, gather + sum, then
    torch.topk(largest=False); one more topk over the chunks' winners."""
    vals, rows = [], []
    for s0 in range(0, n_rows, chunk):
        d = tables[:, addr_of(s0, min(s0 + chunk, n_rows))].sum(-1)
        v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        vals.append(v)
        rows.append(i + s0)
    v, i = torch.topk(torch.cat(vals, 1), k, dim=1, largest=False)
    return v, torch.cat(rows, 1).gather(1, i)


def onehot_topk_flat_row(torch, ops, k_topk, tables, codes, regs, k=K) -> dict:
    """B6 (`ops.adc_topk_flat`) on the onehot path over one device's uint16
    §4.3 addresses with four extended tables (one unit of G = 4: each row's
    addresses sorted once for the four): one call counted, bit-equal to the
    plain onehot version, within rtol = atol = 1e-5 of the gather kernel
    on the same input, timed beside it, with the bound (adds and the sort's
    compare-exchanges), the lookup bound and the library expression on
    sorted addresses."""
    dev = codes.device
    q_n, (n, w) = tables.shape[0], codes.shape
    torch.cuda.synchronize()
    ops.reset_launches()
    got = ops.adc_topk_flat(tables, codes, k, block_n=BLOCK_N, path="onehot")
    torch.cuda.synchronize()
    n6 = ops.launches["adc_topk"]
    if n6 != 1:
        raise RuntimeError(f"adc_topk_flat_onehot: {n6} launches, expected 1")
    inf = torch.full((q_n,), torch.inf, device=dev)
    t = time.perf_counter()
    want = k_topk.adc_topk_plain(tables, codes, inf, k, BLOCK_N, "onehot")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("adc_topk_flat_onehot is not bit-equal to its plain version")
    gat = ops.adc_topk_flat(tables, codes, k, block_n=BLOCK_N)
    if not torch.allclose(got[0], gat[0], **TOL):
        raise RuntimeError("adc_topk_flat: onehot and gather differ beyond rtol 1e-5")
    rel = float(((got[0] - gat[0]).abs() / gat[0].abs().clamp_min(1e-30)).max())
    # these queries' top-k may round alike on both paths, so the sort is
    # shown again on the rows whose sums under the first table differ (B8
    # on both paths): there the onehot top-k must be the plain onehot's and
    # differ from the gather's
    diff = torch.nonzero(ops.adc_scan_flat(tables[0], codes, path="onehot")
                         != ops.adc_scan_flat(tables[0], codes)).flatten()
    if diff.numel() < k:
        raise RuntimeError(f"adc_topk_flat_onehot: {diff.numel()} rows where the paths "
                           f"round apart, fewer than k = {k}")
    sub = codes.view(torch.int16)[diff].view(torch.uint16)
    so = ops.adc_topk_flat(tables, sub, k, block_n=BLOCK_N, path="onehot")
    sp = k_topk.adc_topk_plain(tables, sub, inf, k, BLOCK_N, "onehot")
    if not (torch.equal(so[0], sp[0]) and torch.equal(so[1], sp[1])):
        raise RuntimeError("adc_topk_flat_onehot is not bit-equal to its plain version on the "
                           "rows where the paths round apart")
    differing = onehot_differs(torch, "adc_topk_flat_onehot", sub, so[0],
                               ops.adc_topk_flat(tables, sub, k, block_n=BLOCK_N)[0])
    del so, sp, sub
    g = k_topk.topk_group_size([q_n], [n], k, 1, w, tables.shape[1])
    ov, oi = torch.empty_like(got[0]), torch.empty_like(got[1])

    def run(path):
        k_topk.launch_topk(tables, codes, None, ov, oi, k, BLOCK_N, g, None, path)

    ms, sm_mhz = clocked_ms(torch, lambda: run("onehot"), 10)
    queued = cuda_ms(torch, lambda: run("onehot"), 10, queued=True)
    gather_ms = cuda_ms(torch, lambda: run("gather"), 10)
    ce = k_topk.sort_network_size(w)
    units = -(-q_n // g)
    bms, by = bound_ms(n * w * 2 + tables.numel() * 4 + q_n * k * 8,
                       n * (q_n * w + units * 2 * ce))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def addr_sorted(s0, s1):
        return torch.sort(codes[s0:s1].view(torch.int16).long() & 0xFFFF, -1).values

    row = dict(
        name="adc_topk_flat_onehot", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk.cu",
        replaces="src/repro/kernels/adc_topk.py:702", launches=n6, max_abs_err=0.0,
        ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: chunked_topk(torch, tables, addr_sorted, n, k,
                                                       1 << 22), 2),
        library_call="each row's uint16 addresses sorted, tables[:, addresses].sum(-1) then "
                     "torch.topk(largest=False) per chunk of rows, one more torch.topk over "
                     "the chunks",
        path="onehot", gather_ms=gather_ms, gather_max_rel=rel,
        rows_rounding_apart=int(diff.numel()), entries_differing_on_them=differing,
        lookup_bound_ms=q_n * n * w / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
        registers=topk_registers(regs, "adc_topk_kernel", 1, w, g, sort=True),
        shape=dict(queries=q_n, k=k, rows=n, width=w, code_dtype="torch.uint16",
                   table_width=int(tables.shape[1]), block_n=BLOCK_N, tables_per_block=g,
                   sort_compare_exchanges=ce),
    )
    log(phase="kernel_api_topk_onehot", queries=q_n, k=k, rows=n, launches=n6, ms=ms,
        gather_ms=gather_ms, gather_max_rel=rel)
    return row


def kernel_api_and_flat(torch, np, ops, k_scan, k_topk, eng, batches, dev, direct_codes,
                        direct_tables, regs) -> list[dict]:
    """The third slice's phases: B8, B6 and B7 through `ops` over the whole
    index's codes, and the flat search on B1 + B6; and the onehot path of
    B8 and B6 (PR 21): over the uint16 addresses bit-equal to the plain
    onehot versions and within rtol = atol = 1e-5 of the gather, on the
    raw codes bit-equal to the gather.  Each call is counted with the
    counts reset just before it; returns the kernels' rows."""
    from repro_torch.core.index import filter_clusters, probe_groups, search

    idx = eng.index
    dv = eng._device_put()
    cb = dv["codebook"]
    dsub = cb.shape[2]
    n = idx.n_vectors
    codes = torch.as_tensor(idx.codes, device=dev)                    # (N, M) uint8
    cols = torch.arange(M, device=dev) * 256
    q16 = batches[1][:16]
    qt = torch.as_tensor(q16, device=dev)
    _, qmc1 = filter_clusters(dv["centroids"], qt, 1)
    tables16 = ops.build_luts(cb, qmc1.reshape(16, M, dsub).contiguous()).reshape(16, -1)
    kernels = []

    def counted(kname, fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if ops.launches[kname] <= 0:
            raise RuntimeError(f"kernel {kname} was never launched")
        return out, ops.launches[kname]

    def plain_timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # -- B8 over every code row, raw and direct; direct on both paths -------
    scan_rows = []
    direct_table = direct_tables[0].contiguous()
    gather_out = {}
    for label, table, src, direct, path in (
        ("adc_scan", tables16[0].contiguous(), codes, False, "gather"),
        ("adc_scan_direct", direct_table, direct_codes, True, "gather"),
        ("adc_scan_direct_onehot", direct_table, direct_codes, True, "onehot"),
    ):
        if direct:
            got, n8 = counted("adc_scan", lambda: ops.adc_scan_flat(table, src, path=path))
        else:
            got, n8 = counted("adc_scan", lambda: ops.adc_scan(table.reshape(M, 256), src))
            # raw codes: the onehot path's sums are the gather's, bit for bit
            if not torch.equal(ops.adc_scan(table.reshape(M, 256), src, path="onehot"), got):
                raise RuntimeError("adc_scan: onehot differs from gather on raw codes")
        want, plain_ms = plain_timed(lambda: k_scan.adc_scan_plain(table, src, path))
        err = check_kernel(torch, label, (got,), (want,))
        extra = {}
        if path == "onehot":
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} is not bit-equal to its plain version")
            g8 = gather_out["adc_scan_direct"]
            if not torch.allclose(got, g8, **TOL):
                raise RuntimeError(f"{label}: onehot and gather differ beyond rtol 1e-5")
            rel = float(((got - g8).abs() / g8.abs().clamp_min(1e-30)).max())
            extra = dict(path="onehot", gather_max_rel=rel,
                         rows_differing_from_gather=onehot_differs(torch, label, src, got, g8),
                         gather_ms=cuda_ms(torch, lambda: k_scan.launch(table, src, g8), 20))
        del want
        out = torch.empty_like(got)
        rows, w = src.shape
        item = src.element_size()
        sort_ce = k_topk.sort_network_size(w) if path == "onehot" else 0
        bms, by = bound_ms(rows * w * item + rows * 4 + table.numel() * 4,
                           rows * (w + 2 * sort_ce))

        def lib(table=table, src=src, direct=direct, sort=path == "onehot"):
            for s0 in range(0, src.shape[0], 1 << 23):
                a = src[s0 : s0 + (1 << 23)]
                a = (a.view(torch.int16).long() & 0xFFFF) if direct else a.long() + cols
                if sort:
                    a = torch.sort(a, dim=-1).values
                out[s0 : s0 + a.shape[0]] = table[a].sum(-1)

        kernels.append(dict(
            name=label, route="cuda", source=f"{SRC_ROOT}/csrc/adc_scan.cu",
            replaces="src/repro/kernels/adc_scan.py:81", launches=n8, max_abs_err=err,
            ms=cuda_ms(torch, lambda: k_scan.launch(table, src, out, path), 20),
            queued_ms=cuda_ms(torch, lambda: k_scan.launch(table, src, out, path), 20,
                              queued=True),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(torch, lib, 3),
            library_call="table[addresses].sum(-1) in 8M-row chunks (addresses "
                         + ("from uint16 codes" if direct else "codes + m * 256")
                         + (", each row's sorted" if path == "onehot" else "") + ")",
            shape=dict(rows=rows, width=w, code_dtype=str(src.dtype),
                       table_width=table.numel(), sort_compare_exchanges=sort_ce),
            **extra,
        ))
        scan_rows.append(dict(label=label, launches=n8, rows=rows))
        if direct and path == "gather":
            gather_out[label] = got
        del got, out
    del gather_out
    log(phase="kernel_api_scan", calls=scan_rows)

    # -- B6 over every code row: Fig. 16's Q and Fig. 17's k ----------------
    def addr_raw(s0, s1):
        return codes[s0:s1].long() + cols

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    topk_rows = []
    for q_n, k in ((1, 10), (4, 10), (8, 10), (16, 10), (1, 1), (1, 100), (1, 1024),
                   (1, 4096)):
        tab = tables16[:q_n].contiguous()
        got, n6 = counted("adc_topk", lambda: ops.adc_topk(tab, codes, k, block_n=BLOCK_N))
        inf = torch.full((q_n,), torch.inf, device=dev)
        want, plain_ms = plain_timed(
            lambda: k_topk.adc_topk_plain(tab, codes, inf, k, BLOCK_N))
        err = check_kernel(torch, f"adc_topk q={q_n} k={k}", got, want)
        del want
        ov, oi = torch.empty_like(got[0]), torch.empty_like(got[1])
        bms, by = bound_ms(n * M + tab.numel() * 4 + q_n * k * 8, q_n * n * M)
        lib_ms = cuda_ms(torch, lambda: chunked_topk(
            torch, tab, addr_raw, n, k, max(1 << 18, (1 << 24) // q_n)), 2)
        g = k_topk.topk_group_size([q_n], [n], k, 0, M, tab.shape[1])
        ms, sm_mhz = clocked_ms(torch, lambda: k_topk.launch_topk(tab, codes, None, ov, oi, k,
                                                                  BLOCK_N, g), 10)
        queued = cuda_ms(torch, lambda: k_topk.launch_topk(tab, codes, None, ov, oi, k,
                                                           BLOCK_N, g), 10, queued=True)
        if not (torch.equal(ov, got[0]) and torch.equal(oi, got[1])):
            raise RuntimeError(f"adc_topk q={q_n} k={k}: a repeated launch changed the result")
        kernels.append(dict(
            name=f"adc_topk_q{q_n}_k{k}", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk.cu",
            replaces="src/repro/kernels/adc_topk.py:702", launches=n6, max_abs_err=err,
            ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms,
            library_call="tables[:, codes + m * 256].sum(-1) then torch.topk(largest=False) "
                         "per chunk of rows, one more torch.topk over the chunks",
            # the Q * N * W table lookups, one warp lookup per SM clock
            lookup_bound_ms=q_n * n * M / (n_sm * 32 * sm_mhz * 1e6) * 1e3,
            sm_clock_mhz=sm_mhz, registers=topk_registers(regs, "adc_topk_kernel", 0, M, g),
            shape=dict(queries=q_n, k=k, rows=n, width=M, block_n=BLOCK_N, tables_per_block=g,
                       units=-(-q_n // g), blocks=k_topk._grid(dev, "adc_topk_blocks_per_sm",
                                                               0, 0, M, tab.shape[1], k, g)),
        ))
        topk_rows.append(dict(queries=q_n, k=k, launches=n6, ms=ms, tables_per_block=g))
        del got
    # one launch with a finite per-query bound: each query's own k-th
    # distance, so every tile above it is dropped and the result is unchanged
    q_n, k = 4, 10
    tab = tables16[:q_n].contiguous()
    free = ops.adc_topk(tab, codes, k, block_n=BLOCK_N)
    bound = free[0][:, -1].contiguous()
    got, nb = counted("adc_topk", lambda: ops.adc_topk(tab, codes, k, block_n=BLOCK_N,
                                                      bound=bound))
    want, _ = plain_timed(lambda: k_topk.adc_topk_plain(tab, codes, bound, k, BLOCK_N))
    check_kernel(torch, "adc_topk with a bound", got, want)
    if not (torch.equal(got[0], free[0]) and torch.equal(got[1], free[1])):
        raise RuntimeError("adc_topk: a bound at the k-th distance changed the result")
    ov, oi = torch.empty_like(got[0]), torch.empty_like(got[1])
    g = k_topk.topk_group_size([q_n], [n], k, 0, M, tab.shape[1])
    bounded_ms = cuda_ms(torch, lambda: k_topk.launch_topk(tab, codes, bound, ov, oi, k,
                                                           BLOCK_N, g), 10)
    # raw codes: the onehot path's top-k is the gather's, bit for bit
    oh = ops.adc_topk(tab, codes, k, block_n=BLOCK_N, path="onehot")
    if not (torch.equal(oh[0], free[0]) and torch.equal(oh[1], free[1])):
        raise RuntimeError("adc_topk: onehot differs from gather on raw codes")
    log(phase="kernel_api_topk", calls=topk_rows, bounded=dict(
        queries=q_n, k=k, launches=nb, ms=bounded_ms, equal_to_unbounded=True),
        onehot_raw_equals_gather=True)
    del codes
    torch.cuda.empty_cache()
    kernels.append(onehot_topk_flat_row(torch, ops, k_topk, direct_tables, direct_codes, regs))

    # -- B7 on the 64 probed clusters of one query, as int32 windows --------
    kp = eng.k_prime(K)
    cids, qmc = filter_clusters(dv["centroids"], qt[:1], NPROBE)
    cl = cids[0].tolist()
    tables = ops.build_luts(cb, qmc.reshape(NPROBE, M, dsub).contiguous()).reshape(NPROBE, -1)
    sizes = idx.cluster_sizes()[cl]
    win = max(BLOCK_N, -(-int(sizes.max()) // BLOCK_N) * BLOCK_N)
    addrs = torch.zeros((NPROBE, win, M), dtype=torch.int32, device=dev)
    for j, c in enumerate(cl):
        seg = torch.as_tensor(idx.cluster_codes(c), device=dev)
        addrs[j, : seg.shape[0]] = seg.int() + cols.int()
    n_valid = torch.as_tensor(sizes.astype(np.int32), device=dev)
    got, n7 = counted("adc_topk_pairs", lambda: ops.adc_topk_pairs(
        tables, addrs, n_valid, kp, block_n=BLOCK_N))
    want, plain_ms = plain_timed(
        lambda: k_topk.adc_topk_pairs_plain(tables, addrs, n_valid, kp))
    err = check_kernel(torch, "adc_topk_pairs", got, want)
    ov = torch.full_like(got[0], torch.inf)
    oi = torch.full_like(got[1], -1)
    valid = int(sizes.sum())
    bms, by = bound_ms(valid * M * 4 + tables.numel() * 4 + NPROBE * (kp * 8 + 4),
                       valid * M)
    lane = torch.arange(win, device=dev)

    def lib_pairs():
        for s0 in range(0, NPROBE, 8):
            a = addrs[s0 : s0 + 8].long()
            d = tables[s0 : s0 + 8].gather(1, a.reshape(a.shape[0], -1))
            d = d.reshape(a.shape).sum(-1)
            d = torch.where(lane < n_valid[s0 : s0 + 8, None], d, torch.inf)
            torch.topk(d, kp, dim=1, largest=False)

    ms7, sm_mhz = clocked_ms(torch, lambda: k_topk.launch_pairs(tables, addrs, n_valid, ov,
                                                                oi, kp, BLOCK_N), 10)
    queued7 = cuda_ms(torch, lambda: k_topk.launch_pairs(tables, addrs, n_valid, ov, oi, kp,
                                                         BLOCK_N), 10, queued=True)
    kernels.append(dict(
        name="adc_topk_pairs", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk_pairs.cu",
        replaces="src/repro/kernels/adc_topk.py:642", launches=n7, max_abs_err=err,
        ms=ms7, queued_ms=queued7, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lib_pairs, 3),
        library_call="tables.gather(1, windows).sum(-1), rows past n_valid at +inf, then "
                     "torch.topk(largest=False), 8 pairs at a time",
        lookup_bound_ms=valid * M / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
        registers=topk_registers(regs, "adc_topk_pairs_kernel", 2, M, 1),
        shape=dict(pairs=NPROBE, window=win, width=M, k=kp, valid_rows=valid,
                   window_gb=addrs.numel() * 4 / 1e9,
                   blocks=k_topk._grid(dev, "adc_topk_pairs_blocks_per_sm", 2, 0, M,
                                       tables.shape[1], kp)),
    ))
    log(phase="kernel_api_pairs", pairs=NPROBE, window=win, valid_rows=valid, k=kp,
        launches=n7, ms=ms7)
    del addrs, got, want
    torch.cuda.empty_cache()

    # -- the flat search on B1 + B6, against the engine without re-rank -----
    flat_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        f_d, f_i = search(idx, q16, NPROBE, K, device=dev)
        flat_ms.append((time.perf_counter() - t) * 1e3)
        flat_launches = {kn: v for kn, v in ops.launches.items() if v}
    if flat_launches.get("build_luts", 0) != 1 or flat_launches.get("adc_topk", 0) != 1:
        raise RuntimeError(f"flat_search: expected one B1 and one B6 launch: {flat_launches}")
    if f_d.shape != (16, K) or not np.isfinite(f_d).all() or (f_i < 0).any():
        raise RuntimeError("flat_search: non-finite distances or missing ids")
    eng.rerank = "off"
    e_d, e_i = eng.search(q16, NPROBE, K)
    eng.rerank = "exact"
    if not np.array_equal(f_d, e_d):
        raise RuntimeError(f"flat search distances differ from the engine's ADC top-k:\n"
                           f"{f_d[:2]}\n{e_d[:2]}")
    for row_d, a, b in zip(f_d, f_i, e_i):
        for v in np.unique(row_d):
            if set(a[row_d == v]) != set(b[row_d == v]):
                raise RuntimeError("flat search ids differ from the engine's")
    # where the wall time goes: the host by function (one search under
    # cProfile) and the device (one search under torch.profiler)
    host_top = host_by_function(lambda: search(idx, q16, NPROBE, K, device=dev))
    # torch.profiler now and then records none of the port's own kernels
    # in a call (seen on the H100 with every ATen kernel present), so a
    # profile that lacks B6 is taken again, at most three times in all
    for prof_attempts in range(1, 4):
        busy, by_kernel, n_acts, prof_wall = profile_call(
            torch, lambda: search(idx, q16, NPROBE, K, device=dev), top=None)
        b6_prof = sum(ms for name, ms in by_kernel.items() if "adc_topk_kernel" in name)
        if b6_prof > 0:
            break
    else:
        raise RuntimeError(f"flat_search: no B6 kernel in {prof_attempts} profiles: "
                           f"{list(by_kernel)}")
    # that search's grouped B6 call, against its plain version and timed alone
    qrot = torch.as_tensor(idx.rotate(np.asarray(q16, np.float32)), device=dev)
    cids, qmc = filter_clusters(torch.as_tensor(idx.centroids, device=dev), qrot, NPROBE)
    luts = ops.build_luts(torch.as_tensor(idx.codebook, device=dev),
                          qmc.reshape(16 * NPROBE, M, dsub)).reshape(16 * NPROBE, M * 256)
    order, row_off, tab_off, rows = probe_groups(idx, cids)
    codes_t = torch.as_tensor(idx.codes[rows], device=dev)
    lsorted = luts[torch.as_tensor(order, device=dev)]
    got = ops.adc_topk_grouped(lsorted, codes_t, K, row_off, tab_off)
    inf = torch.full((lsorted.shape[0],), torch.inf, device=dev)
    want, plain_ms = plain_timed(lambda: k_topk.adc_topk_grouped_plain(
        lsorted, codes_t, inf, K, BLOCK_N, row_off, tab_off))
    err = check_kernel(torch, "adc_topk grouped (flat search)", got, want)
    g = k_topk.topk_group_size(np.diff(tab_off), np.diff(row_off), K, 0, M, lsorted.shape[1])
    units = k_topk.topk_units(row_off, tab_off, g).to(dev)
    ov, oi = torch.empty_like(got[0]), torch.empty_like(got[1])
    b6_kernel_ms, sm_mhz = clocked_ms(torch, lambda: k_topk.launch_topk(
        lsorted, codes_t, None, ov, oi, K, BLOCK_N, g, units), 20)
    b6_queued_ms = cuda_ms(torch, lambda: k_topk.launch_topk(
        lsorted, codes_t, None, ov, oi, K, BLOCK_N, g, units), 20, queued=True)

    def lib_flat():
        for j in range(len(row_off) - 1):
            r0, r1, t0, t1 = row_off[j], row_off[j + 1], tab_off[j], tab_off[j + 1]
            if r1 > r0:
                d = lsorted[t0:t1][:, codes_t[r0:r1].long() + cols].sum(-1)
                torch.topk(d, min(K, r1 - r0), dim=1, largest=False)

    counts = np.diff(tab_off)
    rows_c = np.diff(row_off)
    n_rows, n_tables = int(rows_c.sum()), int(counts.sum())
    lookups = int((counts * rows_c).sum()) * M
    bms, by = bound_ms(n_rows * M + n_tables * M * 256 * 4 + n_tables * K * 8, lookups)
    kernels.append(dict(
        name="adc_topk_flat_search", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk.cu",
        replaces="src/repro/kernels/adc_topk.py:702", launches=flat_launches["adc_topk"],
        max_abs_err=err, ms=b6_kernel_ms, queued_ms=b6_queued_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lib_flat, 3),
        library_call="per probed cluster, its tables[:, codes + m * 256].sum(-1) then "
                     "torch.topk(min(k, rows), largest=False)",
        lookup_bound_ms=lookups / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
        shape=dict(groups=len(counts), rows=n_rows, tables=n_tables, k=K, tables_per_block=g,
                   units=int(units.shape[0])),
    ))
    log(phase="flat_search", queries=16, nprobe=NPROBE, k=K, wall_ms=flat_ms,
        launches=flat_launches, distinct_clusters=len(counts),
        equal_to_engine_rerank_off=True,
        host_ms_by_function_profiled=host_top,
        profiled=dict(wall_ms=prof_wall, device_busy_ms=busy, device_idle_ms=prof_wall - busy,
                      device_activities=n_acts, b6_device_ms=b6_prof, attempts=prof_attempts),
        b6=dict(launches=flat_launches["adc_topk"], device_ms=b6_prof, kernel_ms=b6_kernel_ms,
                bound_ms=bms, rows=n_rows, tables=n_tables, tables_per_block=g))
    return kernels


def lm_serve(torch, np, ops, k_flash, k_lut, k_rerank, dev, seed: int) -> list:
    """The fourth slice's phase: full-width qwen3-8b served through
    `repro_torch.launch.serve.serve` (prefill on kernel B10, greedy decode,
    retrieval on B1 / B4 / B2 / B3), its launch counts, flash-on vs
    flash-off prefill logits, and B1 (wide dsub), B3 (D = 4096, the
    retrieval engine's own candidates) and B10 held against their plain
    versions at the path's shapes.  Frees the model before it returns the
    kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.configs.memanns import SIFT1B, reduced_retrieval
    from repro_torch.launch.serve import RetrievalOptions, retrieval_engine, serve
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config(LM_ARCH), use_flash_kernel=True)
    cfg_off = dataclasses.replace(cfg, use_flash_kernel=False)
    max_len = LM_PROMPT + LM_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=g, device=dev)

    def run_prefill(c):
        return prefill(model, c, tokens, max_len=max_len, cache_dtype=torch.float32)

    warm_ms = wall_ms(torch, lambda: run_prefill(cfg))

    # -- the main path: serve() through the entry point, counts reset just before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep = serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, steps=LM_STEPS, device=dev,
                params=model, seed=seed, retrieval=RetrievalOptions(**LM_RETRIEVAL))
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launches.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ret = rep["retrieval_stats"]
    per_phase = dict(rep["kernel_launches"], retrieval=ret["kernel_launches"])
    ret_kernels = ("build_luts", "adc_topk_tiles", "rerank_dists") + (
        ("build_ext_luts_pairs",) if ret["cooc"] else ())
    # the retrieval serves through a warmed ServingEngine: micro-batches of
    # half the request batch, each one launch of each retrieval kernel, and
    # no build after warmup
    n_micro = -(-LM_BATCH // max(1, LM_BATCH // 2))
    if (launches.get("flash_attention_fwd") != cfg.n_layers
            or per_phase["prefill"] != {"flash_attention_fwd": cfg.n_layers}
            or per_phase["decode"]
            or any(per_phase["retrieval"].get(n, 0) != n_micro for n in ret_kernels)
            or ret["batches"] != n_micro or ret["compiles"] != 0):
        raise RuntimeError(f"lm_serve: expected {cfg.n_layers} B10 launches in the prefill, "
                           f"none in the decode and {ret_kernels} once in each of "
                           f"{n_micro} retrieval micro-batches with no build, got "
                           f"{launches} ({per_phase}, {ret})")
    gen = np.asarray(rep["generated"])
    if gen.shape != (LM_BATCH, 8) or (gen < 0).any() or (gen >= cfg.vocab_size).any():
        raise RuntimeError(f"lm_serve: malformed generated tokens {gen.tolist()}")
    ids = np.asarray(rep["retrieved_ids"])
    if (ids.shape != (LM_BATCH, 4) or (ids < 0).any()
            or (ids >= LM_RETRIEVAL["vectors"]).any()):
        raise RuntimeError(f"lm_serve: malformed retrieved ids {ids.tolist()}")
    steps = LM_STEPS - 1

    # -- where the time goes: one profiled prefill and decode step
    pre = profile_call(torch, lambda: run_prefill(cfg))
    on, cache = run_prefill(cfg)
    tok = on[:, -1].argmax(-1)[:, None]
    dec = profile_call(torch, lambda: decode_step(model, cfg, tok, cache, LM_PROMPT))
    cfg_od = dataclasses.replace(cfg, opt_decode=True)
    opt_ms = wall_ms(torch, lambda: decode_step(model, cfg_od, tok, cache, LM_PROMPT))
    log(phase="lm_breakdown", prefill_device_busy_ms=pre[0], prefill_wall_ms=pre[3],
        prefill_device_events=pre[2], prefill_ms_by_kernel=pre[1],
        decode_device_busy_ms=dec[0], decode_wall_ms=dec[3], decode_device_events=dec[2],
        decode_ms_by_kernel=dec[1], opt_decode_step_wall_ms=opt_ms)
    del cache
    torch.cuda.synchronize()
    t = time.perf_counter()
    off, cache = run_prefill(cfg_off)
    torch.cuda.synchronize()
    chunked_ms = (time.perf_counter() - t) * 1e3
    del cache
    a, b = on.float()[:, 0], off.float()[:, 0]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("lm_serve: non-finite prefill logits")
    rel = float((a - b).norm() / b.norm())
    max_rel = float((a - b).abs().max() / b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    if rel > LM_E2E_REL or max_rel > LM_E2E_MAX:
        raise RuntimeError(f"lm_serve: flash-on and flash-off logits differ: rel norm {rel}, "
                           f"max {max_rel} of the largest logit")
    log(phase="lm_serve", arch=cfg.name, params_b=cfg.n_params() / 1e9, weights_gb=weights_gb,
        batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_STEPS, cache_dtype="float32",
        init_s=init_s, warmup_prefill_ms=warm_ms, prefill_ms=rep["prefill_s"] * 1e3,
        decode_ms_per_step=rep["decode_s"] * 1e3 / steps,
        decode_tok_per_s=rep["decode_tok_per_s"], peak_memory_gb=peak,
        launches=launches, launches_by_phase=per_phase, generated=rep["generated"],
        chunked_prefill_ms=chunked_ms, flash_vs_chunked_rel_norm=rel,
        flash_vs_chunked_max_of_max=max_rel, first_token_agreement=agree,
        first_tokens_flash=a.argmax(-1).tolist(), first_tokens_chunked=b.argmax(-1).tolist(),
        retrieval_ms=rep["retrieval_s"] * 1e3, retrieved_ids=rep["retrieved_ids"],
        retrieval_stats=ret)
    del model, on, off, a, b
    torch.cuda.empty_cache()

    # -- B1 at the retrieval's shapes: M = 8 tables of dsub 512 per filled pair
    rc = reduced_retrieval(SIFT1B, n_vectors=LM_RETRIEVAL["vectors"], dim=cfg.d_model)
    dsub, n_rows = cfg.d_model // rc.m, LM_BATCH * rc.nprobe
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    cb = torch.randn(rc.m, 256, dsub, device=dev, generator=g)
    qmc = torch.randn(n_rows, rc.m, dsub, device=dev, generator=g)
    rows = torch.arange(n_rows, dtype=torch.int32, device=dev)
    luts = ops.build_luts(cb, qmc, rows)
    want = k_lut.build_luts_plain(cb, qmc)
    err = float((luts - want).abs().max())
    if not torch.equal(luts, want):
        raise RuntimeError(f"lut_build (dsub {dsub}) disagrees with its plain version: {err}")
    out = torch.empty_like(luts)
    n_lut = luts.numel()
    bms, by = bound_ms(4 * (cb.numel() + qmc.numel() + n_rows + n_lut), 3 * n_lut * dsub)
    wide = dsub not in k_lut.TEMPLATED_DSUB
    wide_row = dict(
        name="lut_build", route="cuda", source=f"{SRC_ROOT}/csrc/lut_build.cu",
        replaces="src/repro/kernels/lut_build.py:35",
        launches=per_phase["retrieval"]["build_luts"], max_abs_err=err,
        ms=cuda_ms(torch, lambda: k_lut.launch(cb, qmc, out, rows), 20),
        queued_ms=cuda_ms(torch, lambda: k_lut.launch(cb, qmc, out, rows), 20, queued=True),
        cold_ms=cold_ms(torch, lambda: k_lut.launch(cb, qmc, out, rows), 20),
        plain_ms=wall_ms(torch, lambda: k_lut.build_luts_plain(cb, qmc)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: ((cb[None] - qmc[:, :, None, :]) ** 2).sum(-1), 5),
        library_call="((codebook[None] - qmc[:, :, None, :]) ** 2).sum(-1) (squared, no "
                     "sqrt: the kernel's function)",
        shape=dict(path="lm_serve --retrieval", pairs=n_rows, m=rc.m, dsub=dsub,
                   kernel="lut_build_wide_kernel" if wide else "lut_build_kernel"),
        plan=k_lut.wide_plan(n_rows, rc.m, dsub, torch.cuda.get_device_properties(
            0).multi_processor_count) if wide else None,
    )
    log(phase="lm_lut_wide", **{k_: v_ for k_, v_ in wide_row.items() if k_ != "source"})
    del cb, qmc, luts, want, out

    # -- B3 at the retrieval's shapes: the same engine's own candidates, D = 4096
    reng, rcfg, qv, _ = retrieval_engine(cfg, RetrievalOptions(**LM_RETRIEVAL), LM_BATCH, dev, seed)
    kp = reng.k_prime(rcfg.k)
    handle = reng.dispatch_plan(reng.plan_batch(qv, rcfg.nprobe), kp)
    cand = torch.where(torch.isfinite(handle.out_d), handle.out_i, -1).int().contiguous()
    rerank_row = check_rerank(
        torch, ops, k_rerank, torch.as_tensor(qv, device=dev), cand, reng.raw,
        launches=per_phase["retrieval"]["rerank_dists"],
        shape=dict(path="lm_serve --retrieval", queries=LM_BATCH, candidates=kp,
                   dim=cfg.d_model, store=str(reng.raw.vectors.dtype).replace("torch.", "")))
    log(phase="lm_rerank", **{k_: v_ for k_, v_ in rerank_row.items() if k_ != "source"})
    del reng, handle, cand

    # -- B10 at the prefill's shapes against its plain version ---------------
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = flash_inputs(torch, dev, seed, h, kvh, hd)
    scale = hd**-0.5
    blocks = (min(512, LM_PROMPT), min(512, max_len))
    got = ops.flash_attention_fwd(q, k, v, scale=scale, kv_valid=LM_PROMPT, bq=blocks[0],
                                  bk=blocks[1])
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = k_flash.flash_attention_fwd_plain(q, k, v, scale, 0, LM_PROMPT, *blocks)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **FLASH_BF16_TOL):
        raise RuntimeError(f"flash_attention_fwd (bf16 q) disagrees with its plain version: {err}")
    qf = q.float()
    got32 = ops.flash_attention_fwd(qf, k, v, scale=scale, kv_valid=LM_PROMPT)
    want32 = k_flash.flash_attention_fwd_plain(qf, k, v, scale, 0, LM_PROMPT, *blocks)
    err32 = float((got32 - want32).abs().max())
    if not torch.allclose(got32, want32, **FLASH_F32_TOL):
        raise RuntimeError(f"flash_attention_fwd (f32 q) disagrees with its plain version: {err32}")
    del want, want32
    # the peaked-score case at the same shapes (largest live logit ~30), held
    # against the function in float64 at the same tolerances: there the f32
    # plain version's own rounding uses more than the f32 tolerance (its
    # share is logged beside the kernel's, and the kernel's against it)
    peaked = {}
    for label, qx, tol in (("bf16_q", q, FLASH_BF16_TOL), ("f32_q", qf, FLASH_F32_TOL)):
        qp = peak_queries(torch, qx, k, scale, LM_PROMPT)
        got_p = ops.flash_attention_fwd(qp, k, v, scale=scale, kv_valid=LM_PROMPT)
        want_p = k_flash.flash_attention_fwd_plain(qp, k, v, scale, 0, LM_PROMPT, *blocks)
        exact = flash_exact(torch, qp, k, v, scale, LM_PROMPT).to(qp.dtype)
        err_p = float((got_p.float() - exact.float()).abs().max())
        if not torch.allclose(got_p.float(), exact.float(), **tol):
            raise RuntimeError(f"flash_attention_fwd ({label}, peaked scores) disagrees with "
                               f"the float64 result: {err_p}")
        peaked[label] = dict(
            max_abs_err_vs_f64=err_p, target_logit=FLASH_PEAK_LOGIT,
            tolerance_used=dict(kernel_vs_f64=tol_ratio(got_p, exact, tol),
                                plain_vs_f64=tol_ratio(want_p, exact, tol),
                                kernel_vs_plain=tol_ratio(got_p, want_p, tol)))
        del qp, got_p, want_p, exact
    out = torch.empty_like(got)
    ms = cuda_ms(torch, lambda: k_flash.launch(q, k, v, out, scale, 0, LM_PROMPT), 10)
    queued = cuda_ms(torch, lambda: k_flash.launch(q, k, v, out, scale, 0, LM_PROMPT), 10,
                     queued=True)
    out32 = torch.empty_like(got32)
    ms32 = cuda_ms(torch, lambda: k_flash.launch(qf, k, v, out32, scale, 0, LM_PROMPT), 10)
    # library yardstick: SDPA in f32 on the valid keys, heads first (made outside the timing)
    qt = qf.transpose(1, 2).contiguous()
    kt = k[:, :LM_PROMPT].transpose(1, 2).contiguous()
    vt = v[:, :LM_PROMPT].transpose(1, 2).contiguous()
    sdpa_ms = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), 10)
    pairs, fmas, n_bytes = flash_work(q, LM_PROMPT, kvh)
    bms, by = bound_ms(n_bytes, fmas)
    passes = k_flash.tf32_passes(q.dtype, k.dtype)
    tc_ms, tc_by = flash_bound_tc_ms(n_bytes, fmas, passes)
    attrs = k_flash.kernel_attributes(hd, q.dtype, k.dtype)
    attrs32 = k_flash.kernel_attributes(hd, torch.float32, k.dtype)
    row = dict(
        name="flash_attention_fwd", route="cuda", source=f"{SRC_ROOT}/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:104", launches=launches["flash_attention_fwd"],
        max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=sdpa_ms,
        library_call="F.scaled_dot_product_attention(q, k, v, is_causal=True, "
                     "enable_gqa=True) in f32 on (B, H, S, hd) copies, k / v cut to kv_valid",
        bound_tc_ms=tc_ms, bound_tc_by=tc_by, tf32_passes=dict(qk=passes[0], pv=passes[1]),
        kernel=attrs, peaked=peaked,
        f32_q=dict(max_abs_err=err32, ms=ms32, kernel=attrs32,
                   bound_tc_ms=flash_bound_tc_ms(
                       flash_work(qf, LM_PROMPT, kvh)[2], fmas,
                       k_flash.tf32_passes(torch.float32, k.dtype))[0]),
        shape=dict(q=list(q.shape), kv=list(k.shape), q_dtype="bfloat16", kv_dtype="float32",
                   kv_valid=LM_PROMPT, causal_pairs=pairs, fmas=fmas, bytes=n_bytes),
    )
    log(phase="lm_flash_kernel", **{k_: v_ for k_, v_ in row.items() if k_ != "source"})
    del q, k, v, qf, qt, kt, vt, got, got32, out, out32
    torch.cuda.empty_cache()
    return [wide_row, rerank_row, row]


def delta_store(delta, dev):
    """The delta's vectors as a one-device store (the delta re-rank's,
    `DeltaIndex.device_store`): candidates are buffer rows."""
    import types

    v, i_dev, i_row, base = delta.device_store(dev)
    return types.SimpleNamespace(vectors=v, id_dev=i_dev, id_row=i_row, row_base=base)


def mutable_engine(torch, np, eng, dev, block_n=BLOCK_N, rerank="exact", **knobs):
    """A mutable engine over an engine's trained index, placement and raw
    store (no second training, no corpus): the shards re-packed with the
    mutable slack, the store re-packed with 50 % row slack
    (`layout.reserve_raw_store`, the mutable engine's own raw slack)."""
    from repro_torch.retrieval.engine import MemANNSEngine
    from repro_torch.retrieval.layout import reserve_raw_store

    meng = MemANNSEngine.from_reference(
        eng.index, eng.placement, block_n=block_n, mutable=True, freqs=eng.freqs,
        device=dev, **knobs)
    meng.raw, meng.rerank = reserve_raw_store(eng.raw, 0.5), rerank
    return meng


def compaction_reencode_check(torch, np, meng, old_index, tomb, ins_ids, ins_x, ins_assign,
                              chunk_rows=1 << 22) -> dict:
    """The compacted index against a scratch re-encode of the changed
    clusters: per changed cluster, its surviving rows (in their old order,
    vectors from the raw store, the corpus the index was encoded from) then
    its live inserts (insertion order, the inserted f32 vectors), assigned
    and encoded afresh on the card; assignments, codes, ids and offsets
    must be equal."""
    from repro_torch.core.delta import isin_ids
    from repro_torch.core.index import assign_clusters, encode_vectors

    dev, new, raw = meng.device, meng.index, meng.raw
    c_n = old_index.n_clusters
    old_sizes = old_index.cluster_sizes()
    row_cluster = np.repeat(np.arange(c_n), old_sizes)
    dead = isin_ids(old_index.vec_ids, tomb)
    live_ins = ~np.isin(ins_ids, tomb)
    added = np.bincount(ins_assign[live_ins], minlength=c_n)
    removed = np.bincount(row_cluster[dead], minlength=c_n)
    want_sizes = old_sizes - removed + added
    if not np.array_equal(new.cluster_sizes(), want_sizes):
        raise RuntimeError("compaction: cluster sizes differ from survivors + inserts")
    changed = np.flatnonzero((removed > 0) | (added > 0))
    cent = torch.as_tensor(new.centroids, device=dev)
    cb = torch.as_tensor(new.codebook, device=dev)
    ins_x_t = torch.as_tensor(ins_x, device=dev)
    rows_checked, i = 0, 0
    while i < len(changed):
        j, n_rows = i, 0
        while j < len(changed) and (j == i or n_rows + want_sizes[changed[j]] <= chunk_rows):
            n_rows += int(want_sizes[changed[j]])
            j += 1
        ids, is_ins, ins_pos, clus = [], [], [], []
        for c in changed[i:j].tolist():
            lo, hi = int(old_index.offsets[c]), int(old_index.offsets[c + 1])
            surv = old_index.vec_ids[lo:hi][~dead[lo:hi]]
            mine = np.flatnonzero(live_ins & (ins_assign == c))
            ids += [surv, ins_ids[mine]]
            is_ins += [np.zeros(surv.size, bool), np.ones(mine.size, bool)]
            ins_pos += [np.full(surv.size, -1), mine]
            clus.append(np.full(surv.size + mine.size, c))
        ids, is_ins = np.concatenate(ids), np.concatenate(is_ins)
        ins_pos, clus = np.concatenate(ins_pos), np.concatenate(clus)
        x = torch.empty((ids.size, new.centroids.shape[1]), dtype=torch.float32, device=dev)
        main = torch.as_tensor(np.flatnonzero(~is_ins), device=dev)
        mid = torch.as_tensor(ids[~is_ins], device=dev)
        rows = raw.row_base[raw.id_dev[mid].long()] + raw.id_row[mid].long()
        x[main] = raw.vectors[rows].float()
        x[torch.as_tensor(np.flatnonzero(is_ins), device=dev)] = ins_x_t[
            torch.as_tensor(ins_pos[is_ins], device=dev)]
        a = assign_clusters(cent, x, dev)
        codes = encode_vectors(cb, cent, x, a, dev).cpu().numpy()
        lo = np.concatenate([np.arange(new.offsets[c], new.offsets[c + 1]) for c in changed[i:j]])
        if not np.array_equal(a.cpu().numpy(), clus):
            raise RuntimeError("compaction: a re-encoded row lands in another cluster")
        if not (np.array_equal(new.vec_ids[lo], ids) and np.array_equal(new.codes[lo], codes)):
            raise RuntimeError("compaction: codes or ids differ from a scratch re-encode")
        rows_checked += ids.size
        i = j
    return dict(changed_clusters=int(changed.size), rows_reencoded=rows_checked)


def mutable_phase(torch, np, ops, k_lut, k_topk, k_rerank, meng, ds, batches, dev, seed,
                  n_inserts=MUT_INSERTS, n_deletes=MUT_DELETES) -> list[dict]:
    """The mutable path at the main path's geometry (tiles, plain codes,
    prune, exact re-rank): inserts and deletes, timed batches with the delta
    active, checks (a)-(e), the delta scan's kernels held against their
    plain versions, and the same engine with the delta inactive after
    compaction.  Returns the two kernel rows (B5 at the delta view, B3 at
    the delta re-rank)."""
    import types

    from repro_torch.core.delta import delta_topk_plain, delta_topk_rows, plan_delta_scan
    from repro_torch.retrieval import mutation

    t_phase = time.perf_counter()
    n0 = meng.index.n_vectors
    delta = meng.delta
    ins_x = ds.queries(n_inserts, seed=seed + 3)
    ins_ids = np.arange(n0, n0 + n_inserts, dtype=np.int64)
    rng = np.random.default_rng(seed + 4)
    # the first 1000 inserts stay live: check (a) looks each of them up
    dels = np.concatenate([rng.choice(n0, n_deletes // 2, replace=False),
                           rng.choice(ins_ids[1000:], n_deletes - n_deletes // 2,
                                      replace=False)])
    t = time.perf_counter()
    meng.insert(ins_ids, ins_x)
    insert_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    meng.delete(dels)
    delete_ms = (time.perf_counter() - t) * 1e3
    tomb = delta.tombstone_array()
    k_fetch = mutation.fetch_depth(meng, K, tomb.size)
    kd = min(k_fetch, delta.capacity)

    meng.search(batches[0], NPROBE, K)  # warm-up: the view and the device copies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    batch_ms, results = [], []
    for qb in batches[1:]:
        t = time.perf_counter()
        results.append(meng.search(qb, NPROBE, K))
        batch_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for kname in ("build_luts", "adc_topk_tiles", "adc_topk_windows", "rerank_dists"):
        if launches[kname] <= 0:
            raise RuntimeError(f"mutable: kernel {kname} was never launched on the path")
    for d, i in results:
        if d.shape != (BATCH, K) or not np.isfinite(d).all() or (i < 0).any():
            raise RuntimeError("mutable: non-finite distances or missing ids")
        if (np.diff(d, axis=1) < 0).any():
            raise RuntimeError("mutable: distances are not ascending")
        if np.isin(i, tomb).any():  # check (b)
            raise RuntimeError("mutable: a tombstoned id was returned")
    # the same batches lap by lap (the device synchronised at each stage),
    # each stage's launches counted: their sum must be the timed run's, and
    # the delta re-rank's B3 launches are read from its own stage
    laps, plan_ms, stage_launches = [], [], {}
    for qb in batches[1:]:
        lap = {}
        mutation.mutable_search(meng, qb, NPROBE, K, timings=lap)
        for stage, counts in lap.pop("launches").items():
            for kname, n in counts.items():
                got = stage_launches.setdefault(stage, {})
                got[kname] = got.get(kname, 0) + n
        laps.append(lap)
        t = time.perf_counter()
        meng.plan_batch(qb, NPROBE)
        plan_ms.append((time.perf_counter() - t) * 1e3)
    summed = {}
    for counts in stage_launches.values():
        for kname, n in counts.items():
            summed[kname] = summed.get(kname, 0) + n
    if summed != {k: v for k, v in launches.items() if v}:
        raise RuntimeError(f"mutable: the stages' launches {stage_launches} do not add up "
                           f"to the timed batches' {launches}")
    scan_launches = stage_launches.get("delta_scan_ms", {})
    rr_launches = stage_launches.get("delta_rerank_ms", {}).get("rerank_dists", 0)
    if min(scan_launches.get("build_luts", 0), scan_launches.get("adc_topk_windows", 0),
           rr_launches) <= 0:
        raise RuntimeError(f"mutable: the delta scan or its re-rank launched no kernel "
                           f"({stage_launches})")
    qb1 = batches[1]
    cent, cb = meng.index.centroids, meng.index.codebook
    q1 = torch.as_tensor(qb1, device=dev)
    # the delta scan and its re-rank as the search runs them (on the card)
    scan_busy, scan_by, _, scan_wall = profile_call(
        torch, lambda: delta_topk_rows(delta, cent, cb, qb1, NPROBE, kd, device=dev))
    _, drows = delta_topk_rows(delta, cent, cb, qb1, NPROBE, kd, device=dev)
    rr_busy, rr_by, _, rr_wall = profile_call(
        torch, lambda: mutation.rerank_rows(delta, q1, drows))
    batch_busy, batch_by, _, _ = profile_call(torch, lambda: meng.search(qb1, NPROBE, K))
    s = meng.shards
    reckoned = dict(
        shards_gb=s.codes.size * s.codes.itemsize / 1e9, raw_store_gb=meng.raw.nbytes() / 1e9,
        batch_tables_gb=BATCH * NPROBE * M * 256 * 4 / 1e9)
    log(phase="mutable", inserts=n_inserts, deletes=int(dels.size), tombstones=int(tomb.size),
        insert_ms=insert_ms, delete_ms=delete_ms, k_fetch=k_fetch, delta_k=kd,
        batch_ms=batch_ms, mean_batch_ms=float(np.mean(batch_ms)), host_plan_ms=plan_ms,
        laps_ms=laps, delta_scan_device_ms=scan_busy, delta_scan_wall_ms=scan_wall,
        delta_scan_by_kernel=scan_by, delta_rerank_device_ms=rr_busy,
        delta_rerank_wall_ms=rr_wall, delta_rerank_by_kernel=rr_by,
        batch_device_busy_ms=batch_busy, batch_by_kernel=batch_by,
        launches={k: v for k, v in launches.items() if v},
        launches_per_batch={k: v / (len(batches) - 1) for k, v in launches.items() if v},
        launches_by_stage=stage_launches,
        reckoned_memory=reckoned, reckoned_total_gb=sum(reckoned.values()),
        memory_allocated_gb=torch.cuda.memory_allocated() / 1e9, peak_memory_gb=peak,
        view_rows=int(delta.view(meng.index.n_clusters, dev).codes.shape[1]),
        view_max_count=delta.view(meng.index.n_clusters, dev).max_count)

    # (a) each of 1000 inserted vectors finds its own id first
    _, own = meng.search(ins_x[:1000], NPROBE, K)
    if not np.array_equal(own[:, 0], ins_ids[:1000]):
        raise RuntimeError("mutable: an inserted vector does not find itself first")

    # the delta scan on the card against its plain formula, bit-equal,
    # unbounded and bounded (the median of each query's unbounded list)
    q16 = qb1[:16]
    for kk in (K, kd):
        u = mutation.engine_delta_topk(meng, q16, NPROBE, kk)
        bound = np.nanmedian(np.where(np.isfinite(u[0]), u[0], np.nan), axis=1)
        bound = np.nan_to_num(bound, nan=np.inf).astype(np.float32)
        for b in (None, bound):
            got = mutation.engine_delta_topk(meng, q16, NPROBE, kk, bound=b)
            want = delta_topk_plain(delta, cent, cb, q16, NPROBE, kk, bound=b, device=dev)
            if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                raise RuntimeError(f"delta scan (k={kk}, bound={b is not None}) differs "
                                   "from delta_topk_plain")

    # (c) 16 queries against the plain mutable path at the search's depths
    e_d, e_i = meng.search(q16, NPROBE, K)
    p_d, p_i = mutable_plain_path(torch, np, k_lut, k_rerank, meng, q16, k_fetch, kd)
    store = delta_store(delta, dev)
    if not same_outside_ties(np, e_d, e_i, p_d, p_i):
        raise RuntimeError("mutable: 16 queries differ from the plain path")

    # (d) pruned == unpruned with the delta active
    pr = meng.search(qb1, NPROBE, K)
    meng.prune = False
    un = meng.search(qb1, NPROBE, K)
    meng.prune = True
    if not all(np.array_equal(a, b) for a, b in zip(pr, un)):
        raise RuntimeError("mutable: pruned search differs from the unpruned search")
    log(phase="mutable_checks", own_id_first=1000, tombstones_absent=True,
        delta_scan_vs_plain="bit-equal", plain_path_queries=16, pruned_equals_unpruned=BATCH)

    # the kernel rows: B5 at the delta view's shape, B3 at the delta re-rank's
    scan = plan_delta_scan(delta, cent, cb, qb1, NPROBE, kd, device=dev)
    rows = []
    rows.append(check_delta_scan(torch, np, ops, k_topk, scan,
                                 scan_launches["adc_topk_windows"]))
    rows.append(check_rerank(
        torch, ops, k_rerank, q1, drows.int().contiguous(), store, launches=rr_launches,
        shape=dict(path="mutable delta re-rank", queries=BATCH, candidates=kd, dim=D,
                   store="float32", buffered_rows=delta.n)))

    # (e) compaction; then the compacted index against a scratch re-encode,
    # and its re-rank-off search against the same view's mutable search
    view_off = dataclasses.replace(meng, rerank="off")
    pre = view_off.search(qb1, NPROBE, K)
    old_index = meng.index
    live = delta.live_mask()[: delta.n]
    ins_assign = np.full(n_inserts, -1, np.int64)
    pos = np.searchsorted(ins_ids, delta.vec_ids[: delta.n])
    ins_assign[pos] = delta.assign[: delta.n]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep = meng.compact()
    compact_peak = torch.cuda.max_memory_allocated() / 1e9
    if meng.mutation_active or rep.merged != int(live.sum()):
        raise RuntimeError(f"mutable: compaction left the delta active or merged "
                           f"{rep.merged} rows, not {int(live.sum())}")
    t = time.perf_counter()
    reenc = compaction_reencode_check(torch, np, meng, old_index, tomb, ins_ids, ins_x,
                                      ins_assign)
    reenc["seconds"] = time.perf_counter() - t
    del old_index
    meng.search(qb1[:8], NPROBE, K)  # the device copies, shared with the view below
    post = dataclasses.replace(meng, rerank="off").search(qb1, NPROBE, K)
    starved = ~np.isfinite(pre[0]).all(axis=1)
    ok = ~starved
    if not same_outside_ties(np, pre[0][ok], pre[1][ok], post[0][ok], post[1][ok]):
        raise RuntimeError("mutable: the compacted engine differs from the mutable search")
    log(phase="mutable_compaction", report=dataclasses.asdict(rep), summary=rep.summary(),
        peak_memory_gb=compact_peak, reencode_check=reenc, starved_queries=int(starved.sum()),
        rerank_off_equal=int(ok.sum()))

    # the same engine with the delta inactive
    inactive = drive_path(torch, np, ops, "mutable_inactive", meng, batches,
                          ("build_luts", "adc_topk_tiles", "rerank_dists"))
    log(phase="mutable_summary", seconds=time.perf_counter() - t_phase,
        mean_batch_ms_delta_active=float(np.mean(batch_ms)),
        mean_batch_ms_delta_inactive=inactive["mean_batch_ms"])
    return rows


def check_delta_scan(torch, np, ops, k_topk, scan, launches: int) -> dict:
    """B5 at the delta view's shape (one pair per (query, probe slot), each
    scanning its cluster's run of live rows, `block_n` 64, unpruned): rows
    equal and distances bit-equal to the plain version, timed as every row."""
    dev = scan.tables.device
    lut_row, st, nv = (t.reshape(-1) for t in (scan.lut_row, scan.starts, scan.n_valid))
    pq = scan.pair_q.reshape(-1)
    codes, kk, bn = scan.view.codes, scan.k_pair, scan.view.block_n
    no_lb = torch.full(lut_row.shape, -torch.inf, device=dev)
    gv, gi, _ = ops.adc_topk_windows(scan.tables, codes, scan.starts, scan.n_valid, kk,
                                     lut_row=scan.lut_row, block_n=bn, pair_q=scan.pair_q,
                                     bound=scan.bound)
    t = time.perf_counter()
    wv, wi, _ = k_topk.adc_topk_windows_plain(scan.tables, lut_row, codes, st, nv, pq, no_lb,
                                              scan.bound, kk, bn)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    gv, gi = gv.reshape(wv.shape), gi.reshape(wi.shape)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        raise RuntimeError("adc_topk_windows (delta view) disagrees with its plain version")
    filled = torch.nonzero((lut_row >= 0) & (nv > 0)).flatten().int()
    sq = scan.bound.clone()
    ov, oi = torch.empty_like(gv), torch.empty_like(gi)
    os_ = torch.empty((lut_row.shape[0], 2), dtype=torch.int32, device=dev)

    def launch():
        sq.copy_(scan.bound)
        k_topk.launch_windows(scan.tables, lut_row, codes, filled, st, nv, pq, no_lb,
                              scan.bound, sq, ov, oi, os_, kk, bn)

    lib_run, lib_groups = scan_library(torch, scan.tables, lut_row, codes, st, nv, kk)
    lib_v = torch.full(gv.shape, torch.inf, device=dev)
    lib_run(lib_v)
    if not torch.allclose(lib_v, gv, **TOL):
        raise RuntimeError("delta scan: the library expression computes another function")
    rows_scored = int(nv[filled.long()].sum())
    live_rows = int(scan.view.counts.sum())
    m = codes.shape[2]
    bms, by = bound_ms(live_rows * m + scan.tables.numel() * 4 + lut_row.shape[0] * kk * 8,
                       rows_scored * m)
    return dict(
        name="adc_topk_windows", route="cuda", source=f"{SRC_ROOT}/csrc/adc_topk_windows.cu",
        replaces="src/repro/kernels/adc_topk.py:592", launches=launches, max_abs_err=0.0,
        ms=cuda_ms(torch, launch, 20), queued_ms=cuda_ms(torch, launch, 20, queued=True),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=cuda_ms(torch, lib_run, 1),
        library_call="per filled pair, its run's tables[pair][addresses].sum(-1) then "
                     f"torch.topk(k_pair, largest=False), pairs of like length batched "
                     f"({lib_groups} gathers)",
        shape=dict(path="mutable delta scan", pairs=lut_row.shape[0],
                   pairs_scanned=int(filled.numel()), k_pair=kk, block_n=bn,
                   view_rows=codes.shape[1], live_rows=live_rows, rows_scored=rows_scored,
                   table_width=scan.tables.shape[1]),
    )


def shards_embed(torch, np, big, small) -> bool:
    """True when `small`'s packing (a from-scratch `build_shards`, no slack)
    sits at the start of `big`'s arrays (the same packing grown by slack:
    more rows, slots and columns) and the rest of `big` is padding."""
    cap, w, s_n = small.codes.shape[1], small.codes.shape[2], small.slot_start.shape[1]
    fill = 0 if big.add_offsets else big.sentinel
    fill = fill - (1 << 16) if big.codes.dtype == torch.uint16 and fill >= 1 << 15 else fill

    def bits(c):
        c = torch.as_tensor(c)
        return c.view(torch.int16) if c.dtype == torch.uint16 else c

    bc, sc = bits(big.codes), bits(small.codes).to(bits(big.codes).device)
    ok = (torch.equal(bc[:, :cap, :w], sc) and bool((bc[:, cap:] == fill).all())
          and bool((bc[:, :, w:] == fill).all()))
    ok &= np.array_equal(big.vec_ids[:, :cap], small.vec_ids)
    ok &= bool((big.vec_ids[:, cap:] == -1).all())
    for f, empty in (("slot_start", 0), ("slot_size", 0), ("slot_cluster", -1),
                     ("combo_addrs", 0)):
        a, b = getattr(big, f), getattr(small, f)
        ok &= np.array_equal(a[:, :s_n], b) and bool((a[:, s_n:] == empty).all())
    return bool(ok and np.array_equal(big.local_slot, small.local_slot))


def mutable_cooc_cell(torch, np, ops, meng, ds, batches, dev, seed, n_rows=MUT_COOC_ROWS,
                      n_inserts=MUT_INSERTS, n_deletes=MUT_DELETES):
    """One windows x co-occurrence mutable cell at a reduced N (scale only;
    the same centroids, codebook and geometry): the main index's rows with
    ids below `n_rows`, re-placed by Algorithm 1, its raw vectors from the
    store.  Inserts and deletes, timed batches, then a compaction whose
    co-occurrence repack (`update_shards`) runs on the card and must hold a
    from-scratch `build_shards` of the compacted index bit for bit
    (`shards_embed`: the same packing, grown by the slack); the
    compacted engine's re-rank-off answers must be those of the mutable
    search within the cross-encoding tolerance (rtol 2e-4), ids included
    (`same_within_tol`).  Returns the compacted cell's engine."""
    from repro_torch.convert import index_from_arrays
    from repro_torch.core.placement import place_clusters
    from repro_torch.retrieval.engine import MemANNSEngine
    from repro_torch.retrieval.layout import build_shards

    t_cell = time.perf_counter()
    idx = meng.index
    keep = idx.vec_ids < n_rows
    sizes = np.bincount(np.repeat(np.arange(idx.n_clusters), idx.cluster_sizes())[keep],
                        minlength=idx.n_clusters)
    offsets = np.zeros(idx.n_clusters + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    sub = index_from_arrays(idx.centroids, idx.codebook, idx.codes[keep], idx.vec_ids[keep],
                            offsets)
    plc = place_clusters(sizes.astype(np.float64), meng.freqs, NDEV, centroids=sub.centroids)
    raw = meng.raw
    xs = torch.zeros((n_rows, D), dtype=torch.bfloat16, device=dev)
    ids = torch.as_tensor(sub.vec_ids, device=dev).long()
    xs[ids] = raw.vectors[raw.row_base[raw.id_dev[ids].long()] + raw.id_row[ids].long()]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ceng = MemANNSEngine.from_reference(
        sub, plc, xs, block_n=BLOCK_N, raw_dtype="bfloat16", scan="windows", use_cooc=True,
        rerank="exact", mutable=True, freqs=meng.freqs, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del xs, ids
    ins_x = ds.queries(n_inserts, seed=seed + 5)
    ins_ids = np.arange(n_rows, n_rows + n_inserts, dtype=np.int64)
    rng = np.random.default_rng(seed + 6)
    dels = np.concatenate([rng.choice(sub.vec_ids, n_deletes // 2, replace=False),
                           rng.choice(ins_ids, n_deletes - n_deletes // 2, replace=False)])
    ceng.insert(ins_ids, ins_x)
    ceng.delete(dels)
    ceng.search(batches[0], NPROBE, K)
    torch.cuda.synchronize()
    ops.reset_launches()
    batch_ms = []
    for qb in batches[1:3]:
        t = time.perf_counter()
        d, i = ceng.search(qb, NPROBE, K)
        batch_ms.append((time.perf_counter() - t) * 1e3)
        if d.shape != (BATCH, K) or not np.isfinite(d).all() or np.isin(i, dels).any():
            raise RuntimeError("mutable cooc: malformed results or a tombstoned id")
    launches = dict(ops.launches)
    for kname in ("build_luts", "build_ext_luts_pairs", "adc_topk_windows", "rerank_dists"):
        if launches[kname] <= 0:
            raise RuntimeError(f"mutable cooc: kernel {kname} was never launched")
    view_off = dataclasses.replace(ceng, rerank="off")
    pre = view_off.search(batches[1], NPROBE, K)
    rep = ceng.compact()
    torch.cuda.synchronize()
    t = time.perf_counter()
    scratch = build_shards(ceng.index, ceng.placement, use_cooc=True, block_n=BLOCK_N,
                           device=dev)
    scratch_s = time.perf_counter() - t
    sh = ceng.shards
    if not shards_embed(torch, np, sh, scratch):
        raise RuntimeError("mutable cooc: update_shards differs from a scratch build_shards")
    del scratch
    # the delta scanned its rows with plain codes; compaction re-encodes them
    # (and re-mines their clusters): the same distances up to reassociation,
    # within the reference's cross-encoding tolerance
    ceng.search(batches[1][:8], NPROBE, K)
    post = dataclasses.replace(ceng, rerank="off").search(batches[1], NPROBE, K)
    ok = np.isfinite(pre[0]).all(axis=1)
    band = same_within_tol(np, pre[0][ok], pre[1][ok], post[0][ok], post[1][ok], rtol=2e-4)
    same_ids = float(np.mean(pre[1][ok] == post[1][ok]))
    log(phase="mutable_cooc_windows", n=n_rows, build_seconds=build_s, batch_ms=batch_ms,
        launches={k: v for k, v in launches.items() if v}, report=dataclasses.asdict(rep),
        scratch_build_seconds=scratch_s, update_shards_equals_scratch=True,
        rerank_off_allclose=int(ok.sum()), rerank_off_ids_in_place=same_ids,
        rerank_off_ids_in_band=band, width=sh.width,
        seconds=time.perf_counter() - t_cell)
    return ceng


def profiled_spans(torch, fn, spans=PROFILED_SPANS) -> dict:
    """One call of `fn` under torch.profiler (CPU + CUDA), its spans opened
    as `record_function` ranges (`Tracer(profiler=True)`): for each span
    name, the port's kernels whose launch falls inside the range, counted
    by kernel name (PyTorch's own kernels counted together as `aten`), and
    the device ms of all of them.  Reads the Chrome
    trace the profiler exports (under build/, which git ignores):
    `user_annotation` ranges, `cuda_runtime` launches and `kernel` events
    joined on their correlation id.  `kernel_events` 0 means the profiler
    saw no device activity."""
    path = pathlib.Path("build") / "smoke_profile.json"
    path.parent.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as tp:
        fn()
        torch.cuda.synchronize()
    tp.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in spans]
    out = {}
    for r in ranges:
        row = out.setdefault(r["name"], {"ranges": 0, "kernels": {}, "device_ms": 0.0})
        row["ranges"] += 1
        for kev in kernels:
            ts = launch_ts.get(kev.get("args", {}).get("correlation"))
            if ts is not None and r["ts"] <= ts <= r["ts"] + r["dur"]:
                name = next((n for n in PORT_KERNELS if n in kev["name"]), "aten")
                row["kernels"][name] = row["kernels"].get(name, 0) + 1
                row["device_ms"] += kev["dur"] / 1e3
    return dict(spans=out, kernel_events=len(kernels), ranges=len(ranges))


def launches_by_stage(srv, ops) -> dict:
    """Wrap a ServingEngine's plan-time delta scan and its dispatch so that
    each stage's kernel launches are counted (`ops.launches` diffs) in the
    returned dict, {"delta": {...}, "dispatch": {...}}."""
    counts = {"delta": {}, "dispatch": {}}

    def wrap(stage, fn):
        def run(*a, **kw):
            before = dict(ops.launches)
            try:
                return fn(*a, **kw)
            finally:
                for k, v in ops.launches.items():
                    if v != before.get(k, 0):
                        counts[stage][k] = counts[stage].get(k, 0) + v - before.get(k, 0)
        return run

    srv._delta_micro_batch = wrap("delta", srv._delta_micro_batch)
    srv._dispatch_micro_batch = wrap("dispatch", srv._dispatch_micro_batch)
    return counts


def serving_obs_faults(torch, np, ops, eng, batches) -> dict:
    """ServingEngine's observability and fault tolerance on the immutable
    main-path engine (micro-batches of `SERVE_MICRO_BATCH`, depth 1, the
    timed batches as one stream).  Observability on (a `Tracer` and the
    registry) against off (`metrics=False`, no tracer): bit-identical, no
    build; every batch tree holds plan (schedule / densify / emit_tiles),
    dispatch (rerank_dispatch), dispatch_wait and collect; the Prometheus
    rendering passes tools/check_metrics_torch.py's line check; one
    micro-batch under torch.profiler with `Tracer(profiler=True)` puts the
    port's kernels inside the span ranges.  Faults: logical device 3 dead
    from batch 1 (covered queries bit-identical to the healthy run, the rest
    flagged, coverage equal to the plans' lost pairs), a hung collect at
    batch 2 (failed over and refired), two transient dispatch faults
    (retried, then bit-identical), a 1 ms deadline (late batches served at
    `degrade_nprobe` without the re-rank: equal to that search), and a
    queue limit (shed, the admitted queries answered)."""
    import importlib.util

    from repro_torch.kernels import _build
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    from repro_torch.retrieval.faults import FaultPlan
    from repro_torch.retrieval.serving import PHASES, ServingEngine

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "check_metrics_torch", pathlib.Path(__file__).resolve().parent / "tools"
        / "check_metrics_torch.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    stream = np.concatenate(batches[1:])
    mb = SERVE_MICRO_BATCH
    n_mb = len(stream) // mb

    def server(**kw):
        srv = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=mb, pipeline_depth=1,
                            autotune="off", **kw)
        srv.warmup()
        return srv

    # -- observability on vs off ------------------------------------------
    tracer = Tracer()
    on, off = server(tracer=tracer), server(metrics=False)
    built = _build.compile_count()
    t = time.perf_counter()
    d_on, i_on = on.search(stream)
    wall_on = time.perf_counter() - t
    eng.tracer = NULL_TRACER
    t = time.perf_counter()
    d_off, i_off = off.search(stream)
    wall_off = time.perf_counter() - t
    if not (np.array_equal(d_on, d_off) and np.array_equal(i_on, i_off)):
        raise RuntimeError("serving_obs_faults: results differ with observability on and off")
    if on.stats.compiles or off.stats.compiles or _build.compile_count() != built:
        raise RuntimeError("serving_obs_faults: a build after warmup")
    roots = tracer.roots()
    if len(roots) != n_mb or sum(r.args["queries"] for r in roots) != len(stream):
        raise RuntimeError(f"serving_obs_faults: {len(roots)} batch trees for {n_mb} batches")
    for r in roots:
        kids = {c.name: c for c in r.children}
        if not {"plan", "dispatch", "dispatch_wait", "collect"} <= set(kids):
            raise RuntimeError(f"serving_obs_faults: a batch tree holds {sorted(kids)}")
        if [c.name for c in kids["plan"].children] != ["schedule", "densify", "emit_tiles"] \
                or [c.name for c in kids["dispatch"].children] != ["rerank_dispatch"]:
            raise RuntimeError("serving_obs_faults: the engine's child spans are missing")
    text = on.stats.registry.render_prometheus()
    problems = check.check_exposition(text)
    if problems or off.stats.registry.render_prometheus():
        raise RuntimeError(f"serving_obs_faults: exposition problems {problems}")
    span_ms = {}
    for r in roots:
        for node in r.walk():
            span_ms[node.name] = span_ms.get(node.name, 0.0) + (node.t1 - node.t0) * 1e3
    prof_srv = server(tracer=Tracer(profiler=True))
    profiled = profiled_spans(torch, lambda: prof_srv.search(stream[:mb]))
    eng.tracer = NULL_TRACER
    if profiled["kernel_events"]:
        inside = profiled["spans"]
        want = {"dispatch": ("lut_build", "adc_topk_tiles", "rerank"),
                "rerank_dispatch": ("rerank",)}
        for span, names in want.items():
            got = inside.get(span, {}).get("kernels", {})
            if not all(any(n in g for g in got) for n in names):
                raise RuntimeError(f"serving_obs_faults: span {span} launched {got}")
    obs = dict(queries=len(stream), micro_batches=n_mb, wall_ms_on=wall_on * 1e3,
               wall_ms_off=wall_off * 1e3, qps_on=len(stream) / wall_on,
               qps_off=len(stream) / wall_off, batch_trees=len(roots),
               span_ms_total=span_ms, exposition_lines=len(text.splitlines()),
               exposition_problems=0,
               phase_seconds={p: on.stats.phase_seconds(p) for p in PHASES},
               p50_ms=float(np.percentile(on.stats.latencies_s, 50)) * 1e3,
               p99_ms=float(np.percentile(on.stats.latencies_s, 99)) * 1e3,
               registry_p50_ms=on.stats.p50_s() * 1e3,
               registry_p99_ms=on.stats.p99_s() * 1e3,
               registry_p999_ms=on.stats.p999_s() * 1e3, profiled=profiled)

    # -- failover: logical device 3 dead from batch 1 -----------------------
    dead = 3
    fp = FaultPlan(device_death={dead: 1})
    fsrv = server(faults=fp)
    t = time.perf_counter()
    res = fsrv.search_result(stream)
    fo_wall = time.perf_counter() - t
    live = np.ones(eng.ndev, bool)
    live[dead] = False
    want_lost = []
    for off_q in range(mb, len(stream), mb):
        plan = eng.plan_batch(stream[off_q:off_q + mb], NPROBE, live=live)
        want_lost += [(int(q) + off_q, int(c)) for q, c in zip(plan.lost_q, plan.lost_c)]
    got_lost = sorted((int(a), int(b)) for a, b in res.coverage_lost)
    ok = ~res.degraded
    if fsrv.stats.compiles or fsrv.stats.failovers != 1 or res.degraded[:mb].any():
        raise RuntimeError(f"failover: {fsrv.stats.failovers} failovers, "
                           f"{fsrv.stats.compiles} builds")
    if got_lost != sorted(want_lost):
        raise RuntimeError("failover: coverage_lost differs from the plans' lost pairs")
    if not np.array_equal(res.degraded, np.isin(np.arange(len(stream)),
                                                res.coverage_lost[:, 0])):
        raise RuntimeError("failover: degraded flags differ from the lost queries")
    if not (np.array_equal(res.dists[ok], d_off[ok]) and np.array_equal(res.ids[ok], i_off[ok])):
        raise RuntimeError("failover: a covered query differs from the healthy run")
    stranded = sum(1 for r in eng.placement.replicas if r and set(r) <= {dead})
    failover = dict(dead_device=dead, from_batch=1, wall_ms=fo_wall * 1e3,
                    degraded_queries=int(res.degraded.sum()), lost_pairs=len(got_lost),
                    covered_bit_identical=int(ok.sum()), stranded_clusters=stranded,
                    health=fsrv.health())

    # -- a hung collect at batch 2: failed over, refired --------------------
    hung_dev = 5
    fp = FaultPlan(hang_collect={2: hung_dev})
    hsrv = server(faults=fp, collect_timeout_s=30.0)
    t = time.perf_counter()
    hres = hsrv.search_result(stream)
    hang_wall = time.perf_counter() - t
    hok = ~hres.degraded
    if hsrv.stats.retries != 1 or hsrv.stats.failovers != 1 or hsrv.stats.compiles:
        raise RuntimeError(f"hang: retries {hsrv.stats.retries}, failovers "
                           f"{hsrv.stats.failovers}")
    if not (np.array_equal(hres.dists[hok], d_off[hok])
            and np.array_equal(hres.ids[hok], i_off[hok])):
        raise RuntimeError("hang: a covered query differs from the healthy run")
    if hang_wall > 10 * wall_off + 5.0:
        raise RuntimeError(f"hang: the stream took {hang_wall:.1f} s (a stall)")

    # -- two transient dispatch faults of batch 1: retried, then healthy ---
    fp = FaultPlan(transient_dispatch={1: 2})
    tsrv = server(faults=fp, retry_backoff_s=0.001)
    tres = tsrv.search_result(stream)
    if tsrv.stats.retries != 2 or tsrv.stats.failovers or tres.degraded.any() or not (
            np.array_equal(tres.dists, d_off) and np.array_equal(tres.ids, i_off)):
        raise RuntimeError("transient: not retried to the healthy answer")

    # -- a 1 ms deadline: late batches at degrade_nprobe, no re-rank --------
    dsrv = server(deadline_ms=1.0)
    dres = dsrv.search_result(stream)
    late = dres.deadline_degraded
    adc = dataclasses.replace(eng, rerank="off")
    for off_q in range(0, len(stream), mb):
        sl = slice(off_q, off_q + mb)
        if late[sl].any():
            wd, wi = adc.search(stream[sl], dsrv.degrade_nprobe, K)
            if not (late[sl].all() and np.array_equal(dres.dists[sl], wd)
                    and np.array_equal(dres.ids[sl], wi)):
                raise RuntimeError("deadline: a late batch differs from the ADC search at "
                                   "degrade_nprobe")
    if not late.any() or dsrv.stats.degraded_queries != int(late.sum()) or dsrv.stats.compiles:
        raise RuntimeError("deadline: no batch degraded")

    # -- admission: queue_limit sheds ----------------------------------------
    qsrv = server(queue_limit=2 * mb)
    admitted = qsrv.submit(stream)
    state = qsrv.health()["state"]
    qd, qi = qsrv.flush()
    if admitted != 2 * mb or state != "overloaded" or qsrv.stats.rejected_queries != \
            len(stream) - 2 * mb or not np.array_equal(qi, i_off[:2 * mb]):
        raise RuntimeError("admission: the queue limit did not shed as it should")
    out = dict(phase="serving_obs_faults", obs=obs, failover=failover,
               hang=dict(device=hung_dev, seq=2, wall_ms=hang_wall * 1e3,
                         degraded_queries=int(hres.degraded.sum()),
                         retries=hsrv.stats.retries, failovers=hsrv.stats.failovers),
               transient=dict(seq=1, faults=2, retries=tsrv.stats.retries,
                              bit_identical=True),
               deadline=dict(deadline_ms=1.0, degrade_nprobe=dsrv.degrade_nprobe,
                             late_queries=int(late.sum()), late_equal_adc_search=True),
               admission=dict(queue_limit=2 * mb, submitted=len(stream), admitted=admitted,
                              rejected=qsrv.stats.rejected_queries, health_when_full=state),
               seconds=time.perf_counter() - t_phase)
    log(**out)
    return out


def mutable_plain_path(torch, np, k_lut, k_rerank, meng, q16, k_fetch, kd):
    """16 queries through a plain mutable path at fetch depth `k_fetch` and
    delta depth `kd`: plain LUTs -> unpruned ADC top-k_fetch over every
    probed main row -> plain re-rank; `delta_topk_plain` -> plain re-rank of
    the delta's candidates (its own id -> buffer row map; the buffered ids
    are distinct); a plain merge: tombstoned main hits out, then a stable
    sort of [main | delta], main rows first on equal distances.  Returns
    (dists (16, K), ids (16, K))."""
    from repro_torch.core.delta import delta_topk_plain

    dev, delta = meng.device, meng.delta
    tomb = delta.tombstone_array()
    q = torch.as_tensor(q16, device=dev)
    _, cand = plain_adc_topk(torch, np, k_lut, meng, q, k_fetch)
    m_d, m_i = plain_rerank(torch, k_rerank, q, cand, meng.raw, k_fetch)
    all_d, all_i = [m_d], [m_i]
    gone = np.isin(m_i, tomb)
    all_d[0], all_i[0] = np.where(gone, np.inf, m_d), np.where(gone, -1, m_i)
    if delta.live_count:
        cent, cb = meng.index.centroids, meng.index.codebook
        _, pdi = delta_topk_plain(delta, cent, cb, q16, NPROBE, kd, device=dev)
        store = delta_store(delta, dev)
        row_of = {int(v): r for r, v in enumerate(delta.vec_ids[: delta.n])}
        rc = np.array([[row_of.get(int(v), -1) for v in row] for row in pdi], np.int32)
        x_d, x_r = plain_rerank(torch, k_rerank, q, torch.as_tensor(rc, device=dev), store, kd)
        all_d.append(x_d)
        all_i.append(np.where(x_r >= 0, delta.vec_ids[np.maximum(x_r, 0)], -1))
    all_d, all_i = np.concatenate(all_d, axis=1), np.concatenate(all_i, axis=1)
    order = np.argsort(all_d, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(all_d, order, 1), np.take_along_axis(all_i, order, 1)


def mutable_serving(torch, np, ops, k_lut, k_rerank, meng, ds, batches, dev, seed,
                    rounds=MUT_SERVE_ROUNDS, n_ins=MUT_SERVE_INSERTS,
                    n_del=MUT_SERVE_DELETES) -> dict:
    """`ServingEngine(mutable=True)` over the compacted mutable engine at
    its defaults (micro-batches of `SERVE_MICRO_BATCH`, depth 1, a 4096-row
    delta compacting at 0.75, tombstone limit 1024, overfetch k: a fixed
    fetch bucket of 128).  `rounds` churn rounds, each `n_ins` inserts
    (drawn as the mutable phase draws them), `n_del` deletes of live ids
    (originals and earlier inserts) and the timed batches as one stream.
    Checks: (a) no deleted id is ever returned; (b) 100 of each round's
    inserts, served as queries right after their insert, find their own id
    first; (c) in rounds 1,
    5 and the last, 16 queries equal the plain mutable path at the
    serving's fetch depths (distances bit-equal, ids outside exact ties);
    (d) one round's stream at depth 0 and 1 on the same state:
    bit-identical; (e) no build after warmup, and per micro-batch two B1,
    one B2, one B5 and two B3 launches, B1 / B5 / B3 in the plan-time delta
    stage and B1 / B2 / B3 in the dispatch; (f) deleting query 0's whole
    fetch window (with the delta empty) starves one batch, a compaction
    follows the drain, and the next search is full and equals the plain
    path.  Records QPS (compactions left out of the wall), p50 / p99, the
    host fraction, the phases' seconds, each compaction's seconds and
    stages, one micro-batch profiled with its spans as `record_function`
    ranges, and the registry's snapshot."""
    from repro_torch.kernels import _build
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    from repro_torch.retrieval.serving import PHASES, ServingEngine

    t_phase = time.perf_counter()
    if meng.mutation_active:
        raise RuntimeError("mutable_serving: the engine's delta is not empty")
    srv = ServingEngine(meng, nprobe=NPROBE, k=K, micro_batch=SERVE_MICRO_BATCH, mutable=True,
                        autotune="off")
    k_fetch, kd = srv._k_fetch(), srv._delta_k()
    if (k_fetch, srv.tombstone_limit, meng.delta.capacity) != (128, 1024, 4096):
        raise RuntimeError(f"mutable_serving: fetch {k_fetch}, tombstone limit "
                           f"{srv.tombstone_limit}, delta {meng.delta.capacity}")
    reports = []
    compact = srv.compact

    def compact_recorded():
        rep = compact()
        reports.append(dict(latency_s=rep.latency_s, stage_seconds=rep.stage_seconds,
                            merged=rep.merged, dropped=rep.dropped,
                            clusters_changed=rep.clusters_changed,
                            devices_rewritten=rep.devices_rewritten,
                            shapes_changed=rep.shapes_changed))
        return rep

    srv.compact = compact_recorded
    t = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t
    built = _build.compile_count()
    stages = launches_by_stage(srv, ops)
    stream = np.concatenate(batches[1:])
    n_mb = len(stream) // SERVE_MICRO_BATCH
    n0 = meng.index.n_vectors
    rng = np.random.default_rng(seed + 7)
    # originals to delete, distinct across rounds (ids the mutable phase
    # deleted are gone from the index; deleting one again is a no-op)
    orig_dels = rng.choice(n0, rounds * n_del, replace=False)
    live_ins: list[int] = []
    deleted: set[int] = set()
    next_id = n0 + MUT_INSERTS
    walls, rows, plain_rounds, stream_lat = [], [], [], []
    depth_checked = False
    for r in range(rounds):
        ins_x = ds.queries(n_ins, seed=seed + 100 + r)
        ins_ids = np.arange(next_id, next_id + n_ins, dtype=np.int64)
        next_id += n_ins
        n_comp = len(reports)
        # (b) the first 100 inserts, served as queries right after their
        # insert (from the delta), find their own id first; a compaction
        # moves inserts into the main index, where only the ADC top-k'
        # reaches the re-rank, so the check runs before the round's other
        # inserts can trigger one
        t = time.perf_counter()
        srv.insert(ins_ids[:100], ins_x[:100])
        mut_ms = (time.perf_counter() - t) * 1e3
        _, own = srv.search(ins_x[:100])
        if not np.array_equal(own[:, 0], ins_ids[:100]):
            raise RuntimeError(f"mutable_serving round {r}: an insert does not find itself")
        t = time.perf_counter()
        srv.insert(ins_ids[100:], ins_x[100:])
        # deletes: half originals, half earlier inserts (none of this round's)
        pool = np.asarray(live_ins, np.int64)
        n_old = min(n_del // 2, pool.size)
        dels = np.concatenate([orig_dels[r * n_del : r * n_del + n_del - n_old],
                               rng.choice(pool, n_old, replace=False)])
        srv.delete(dels)
        mut_ms += (time.perf_counter() - t) * 1e3
        deleted.update(dels.tolist())
        live_ins = [i for i in live_ins if i not in deleted] + ins_ids.tolist()
        before = {k: v for k, v in stages["delta"].items()}, dict(stages["dispatch"])
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        d, i = srv.search(stream)
        wall = time.perf_counter() - t
        walls.append(wall)
        lat_ms = [x * 1e3 for x in list(srv.stats.latencies_s)[-n_mb:]]
        stream_lat += lat_ms
        launches = {k: v for k, v in ops.launches.items() if v}
        per_stage = {s: {k: v - b.get(k, 0) for k, v in stages[s].items() if v - b.get(k, 0)}
                     for s, b in zip(("delta", "dispatch"), before)}
        # with no live buffered row (a compaction just merged them) the delta
        # stage scans nothing and launches nothing
        scanned = n_mb if meng.delta.live_count else 0
        want_stage = {"delta": {k: scanned for k in ("build_luts", "adc_topk_windows",
                                                     "rerank_dists") if scanned},
                      "dispatch": {"build_luts": n_mb, "adc_topk_tiles": n_mb,
                                   "rerank_dists": n_mb}}
        want = {k: want_stage["delta"].get(k, 0) + want_stage["dispatch"].get(k, 0)
                for k in ("build_luts", "adc_topk_tiles", "adc_topk_windows", "rerank_dists")}
        want = {k: v for k, v in want.items() if v}
        if launches != want or per_stage != want_stage:  # (e)
            raise RuntimeError(f"mutable_serving round {r}: launches {launches} by stage "
                               f"{per_stage}, want {want} / {want_stage}")
        if d.shape != (len(stream), K) or not np.isfinite(d).all() or (i < 0).any():
            raise RuntimeError(f"mutable_serving round {r}: malformed results")
        if np.isin(i, np.fromiter(deleted, np.int64, len(deleted))).any():  # (a)
            raise RuntimeError(f"mutable_serving round {r}: a deleted id was returned")
        if not depth_checked and meng.delta.live_count:  # (d)
            srv.pipeline_depth = 0
            d0, i0 = srv.search(stream)
            srv.pipeline_depth = 1
            if not (np.array_equal(d0, d) and np.array_equal(i0, i)):
                raise RuntimeError("mutable_serving: depth 0 differs from depth 1")
            depth_checked = True
        if r in (0, 4, rounds - 1):  # (c)
            q16 = batches[1][:16]
            s_d, s_i = srv.search(q16)
            p_d, p_i = mutable_plain_path(torch, np, k_lut, k_rerank, meng, q16, k_fetch, kd)
            if not same_outside_ties(np, s_d, s_i, p_d, p_i):
                raise RuntimeError(f"mutable_serving round {r}: 16 queries differ from the "
                                   "plain path")
            plain_rounds.append(r + 1)
        rows.append(dict(round=r + 1, inserts=n_ins, deletes=int(dels.size),
                         mutate_ms=mut_ms, stream_ms=wall * 1e3, qps=len(stream) / wall,
                         latency_ms=lat_ms,
                         compactions=len(reports) - n_comp,
                         delta_rows=int(meng.delta.n), tombstones=meng.delta.tombstone_count))
    st = srv.stats
    if st.compiles or _build.compile_count() != built:
        raise RuntimeError(f"mutable_serving: {st.compiles} builds after warmup")
    if not reports:
        raise RuntimeError("mutable_serving: no compaction landed mid-stream")
    churn = dict(rounds=rounds, queries=rounds * len(stream),
                 qps=rounds * len(stream) / sum(walls), stream_ms=[w * 1e3 for w in walls],
                 p50_ms=float(np.percentile(stream_lat, 50)),
                 p99_ms=float(np.percentile(stream_lat, 99)),
                 registry_p50_ms=st.p50_s() * 1e3, registry_p99_ms=st.p99_s() * 1e3,
                 host_fraction=st.host_fraction(), overlap_fraction=st.overlap_fraction(),
                 phase_seconds={p: st.phase_seconds(p) for p in PHASES},
                 starved_batches=st.starved_batches, compactions=list(reports),
                 rounds_detail=rows, launches_by_stage={k: dict(v) for k, v in stages.items()})

    # one micro-batch with the delta active, its spans as profiler ranges
    tracer = Tracer(profiler=True)
    srv.tracer = meng.tracer = tracer
    profiled = profiled_spans(torch, lambda: srv.search(stream[:SERVE_MICRO_BATCH]))
    srv.tracer = meng.tracer = NULL_TRACER
    delta_kernels = profiled["spans"].get("delta", {}).get("kernels", {})
    profiler_sees_delta_b3 = "rerank" in delta_kernels
    delta_event_ms = None
    if not profiler_sees_delta_b3:
        # the profiler shows no B3 in the delta span: time the stage with events
        padded = stream[:SERVE_MICRO_BATCH]
        plan = meng.plan_batch(padded, NPROBE)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        srv._delta_micro_batch(padded, plan, k_fetch)
        e1.record()
        torch.cuda.synchronize()
        delta_event_ms = e0.elapsed_time(e1)

    # (f) starvation: query 0's whole fetch window deleted with the delta empty
    srv.compact()
    q0 = batches[1][:1]
    _, window = dataclasses.replace(meng, rerank="off").search(q0, NPROBE, k_fetch + 8)
    victims = window[0][window[0] >= 0]
    srv.delete(victims)
    starved0, comps0 = st.starved_batches, len(reports)
    _, si = srv.search(batches[1][:SERVE_MICRO_BATCH])
    if not (si[0] < 0).any() or st.starved_batches != starved0 + 1 or \
            len(reports) != comps0 + 1 or meng.mutation_active:
        raise RuntimeError("mutable_serving: deleting query 0's window did not starve one "
                           "batch and compact")
    q16 = batches[1][:16]
    s_d, s_i = srv.search(q16)
    p_d, p_i = mutable_plain_path(torch, np, k_lut, k_rerank, meng, q16, k_fetch, kd)
    if (s_i < 0).any() or not same_outside_ties(np, s_d, s_i, p_d, p_i):
        raise RuntimeError("mutable_serving: the search after the starvation compaction "
                           "differs from the plain path")
    out = dict(phase="mutable_serving", k_fetch=k_fetch, delta_k=kd,
               tombstone_limit=srv.tombstone_limit, delta_capacity=meng.delta.capacity,
               compact_occupancy=srv.compact_occupancy, warmup_s=warm_s, churn=churn,
               checks=dict(deleted_never_returned=True, own_id_first=100 * rounds,
                           plain_path_rounds=plain_rounds, depth0_equals_depth1=depth_checked,
                           builds_after_warmup=0, starved_then_compacted=True),
               compactions=reports, profiled=profiled,
               profiler_sees_delta_b3=profiler_sees_delta_b3,
               delta_stage_event_ms=delta_event_ms, snapshot=st.snapshot(),
               seconds=time.perf_counter() - t_phase)
    log(**out)
    return out


def quant_mse(torch, np, index, raw, sample_ids) -> float:
    """Mean squared quantisation error of `index`'s codes over the rows of
    `sample_ids` (vectors from the raw store; in the coding space, rotated
    under OPQ, where R keeps every norm)."""
    from repro_torch.core.index import rotate_rows
    from repro_torch.core.pq import pq_decode

    dev = raw.vectors.device
    inv = np.empty(index.n_vectors, np.int64)
    inv[index.vec_ids] = np.arange(index.n_vectors)
    pos = inv[sample_ids]
    cl = torch.as_tensor(np.searchsorted(index.offsets, pos, side="right") - 1, device=dev)
    ids = torch.as_tensor(sample_ids, device=dev)
    x = raw.vectors[raw.row_base[raw.id_dev[ids].long()] + raw.id_row[ids].long()].float()
    if index.rotation is not None:
        x = rotate_rows(x, index.rotation)
    res = x - torch.as_tensor(index.centroids, device=dev)[cl]
    dec = pq_decode(torch.as_tensor(index.codebook, device=dev),
                    torch.as_tensor(index.codes[pos], device=dev))
    return float(((res - dec) ** 2).sum(1).mean())


def autotune_phase(torch, np, ops, eng, batches) -> None:
    """The kernel-geometry autotune on the main-path engine, after
    every phase that relies on its `block_n` of 1024, which it restores.

    `ServingEngine(autotune="sweep")` with a fresh cache directory times
    the grid (`core.autotune`: the engine's search of 500 queries at
    nprobe 64, the server's shape, at block_n 256 / 512 / 1024, each a
    retile; B3 over 2^22 candidates at 16 / 32 / 64 a block, CUDA events)
    and applies its pick before its warmup; it then serves the
    `serving` phase's 5,000-query stream (micro-batches of 500, depth 1),
    which must equal the untuned server's bit for bit with no build after
    warmup.  A second server with `autotune="cache"` on the directory must
    hit (`swept` 0).  Then one 1000-query batch at each swept block_n
    (retiled; seconds), its device busy ms and batch wall, the answers
    bit-identical across them: where the device time goes at each, beside
    the sweep's pick."""
    import tempfile

    from repro_torch.core.autotune import KernelGeometry
    from repro_torch.kernels import _build
    from repro_torch.retrieval.serving import ServingEngine

    t_phase = time.perf_counter()
    stream = np.concatenate(batches[1:])

    def server(**kw):
        return ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=SERVE_MICRO_BATCH,
                             pipeline_depth=1, **kw)

    base = server(autotune="off")
    base.warmup()
    want_d, want_i = base.search(stream)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as cache_dir:
        srv = server(autotune="sweep", autotune_cache_dir=cache_dir)
        t = time.perf_counter()
        rep = srv.apply_autotune()
        apply_s = time.perf_counter() - t
        srv.warmup()
        built = _build.compile_count()
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        d, i = srv.search(stream)
        wall = time.perf_counter() - t
        launches = {k: v for k, v in ops.launches.items() if v}
        st = srv.stats
        if rep["source"] != "sweep" or rep["swept"] <= 0:
            raise RuntimeError(f"autotune: no sweep ran: {rep}")
        if st.compiles or _build.compile_count() != built:
            raise RuntimeError(f"autotune: {st.compiles} builds after warmup")
        if not (np.array_equal(d, want_d) and np.array_equal(i, want_i)):
            raise RuntimeError(f"autotune: the tuned stream ({rep['geometry']}) differs from "
                               "the untuned one")
        for kname in ("build_luts", "adc_topk_tiles", "rerank_dists"):
            if launches.get(kname) != st.batches:
                raise RuntimeError(f"autotune: {kname} launched {launches.get(kname)} times "
                                   f"in {st.batches} micro-batches")
        hit = server(autotune="cache", autotune_cache_dir=cache_dir).apply_autotune()
        if hit["source"] != "cache" or hit["swept"] != 0:
            raise RuntimeError(f"autotune: the second server missed the cache: {hit}")

    qb, kp = batches[1], eng.k_prime(K)
    rows, first = [], None
    for bn in sorted(int(b) for b in rep["timings"]["batch_s"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        retiled = eng.apply_geometry(KernelGeometry(block_n=bn))
        retile_s = time.perf_counter() - t
        plan = eng.plan_batch(qb, NPROBE)
        out = eng.collect(eng.dispatch_rerank(eng.dispatch_plan(plan, kp), qb, K))
        busy, by_kernel, _, _ = profile_call(torch, lambda: eng.collect(
            eng.dispatch_rerank(eng.dispatch_plan(plan, kp), qb, K)))
        t = time.perf_counter()
        eng.search(qb, NPROBE, K)
        batch_ms = (time.perf_counter() - t) * 1e3
        if first is None:
            first = out
        elif not all(np.array_equal(a, b) for a, b in zip(out, first)):
            raise RuntimeError(f"autotune: the batch at block_n {bn} differs")
        rows.append(dict(block_n=bn, retiled=retiled, retile_seconds=retile_s,
                         device_busy_ms=busy, device_ms_by_kernel=by_kernel,
                         batch_ms=batch_ms, tiles_per_dev=plan.tiles_per_dev,
                         sweep_batch_ms=rep["timings"]["batch_s"][str(bn)] * 1e3))
    t = time.perf_counter()
    eng.apply_geometry(KernelGeometry(block_n=BLOCK_N))
    restore_s = time.perf_counter() - t
    log(phase="autotune", engine_rows=int(eng.index.n_vectors), sweep=rep,
        apply_autotune_seconds=apply_s, tuned_geometry=rep["geometry"],
        tuned_stream=dict(queries=len(stream), micro_batches=st.batches,
                          wall_ms=wall * 1e3, qps=len(stream) / wall, compiles=st.compiles,
                          launches=launches, bit_identical_to_untuned=True),
        cache_hit=dict(source=hit["source"], swept=hit["swept"], key=hit["key"]),
        real_batches=rows, real_batches_bit_identical=True, restore_seconds=restore_s,
        seconds=time.perf_counter() - t_phase)


def dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def checkpoint_phase(torch, np, ceng, meng, ds, batches, dev, seed) -> None:
    """Checkpoints on the card.  The 4M-row windows x co-occurrence
    mutable cell (`ceng`, exact re-rank) gets a live delta of 1000 inserts
    and 500 tombstones; `save_engine` then `load_engine` on the card must
    answer 1000 queries bit for bit.  The save is crashed at each of its
    three points and `load_index` must return the complete old or new
    checkpoint.  The 100M-row index (`meng.index`) goes through
    `save_index` / `load_index` without its raw store: at 100M rows the
    reference-format f32 store would pad to ~8 x 16.7M x 128 x 4 B = 68.7
    GB on disk.  Seconds and bytes of each; written under a temp directory
    that is deleted afterwards."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_engine, load_index, save_engine, save_index
    from repro_torch.retrieval.faults import FaultPlan, InjectedCrash

    t_phase = time.perf_counter()
    first = MUT_COOC_ROWS + MUT_INSERTS
    ins_ids = np.arange(first, first + 1000, dtype=np.int64)
    rng = np.random.default_rng(seed + 9)
    dels = np.concatenate([rng.choice(ceng.index.vec_ids, 400, replace=False), ins_ids[:100]])
    ceng.insert(ins_ids, ds.queries(1000, seed=seed + 8))
    ceng.delete(dels)
    q = batches[1]
    want = ceng.search(q, NPROBE, K)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(root, "engine")
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_engine(path, ceng, extra={"v": 1})
        save_s = time.perf_counter() - t
        nbytes = dir_bytes(path)
        t = time.perf_counter()
        got = load_engine(path, ndev=NDEV, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        out = got.search(q, NPROBE, K)
        if not all(np.array_equal(a, b) for a, b in zip(out, want)):
            raise RuntimeError("checkpoint: the restored engine answers differently")
        if got.delta.n != ceng.delta.n or got.delta.tombstones != ceng.delta.tombstones:
            raise RuntimeError("checkpoint: the restored delta differs")
        del got
        crashes, have = [], 1
        for n, point in enumerate(("before_commit", "after_rename_old", "after_rename_new")):
            fp = FaultPlan(crash_save_at=point)
            try:
                save_engine(path, ceng, extra={"v": n + 2}, faults=fp)
            except InjectedCrash:
                pass
            else:
                raise RuntimeError(f"checkpoint: no crash at {point}")
            t = time.perf_counter()
            idx, delta, extra = load_index(path)
            v = extra["v"]
            ok = {"before_commit": v == have, "after_rename_old": v == have,
                  "after_rename_new": v == n + 2}[point]
            same = all(np.array_equal(getattr(idx, f), getattr(ceng.index, f))
                       for f in ("codes", "vec_ids", "offsets", "centroids", "codebook"))
            if not (ok and same and delta.n == ceng.delta.n):
                raise RuntimeError(f"checkpoint: crash at {point} loaded version {v}")
            crashes.append(dict(point=point, loaded_version=v,
                                load_seconds=time.perf_counter() - t))
            have = v
        big = os.path.join(root, "index_100m")
        t = time.perf_counter()
        save_index(big, meng.index)
        big_save_s = time.perf_counter() - t
        big_bytes = dir_bytes(big)
        t = time.perf_counter()
        idx, delta, _ = load_index(big)
        big_load_s = time.perf_counter() - t
        if delta is not None or not all(
                np.array_equal(getattr(idx, f), getattr(meng.index, f))
                for f in ("codes", "vec_ids", "offsets", "centroids", "codebook")):
            raise RuntimeError("checkpoint: the 100M index read back differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(phase="checkpoint", engine_rows=int(ceng.index.n_vectors), delta_rows=int(ceng.delta.n),
        tombstones=len(ceng.delta.tombstones), save_engine_seconds=save_s,
        load_engine_seconds=load_s, engine_bytes=nbytes, queries=len(q), bit_identical=True,
        crashes=crashes, index_rows=int(idx.n_vectors), save_index_seconds=big_save_s,
        load_index_seconds=big_load_s, index_bytes=big_bytes,
        seconds=time.perf_counter() - t_phase)


def opq_phase(torch, np, ops, k_lut, k_rerank, args, hist, ds, batches, dev, gt, main) -> None:
    """OPQ on the main path's full geometry: the same 100M-row
    corpus regenerated from the seed (the main engine is freed by now: the
    two would not fit the card together), `MemANNSEngine.build(opq_iters=5)`
    with the main build's other arguments (pq_iters 10, 8 logical devices,
    bf16 raw store, exact re-rank), stage seconds and peak memory, the
    rotation's orthonormality error, the quantisation MSE over the main
    phase's 65,536 sampled rows beside plain PQ's (`main`), recall@10
    beside the main engine's (information), the 5 timed batches with the
    launches of B1, B2, B3.  Checks: 16 queries against the plain path
    (ADC and re-rank bit-equal), pruned == unpruned on 1000 queries, and
    1000 inserts into the rotated engine made mutable (the same index and
    placement; it shares the immutable engine's raw store, which inserts
    do not touch until a compaction, and none runs here), beside 1000
    tombstones of main rows as in the `mutable` phase (fetch 2048), each
    find their own id first, through B1 + B5 on the delta and B3, and no
    tombstoned id comes back."""
    from repro_torch.core.index import recall_at_k
    from repro_torch.data.vectors import generate_clustered
    from repro_torch.retrieval.engine import MemANNSEngine

    import gc

    t_phase = time.perf_counter()
    # the mutable engines' serving objects hold reference cycles (spans,
    # tracer): collect them, or their 38 GB store outlives `del`
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    xs, _ = generate_clustered(
        args.n, D, N_CLUSTERS, seed=args.seed, size_zipf=1.3, center_scale=5.0,
        noise=1.0, device=dev, dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t = time.perf_counter()
    oeng = MemANNSEngine.build(
        xs, N_CLUSTERS, M, ndev=NDEV, history_queries=hist, nprobe_history=NPROBE,
        block_n=BLOCK_N, kmeans_iters=10, pq_iters=10, train_subsample=262_144,
        pq_train_subsample=65_536, rerank="exact", raw_dtype="bfloat16", opq_iters=5,
        seed=args.seed, device=dev, stats=stages,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 1e9
    del xs
    torch.cuda.empty_cache()
    rot = oeng.index.rotation
    orth = float(np.abs(rot.astype(np.float64) @ rot.T - np.eye(D)).max())
    mse = quant_mse(torch, np, oeng.index, oeng.raw, main["sample_ids"])
    drive = drive_path(torch, np, ops, "search_opq", oeng, batches,
                       ("build_luts", "adc_topk_tiles", "rerank_dists"))
    plain_path_check(torch, np, k_lut, k_rerank, oeng, batches[1][:16])
    qb, kp = batches[1], oeng.k_prime(K)
    pruned = oeng.search(qb, NPROBE, K)
    adc_pruned = oeng.collect(oeng.dispatch_plan(oeng.plan_batch(qb, NPROBE), kp))
    oeng.prune = False
    unpruned = oeng.search(qb, NPROBE, K)
    adc_unpruned = oeng.collect(oeng.dispatch_plan(oeng.plan_batch(qb, NPROBE), kp))
    oeng.prune = True
    for a, b in zip(pruned + adc_pruned, unpruned + adc_unpruned):
        if not np.array_equal(a, b):
            raise RuntimeError("opq: the pruned search differs from the unpruned search")
    n_gt = len(gt)
    recall = recall_at_k(pruned[1][:n_gt], gt)
    adc_recall = recall_at_k(adc_pruned[1][:n_gt, :K], gt)

    mut = MemANNSEngine.from_reference(oeng.index, oeng.placement, block_n=BLOCK_N,
                                       mutable=True, freqs=oeng.freqs, device=dev)
    mut.raw, mut.rerank = oeng.raw, "exact"
    oeng._dev_arrays = None
    ins_x = ds.queries(1000, seed=args.seed + 12)
    ins_ids = np.arange(args.n, args.n + 1000, dtype=np.int64)
    dels = np.random.default_rng(args.seed + 13).choice(args.n, 1000, replace=False)
    t = time.perf_counter()
    mut.insert(ins_ids, ins_x)
    insert_ms = (time.perf_counter() - t) * 1e3
    mut.delete(dels)
    mut.search(batches[0], NPROBE, K)  # warm-up: the delta view and the device copies
    ops.reset_launches()
    t = time.perf_counter()
    d, i = mut.search(ins_x, NPROBE, K)
    insert_search_ms = (time.perf_counter() - t) * 1e3
    ins_launches = {k: v for k, v in ops.launches.items() if v}
    if not np.array_equal(i[:, 0], ins_ids):
        raise RuntimeError(f"opq: {int((i[:, 0] != ins_ids).sum())} inserts do not find "
                           "their own id first")
    if np.isin(i, dels).any():
        raise RuntimeError("opq: a tombstoned id came back")
    for kname in ("build_luts", "adc_topk_tiles", "adc_topk_windows", "rerank_dists"):
        if ins_launches.get(kname, 0) <= 0:
            raise RuntimeError(f"opq: {kname} was never launched by the mutable search")
    log(phase="opq", n=args.n, opq_iters=5, build_seconds=build_s, stage_seconds=stages,
        memory_held_before_gb=held_gb, peak_memory_gb=peak, orthonormality_error=orth,
        same_cluster_sizes_as_main=bool(np.array_equal(oeng.index.cluster_sizes(),
                                                       main["cluster_sizes"])),
        quant_mse=dict(sample_rows=len(main["sample_ids"]), opq=mse, plain_pq=main["mse"]),
        recall_at_10=dict(opq=recall, main=main["recall"]),
        adc_only_recall_at_10=dict(opq=adc_recall, main=main["adc_recall"]),
        batch_ms=drive["batch_ms"], launches=drive["launches"],
        plain_path_equal=True, prune_bit_identical=True,
        inserts=dict(rows=len(ins_ids), tombstones=len(dels), insert_ms=insert_ms,
                     search_ms=insert_search_ms,
                     own_id_first=True, launches=ins_launches),
        seconds=time.perf_counter() - t_phase)
    del mut, oeng
    torch.cuda.empty_cache()


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
    from repro_torch.core.index import brute_force, recall_at_k
    from repro_torch.data.vectors import SkewedVectorDataset, generate_clustered
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import adc_scan as k_scan
    from repro_torch.kernels import adc_topk as k_topk
    from repro_torch.kernels import flash_attn as k_flash
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
    regs = ptxas_summary(_build.ptxas_report())
    log(phase="build_kernels", seconds=time.perf_counter() - t, lib=str(lib.name),
        ptxas=regs)

    # == the LM serving path (B10), before the engine takes the memory ======
    lm_rows = lm_serve(torch, np, ops, k_flash, k_lut, k_rerank, dev, args.seed)

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
    launches = drive_path(torch, np, ops, "search", eng, batches,
                          ("build_luts", "adc_topk_tiles", "rerank_dists"))["launches"]
    # where the host plan's time goes, by function
    log(phase="breakdown", host_plan_ms_by_function_profiled=host_by_function(
        lambda: eng.plan_batch(batches[1], NPROBE)))
    plan = eng.plan_batch(batches[1], NPROBE)
    handle = eng.dispatch_plan(plan, kp)

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
    b1_queued = cuda_ms(torch, lambda: k_lut.launch(cb, qmc, out, rows), 20, queued=True)
    n_lut = n_rows * M * 256
    bms, by = bound_ms(4 * (cb.numel() + qmc_rows.numel() + n_rows + n_lut),
                       3 * n_lut * dsub)
    kernels.append(dict(
        name="lut_build", route="cuda", source=f"{SRC_ROOT}/csrc/lut_build.cu",
        replaces="src/repro/kernels/lut_build.py:35", launches=launches["build_luts"],
        max_abs_err=err, ms=b1_ms, queued_ms=b1_queued,
        plain_ms=wall_ms(torch, lambda: k_lut.build_luts_plain(cb, qmc[rows.long()])),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: ((cb[None] - qmc_rows[:, :, None, :]) ** 2).sum(-1), 5),
        library_call="((codebook[None] - qmc_rows[:, :, None, :]) ** 2).sum(-1) over the "
                     "valid pairs' residuals (squared, no sqrt: the kernel's function)",
        shape=dict(pairs=n_rows, pair_slots=ndev * p, m=M, dsub=dsub),
    ))

    # B2: pruned tile scan, as the path calls it and unpruned per pair
    kernels.append(check_scan(
        torch, ops, k_topk, name="adc_topk_tiles", scan="tiles",
        source=f"{SRC_ROOT}/csrc/adc_topk_tiles.cu",
        replaces="src/repro/kernels/adc_topk.py:397", launches=launches["adc_topk_tiles"],
        tables=luts.reshape(n_rows, -1), lut_row=lut_row, codes=dv["codes"], plan=plan,
        dv=dv, kp=kp, regs=regs,
    ))

    # B3: exact re-rank with the fused gather, on this batch's candidates
    raw = eng.raw
    qt = torch.as_tensor(batches[1], device=dev)
    cand = torch.where(torch.isfinite(handle.out_d), handle.out_i, -1).int().contiguous()
    kernels.append(check_rerank(
        torch, ops, k_rerank, qt, cand, raw, launches=launches["rerank_dists"],
        shape=dict(path="search", queries=qt.shape[0], candidates=kp, dim=D,
                   store="bfloat16")))
    del luts_plain

    # -- 16 queries: engine == plain path at full scale ---------------------
    plain_path_check(torch, np, k_lut, k_rerank, eng, batches[1][:16])
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

    # -- the onehot path on raw codes: the gather's sums, bit for bit --------
    raw_onehot_equal(torch, np, ops, eng, plan, luts.reshape(n_rows, -1), lut_row, kp)
    eng.path = "onehot"
    search_onehot = drive_path(torch, np, ops, "search_onehot", eng, batches[:2],
                               ("build_luts", "adc_topk_tiles", "rerank_dists"))
    onehot_out = eng.search(qb, NPROBE, K)
    eng.path = "gather"
    if not all(np.array_equal(a, b) for a, b in zip(onehot_out, pruned)):
        raise RuntimeError("search_onehot: the onehot path differs from the gather path on "
                           "raw codes")
    log(phase="search_onehot_check", queries=BATCH, equal_to_gather=True,
        batch_ms=search_onehot["batch_ms"])

    # -- ServingEngine over the main-path engine ----------------------------
    serving_phase(torch, np, ops, eng, batches)
    serving_obs_faults(torch, np, ops, eng, batches)

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
    # plain PQ's quantisation error on a row sample, for the OPQ phase
    sample_ids = np.sort(np.random.default_rng(args.seed + 11).choice(
        args.n, 65_536, replace=False))
    main_quality = dict(sample_ids=sample_ids, recall=recall, adc_recall=adc_recall,
                        mse=quant_mse(torch, np, eng.index, raw, sample_ids),
                        cluster_sizes=eng.index.cluster_sizes())

    # == the co-occurrence slice (§4.3) and the windows scan ================
    cooc_kernels, direct_codes, direct_tables = cooc_and_windows(
        torch, np, ops, k_lut, k_topk, k_rerank, eng, batches, dev, pruned, adc_pruned, regs)
    kernels += cooc_kernels
    torch.cuda.empty_cache()

    # == the kernel-level ADC API (B8, B6, B7) and the flat search ==========
    kernels += kernel_api_and_flat(torch, np, ops, k_scan, k_topk, eng, batches, dev,
                                   direct_codes, direct_tables, regs)

    # == the kernel-geometry autotune (sweep, tuned serving, cache hit) ======
    autotune_phase(torch, np, ops, eng, batches)

    # == the mutable path (inserts, deletes, compaction) =====================
    # the immutable engine's device arrays are freed first; the mutable one
    # reuses its index, placement and raw store (re-packed with slack)
    del direct_codes, direct_tables, dv, luts, qmc, qmc_rows, rows, lut_row, out, cand
    del handle, qt, raw, ids_of_row, mapped, gt_rows
    t = time.perf_counter()
    eng._dev_arrays = None
    torch.cuda.empty_cache()
    meng = mutable_engine(torch, np, eng, dev, rerank="exact")
    del eng
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(phase="mutable_build", seconds=time.perf_counter() - t,
        code_rows_per_device=int(meng.shards.codes.shape[1]),
        raw_store_gb=meng.raw.nbytes() / 1e9,
        memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    kernels += mutable_phase(torch, np, ops, k_lut, k_topk, k_rerank, meng, ds, batches,
                             dev, args.seed)
    ceng = mutable_cooc_cell(torch, np, ops, meng, ds, batches, dev, args.seed)

    # == checkpoints: the 4M-row cell round trip, crashes, the 100M index ====
    checkpoint_phase(torch, np, ceng, meng, ds, batches, dev, args.seed)
    del ceng
    torch.cuda.empty_cache()
    mutable_serving(torch, np, ops, k_lut, k_rerank, meng, ds, batches, dev, args.seed)
    del meng
    torch.cuda.empty_cache()

    # == OPQ at full scale (the main engine is gone: a second 100M build) ====
    opq_phase(torch, np, ops, k_lut, k_rerank, args, hist, ds, batches, dev, gt, main_quality)

    kernels += lm_rows
    log(phase="done", seconds=time.perf_counter() - t_start, nvidia_smi=smi)
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
