"""Warmup-time kernel-geometry autotuner (the reference's `repro.core.autotune`).

The kernels take their geometry from `MemANNSEngine` knobs: `block_n` (the
scan tile height, baked into the shard layout), `rerank_block` (B3's
candidates per thread block) and `tile_floor` (the tile queue's capacity
floor).  None of them changes a bit of any result (geometry is data
layout, never selection order; `tests/test_torch_autotune.py` holds the
invariance wall), but the fastest values depend on the card, so this
module measures them:

  * `sweep_engine` times a small grid of geometries -- `block_n` on the
    engine's own search path, `rerank_block` on a synthetic B3 call shaped
    like the engine's raw store -- and takes each knob's argmin, but keeps
    the current value unless the argmin beats it by `SWEEP_MARGIN`;
  * the pick persists to a versioned JSON cache keyed by (device name,
    shard-shape bucket, k bucket), so a process pays the sweep once per
    (card, config) and every later start reads the winner;
  * `configs/autotune_defaults.json` is the fallback for a backend never
    swept on this machine; its rows are `block_n = 0` ("keep the
    build-time geometry") unless a sweep on that card measured a winner.

Where the port differs from the reference (each knob's unit is the port's
own kernel's, so the two caches never mix):

  * **Device and cache file.**  `backend_info` is ("cuda", the CUDA device
    name) or ("cpu", "cpu"); the cache is
    `~/.cache/repro_torch/autotune-<backend>-v<CACHE_VERSION>.json`, never
    the reference's file.
  * **`engine_key`** is built from the port's `DeviceShards`: width, code
    itemsize, addressing mode, M, the pow2 bucket of the most rows a device
    holds, the k bucket and `rerank`.  The reference buckets the padded
    row capacity, which moves with the tile height, so a retiled engine
    missed its own entry; the rows held do not move.
  * **`rerank_block`** is in B3's unit, candidates per thread block
    (`kernels.rerank.launch_plan(block_k=...)`), not the reference's LANE
    multiples; the grid is 16, 32 and 64 (B3's `CAND_MAX`) and the current
    value.
  * **Timing `block_n`.**  The reference times B2 alone on 8 synthetic
    tiles.  On the H100 a synthetic B2 scan (even one sized to a
    millisecond) ranked 256 / 512 / 1024 differently from run to run,
    while the serving path lost 1.8x at 512 and 3.1x at 256: the host
    builds a tile queue whose length doubles as `block_n` halves (PERF.md
    §6).  So each candidate is a retile and the wall time of
    `engine.search` -- host plan, B1 / B2 / B3, collect -- on a batch of
    the caller's serving shape (`nprobe`, `batch` queries at the IVF
    centroids, drawn by cluster size), and the engine ends at its own
    geometry.  A search at 100M rows takes 0.3-2.4 s, far above the
    ~20 us where a wall time reads the host's launch pace.
  * **Timing `rerank_block`.**  B3 alone (the host does the same work at
    every block), with CUDA events on `SWEEP_CANDIDATES_CUDA` candidates
    (2^22: ~1 GB of bf16 rows gathered, ~0.7 ms); on the CPU (the plain
    version) small, on the host's clock.
  * **Defaults.**  The port's own `configs/autotune_defaults.json`; no TPU
    or reference number is in it.

`ServingEngine(autotune="off"|"cache"|"sweep")` is the consumer: it
applies the resolved geometry at `warmup()`, before anything is warmed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.kernels import ops

# bump when the cache entry schema OR the meaning of a tuned knob changes:
# both the file name and the document carry it, so a stale cache is ignored
CACHE_VERSION = 1

DEFAULT_BLOCK_NS = (256, 512, 1024)
DEFAULT_RERANK_BLOCKS = (16, 32, 64)
# B3's synthetic candidates (module docstring); the CPU runs the plain
# version, small
SWEEP_CANDIDATES_CUDA, SWEEP_CANDIDATES_CPU = 1 << 22, 1 << 9
# a candidate replaces the current value only when it is this much faster
# than it: B3's synthetic times move by a few per cent between runs on
# one card (PERF.md §6: 64 a block against the kernel's own 1.5-5 %
# apart), so a pick inside that spread is noise
SWEEP_MARGIN = 0.10


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """One tunable kernel-geometry point.

    block_n: scan tile height; 0 = keep the engine's.  A different value
      retiles the shards (`MemANNSEngine.retile`).
    rerank_block: B3's candidates per thread block; 0 = the kernel's own.
    tile_floor: least tiles-per-device queue capacity; 0 = pairs_per_dev.
    """

    block_n: int = 0
    rerank_block: int = 0
    tile_floor: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelGeometry":
        return cls(
            block_n=int(d.get("block_n", 0) or 0),
            rerank_block=int(d.get("rerank_block", 0) or 0),
            tile_floor=int(d.get("tile_floor", 0) or 0),
        )


def backend_info(device: torch.device | str | None = None) -> tuple[str, str]:
    """(backend, device kind): ("cuda", the CUDA device name) for a CUDA
    device (default: cuda when torch sees one), else ("cpu", "cpu")."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return "cpu", "cpu"


def cache_path(backend: str, cache_dir: str | None = None) -> str:
    """The versioned per-backend user cache file (written by a sweep)."""
    base = cache_dir or os.path.join(os.path.expanduser("~"), ".cache", "repro_torch")
    return os.path.join(base, f"autotune-{backend}-v{CACHE_VERSION}.json")


def defaults_path() -> str:
    """The in-repo fallback table (`repro_torch/configs/autotune_defaults.json`)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "autotune_defaults.json")


def load_cache(backend: str, cache_dir: str | None = None) -> dict:
    """Entries of the user cache; {} when absent, unreadable or stale (the
    version is in the file name and in the document)."""
    try:
        with open(cache_path(backend, cache_dir)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def save_cache(backend: str, entries: dict, cache_dir: str | None = None) -> str:
    """Merge `entries` into the user cache (atomic rewrite); returns its path."""
    path = cache_path(backend, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    merged = load_cache(backend, cache_dir)
    merged.update(entries)
    doc = {"version": CACHE_VERSION, "backend": backend, "entries": merged}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_defaults(backend: str) -> KernelGeometry | None:
    """The backend's geometry from the in-repo defaults table, or None."""
    try:
        with open(defaults_path()) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
        return None
    entry = (doc.get("backends") or {}).get(backend)
    return KernelGeometry.from_dict(entry) if isinstance(entry, dict) else None


def _pow2(n: int) -> int:
    return 1 << math.ceil(math.log2(max(int(n), 1)))


def engine_key(engine, k: int, device_kind: str | None = None) -> str:
    """Cache key: (device kind, shard-shape bucket, k bucket).

    The shard bucket covers what picks the scan's instantiation (width and
    code itemsize, raw codes or direct addresses, M) and the pow2 bucket of
    the most rows a device holds (not the padded capacity, which changes
    with `block_n`: a retile keeps the key); k is pow2-bucketed like the
    serving fetches.  Two engines with one key can share a geometry.
    """
    if device_kind is None:
        _, device_kind = backend_info(engine.device)
    s = engine.shards
    itemsize = (s.codes.element_size() if isinstance(s.codes, torch.Tensor)
                else s.codes.dtype.itemsize)
    mode = "raw" if s.add_offsets else "addr"
    return (f"{device_kind}|w{s.width}x{itemsize}{mode}|m{s.m_subspaces}"
            f"|rows{_pow2(int(s.slot_size.sum(axis=1).max(initial=1)))}"
            f"|k{_pow2(max(k, 1))}|rerank-{engine.rerank}")


# ------------------------------ sweeping ------------------------------- #


def _median_s(fn, cuda_events: bool, iters: int, warmup: int) -> float:
    """Median seconds of one `fn()` call: CUDA events around it on the
    card, the host clock otherwise (`fn` returns host arrays, so its work
    is done when it returns)."""
    for _ in range(warmup):
        fn()
    ts = []
    if cuda_events:
        torch.cuda.synchronize()
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _sweep_queries(engine, n: int) -> np.ndarray:
    """(n, D) f32 original-space queries at the IVF centroids, each
    cluster drawn with probability proportional to its size, from a fixed
    seed: a batch whose probes land where the rows are, as served queries'
    do."""
    idx = engine.index
    sizes = idx.cluster_sizes().astype(np.float64)
    pick = np.random.default_rng(0).choice(len(sizes), size=n, p=sizes / sizes.sum())
    q = np.asarray(idx.centroids, np.float32)[pick]
    return q if idx.rotation is None else q @ np.asarray(idx.rotation, np.float32).T


def _time_batch(engine, block_n: int, k: int, nprobe: int, queries: np.ndarray,
                iters: int, warmup: int) -> float:
    """Median wall seconds of `engine.search(queries, nprobe, k)` with the
    shards retiled to `block_n`: the serving path, host plan included."""
    if engine.shards.block_n != block_n:
        engine.retile(block_n)
    return _median_s(lambda: engine.search(queries, nprobe, k), False, iters, warmup)


def _time_rerank(engine, block_k: int, k: int, iters: int, warmup: int) -> float:
    """Median seconds of one B3 call with `block_k` candidates a block, at
    the cascade's k' over the engine's raw store (random stored ids)."""
    dev = engine.device
    kp = engine.k_prime(max(k, 1))
    q_n = max(1, (SWEEP_CANDIDATES_CUDA if dev.type == "cuda" else SWEEP_CANDIDATES_CPU) // kp)
    gen = torch.Generator(device=dev).manual_seed(1)
    raw = engine.raw
    vectors, id_dev, id_row, row_base = raw.vectors, raw.id_dev, raw.id_row, raw.row_base
    ids = torch.nonzero(id_dev >= 0).flatten().to(torch.int32)
    cand = ids[torch.randint(0, ids.numel(), (q_n, kp), generator=gen, device=dev)]
    queries = torch.randn((q_n, vectors.shape[1]), generator=gen, device=dev)

    def fn():
        return ops.rerank_dists(queries, cand, vectors, id_dev, id_row, row_base,
                                block_k=block_k)

    return _median_s(fn, dev.type == "cuda", iters, warmup)


def _pick(times: dict[int, float], current: int) -> int:
    """The argmin of `times`, unless it beats `current` by less than
    `SWEEP_MARGIN`: then `current`."""
    best = min(times, key=times.get)
    return best if times[best] < (1.0 - SWEEP_MARGIN) * times[current] else current


def sweep_engine(
    engine,
    k: int,
    nprobe: int = 8,
    batch: int = 256,
    block_ns: tuple[int, ...] | None = None,
    rerank_blocks: tuple[int, ...] | None = None,
    iters: int = 3,
    warmup: int = 1,
) -> tuple[KernelGeometry, dict]:
    """Time the candidate grid; return (pick, report).

    `block_n` is timed on the engine's search of `batch` queries at
    `nprobe` (the serving shape; `ServingEngine` passes its own), the
    current tile height first, and the engine is retiled back to it
    afterwards; `rerank_block` on a synthetic B3 call.  The current value
    of each knob is always in the grid, and a knob moves off it only to a
    candidate faster by more than `SWEEP_MARGIN` (`_pick`), so a pick is
    never a difference the timing's spread can make.  The two knobs are
    picked independently; `tile_floor` is kept.
    """
    current = engine.shards.block_n
    grid = {current, *(DEFAULT_BLOCK_NS if block_ns is None else block_ns)}
    queries = _sweep_queries(engine, batch)
    try:
        batch_times = {bn: _time_batch(engine, bn, k, nprobe, queries, iters, warmup)
                       for bn in sorted(grid, key=lambda bn: (bn != current, bn))}
    finally:
        if engine.shards.block_n != current:
            engine.retile(current)
    best_bn = _pick(batch_times, current)

    rerank_times: dict[int, float] = {}
    best_bk = 0
    if engine.rerank == "exact":
        if engine.raw is None:
            raise ValueError("rerank='exact' needs a raw-vector store to sweep B3's blocks")
        grid = DEFAULT_RERANK_BLOCKS if rerank_blocks is None else rerank_blocks
        grid = tuple(sorted({engine.rerank_block, *grid}))
        rerank_times = {bk: _time_rerank(engine, bk, k, iters, warmup) for bk in grid}
        best_bk = _pick(rerank_times, engine.rerank_block)

    geo = KernelGeometry(block_n=int(best_bn), rerank_block=int(best_bk),
                         tile_floor=int(engine.tile_floor))
    report = {
        "swept": len(batch_times) + len(rerank_times),
        "margin": SWEEP_MARGIN,
        "batch": {"queries": int(batch), "nprobe": int(nprobe)},
        "batch_s": {str(bn): t for bn, t in sorted(batch_times.items())},
        "rerank_s": {str(bk): t for bk, t in rerank_times.items()},
    }
    return geo, report


# ------------------------------ entry point ---------------------------- #


def autotune_engine(
    engine,
    k: int,
    mode: str = "cache",
    cache_dir: str | None = None,
    block_ns: tuple[int, ...] | None = None,
    rerank_blocks: tuple[int, ...] | None = None,
    nprobe: int = 8,
    batch: int = 256,
) -> tuple[KernelGeometry | None, dict]:
    """Resolve the tuned geometry for (engine, k) under an autotune mode.

    Returns (geometry or None, report).  The report carries `mode`,
    `source` ("off" | "cache" | "sweep" | "defaults" | "miss"), `swept`
    (candidates timed by this call: 0 on every cache hit), the cache `key`
    and the geometry.  Modes:

      "off"   : never touch the engine; (None, report).
      "cache" : the cached entry for this key, else the in-repo default for
                the backend, else nothing ("miss").
      "sweep" : "cache"'s entry on a hit; on a miss `sweep_engine` runs
                (at `nprobe` and `batch`, the serving shape) and its pick
                is persisted, so the next start sweeps nothing.  The key
                carries no nprobe or batch, as the reference's does not.
    """
    if mode not in ("off", "cache", "sweep"):
        raise ValueError(f"autotune must be 'off', 'cache' or 'sweep', got {mode!r}")
    report: dict = {"mode": mode, "source": "off", "swept": 0}
    if mode == "off":
        return None, report
    backend, device_kind = backend_info(engine.device)
    key = engine_key(engine, k, device_kind=device_kind)
    report.update(backend=backend, device_kind=device_kind, key=key,
                  cache_path=cache_path(backend, cache_dir))
    entry = load_cache(backend, cache_dir).get(key)
    if isinstance(entry, dict):
        geo = KernelGeometry.from_dict(entry)
        report.update(source="cache", geometry=geo.as_dict())
        return geo, report
    if mode == "sweep":
        geo, sweep_report = sweep_engine(engine, k, nprobe=nprobe, batch=batch,
                                         block_ns=block_ns, rerank_blocks=rerank_blocks)
        save_cache(backend, {key: {**geo.as_dict(), "timings": sweep_report}}, cache_dir)
        report.update(source="sweep", swept=sweep_report["swept"], geometry=geo.as_dict(),
                      timings=sweep_report)
        return geo, report
    geo = load_defaults(backend)
    if geo is not None:
        report.update(source="defaults", geometry=geo.as_dict())
        return geo, report
    report.update(source="miss")
    return None, report
