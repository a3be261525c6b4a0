"""Build the CUDA kernels under `csrc/` with nvcc and load them with ctypes.

Route (b) of the port's kernel guide: each `csrc/*.cu` has a plain C
interface (no PyTorch headers), so nvcc compiles it in seconds.  The
sources compile in parallel, one nvcc process each, into objects that are
linked into one shared library under `<repo>/build/repro_torch_kernels/`,
named by a hash of the sources and flags so an edited source rebuilds.
Nothing is built at import time: the first kernel launch builds.  A failed
build raises with nvcc's output.  `compile_events` counts what a warmed
server must not do again: nvcc builds of the library (`build_library`
compiling, not reusing a build) and CUDA-graph captures (no module of the
port captures one today; one that does adds to `graph_captures`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# nvcc builds and CUDA-graph captures since the process started (the
# serving layer's compile counter reads their sum, `compile_count`)
compile_events = {"nvcc_builds": 0, "graph_captures": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every launcher; each returns cudaGetLastError() as int
SIGNATURES = {
    # codebook, qmc, rows (may be null), out, n_pairs, m, dsub, stream
    "lut_build_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    # codebook, qmc, rows (may be null), out, n_pairs, m, dsub, then
    # `lut_build.wide_plan`'s pg, cw, ds, n_slices, stages, stride, g,
    # threads, smem; stream
    "lut_build_wide_launch": [_P] * 4 + [_I] * 12 + [_P],
    # luts, set_idx (may be null), caddr, out, n_rows, ma, n_combos,
    # combo_len, t_pad, gtab, stream
    "ext_lut_launch": [_P] * 4 + [_I] * 6 + [_P],
    # tables, lut_row, codes, pair_order, pair_t0, pair_t1, tile_block,
    # tile_row0, n_valid, pair_q, pair_lb, bound, sq, out_v, out_i, stats,
    # n_pairs, pairs_per_dev, cap, w, table_width, code_fmt, onehot, k,
    # block_n, stream
    "adc_topk_tiles_launch": [_P] * 16 + [_I, _I, _L] + [_I] * 6 + [_P],
    # tables, lut_row, codes, pair_order, starts, n_valid, pair_q, pair_lb,
    # bound, sq, out_v, out_i, stats, n_blocks, pairs_per_dev, cap, w,
    # table_width, code_fmt, onehot, k, block_n, stream
    "adc_topk_windows_launch": [_P] * 13 + [_I, _I, _L] + [_I] * 6 + [_P],
    # queries, cand, id_dev, id_row, row_base, vectors, out, q, k, d,
    # ids_cap, ndev, vec_is_bf16, plan (`rerank.PLAN_FIELDS` of
    # `rerank.launch_plan`, an int array), stream
    "rerank_launch": [_P] * 7 + [_I] * 6 + [_P, _P],
    # table, codes, out, n, w, table_width, code_fmt, onehot, gtab, stream
    "adc_scan_launch": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # tables, codes, bound (may be null), units (may be null), out_v, out_i,
    # part_v, part_i, tickets, n_units, n_q, n_rows, w, table_width,
    # code_fmt, onehot, k, block_n, g, n_blocks, stream
    "adc_topk_launch": [_P] * 9 + [_I] * 11 + [_P],
    # code_fmt, onehot, w, table_width, k, g
    "adc_topk_blocks_per_sm": [_I] * 6,
    # tables, addrs, n_valid, out_v, out_i, part_v, part_i, tickets,
    # n_pairs, win_len, w, table_width, code_fmt, onehot, k, block_n,
    # n_blocks, stream
    "adc_topk_pairs_launch": [_P] * 8 + [_I, _L] + [_I] * 7 + [_P],
    # code_fmt, onehot, w, table_width, k
    "adc_topk_pairs_blocks_per_sm": [_I] * 5,
    # tables, codes, bound, units, n_valid (each may be null but tables and
    # codes), out_v, out_i, part_v, part_i, tickets, ilv (null at g 1),
    # ustart (int64 scratch), win_len, n_units, n_q, n_rows, w, table_width,
    # code_fmt, onehot, k, block_n, g, n_blocks, stream
    "adc_topk_wide_launch": [_P] * 12 + [_L] + [_I] * 11 + [_P],
    # tables, lut_row, codes, order, ustart, pair_t0, pair_t1, tile_block,
    # tile_row0 (B2; null for B5), starts (B5; null for B2), n_valid,
    # pair_q, pair_lb, bound, sq, out_v, out_i, stats, part_v, part_i,
    # tickets, n_units, pairs_per_dev, cap, w, table_width, code_fmt,
    # onehot, k, block_n, n_blocks, stream
    "adc_topk_scan_wide_launch": [_P] * 21 + [_I, _I, _L] + [_I] * 7 + [_P],
    # code_fmt, onehot, w, table_width, k, g, pairs (B2 / B5's kernel)
    "adc_topk_wide_blocks_per_sm": [_I] * 7,
    # tables, codes, bound, units, n_valid (as above), out_v, out_i,
    # scratch, win_len, n_units, n_q, n_rows, w, table_width, code_fmt,
    # onehot, k, block_n, gtab, n_blocks, launched (host int), split_ms
    # (host floats or null), stream
    "adc_topk_select_launch": [_P] * 8 + [_L] + [_I] * 11 + [_P] * 3,
    # tables, lut_row, codes, order, pair_t0, pair_t1, tile_block,
    # tile_row0 (B2; null for B5), starts (B5; null for B2), n_valid,
    # pair_q, pair_lb, bound, sq, out_v, out_i, stats, scratch, n_units,
    # n_q, pairs_per_dev, cap, w, table_width, code_fmt, onehot, k,
    # block_n, gtab, n_blocks, launched (host int), split_ms (host floats or
    # null), stream
    "adc_topk_scan_select_launch": [_P] * 18 + [_I, _I, _I, _L] + [_I] * 8 + [_P] * 3,
    # code_fmt, onehot, w, table_width, gtab, pairs (B2 / B5's kernel)
    "adc_topk_select_blocks_per_sm": [_I] * 6,
    # q, k, v, out, b, sq, sk, h, kvh, hd, q_offset, kv_valid, q_is_bf16,
    # kv_is_bf16, scale, variant (`flash_attn.VARIANTS`), stream
    "flash_attn_launch": [_P] * 4 + [_I] * 10 + [_F, _I, _P],
    # hd, q_is_bf16, kv_is_bf16, variant, out (3 ints: registers, spill
    # bytes, dynamic shared memory bytes)
    "flash_attn_attributes": [_I, _I, _I, _I, _P],
}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the repro_torch CUDA kernels are built from csrc/ on first use"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[pathlib.Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> pathlib.Path:
    """Compile every csrc/*.cu (in parallel) and link one .so; return its path.

    Reuses an existing library of the same source hash.  The ptxas report
    (each source's nvcc seconds; registers, shared memory, spills per
    kernel) is kept next to it as `<lib>.ptxas.txt`.
    """
    srcs = _sources()
    lib = BUILD_DIR / f"librepro_torch_kernels-{_digest(srcs)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    compile_events["nvcc_builds"] += 1
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}-{tag}.o" for s in srcs]

    def compile_one(src_obj):
        t = time.perf_counter()
        done = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src_obj[0]), "-o", str(src_obj[1])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return done, time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        results = list(pool.map(compile_one, zip(srcs, objs)))
    report, failed = [], []
    for s, (done, seconds) in zip(srcs, results):
        report.append(f"== {s.name} ({seconds:.1f} s)\n{done.stdout}")
        if done.returncode != 0:
            failed.append(f"nvcc failed on {s.name} (rc {done.returncode}):\n{done.stdout}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n{link.stdout}")
    (BUILD_DIR / f"{lib.name}.ptxas.txt").write_text("\n".join(report))
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), argtypes declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def compile_count() -> int:
    """nvcc builds plus CUDA-graph captures so far in this process."""
    return sum(compile_events.values())


def ptxas_report() -> str:
    """nvcc's -Xptxas -v output of the current build ('' before a build)."""
    p = BUILD_DIR / f"librepro_torch_kernels-{_digest(_sources())}.so.ptxas.txt"
    return p.read_text() if p.exists() else ""


def pow2_dividing(*xs: int) -> int:
    """The largest power of two <= 16 that divides every x (a copy width,
    in bytes, that addresses and sizes allow)."""
    g = 16
    while g > 1 and any(x % g for x in xs):
        g //= 2
    return g


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans' n_sm)."""
    import torch

    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
