"""The in-place ADC scans (a 65,536-entry uint16 table read where it lies)
against an earlier tree's in-place block, in one call on the card.

Usage (on the card, from the repo root):

    mkdir -p build/inplace_parent && for f in adc_topk_common.cuh adc_topk_multi.cuh \\
        adc_topk_wide.cu adc_topk_tiles.cu adc_topk_windows.cu; do \\
        git show 5d96f40:src/repro_torch/csrc/$f > build/inplace_parent/$f; done
    python3 tools/probe_inplace.py --parent-dir build/inplace_parent

The parent's sources (one table a unit for B6 / B7; B2 / B5 on a persistent
grid of one pair a block, `scan_pair` with its WIDE flag) are copied with
`%globaltimer` stamps in `scan_pair` (one record a pair: its block, start,
end and valid rows) and built with nvcc into a library of their own C
interface.  Variants of the port's in-place block are built from edited
copies of its two sources (`adc_topk_wide.cu`, `adc_topk_wide_g24.cu`):
`carveout` (a preferred shared-memory carveout of `--carveout` percent, so
that L1 keeps more of the tables), `min_blocks` (G > 1 compiled for
`--min-blocks` resident blocks an SM) and `min_blocks_g1` (B7 and B2 / B5
for `--min-blocks-g1`).  On data made on the card from the
smoke's seed it times, in turns (parent, port, variants, then the reverse;
CUDA events, the mean of `--reps` calls each), at two shapes:

  * `smoke`: the smoke's `domain_synthetic` rows: B6 at Q = 4, k = 10 over
    2M uint16 rows; B7, B2 and B5 at k' = 64 on 30 windows of 65,536 rows
    (the smoke's n_valid), each window its own table and query;
  * `many`: 2,048 windows of 512 rows (block_n 512), each with its own
    65,536-entry table (512 MB of tables), B7 / B2 / B5 at k' = 64 (B6 at
    Q = 4 over those 1M rows).

It also times the port's B6 at G = 1, 2 and 4 (Q = 4 each) and prints the
in-place lookup cost each implies, in the units of kernels/adc_topk.py
`_INPLACE_CLOCKS` (SM clocks of the model's 1.98 GHz per warp-wide lookup
of one table's entry).  Every port row is checked bit-equal to the parent's
(B2 / B5 unpruned, each pair its own query).  Prints the card's name and
power limit in each JSON line; exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
__device__ unsigned long long g_rec[5][65536];  // start, end, block, rows, pair's query
__device__ int g_n;
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''

ANCHORS = {
    "  int n_skip = 0, n_avoid = 0;\n  __syncthreads();\n": (
        "  int n_skip = 0, n_avoid = 0;\n  __syncthreads();\n"
        "  const unsigned long long t_pair = gtimer();\n"),
    "  if (tid == 0) {\n    stats[0] = n_skip;\n": (
        "  if (tid == 0) {\n    const int r = atomicAdd(&g_n, 1);\n"
        "    if (r < 65536) {\n      g_rec[0][r] = t_pair;\n      g_rec[1][r] = gtimer();\n"
        "      g_rec[2][r] = blockIdx.x;\n      g_rec[3][r] = nv;\n      g_rec[4][r] = qi;\n"
        "    }\n    stats[0] = n_skip;\n"),
}

READ = r'''
extern "C" int inplace_read_NAME(unsigned long long* out, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, repro_adc::g_rec, sizeof(unsigned long long) * 5 * 65536);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, repro_adc::g_n, sizeof(int));
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(repro_adc::g_n, &zero, sizeof(int));
  return static_cast<int>(e);
}
'''

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the parent's C interface (commit 5d96f40)
PARENT_SIGNATURES = {
    "adc_topk_wide_launch": [P] * 10 + [L] + [I] * 11 + [P],
    "adc_topk_wide_blocks_per_sm": [I] * 6,
    "adc_topk_tiles_launch": [P] * 16 + [I, I, L] + [I] * 7 + [P],
    "adc_topk_windows_launch": [P] * 13 + [I, I, L] + [I] * 7 + [P],
    "inplace_read_tiles": [P, P],
    "inplace_read_windows": [P, P],
}


def nvcc_lib(srcs: list[pathlib.Path], out: pathlib.Path) -> None:
    from repro_torch.kernels import _build

    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", *map(str, srcs),
                           "-o", str(out)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed for {out.name}:\n{done.stdout}{done.stderr}")


def load(path: pathlib.Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def build_parent(parent_dir: pathlib.Path, work: pathlib.Path) -> pathlib.Path:
    work.mkdir(parents=True, exist_ok=True)
    src = (parent_dir / "adc_topk_common.cuh").read_text()
    src = src.replace("namespace repro_adc {\n", "namespace repro_adc {\n" + STAMP, 1)
    for old, new in ANCHORS.items():
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once in the parent's scan_pair: {old!r}")
        src = src.replace(old, new)
    (work / "adc_topk_common.cuh").write_text(src)
    (work / "adc_topk_multi.cuh").write_text((parent_dir / "adc_topk_multi.cuh").read_text())
    (work / "adc_topk_wide.cu").write_text((parent_dir / "adc_topk_wide.cu").read_text())
    for scan in ("tiles", "windows"):
        (work / f"adc_topk_{scan}.cu").write_text(
            (parent_dir / f"adc_topk_{scan}.cu").read_text() + READ.replace("NAME", scan))
    out = work / "libparent.so"
    nvcc_lib([work / "adc_topk_wide.cu", work / "adc_topk_tiles.cu",
              work / "adc_topk_windows.cu"], out)
    return out


def build_variant(name: str, edit, work: pathlib.Path) -> pathlib.Path:
    """The port's in-place sources with `edit(file name, text) -> text`."""
    from repro_torch.kernels import _build

    d = work / name
    d.mkdir(parents=True, exist_ok=True)
    for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "adc_topk_wide.cu",
                                               _build.CSRC / "adc_topk_wide_g24.cu"]:
        text = f.read_text()
        new = edit(f.name, text)
        (d / f.name).write_text(new)
    out = d / f"lib{name}.so"
    nvcc_lib([d / "adc_topk_wide.cu", d / "adc_topk_wide_g24.cu"], out)
    return out


def edit_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"anchor not found once: {old!r}")
    return text.replace(old, new)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-dir", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--carveout", type=int, default=25, help="percent, the carveout variant")
    ap.add_argument("--min-blocks", type=int, default=4, help="the min_blocks variant at G > 1")
    ap.add_argument("--min-blocks-g1", type=int, default=6,
                    help="the min_blocks_g1 variant: B7 and B2 / B5's kernels")
    ap.add_argument("--shapes", default="smoke,many")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_inplace: needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels import adc_topk as k_topk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    work = ROOT / "build" / "probe_inplace"
    carve = (f"  cudaError_t e = set_smem(kernel, smem);\n  if (e != cudaSuccess) return "
             f"static_cast<int>(e);\n  kernel<<<")

    def carveout(name, text):
        if name != "adc_topk_multi.cuh":
            return text
        text = edit_once(text, carve, carve.replace(
            "  kernel<<<", f"  e = cudaFuncSetAttribute(kernel, "
            f"cudaFuncAttributePreferredSharedMemoryCarveout, {args.carveout});\n"
            f"  if (e != cudaSuccess) return static_cast<int>(e);\n  kernel<<<"))
        return edit_once(text, "  int n = 0;\n  e = cudaOccupancy", (
            f"  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, "
            f"{args.carveout});\n  if (e != cudaSuccess) return -static_cast<int>(e);\n"
            "  int n = 0;\n  e = cudaOccupancy"))

    def min_blocks(name, text):
        if name != "adc_topk_wide.cuh":
            return text
        return edit_once(text, "__global__ void __launch_bounds__(THREADS, multi_min_blocks<G>())",
                         f"__global__ void __launch_bounds__(THREADS, G == 1 ? 4 : "
                         f"{args.min_blocks})")

    def min_blocks_g1(name, text):
        if name != "adc_topk_wide.cuh":
            return text
        text = edit_once(text, "__global__ void __launch_bounds__(THREADS, multi_min_blocks<G>())",
                         f"__global__ void __launch_bounds__(THREADS, G == 1 ? "
                         f"{args.min_blocks_g1} : multi_min_blocks<G>())")
        return edit_once(text, "__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())",
                         f"__global__ void __launch_bounds__(THREADS, {args.min_blocks_g1})")

    builders = dict(carveout=carveout, min_blocks=min_blocks, min_blocks_g1=min_blocks_g1)
    with concurrent.futures.ThreadPoolExecutor(len(builders) + 2) as pool:
        futs = {"parent": pool.submit(build_parent, pathlib.Path(args.parent_dir),
                                      work / "parent"),
                "port": pool.submit(_build.build_library)}
        futs.update({n: pool.submit(build_variant, n, f, work) for n, f in builders.items()})
        libs = {n: f.result() for n, f in futs.items()}
    parent = load(libs["parent"], PARENT_SIGNATURES)
    port_lib = _build.library()
    variants = {n: load(libs[n], _build.SIGNATURES) for n in builders}
    real_library = _build.library

    def use(lib):  # the port's launchers call `lib`
        _build.library = (lambda: lib) if lib is not port_lib else real_library
        k_topk._blocks_per_sm.cache_clear()

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    a, w, kg = cs.DOMAIN_TABLE, 16, 64
    rec = (ctypes.c_ulonglong * (5 * 65536))()
    n_rec = ctypes.c_int(0)

    def parent_wide(tables, codes, n_valid, win, out, k, bn, n_units):
        per_sm = parent.adc_topk_wide_blocks_per_sm(1, 0, w, a, k, 1)
        nb = n_sm * per_sm
        pv = torch.empty((nb + n_units) * k, device=dev)
        pi = torch.empty_like(pv, dtype=torch.int32)
        tk = torch.zeros(nb + 2 * n_units, dtype=torch.int32, device=dev)

        def call():
            err = parent.adc_topk_wide_launch(
                tables.data_ptr(), codes.data_ptr(), None, None,
                None if n_valid is None else n_valid.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), pv.data_ptr(), pi.data_ptr(), tk.data_ptr(), win, n_units,
                tables.shape[0], codes.shape[0] if codes.dim() == 2 else 0, w, a, 1, 0, k, bn,
                1, nb, stream())
            if err:
                raise RuntimeError(f"parent adc_topk_wide: cudaError_t {err}")
        return call

    def timed(builds: dict, reps: int) -> dict:
        """Each build's mean ms, in turns: order, then reversed."""
        names = list(builds)
        res = {n: [] for n in names}
        for n in names + names[::-1]:
            lib, fn = builds[n]
            use(lib)
            res[n].append(cs.cuda_ms(torch, fn, reps))
        use(port_lib)
        return res

    def same(x, y):
        return all(torch.equal(p, q) for p, q in zip(x, y))

    def run_shape(shape: str) -> None:
        g = torch.Generator(device=dev).manual_seed(27)
        if shape == "smoke":
            n, p, win, bn = cs.DOMAIN_ROWS, 30, 65_536, cs.BLOCK_N
            tables = torch.rand(4, a, device=dev, generator=g)
            tables[:, -1] = 0.0
            addrs = torch.randint(0, a, (n, w), device=dev, generator=g).to(torch.uint16)
            # the smoke draws its ties row's codes before the windows' n_valid
            torch.randint(0, 256, (n, cs.M), device=dev, generator=g)
            n_valid = torch.randint(0, win + 1, (p,), device=dev, generator=g).int()
            n_valid[:3] = torch.tensor([0, 7, win], dtype=torch.int32, device=dev)
            tab7 = tables.repeat(8, 1)[:p].contiguous()
            win_addrs = addrs[: p * win].reshape(p, win, w)
        else:
            p, win, bn = 2048, 512, 512
            n = p * win
            tab7 = torch.rand(p, a, device=dev, generator=g)
            tab7[:, -1] = 0.0
            tables = tab7[:4].contiguous()
            addrs = torch.randint(0, a, (n, w), device=dev, generator=g).to(torch.uint16)
            n_valid = torch.randint(1, win + 1, (p,), device=dev, generator=g).int()
            win_addrs = addrs.reshape(p, win, w)
        line = dict(probe="inplace", shape=shape, card=smi, pairs=p, window=win, block_n=bn,
                    valid_rows=int(n_valid.sum()), rows=n)

        # B6 at Q = 4, k = 10
        plan6 = k_topk.topk_plan([4], [n], cs.K, 1, w, a)
        outs = {s: (torch.empty(4, cs.K, device=dev),
                    torch.empty(4, cs.K, dtype=torch.int32, device=dev))
                for s in ("old", "new", "g1", "g2")}
        par6 = parent_wide(tables, addrs, None, 0, outs["old"], cs.K, bn, 4)

        def port6(g, key="new"):
            pl = dict(plan6, g=g, smem=k_topk.topk_smem(g, cs.K, 0))
            return lambda: k_topk.launch_topk(tables, addrs, None, *outs[key], cs.K, bn, g,
                                              plan=pl)

        builds = {"parent": (port_lib, par6), "port": (port_lib, port6(plan6["g"]))}
        builds.update({v: (lib, port6(plan6["g"])) for v, lib in variants.items()})
        b6 = dict(plan_g=plan6["g"], ms=timed(builds, args.reps))
        sweep = {}
        for gg in (1, 2, 4):
            ms = cs.cuda_ms(torch, port6(gg, {1: "g1", 2: "g2", 4: "new"}[gg]), args.reps)
            # the model's clocks: ms * SM rate * 32 / (units * rows * W * G), units * G = 4
            sweep[gg] = dict(ms=ms, clocks=ms * 1e-3 * k_topk._SM_LOOKUPS_PER_S * 32 / (4 * n * w))
        b6["g_sweep"] = sweep
        par6()
        for gg in (1, 2, 4):
            port6(gg, {1: "g1", 2: "g2", 4: "new"}[gg])()
        torch.cuda.synchronize()
        b6["same_bits"] = all(same(outs["old"], outs[s]) for s in ("new", "g1", "g2"))
        line["b6"] = b6

        # B7 at k' = 64, one table a window
        plan7 = k_topk.topk_plan([1] * p, [win] * p, kg, 1, w, a, groups=(1,))
        o7 = {s: (torch.empty(p, kg, device=dev), torch.empty(p, kg, dtype=torch.int32, device=dev))
              for s in ("old", "new")}
        par7 = parent_wide(tab7, win_addrs, n_valid, win, o7["old"], kg, bn, p)

        def port7():
            o7["new"][0].fill_(torch.inf)
            o7["new"][1].fill_(-1)
            k_topk.launch_pairs(tab7, win_addrs, n_valid, *o7["new"], kg, bn, plan=plan7)

        def par7_filled():
            o7["old"][0].fill_(torch.inf)
            o7["old"][1].fill_(-1)
            par7()

        builds = {"parent": (port_lib, par7_filled), "port": (port_lib, port7)}
        builds.update({v: (lib, port7) for v, lib in variants.items()})
        b7 = dict(g=plan7["g"], ms=timed(builds, args.reps))
        par7_filled()
        port7()
        torch.cuda.synchronize()
        b7["same_bits"] = same(o7["old"], o7["new"])
        line["b7"] = b7

        # B2 / B5 at k' = 64 over the same windows, each its own query, unpruned
        codes25 = addrs[: p * win].reshape(1, p * win, w)
        starts = torch.arange(p, dtype=torch.int32, device=dev) * win
        own = torch.arange(p, dtype=torch.int32, device=dev)
        no_lb = torch.full((p,), -torch.inf, device=dev)
        no_b = torch.full((p,), torch.inf, device=dev)
        t0w, t1w, blk, row0 = k_topk.window_runs(starts, n_valid, own, bn)
        tile_pair = torch.repeat_interleave(own, (t1w - t0w).long())
        t0, t1, order = k_topk.pair_runs(tile_pair[None], p)
        filled = torch.nonzero(n_valid > 0).flatten().int()
        plan25 = k_topk.scan_plan(kg, a)
        sq = no_b.clone()
        o25 = {s: (torch.empty(p, kg, device=dev), torch.empty(p, kg, dtype=torch.int32, device=dev),
                   torch.zeros(p, 2, dtype=torch.int32, device=dev)) for s in ("old", "new")}
        for scan in ("tiles", "windows"):
            def par25(scan=scan):
                ov, oi, os_ = o25["old"]
                sq.fill_(torch.inf)
                if scan == "tiles":
                    err = parent.adc_topk_tiles_launch(
                        tab7.data_ptr(), own.data_ptr(), codes25.data_ptr(), order.data_ptr(),
                        t0.data_ptr(), t1.data_ptr(), blk.data_ptr(), row0.data_ptr(),
                        n_valid.data_ptr(), own.data_ptr(), no_lb.data_ptr(), no_b.data_ptr(),
                        sq.data_ptr(), ov.data_ptr(), oi.data_ptr(), os_.data_ptr(), p, p,
                        p * win, w, a, 1, 0, kg, bn, 1, stream())
                else:
                    err = parent.adc_topk_windows_launch(
                        tab7.data_ptr(), own.data_ptr(), codes25.data_ptr(), filled.data_ptr(),
                        starts.data_ptr(), n_valid.data_ptr(), own.data_ptr(), no_lb.data_ptr(),
                        no_b.data_ptr(), sq.data_ptr(), ov.data_ptr(), oi.data_ptr(),
                        os_.data_ptr(), filled.shape[0], p, p * win, w, a, 1, 0, kg, bn, 1,
                        stream())
                if err:
                    raise RuntimeError(f"parent {scan}: cudaError_t {err}")

            def port25(scan=scan):
                ov, oi, os_ = o25["new"]
                sq.fill_(torch.inf)
                if scan == "tiles":
                    k_topk.launch(tab7, own, codes25, order, t0, t1, blk, row0, n_valid, own,
                                  no_lb, no_b, sq, ov, oi, os_, kg, bn, plan=plan25)
                else:
                    k_topk.launch_windows(tab7, own, codes25, filled, starts, n_valid, own,
                                          no_lb, no_b, sq, ov, oi, os_, kg, bn, plan=plan25)

            builds = {"parent": (port_lib, par25), "port": (port_lib, port25)}
            builds.update({v: (lib, port25) for v, lib in variants.items()})
            row = dict(ms=timed(builds, args.reps))
            # one instrumented parent call: which block ran which pair, when
            read = getattr(parent, f"inplace_read_{scan}")
            torch.cuda.synchronize()
            read(rec, ctypes.byref(n_rec))
            for o in o25.values():
                o[0].fill_(torch.inf)
                o[1].fill_(-1)
                o[2].zero_()
            par25()
            torch.cuda.synchronize()
            err = read(rec, ctypes.byref(n_rec))
            if err:
                raise RuntimeError(f"read: cudaError_t {err}")
            m = min(n_rec.value, 65536)
            r = np.frombuffer(rec, dtype=np.uint64).reshape(5, 65536)[:, :m].astype(np.int64)
            t_first = int(r[0].min())
            dur = r[1] - r[0]
            longest = int(dur.argmax())
            row["parent_split"] = dict(
                pairs_run=m, blocks_used=int(len(np.unique(r[2]))),
                longest_pair_ms=float(dur[longest] / 1e6), longest_pair_rows=int(r[3][longest]),
                longest_pair_block=int(r[2][longest]),
                last_end_ms=float((r[1].max() - t_first) / 1e6),
                pair_ms_sum=float(dur.sum() / 1e6))
            port25()
            torch.cuda.synchronize()
            row["same_bits"] = same(o25["old"][:2], o25["new"][:2])
            row["stats_new"] = [int(x) for x in o25["new"][2].sum(0)]
            row["stats_parent"] = [int(x) for x in o25["old"][2].sum(0)]
            line["b2" if scan == "tiles" else "b5"] = row
        print(json.dumps(line), flush=True)
        if not (b6["same_bits"] and b7["same_bits"] and line["b2"]["same_bits"]
                and line["b5"]["same_bits"]):
            raise SystemExit(f"probe_inplace: {shape}: the port disagrees with the parent")

    for shape in args.shapes.split(","):
        run_shape(shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
