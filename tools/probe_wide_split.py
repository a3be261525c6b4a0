"""Where the card's time goes in a WIDE B6 block with spilled lists (the
design before the select kernels): scan and per-pass merges against the
merge tree of the runs' lists.

Usage (on the card, from the repo root):

    mkdir -p build/wide_parent && for f in adc_topk_common.cuh adc_topk_multi.cuh \\
        adc_topk_wide.cu; do git show 286c691:src/repro_torch/csrc/$f > build/wide_parent/$f; done
    python3 tools/probe_wide_split.py --parent-dir build/wide_parent

It copies those sources, stamps `%globaltimer` around each block's
`scan_run` (its rows scored and merged pass by pass into the k-entry list
in device memory) and `finish_run` (the merge tree of the runs' lists) in
`topk_multi`, builds them with nvcc into a library of their own C
interface, and runs the smoke's `adc_topk_spill` row: Q = 1, k = 8192, 2M
random raw uint8 rows of W = 16, one random table.  It prints one JSON
line: the call's event time, and per block the scan and merge-tree ns
(mean and max), the blocks' spread of start and end, and the time from
the last scan's end to the last block's end (the tree's tail).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STAMP = r'''
__device__ unsigned long long g_stamp[4][65536];  // start, end, scan ns, merge-tree ns
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
'''


def instrument(src: str) -> str:
    """The parent's adc_topk_multi.cuh with per-block stamps in topk_multi."""
    src = src.replace("namespace repro_adc {\n", "namespace repro_adc {\n" + STAMP, 1)
    scan_anchor = "      if constexpr (std::is_same<Args, WideArgs>::value) {"
    fin_anchor = "      finish_run<G>(a, s, un, c0 + j, first, last, &s_ncand, &s_last);"
    entry = "  const long long bn = a.block_n;\n\n  long long part = 0;"
    for anchor in (scan_anchor, fin_anchor, entry):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in topk_multi: {anchor!r}")
    src = src.replace(scan_anchor, "      const unsigned long long t_a = gtimer();\n" + scan_anchor)
    src = src.replace(fin_anchor, (
        "      const unsigned long long t_b = gtimer();\n" + fin_anchor +
        "\n      if (threadIdx.x == 0) {\n"
        "        g_stamp[2][blockIdx.x] += t_b - t_a;\n"
        "        g_stamp[3][blockIdx.x] += gtimer() - t_b;\n"
        "        g_stamp[1][blockIdx.x] = gtimer();\n      }"))
    src = src.replace(entry, entry.replace(
        "  long long part = 0;",
        "  if (threadIdx.x == 0) g_stamp[0][blockIdx.x] = gtimer();\n  long long part = 0;"))
    return src


READ = r'''
extern "C" int wide_split_read(unsigned long long* out, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, repro_adc::g_stamp, sizeof(unsigned long long) * 4 * 65536);
  if (e != cudaSuccess) return static_cast<int>(e);
  static unsigned long long zero[4][65536];
  return static_cast<int>(cudaMemcpyToSymbol(repro_adc::g_stamp, zero, sizeof(zero)));
}
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-dir", required=True)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--k", type=int, default=8192)
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    work = ROOT / "build" / "probe_wide_split"
    work.mkdir(parents=True, exist_ok=True)
    par = pathlib.Path(args.parent_dir)
    shutil.copy(par / "adc_topk_common.cuh", work / "adc_topk_common.cuh")
    (work / "adc_topk_multi.cuh").write_text(instrument((par / "adc_topk_multi.cuh").read_text()))
    (work / "adc_topk_wide.cu").write_text((par / "adc_topk_wide.cu").read_text() + READ)
    lib_path = work / "libwide_split.so"
    done = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                           str(work / "adc_topk_wide.cu"), "-o", str(lib_path)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(done.stdout + done.stderr)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adc_topk_wide_launch.argtypes = [P] * 12 + [L] + [I] * 12 + [P]
    lib.adc_topk_wide_blocks_per_sm.argtypes = [I] * 7
    lib.wide_split_read.argtypes = [P, I]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(28)
    n, k, w = args.rows, args.k, 16
    table = torch.rand(1, w * 256, device=dev, generator=g)
    codes = torch.randint(0, 256, (n, w), device=dev, generator=g).to(torch.uint8)
    per_sm = lib.adc_topk_wide_blocks_per_sm(0, 0, w, w * 256, k, 0, 1)
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count * per_sm
    part_v = torch.empty((n_blocks + 1) * k + n_blocks * 2 * k, device=dev)
    part_i = torch.empty_like(part_v, dtype=torch.int32)
    tickets = torch.zeros(n_blocks + 2, dtype=torch.int32, device=dev)
    out_v = torch.empty(1, k, device=dev)
    out_i = torch.empty(1, k, dtype=torch.int32, device=dev)
    stamps = (ctypes.c_ulonglong * (4 * 65536))()

    def call():
        err = lib.adc_topk_wide_launch(
            table.data_ptr(), codes.data_ptr(), None, None, None, out_v.data_ptr(),
            out_i.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), tickets.data_ptr(),
            part_v[(n_blocks + 1) * k:].data_ptr(), part_i[(n_blocks + 1) * k:].data_ptr(), 0, 1,
            1, n, w, w * 256, 0, 0, k, 1024, 0, 1, n_blocks,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch: cudaError_t {err}")

    call()
    torch.cuda.synchronize()
    lib.wide_split_read(stamps, 0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    err = lib.wide_split_read(stamps, 0)
    if err:
        raise RuntimeError(f"read: cudaError_t {err}")
    nb = min(n_blocks, -(-n // 1024))
    st = [[stamps[r * 65536 + b] for b in range(nb)] for r in range(4)]
    t0 = min(st[0])
    scan_end = max(st[0][b] + st[2][b] for b in range(nb))
    ms = lambda ns: ns / 1e6  # noqa: E731
    print(json.dumps(dict(
        probe="wide_split", card=torch.cuda.get_device_name(0), rows=n, k=k, blocks=nb,
        call_ms=start.elapsed_time(end),
        scan_ms_mean=ms(sum(st[2]) / nb), scan_ms_max=ms(max(st[2])),
        tree_ms_mean=ms(sum(st[3]) / nb), tree_ms_max=ms(max(st[3])),
        start_spread_ms=ms(max(st[0]) - t0), last_end_ms=ms(max(st[1]) - t0),
        last_scan_end_ms=ms(scan_end - t0), tree_tail_ms=ms(max(st[1]) - scan_end))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
