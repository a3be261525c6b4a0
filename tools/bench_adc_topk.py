#!/usr/bin/env python3
"""Time the unpruned top-k scans B6 and B7 alone, beside another build of
them (the earlier split-and-reduce design of commit b47ed91, or any sources
with its C interface).

    python3 tools/bench_adc_topk.py [--baseline-dir DIR] [--n 100000000] [--reps 10]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the port's kernels and, with `--baseline-dir`, DIR/adc_topk.cu
and DIR/adc_topk_pairs.cu (beside their headers; every `*.cu` in DIR, so
a later design's adc_topk_g1.cu too) into a library of their own under
build/bench_adc_topk/.  DIR's sources must export that design's
interface: `adc_topk_launch` with caller-allocated split lists and reduce
buffers, and `adc_topk_pairs_launch` with one block per pair; e.g.

    mkdir -p build/baseline && for f in adc_topk.cu adc_topk_pairs.cu \\
        adc_topk_common.cuh; do git show b47ed91:src/repro_torch/csrc/$f \\
        > build/baseline/$f; done

On synthetic data made on the card from `--seed` -- N uniform raw uint8
codes of width 16, tables of uniform entries (M = 16, 4096 wide) -- it
checks every build against the plain version and times, in turns
(baseline, port, port, baseline, CUDA events over at least `--reps` calls
and 500 ms of work each):

  * B6 at Q = 1, 4, 8 and 16 tables, k = 10, and at Q = 1, k = 1, 100,
    1024 and 4096, over all N rows;
  * B6 as the flat search calls it: 136 groups of rows (lognormal sizes,
    6.6M rows in all) with 1,024 tables among them, one grouped launch
    against one baseline launch per group;
  * B7 on 64 windows of 259,072 int32 addresses (one full, the rest with
    5.1M valid rows among them), k = 64;

beside the byte / FP32 bound and the lookup bound at the SM clock read
while timing.  Prints the card's name and power limit and one JSON line per
phase; exits non-zero without a GPU, or after the timings when a build
disagreed with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interface of the baseline sources (the split-and-reduce design)
BASELINE_SIGNATURES = {
    # tables, codes, bound, part_v, part_i, tmp_v, tmp_i, out_v, out_i, n_q,
    # n_splits, tiles_per_split, n_rows, w, table_width, code_fmt, k, block_n, stream
    "adc_topk_launch": [_P] * 9 + [_I] * 9 + [_P],
    # tables, addrs, n_valid, out_v, out_i, n_pairs, win_len, w, table_width,
    # code_fmt, k, block_n, stream
    "adc_topk_pairs_launch": [_P] * 5 + [_I, _L, _I, _I, _I, _I, _I, _P],
}
BASELINE_BLOCKS, BASELINE_FAN = 2048, 32  # its split target and reduce fan-in


def build_baseline(src_dir: pathlib.Path):
    """(ctypes library of src_dir's two sources, ptxas report)."""
    from repro_torch.kernels import _build

    srcs = sorted(src_dir.glob("*.cu"))  # adc_topk.cu, adc_topk_pairs.cu (+ adc_topk_g1.cu)
    h = hashlib.sha256()
    for p in sorted(src_dir.glob("*.cu*")):
        h.update(p.read_bytes())
    out_dir = ROOT / "build" / "bench_adc_topk"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libbaseline-{h.hexdigest()[:16]}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", *map(str, srcs),
                        "-o", str(lib)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in BASELINE_SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll, r.stdout + r.stderr


def baseline_topk(torch, dll, dev):
    """The baseline's B6 launcher (its splits, its scratch allocated per call)."""
    from repro_torch.kernels import _build

    def launch(tables, codes, out_v, out_i, k, block_n):
        q_n, n = tables.shape[0], codes.shape[0]
        n_tiles = -(-n // block_n)
        want = max(1, min(n_tiles, -(-BASELINE_BLOCKS // max(q_n, 1))))
        per = -(-n_tiles // want)
        splits = -(-n_tiles // per)
        scratch = [None] * 4
        if splits > 1:
            n_tmp = q_n * -(-splits // BASELINE_FAN) * k
            scratch = [torch.empty(q_n * splits * k, device=dev),
                       torch.empty(q_n * splits * k, dtype=torch.int32, device=dev),
                       torch.empty(n_tmp, device=dev),
                       torch.empty(n_tmp, dtype=torch.int32, device=dev)]
        err = dll.adc_topk_launch(
            tables.data_ptr(), codes.data_ptr(), None,
            *[None if t is None else t.data_ptr() for t in scratch], out_v.data_ptr(),
            out_i.data_ptr(), q_n, splits, per, n, codes.shape[1], tables.shape[1], 0, k,
            block_n, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "baseline adc_topk")

    return launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-dir", type=pathlib.Path, default=None,
                    help="directory with adc_topk.cu, adc_topk_pairs.cu of the baseline interface")
    ap.add_argument("--n", type=int, default=100_000_000, help="code rows of the B6 cases")
    ap.add_argument("--reps", type=int, default=10, help="calls per timed turn")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_adc_topk: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import adc_topk as k_topk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.log(phase="gpu", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    _build.library()
    cs.log(phase="port_build", ptxas={n: v for n, v in cs.ptxas_summary(
        _build.ptxas_report()).items() if n.startswith("adc_topk_kernel")
        or n.startswith("adc_topk_pairs_kernel")})
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    m, bn = 16, 1024
    dll = None
    if args.baseline_dir is not None:
        dll, report = build_baseline(args.baseline_dir)
        cs.log(phase="baseline_build", source=str(args.baseline_dir),
               ptxas=cs.ptxas_summary(report))
    failed = []

    def turns(builds: dict, reps: int) -> tuple[list, dict, float]:
        order = ["baseline", "port", "port", "baseline"] if "baseline" in builds else ["port"] * 2
        got = [(label, *cs.clocked_ms(torch, builds[label], reps, 500.0)) for label in order]
        mean = {label: sum(t[1] for t in got if t[0] == label) / order.count(label)
                for label in builds}
        # the lookup bound at the clock the port's turns ran at
        return [t[:2] for t in got], mean, max(t[2] for t in got if t[0] == "port")

    def check(name, label, got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            failed.append(f"{label} ({name})")
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    # -- B6 over all rows -------------------------------------------------
    codes = torch.randint(0, 256, (args.n, m), device=dev, generator=gen).to(torch.uint8)
    tables = torch.rand(16, m * 256, device=dev, generator=gen)
    for q_n, k in ((1, 10), (4, 10), (8, 10), (16, 10), (1, 1), (1, 100), (1, 1024), (1, 4096)):
        tab = tables[:q_n].contiguous()
        inf = torch.full((q_n,), torch.inf, device=dev)
        want = k_topk.adc_topk_plain(tab, codes, inf, k, bn)
        g = k_topk.topk_group_size([q_n], [args.n], k, 0, m, tab.shape[1])
        outs = {}
        builds = {"port": lambda tab=tab, g=g: k_topk.launch_topk(
            tab, codes, None, *outs["port"], k, bn, g)}
        if dll is not None:
            launch = baseline_topk(torch, dll, dev)
            builds["baseline"] = lambda tab=tab: launch(tab, codes, *outs["baseline"], k, bn)
        equal = {}
        for label, fn in builds.items():
            outs[label] = (torch.full((q_n, k), torch.inf, device=dev),
                           torch.full((q_n, k), -1, dtype=torch.int32, device=dev))
            fn()
            equal[label] = check(f"b6 q={q_n}", label, outs[label], want)
        got, mean, sm_mhz = turns(builds, args.reps)
        cs.log(phase="b6", queries=q_n, k=k, rows=args.n, tables_per_block=g,
               equal_to_plain=equal, turns_ms=got, mean_ms=mean,
               bound_ms=cs.bound_ms(args.n * m + tab.numel() * 4 + q_n * k * 8,
                                    q_n * args.n * m),
               lookup_bound_ms=q_n * args.n * m / (n_sm * 32 * sm_mhz * 1e6) * 1e3,
               sm_clock_mhz=sm_mhz, nvidia_smi=smi)
        del want
    del codes
    torch.cuda.empty_cache()

    k = 10
    # -- B6 as the flat search calls it: 136 groups, 1,024 tables ---------
    rng = np.random.default_rng(args.seed)
    sizes = np.minimum(rng.lognormal(np.log(24_000), 1.0, 136), 259_072).astype(np.int64)
    sizes = (sizes * (6_590_952 / sizes.sum())).astype(np.int64)
    n_tab = 1 + rng.multinomial(1024 - 136, np.full(136, 1 / 136))
    r_off = np.concatenate([[0], np.cumsum(sizes)])
    t_off = np.concatenate([[0], np.cumsum(n_tab)])
    codes = torch.randint(0, 256, (int(r_off[-1]), m), device=dev, generator=gen).to(torch.uint8)
    tab = torch.rand(int(t_off[-1]), m * 256, device=dev, generator=gen)
    inf = torch.full((tab.shape[0],), torch.inf, device=dev)
    want = k_topk.adc_topk_grouped_plain(tab, codes, inf, k, bn, r_off, t_off)
    g = k_topk.topk_group_size(n_tab, sizes, k, 0, m, tab.shape[1])
    units = k_topk.topk_units(r_off, t_off, g).to(dev)
    outs = {label: (torch.full((tab.shape[0], k), torch.inf, device=dev),
                    torch.full((tab.shape[0], k), -1, dtype=torch.int32, device=dev))
            for label in ("port", "baseline")}
    builds = {"port": lambda: k_topk.launch_topk(tab, codes, None, *outs["port"], k, bn, g,
                                                 units)}
    if dll is not None:
        launch = baseline_topk(torch, dll, dev)
        views = [(tab[t0:t1], codes[r0:r1], outs["baseline"][0][t0:t1],
                  outs["baseline"][1][t0:t1])
                 for r0, r1, t0, t1 in zip(r_off[:-1], r_off[1:], t_off[:-1], t_off[1:])]

        def per_group():
            for tv, cv, ov, oi in views:
                launch(tv, cv, ov, oi, k, bn)

        builds["baseline"] = per_group
    equal = {label: check("b6 grouped", label, (fn(), outs[label])[1], want)
             for label, fn in builds.items()}
    got, mean, sm_mhz = turns(builds, args.reps)
    lookups = int((n_tab * sizes).sum()) * m
    cs.log(phase="b6_grouped", groups=136, rows=int(r_off[-1]), tables=int(t_off[-1]), k=k,
           tables_per_block=g, units=int(units.shape[0]), launches={"port": 1, "baseline": 136},
           equal_to_plain=equal, turns_ms=got, mean_ms=mean,
           bound_ms=cs.bound_ms(int(r_off[-1]) * m + tab.numel() * 4 + tab.shape[0] * k * 8,
                                lookups),
           lookup_bound_ms=lookups / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
           nvidia_smi=smi)
    # the same groups at G = 1, and at k = 1 (fewer merges): where the time goes
    probe = {}
    for label, gg, kk in (("g1_k10", 1, k), ("g4_k1", 4, 1), ("g1_k1", 1, 1)):
        uu = k_topk.topk_units(r_off, t_off, gg).to(dev)
        ov = torch.empty((tab.shape[0], kk), device=dev)
        oi = torch.empty((tab.shape[0], kk), dtype=torch.int32, device=dev)
        probe[label] = cs.clocked_ms(torch, lambda: k_topk.launch_topk(
            tab, codes, None, ov, oi, kk, bn, gg, uu), args.reps, 300.0)[0]
    # and one group of 8 (or 1) tables over all of these rows, at this scale
    for label, qq, gg in (("one_group_q8", 8, 4), ("one_group_q1", 1, 1)):
        ov = torch.empty((qq, k), device=dev)
        oi = torch.empty((qq, k), dtype=torch.int32, device=dev)
        probe[label] = cs.clocked_ms(torch, lambda: k_topk.launch_topk(
            tab[:qq], codes, None, ov, oi, k, bn, gg), args.reps, 300.0)[0]
    cs.log(phase="b6_grouped_probe", port_ms=probe, nvidia_smi=smi)
    del codes, tab, want
    torch.cuda.empty_cache()

    # -- B7: 64 windows of int32 addresses, one full ----------------------
    p, win, kp = 64, 259_072, 64
    a = m * 256
    n_valid_np = np.minimum(rng.lognormal(np.log(60_000), 0.8, p), win).astype(np.int32)
    n_valid_np[0] = win
    n_valid = torch.as_tensor(n_valid_np, device=dev)
    tables = torch.rand(p, a, device=dev, generator=gen)
    addrs = torch.randint(0, a, (p, win, m), device=dev, generator=gen, dtype=torch.int32)
    want = k_topk.adc_topk_pairs_plain(tables, addrs, n_valid, kp)
    outs = {label: (torch.full((p, kp), torch.inf, device=dev),
                    torch.full((p, kp), -1, dtype=torch.int32, device=dev))
            for label in ("port", "baseline")}
    builds = {"port": lambda: k_topk.launch_pairs(tables, addrs, n_valid, *outs["port"], kp,
                                                  bn)}
    if dll is not None:
        def pairs_baseline():
            err = dll.adc_topk_pairs_launch(
                tables.data_ptr(), addrs.data_ptr(), n_valid.data_ptr(),
                outs["baseline"][0].data_ptr(), outs["baseline"][1].data_ptr(), p, win, m, a, 2,
                kp, bn, torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "baseline adc_topk_pairs")

        builds["baseline"] = pairs_baseline
    equal = {label: check("b7", label, (fn(), outs[label])[1], want)
             for label, fn in builds.items()}
    got, mean, sm_mhz = turns(builds, args.reps)
    valid = int(n_valid_np.sum())
    cs.log(phase="b7", pairs=p, window=win, valid_rows=valid, k=kp, equal_to_plain=equal,
           turns_ms=got, mean_ms=mean,
           bound_ms=cs.bound_ms(valid * m * 4 + tables.numel() * 4 + p * (kp * 8 + 4),
                                valid * m),
           lookup_bound_ms=valid * m / (n_sm * 32 * sm_mhz * 1e6) * 1e3, sm_clock_mhz=sm_mhz,
           nvidia_smi=smi)
    print(smi, flush=True)
    if failed:
        print(f"bench_adc_topk: disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
