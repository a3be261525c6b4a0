#!/usr/bin/env python3
"""Time the latency-bound kernels B3 (exact re-rank) and B1's wide kernel
(dsub > 32) alone, warm and cold, beside another build of them (the
earlier designs of commit e38a342, or any sources with their C interface).

    python3 tools/bench_rerank_lut.py [--baseline-dir DIR] [--store-rows 25000000]
                                      [--reps 20] [--seed 0] [--probe [NAME ...]]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the port's kernels and, with `--baseline-dir`, DIR/rerank.cu and
DIR/lut_build.cu into a library of their own under build/bench_rerank_lut/.
DIR's sources must export that design's interface: `rerank_launch` with a
`block_k` and one block per (query, block_k candidates), and
`lut_build_launch` for every dsub; e.g.

    mkdir -p build/baseline && for f in rerank.cu lut_build.cu; do \\
        git show e38a342:src/repro_torch/csrc/$f > build/baseline/$f; done

On data made on the card from `--seed` it checks every build against the
plain version (bit-equal) and times, in turns (baseline, port, port,
baseline):

  * B3 at the main path's shape: 1000 queries x k' 64 candidates, D 128,
    a bf16 store of `--store-rows` rows in 8 devices' shards, ids at
    random (some -1 and unmapped);
  * B3 at the LM retrieval's shape: 4 queries x 64 candidates, D 4096, an
    f32 store of 20,000 rows (the engine's), and the same with a bf16 store;
  * B1's wide kernel at the LM retrieval's shape: 32 pairs, M = 8, dsub 512;

each warm (CUDA events over `--reps` launches back to back from Python on
the same inputs: `chip_smoke.cuda_ms`, the smoke's `ms`), queued (the same
launches queued behind a device-side spin, so no host gap is timed: the
smoke's `queued_ms`), cold (each launch its own event pair, after a 256 MB
write that evicts the L2) and sustained (100 launches in a CUDA graph
replayed for 1 s, with the median SM clock nvidia-smi read meanwhile),
beside the byte / FP32 bound.  With `--probe` it builds edited copies of
the port's sources under build/bench_rerank_lut/ (all of PROBES, or the
ones named) and times each at the production plans in turns with the port
(port, probe, probe, port), warm, queued and cold: no arithmetic
(`nocompute`), no copies into shared memory (`nocopy`), a return at entry
(`noop`: the launch alone), a return after the id rounds (`ids`), plain
16-byte loads and stores instead of `cp.async` (`plaincopy`), and B3's
bounds-checked body where the bound-free one runs (`nofull`).  Only
`nofull` computes the same function; its results are checked, the others'
are not.  Prints the card's name
and power limit, the ptxas lines (registers, spills, shared memory) of the
port's two kernels and one JSON line per case; exits non-zero without a
GPU, or after the timings when a build disagreed with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of the baseline sources
BASELINE_SIGNATURES = {
    # queries, cand, id_dev, id_row, row_base, vectors, out, q, k, d, ids_cap,
    # vec_is_bf16, block_k, stream
    "rerank_launch": [_P] * 7 + [_I] * 6 + [_P],
    # codebook, qmc, rows (may be null), out, n_pairs, m, dsub, stream
    "lut_build_launch": [_P] * 4 + [_I] * 3 + [_P],
}


def build_baseline(src_dir: pathlib.Path):
    """(ctypes library of src_dir's two sources, ptxas report)."""
    from repro_torch.kernels import _build

    srcs = [src_dir / "rerank.cu", src_dir / "lut_build.cu"]
    h = hashlib.sha256()
    for p in sorted(src_dir.glob("*.cu*")):
        h.update(p.read_bytes())
    out_dir = ROOT / "build" / "bench_rerank_lut"
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


# --probe: edits of the port's sources, each (file, old text, new text)
PROBES = {
    "nocompute": [
        ("lut_build.cu", "    if (computes) {\n      const float* base",
         "    if (computes && dsub < 0) {\n      const float* base"),
        ("rerank.cu", "      if (i >= i0 && i < i1 && i < mine && s_row[j] >= 0) {",
         "      if (i >= i0 && i < i1 && i < mine && s_row[j] >= 0 && D < 0) {"),
    ],
    "noop": [
        ("lut_build.cu", "  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n"
         "  if (dsub > 0) return;\n"),
        ("rerank.cu", "  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n"
         "  if (D > 0) return;\n"),
    ],
    "ids": [("rerank.cu", "row_base[dev]) + rr;\n  __syncthreads();\n",
             "row_base[dev]) + rr;\n  __syncthreads();\n  if (D > 0) return;\n")],
    "nocopy": [("async_copy.cuh", "  switch (g) {\n    case 16:",
                "  if (g > 0) return;\n  switch (g) {\n    case 16:")],
    "plaincopy": [("async_copy.cuh", "  switch (g) {\n    case 16:",
                   "  if (g == 16) {\n    *static_cast<uint4*>(dst) = "
                   "*static_cast<const uint4*>(src);\n    return;\n  }\n"
                   "  switch (g) {\n    case 16:")],
    "nofull": [("rerank.cu", "const bool full = d == 32 * per && per % pc == 0;",
                "const bool full = false;")],
}
# probes that compute the kernels' function (their results are checked)
EXACT_PROBES = ("nofull",)


def build_probe(name: str):
    """ctypes library of csrc/rerank.cu and lut_build.cu with PROBES[name]
    applied, bound with the port's signatures."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "bench_rerank_lut" / f"probe_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in ("rerank.cu", "lut_build.cu", "async_copy.cuh"):
        (out_dir / f).write_text((_build.CSRC / f).read_text())
    for f, old, new in PROBES[name]:
        text = (out_dir / f).read_text()
        if old not in text:
            raise RuntimeError(f"probe {name}: {f} no longer holds {old!r}")
        (out_dir / f).write_text(text.replace(old, new))
    lib = out_dir / "libprobe.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                        str(out_dir / "rerank.cu"), str(out_dir / "lut_build.cu"),
                        "-o", str(lib)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on probe {name}:\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn in ("rerank_launch", "lut_build_wide_launch"):
        getattr(dll, fn).argtypes = _build.SIGNATURES[fn]
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def ptxas_lines(report: str, kernels: tuple) -> dict:
    """{kernel entry (mangled): ptxas's 'Used ...' line} for entries whose
    name holds one of `kernels`: registers, barriers, static shared memory
    (the launch plans add the dynamic part), and the spill line before it."""
    out, name, spill = {}, None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in kernels) else None
        elif name and "spill stores" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out[name] = ln.split("ptxas info    :")[-1].strip() + "; " + spill
            name = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-dir", type=pathlib.Path, default=None,
                    help="directory with rerank.cu and lut_build.cu of the baseline interface")
    ap.add_argument("--store-rows", type=int, default=25_000_000,
                    help="rows of the main-path B3 store (bf16, D 128)")
    ap.add_argument("--reps", type=int, default=20, help="launches per timed turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", nargs="*", default=None, choices=sorted(PROBES),
                    help="also time edited copies of the kernels (all, or the ones named)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_rerank_lut: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import lut_build as k_lut
    from repro_torch.kernels import rerank as k_rerank

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.log(phase="gpu", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    _build.library()
    cs.log(phase="port_build", ptxas=ptxas_lines(
        _build.ptxas_report(), ("rerank_kernel", "lut_build_wide_kernel")))
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    dll = None
    if args.baseline_dir is not None:
        dll, report = build_baseline(args.baseline_dir)
        cs.log(phase="baseline_build", source=str(args.baseline_dir),
               ptxas=ptxas_lines(report, ("rerank_kernel", "lut_build_wide_kernel")))
    failed = []
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def sustained(fn, n: int = 100, min_ms: float = 1000.0) -> list:
        """[ms a launch, SM MHz (median sample)] with `n` launches captured in
        a CUDA graph and replayed for at least `min_ms`: the card busy with
        no host gaps, so that its clock has risen (short, sparse launches
        may run below it)."""
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(n):
                    fn()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        est = cs.cuda_ms(torch, graph.replay, 2)
        reps = max(3, int(min_ms / max(est, 1e-3)) + 1)
        clocks = cs.SmClock()
        try:
            ms = cs.cuda_ms(torch, graph.replay, reps)
        finally:
            clocks.stop()
        return [ms / n, sorted(clocks.samples)[len(clocks.samples) // 2]]

    def with_library(dll, fn):
        """fn() with the port's launchers bound to `dll`."""
        real = _build.library
        _build.library = lambda: dll
        try:
            return fn()
        finally:
            _build.library = real

    def turns(builds: dict, other: str = "baseline", libs: dict | None = None,
              sustain: bool = True) -> dict:
        """Each build timed in turns (other, port, port, other), each under
        the port's launcher bound to libs[label] where given."""
        order = [other, "port", "port", other] if other in builds else ["port"] * 2
        got = {"warm": [], "queued": [], "cold": []} | ({"sustained": []} if sustain else {})
        for label in order:
            def timed(label=label):
                fn = builds[label]
                got["warm"].append((label, cs.cuda_ms(torch, fn, args.reps)))
                got["queued"].append((label, cs.cuda_ms(torch, fn, args.reps, queued=True)))
                got["cold"].append((label, cs.cold_ms(torch, fn, args.reps)))
                if sustain:
                    got["sustained"].append((label, *sustained(fn)))
            with_library(libs[label], timed) if libs and label in libs else timed()
        mean = {kind: {label: sum(t[1] for t in v if t[0] == label) / order.count(label)
                       for label in builds} for kind, v in got.items()}
        return dict(turns_ms=got, mean_ms=mean)

    def check(name, label, got, want):
        ok = torch.equal(got, want)
        if not ok:
            failed.append(f"{label} ({name})")
        return ok

    # -- B3 ---------------------------------------------------------------
    names = (args.probe or sorted(PROBES)) if args.probe is not None else []
    probes = {name: build_probe(name) for name in names}
    # the floor of this timing: a 1 KB PyTorch op
    tiny = torch.zeros(256, device=dev)
    cs.log(phase="floor", warm_ms=cs.cuda_ms(torch, lambda: tiny.add_(1.0), args.reps),
           queued_ms=cs.cuda_ms(torch, lambda: tiny.add_(1.0), args.reps, queued=True),
           cold_ms=cs.cold_ms(torch, lambda: tiny.add_(1.0), args.reps), nvidia_smi=smi)

    def probe_turns(name, build, out, want) -> dict:
        """{probe: turns with the port} for every probe, `build` launching
        into `out`; the exact probes' results held against `want`."""
        res = {}
        for label, lib in probes.items():
            if label in EXACT_PROBES:
                out.fill_(float("nan"))
                with_library(lib, build)
                check(name, f"probe {label}", out, want)
            res[label] = turns({"port": build, label: build}, other=label, libs={label: lib},
                               sustain=False)["mean_ms"]
        return res

    def rerank_case(name, q_n, kc, d, rows, ndev, dtype):
        if dtype == torch.bfloat16:  # bf16 store filled in slices (no f32 copy of it)
            vectors = torch.empty(rows, d, dtype=dtype, device=dev)
            for s in range(0, rows, 1 << 22):
                vectors[s: s + (1 << 22)] = torch.randn(
                    min(1 << 22, rows - s), d, device=dev, generator=gen)
        else:
            vectors = torch.randn(rows, d, device=dev, generator=gen)
        ids_cap = rows + rows // 50
        id_dev = torch.full((ids_cap,), -1, dtype=torch.int32, device=dev)
        id_row = torch.zeros(ids_cap, dtype=torch.int32, device=dev)
        mapped = torch.randperm(ids_cap, device=dev, generator=gen)[:rows]
        slot = torch.arange(rows, device=dev)
        id_dev[mapped] = (slot % ndev).int()
        id_row[mapped] = (slot // ndev).int()
        row_base = (torch.arange(ndev, device=dev) * -(-rows // ndev)).long()
        queries = torch.randn(q_n, d, device=dev, generator=gen)
        cand = torch.randint(0, ids_cap, (q_n, kc), device=dev, generator=gen).int()
        cand[:, -1] = -1
        args_ = (queries, cand, vectors, id_dev, id_row, row_base)
        want = k_rerank.rerank_dists_plain(*args_, 16)
        outs = {label: torch.empty_like(want) for label in ("port", "baseline")}
        builds = {"port": lambda: k_rerank.launch(*args_, outs["port"], 0)}
        if dll is not None:
            def base():
                err = dll.rerank_launch(
                    queries.data_ptr(), cand.data_ptr(), id_dev.data_ptr(), id_row.data_ptr(),
                    row_base.data_ptr(), vectors.data_ptr(), outs["baseline"].data_ptr(),
                    q_n, kc, d, ids_cap, int(dtype == torch.bfloat16), 0, stream())
                _build.check(err, "baseline rerank")
            builds["baseline"] = base
        equal = {}
        for label, fn in builds.items():
            fn()
            equal[label] = check(name, label, outs[label], want)
        res = turns(builds)
        n_c = cand.numel()
        cs.log(phase=name, queries=q_n, candidates=kc, dim=d, store_rows=rows, devices=ndev,
               store=str(dtype).replace("torch.", ""), equal_to_plain=equal, **res,
               bound_ms=cs.bound_ms(n_c * (d * vectors.element_size() + 16) + queries.numel() * 4,
                                    3 * n_c * d),
               plan=k_rerank.launch_plan(q_n, kc, d, vectors.element_size(), n_sm),
               nvidia_smi=smi)
        if probes:  # edited copies of the port's kernel at the same plan
            cs.log(phase=name + "_probe", mean_ms=probe_turns(
                name, builds["port"], outs["port"], want), nvidia_smi=smi)
        del vectors, id_dev, id_row, want
        torch.cuda.empty_cache()

    rerank_case("b3_main", 1000, 64, 128, args.store_rows, 8, torch.bfloat16)
    rerank_case("b3_lm", 4, 64, 4096, 20_000, 1, torch.float32)
    rerank_case("b3_lm_bf16", 4, 64, 4096, 20_000, 1, torch.bfloat16)
    if probes:  # one block's latency: B3 at 1, 8 and 132 queries (a block each)
        for q_n in (1, 8, 132):
            rerank_case(f"b3_q{q_n}", q_n, 64, 128, 2_500_000, 8, torch.bfloat16)

    # -- B1, wide: the LM retrieval's 32 pairs, M = 8, dsub 512 -------------
    m, dsub, n_pairs = 8, 512, 32
    cb = torch.randn(m, 256, dsub, device=dev, generator=gen)
    qmc = torch.randn(n_pairs, m, dsub, device=dev, generator=gen)
    rows = torch.arange(n_pairs, dtype=torch.int32, device=dev)
    want = k_lut.build_luts_plain(cb, qmc)
    outs = {label: torch.empty_like(want) for label in ("port", "baseline")}
    builds = {"port": lambda: k_lut.launch(cb, qmc, outs["port"], rows)}
    if dll is not None:
        def lut_base():
            err = dll.lut_build_launch(cb.data_ptr(), qmc.data_ptr(), rows.data_ptr(),
                                       outs["baseline"].data_ptr(), n_pairs, m, dsub, stream())
            _build.check(err, "baseline lut_build")
        builds["baseline"] = lut_base
    equal = {}
    for label, fn in builds.items():
        fn()
        equal[label] = check("b1_wide", label, outs[label], want)
    res = turns(builds)
    if probes:
        cs.log(phase="b1_wide_probe", mean_ms=probe_turns(
            "b1_wide", builds["port"], outs["port"], want), nvidia_smi=smi)
    n_lut = want.numel()
    cs.log(phase="b1_wide", pairs=n_pairs, m=m, dsub=dsub, equal_to_plain=equal, **res,
           bound_ms=cs.bound_ms(4 * (cb.numel() + qmc.numel() + n_pairs + n_lut),
                                3 * n_lut * dsub),
           plan=k_lut.wide_plan(n_pairs, m, dsub, n_sm), nvidia_smi=smi)
    print(smi, flush=True)
    if failed:
        print(f"bench_rerank_lut: disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
