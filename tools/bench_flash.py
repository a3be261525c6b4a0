#!/usr/bin/env python3
"""Time kernel B10 alone at the smoke's prefill shape, beside another build
of the same C interface (an earlier design of `csrc/flash_attn.cu`).

    python3 tools/bench_flash.py [--baseline OTHER_flash_attn.cu] [--reps 10] [--seed 0]

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
It builds the port's kernels and, with `--baseline`, that source (which
must export `flash_attn_launch` with the C signature `csrc/flash_attn.cu`
had before its general kernel, `BASELINE_SIGNATURE`: the port's without its
last int, now the kernel `variant`, once a `general` flag) into a library of its
own under build/bench_flash/.  At `chip_smoke.py`'s B10 shape (q
(4, 2048, 32, 128), k / v (4, 2560, 8, 128) f32, kv_valid 2048, the same
seed) it holds each build to the smoke's tolerances, for a bf16 and an f32
q: against the plain version with normal scores, against float64 with
peaked ones (largest live logit 30).  It reports the share of the
tolerance each build and the plain version use against float64, then
times the builds in turns (baseline, port, port, baseline) with CUDA
events, beside the FP32 and tensor-core bounds.  Prints the card's name
and power limit and one JSON line per phase; exits non-zero without a
GPU, or after the timings when a build disagreed with its reference.
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

# flash_attn_launch before PR 27: q, k, v, out, b, sq, sk, h, kvh, hd,
# q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, stream
BASELINE_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                    ctypes.c_void_p]


def build_baseline(src: pathlib.Path):
    """(flash_attn_launch of `src` built into its own library, ptxas report)."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "bench_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libbaseline-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", str(src), "-o",
                        str(lib)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).flash_attn_launch
    fn.argtypes = BASELINE_SIGNATURE
    fn.restype = ctypes.c_int
    return fn, r.stdout + r.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="CUDA source exporting flash_attn_launch (BASELINE_SIGNATURE)")
    ap.add_argument("--reps", type=int, default=10, help="launches per timed turn")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_flash: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as k_flash

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.log(phase="gpu", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    _build.library()
    dev = torch.device("cuda")
    h, kvh, hd, kv_valid = 32, 8, 128, cs.LM_PROMPT
    scale = hd**-0.5
    q, k, v = cs.flash_inputs(torch, dev, args.seed, h, kvh, hd)
    builds = {"port": k_flash.launch}
    if args.baseline is not None:
        fn, report = build_baseline(args.baseline)

        def baseline(q_, k_, v_, out, scale_, q_offset, kv_valid_):
            b, sq, h_, hd_ = q_.shape
            err = fn(q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), out.data_ptr(), b, sq,
                     k_.shape[1], h_, k_.shape[2], hd_, q_offset, kv_valid_,
                     int(q_.dtype == torch.bfloat16), int(k_.dtype == torch.bfloat16),
                     float(scale_), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "baseline flash_attn")

        builds = {"baseline": baseline, "port": k_flash.launch}
        cs.log(phase="baseline_build", source=str(args.baseline),
               ptxas=cs.ptxas_summary(report))
    cs.log(phase="port_kernel", kernel_bf16_q=k_flash.kernel_attributes(hd, torch.bfloat16,
                                                                        torch.float32),
           kernel_f32_q=k_flash.kernel_attributes(hd, torch.float32, torch.float32))

    qf = q.float()
    cases = [("bf16_q", q, cs.FLASH_BF16_TOL), ("f32_q", qf, cs.FLASH_F32_TOL)]
    cases += [(f"{name}_peaked", cs.peak_queries(torch, qx, k, scale, kv_valid), tol)
              for name, qx, tol in cases]
    failed = []
    for name, qx, tol in cases:
        want = k_flash.flash_attention_fwd_plain(qx, k, v, scale, 0, kv_valid, 512, 512)
        exact = cs.flash_exact(torch, qx, k, v, scale, kv_valid)
        f32_exact = exact.to(qx.dtype)  # the f64 result in q's dtype
        # as the smoke: normal scores against the plain version, peaked ones
        # against float64 (the plain version's own rounding exceeds the
        # f32 tolerance there)
        ref = f32_exact if name.endswith("peaked") else want
        errs, within, ratio = {}, {}, {}
        vs_exact = {"plain": cs.tol_ratio(want, f32_exact, tol)}
        for label, launch in builds.items():
            out = torch.empty_like(qx)
            launch(qx, k, v, out, scale, 0, kv_valid)
            torch.cuda.synchronize()
            errs[label] = float((out.float() - ref.float()).abs().max())
            within[label] = bool(torch.allclose(out.float(), ref.float(), **tol))
            ratio[label] = cs.tol_ratio(out, want, tol)
            vs_exact[label] = cs.tol_ratio(out, f32_exact, tol)
            if not within[label]:
                failed.append(f"{label} ({name})")
        cs.log(phase="check", case=name, max_abs_err=errs, within_tolerance=within,
               tolerance=tol, tolerance_used_vs_plain=ratio,
               tolerance_used_vs_f64=vs_exact)
        del want, exact, f32_exact

    for name, qx, _ in cases[:2]:
        out = torch.empty_like(qx)
        order = (["baseline", "port", "port", "baseline"] if "baseline" in builds
                 else ["port", "port"])
        turns = [(label, cs.cuda_ms(torch, lambda f=builds[label]: f(
            qx, k, v, out, scale, 0, kv_valid), args.reps)) for label in order]
        mean = {label: sum(ms for lb, ms in turns if lb == label) / order.count(label)
                for label in builds}
        _, fmas, n_bytes = cs.flash_work(qx, kv_valid, kvh)
        passes = k_flash.tf32_passes(qx.dtype, k.dtype)
        cs.log(phase="time", case=name, turns_ms=turns, mean_ms=mean,
               bound_fp32_ms=cs.bound_ms(n_bytes, fmas)[0],
               bound_tc_ms=cs.flash_bound_tc_ms(n_bytes, fmas, passes)[0],
               tf32_passes=passes, nvidia_smi=smi)
    print(smi, flush=True)
    if failed:
        print(f"bench_flash: disagrees with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
