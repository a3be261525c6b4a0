"""ptxas' registers and spills of every kernel the port compiles, against
another tree's (an earlier commit unpacked with `git archive`).

    python3 tools/compare_ptxas.py --parent-root build/parent_tree

Run from the repo root on a machine with nvcc.  It compiles each
`src/repro_torch/csrc/*.cu` of both trees with the port's nvcc flags
(`-Xptxas -v`; one nvcc per source, all in parallel, objects under
`build/compare_ptxas/`), keys every kernel by its mangled name with the
translation unit's hash and a template's parameter list taken out (a
kernel whose arguments changed is still the same instance), and prints one
JSON line: the kernels
of both trees whose registers, spill stores or spill loads agree, those
that differ (each with both reports), and those only one tree has (each
with its report, so an instance whose template arguments changed can be
matched by hand).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def report(csrc: pathlib.Path, out: pathlib.Path) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)

    def one(src):
        return subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-c", str(src), "-o",
                               str(out / f"{src.stem}.o")], capture_output=True, text=True)

    srcs = sorted(csrc.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        done = list(pool.map(one, srcs))
    kernels, name, spill = {}, None, ""
    for src, d in zip(srcs, done):
        if d.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{d.stdout}{d.stderr}")
        for ln in (d.stdout + d.stderr).splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                name = re.sub(r"_cu_[0-9a-f]{8}|__[0-9a-f]{8}_", "_", m.group(1))
                # a template's arguments name it; its parameter list may change
                name = re.sub(r"(I.*?E)Ev.*$", r"\1", name)
            elif name and "spill stores" in ln:
                spill = ln.split("ptxas info    :")[-1].strip()
            elif name and "Used" in ln and "registers" in ln:
                regs = re.search(r"Used \d+ registers", ln).group(0)
                kernels[name] = f"{regs}; {spill}"
                name = None
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-root", required=True, help="a tree with src/repro_torch/csrc")
    args = ap.parse_args()
    work = ROOT / "build" / "compare_ptxas"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        new_f = pool.submit(report, ROOT / "src" / "repro_torch" / "csrc", work / "new")
        old_f = pool.submit(report, pathlib.Path(args.parent_root) / "src" / "repro_torch" / "csrc",
                            work / "parent")
        new, old = new_f.result(), old_f.result()
    both = sorted(set(new) & set(old))
    print(json.dumps(dict(
        probe="compare_ptxas", kernels_same=sum(new[k] == old[k] for k in both),
        kernels_differ={k: dict(parent=old[k], new=new[k]) for k in both if new[k] != old[k]},
        only_parent={k: old[k] for k in sorted(set(old) - set(new))},
        only_new={k: new[k] for k in sorted(set(new) - set(old))})))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
