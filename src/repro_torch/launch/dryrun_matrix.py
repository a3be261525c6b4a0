"""Run the dry-run matrix (every arch x shape + the retrieval cells) as
parallel subprocesses; each cell writes `<out>/<cell>.json`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_matrix [--meshes card] \\
        [--out results/dryrun_torch] [--jobs 6] [--timeout 1800]

The port of `repro.launch.dryrun_matrix`.  `build_worklist` gives the
reference's jobs for the meshes asked for: with `--meshes pod,multipod`
the list equals the reference's, job for job.  On the default `card`
mesh each prefill cell also passes `--flash`, because the port serves its
prefill through kernel B10 (`serve --flash`), which the dry run counts by
the kernel's own model on the meta device.  The device name whose peaks
the cells use is resolved once here (`describe_env`) and passed to every
job, so no job touches the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def build_worklist(meshes=("card",)) -> list[list[str]]:
    from repro_torch.configs import ARCH_IDS, SHAPES

    jobs = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in meshes:
                job = ["--arch", arch, "--shape", shape, "--mesh", mesh]
                if mesh == "card" and SHAPES[shape][2] == "prefill":
                    job.append("--flash")
                jobs.append(job)
    for ds in ("sift1b", "spacev1b"):
        for mesh in meshes:
            jobs.append(["--retrieval", ds, "--mesh", mesh])
            jobs.append(["--retrieval", ds, "--mesh", mesh, "--cooc"])
    return jobs


def longest_first(work: list[list[str]]) -> list[list[str]]:
    """`work` reordered so the slowest traces start first: decode cells of
    the sub-quadratic archs at 524k positions (their attention scans 512
    KV chunks a layer), then the other decodes, train, prefill, then the
    closed-form and skipped cells; more layers first within a kind."""
    from repro_torch.configs import SHAPES, cell_runnable, get_config

    def key(job):
        if "--retrieval" in job:
            return (5, 0)
        cfg = get_config(job[job.index("--arch") + 1])
        shape = job[job.index("--shape") + 1]
        if not cell_runnable(cfg, shape)[0]:
            return (6, 0)
        rank = {"long_500k": 0, "decode_32k": 1, "train_4k": 2, "prefill_32k": 3}
        return (rank.get(shape, 4), -cfg.n_layers)

    return sorted(work, key=key)


def job_name(args: list[str]) -> str:
    return "_".join(a.lstrip("-") for a in args)


def cell_file(job: list[str]) -> str:
    """The file a job's cell is written to (`dryrun.run_cell` /
    `run_retrieval`'s names)."""
    mesh = job[job.index("--mesh") + 1]
    if "--retrieval" in job:
        ds = job[job.index("--retrieval") + 1]
        name = f"memanns-{ds}" + ("-cooc" if "--cooc" in job else "")
        label = "card" if mesh == "card" else ("dpu512" if mesh == "multipod" else "dpu256")
        return f"{name}__{label}.json"
    from repro_torch.launch.dryrun import mesh_label

    arch = job[job.index("--arch") + 1]
    shape = job[job.index("--shape") + 1]
    return f"{arch}__{shape}__{mesh_label(mesh)}.json".replace("/", "_")


def run(work: list[list[str]], out: str, jobs: int = 6, timeout: int = 1800,
        device_kind: str | None = None, log=print) -> dict:
    """Run `work` with at most `jobs` subprocesses of
    `python -m repro_torch.launch.dryrun` at a time, each killed after
    `timeout` seconds; returns {"ok", "fail"} counts by exit code and the
    jobs that failed."""
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    if device_kind is None:
        from repro_torch.launch.env import describe_env

        device_kind = describe_env()["device_kind"]
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    pending = list(work)
    running: list[tuple[subprocess.Popen, list[str], float, object]] = []
    results = {"ok": 0, "fail": 0, "failed": []}
    t_start = time.time()
    try:
        while pending or running:
            while pending and len(running) < jobs:
                job = pending.pop(0)
                fh = open(os.path.join(out, "logs", job_name(job) + ".log"), "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", *job, "--out", out,
                     "--device-kind", device_kind],
                    stdout=fh, stderr=subprocess.STDOUT, env=env,
                )
                running.append((proc, job, time.time(), fh))
            keep = []
            for proc, job, t0, fh in running:
                rc = proc.poll()
                if rc is None and time.time() - t0 > timeout:
                    proc.kill()
                    rc = proc.wait()
                if rc is None:
                    keep.append((proc, job, t0, fh))
                    continue
                fh.close()
                tag = "ok" if rc == 0 else "fail"
                results[tag] += 1
                if rc:
                    results["failed"].append(job_name(job))
                log(f"[{time.time() - t_start:7.1f}s] {tag:4s} ({time.time() - t0:6.1f}s) "
                    f"{job_name(job)}")
            running = keep
            time.sleep(0.2)
    finally:
        for proc, _, _, fh in running:
            proc.kill()
            proc.wait()
            fh.close()
    return results


def main(argv=None) -> int:
    from repro_torch.launch.env import setup_env

    setup_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--meshes", default="card",
                    help="comma-separated: card, pod, multipod (pod,multipod: the "
                         "reference's worklist)")
    ap.add_argument("--device-kind", default=None,
                    help="device name whose peaks the cells use (default: describe_env()'s)")
    args = ap.parse_args(argv)
    work = build_worklist(tuple(args.meshes.split(",")))
    if args.skip_existing:
        before = len(work)
        work = [j for j in work if not os.path.exists(os.path.join(args.out, cell_file(j)))]
        print(f"skipping {before - len(work)} existing cells")
    results = run(longest_first(work), args.out, args.jobs, args.timeout, args.device_kind)
    print(json.dumps(results))
    return 1 if results["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
