"""Aggregate the dry run's cells (`results/dryrun_torch/*.json`) into roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report --in results/dryrun_torch

The port of `repro.launch.roofline_report`: the same table, functions and
outputs.  Roofline-fraction definition (the §Perf score):
  LM cells      : (MODEL_FLOPS_per_chip / peak) / bound_s   -- an MFU bound
  retrieval     : (ideal uint8 probed-code bytes / HBM bw) / bound_s
The "what moves it" column is derived from which term dominates and the
cell's useful-work ratio.

The peaks are per device, not constants: `peaks_for` resolves (peak
FLOP/s, HBM bytes/s) from a device name via `PEAKS` (on an H100,
`torch.cuda.get_device_name` gives "NVIDIA H100 80GB HBM3" and so
"table:H100": 989e12 bf16 FLOP/s, 3.35e12 B/s), falling back to the
v5e-class `DEFAULT_PEAKS`, and every report records a `peaks_source`
("table:<kind>" | "default" | "override") so a fraction computed against
a guessed peak is never mistaken for a measured one.  The port's dry run
and tools call `peaks_for(describe_env()["device_kind"])`; they never use
`DEFAULT_PEAKS` for a figure of the card.  `--peak-flops` / `--hbm-bw`
override both.  `pick_hillclimb` takes the meshes to rank (`mesh_prefix`,
`paper_mesh`), whose defaults are the reference's pod meshes; the CLI
passes the one-card mesh's names when its cells were run there.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

# datasheet peaks keyed by a substring of the device name; dense-f32/bf16
# peak FLOP/s and HBM bandwidth in bytes/s
PEAKS: dict[str, tuple[float, float]] = {
    "TPU v4": (275e12, 1.2e12),
    "TPU v5 lite": (197e12, 819e9),
    "TPU v5e": (197e12, 819e9),
    "TPU v5p": (459e12, 2.8e12),
    "TPU v6 lite": (918e12, 1.6e12),
    "TPU v6e": (918e12, 1.6e12),
    "A100": (312e12, 2.0e12),
    "H100": (989e12, 3.35e12),
}
# historical default (v5e-class) -- keeps old reports comparable when the
# device kind is unknown (e.g. a CPU run)
DEFAULT_PEAKS = (197e12, 819e9)


def peaks_for(
    device_kind: str | None = None,
    peak_flops: float | None = None,
    hbm_bw: float | None = None,
) -> tuple[float, float, str]:
    """(peak FLOP/s, HBM bytes/s, source) for a device kind + overrides.

    Explicit overrides win and mark the source "override"; otherwise the
    longest-matching `PEAKS` key contained in `device_kind` supplies the
    pair ("table:<key>"), else `DEFAULT_PEAKS` ("default").
    """
    flops, bw = DEFAULT_PEAKS
    source = "default"
    if device_kind:
        best = ""
        for key in PEAKS:
            if key.lower() in device_kind.lower() and len(key) > len(best):
                best = key
        if best:
            flops, bw = PEAKS[best]
            source = f"table:{best}"
    if peak_flops is not None or hbm_bw is not None:
        flops = peak_flops if peak_flops is not None else flops
        bw = hbm_bw if hbm_bw is not None else bw
        source = "override"
    return flops, bw, source


def advice(cell: dict) -> str:
    dom = cell.get("dominant", "?")
    ur = cell.get("useful_ratio", 0)
    if str(cell.get("status", "")).startswith("skip"):
        return ""
    if dom == "collective_s":
        return "overlap/shrink collectives: bf16 comms, sequence-parallel norms, fewer reshards"
    if dom == "memory_s":
        if ur and ur < 0.2:
            return "HLO bytes >> useful: fuse elementwise chains, drop remat re-reads, narrower dtypes"
        return "stream larger fused blocks; bf16 activations end-to-end"
    return "MXU-align tile shapes; raise arithmetic intensity per HBM byte"


def fraction(
    cell: dict, peaks: tuple[float, float] = DEFAULT_PEAKS
) -> float | None:
    peak_flops, hbm_bw = peaks
    b = cell.get("bound_s")
    if not b:
        return None
    if "model_flops_per_chip" in cell:
        ideal = cell["model_flops_per_chip"] / peak_flops
        return ideal / b
    if "useful_code_bytes_per_chip" in cell:
        ideal = cell["useful_code_bytes_per_chip"] / hbm_bw
        return ideal / b
    return None


def load(dirname: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def fmt(x, nd=3):
    if x is None:
        return "-"
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) < 1e-3 or abs(x) >= 1e5:
            return f"{x:.2e}"
        return f"{x:.{nd}f}"
    return str(x)


def markdown_table(
    cells: list[dict], peaks: tuple[float, float] = DEFAULT_PEAKS
) -> str:
    hdr = (
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "dominant | model GF/chip | useful ratio | roofline frac | next move |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for c in cells:
        status = str(c.get("status", ""))
        if status.startswith("skip"):
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                + " - | " * 7 + f"{status} |"
            )
            continue
        if status != "ok":
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                + " - | " * 7 + f"{status[:60]} |"
            )
            continue
        fr = fraction(c, peaks)
        mf = c.get("model_flops_per_chip")
        rows.append(
            "| "
            + " | ".join([
                c["arch"], c["shape"], c["mesh"],
                fmt(c.get("compute_s")), fmt(c.get("memory_s")),
                fmt(c.get("collective_s")),
                str(c.get("dominant", "-")).replace("_s", ""),
                fmt(mf / 1e9 if mf else None, 1),
                fmt(c.get("useful_ratio"), 3),
                fmt(fr, 4),
                advice(c),
            ])
            + " |"
        )
    return hdr + "\n".join(rows) + "\n"


def pick_hillclimb(
    cells: list[dict], peaks: tuple[float, float] = DEFAULT_PEAKS,
    mesh_prefix: str = "pod", paper_mesh: str = "dpu256",
) -> dict:
    ok = [c for c in cells if c.get("status") == "ok" and c["mesh"].startswith(mesh_prefix)]
    with_fr = [(fraction(c, peaks), c) for c in ok]
    with_fr = [(f, c) for f, c in with_fr if f]
    worst = min(with_fr, key=lambda t: t[0], default=(None, None))[1]
    coll = max(
        (c for c in ok if c.get("bound_s")),
        key=lambda c: c.get("collective_s", 0) / c["bound_s"],
        default=None,
    )
    paper = next(
        (c for c in cells if c["arch"].startswith("memanns-sift1b") and c["mesh"] == paper_mesh),
        None,
    )
    return {
        "worst_fraction": worst and (worst["arch"], worst["shape"], worst["mesh"]),
        "most_collective_bound": coll and (coll["arch"], coll["shape"], coll["mesh"]),
        "paper_representative": paper and (paper["arch"], paper["shape"], paper["mesh"]),
    }


def _meshes_of(cells: list[dict]) -> dict:
    """`pick_hillclimb`'s mesh names: the card's where any cell ran there."""
    if any(c.get("mesh") == "card" for c in cells):
        return {"mesh_prefix": "card", "paper_mesh": "card"}
    return {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="dirname", default="results/dryrun_torch")
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--device-kind", default=None,
        help="resolve peaks from this device kind (default: the cells' own "
        "`device_kind`, else detect via torch; "
        "offline aggregation of another machine's results should pass the "
        "kind those results were measured on)",
    )
    ap.add_argument(
        "--peak-flops", type=float, default=None,
        help="override peak FLOP/s (marks peaks_source=override)",
    )
    ap.add_argument(
        "--hbm-bw", type=float, default=None,
        help="override HBM bandwidth in bytes/s (marks peaks_source=override)",
    )
    args = ap.parse_args()
    cells = load(args.dirname)
    kind = args.device_kind
    if kind is None and (args.peak_flops is None or args.hbm_bw is None):
        kind = next((c["device_kind"] for c in cells if c.get("device_kind")), None)
        if kind is None:
            from repro_torch.launch.env import describe_env

            kind = describe_env()["device_kind"]
    flops, bw, source = peaks_for(kind, args.peak_flops, args.hbm_bw)
    peaks = (flops, bw)
    md = markdown_table(cells, peaks)
    print(md)
    print(
        "peaks:",
        json.dumps(
            {
                "device_kind": kind, "peak_flops": flops, "hbm_bw": bw,
                "peaks_source": source,
            }
        ),
    )
    print(
        "\nhillclimb candidates:",
        json.dumps(pick_hillclimb(cells, peaks, **_meshes_of(cells)), indent=1),
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)


if __name__ == "__main__":
    main()
