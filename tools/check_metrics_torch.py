"""The metrics contract of the port: Prometheus format validity and the
catalog of docs/OBSERVABILITY.md.

``PYTHONPATH=src python tools/check_metrics_torch.py`` runs two checks over
`repro_torch`'s registry, both hard failures (exit code 1):

  1. **Exposition validity.**  A fresh `ServingStats` registry (every
     family registered, a few series exercised) is rendered through
     `render_prometheus()` and every line is held to the text exposition
     format 0.0.4: HELP / TYPE pairs per family, sample lines
     ``name{label="value",...} number``, histograms exposed as summaries
     with q = 0.5 / 0.99 / 0.999 samples plus ``_sum`` / ``_count``.  The
     JSON snapshot must go through ``json.dumps`` and cover the same
     families.
  2. **Catalog drift.**  The runtime catalog (`MetricsRegistry.catalog()`)
     must equal the metric table of docs/OBSERVABILITY.md: name, type and
     label set, both ways.

`check_exposition(text)` is importable on its own, to hold a live
registry's rendering to the same line check.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DOC = ROOT / "docs" / "OBSERVABILITY.md"

# | `upanns_serving_batches_total` | counter | `scan` | ... |
TABLE_ROW_RE = re.compile(
    r"^\|\s*`(upanns_[a-z0-9_]+)`\s*\|\s*(counter|gauge|histogram)\s*\|\s*([^|]*)\|"
)
SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"                  # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""        # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"   # the rest
    r" (?:[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf)|NaN)$"
)


def doc_catalog() -> set[tuple[str, str, tuple]]:
    """The metric table of docs/OBSERVABILITY.md as (name, type, labels)."""
    if not DOC.is_file():
        print(f"ERROR: missing {DOC.relative_to(ROOT)}")
        sys.exit(1)
    out = set()
    for line in DOC.read_text().splitlines():
        m = TABLE_ROW_RE.match(line.strip())
        if m:
            labels = tuple(t.strip("` ") for t in m.group(3).split(",") if t.strip("`— -"))
            out.add((m.group(1), m.group(2), labels))
    return out


def runtime_catalog_and_text():
    """The port's catalog, a rendering with a few series filled, and its
    JSON snapshot."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.retrieval.serving import ServingStats

    st = ServingStats()
    st.note_compile()
    st.m_batches.inc(scan="tiles")
    st.m_rows_scanned.inc(4096, device=0)
    for v in (0.001, 0.004, 0.02, 0.02, 0.5):
        st.m_latency.observe(v)
        st.observe_phase("plan", v / 2)
    st.set_mutation_gauges(0.25, 3)
    catalog = {(name, mtype, tuple(labels)) for name, mtype, labels in st.registry.catalog()}
    return catalog, st.registry.render_prometheus(), st.registry.snapshot()


def check_exposition(text: str) -> list[str]:
    """Every problem of a Prometheus text rendering (empty: well-formed)."""
    errors = []
    helped, typed, sampled = set(), set(), set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
        elif line.startswith("# TYPE "):
            parts = line.split()
            typed.add(parts[2])
            if parts[3] not in ("counter", "gauge", "summary", "histogram"):
                errors.append(f"line {ln}: bad TYPE {parts[3]!r}")
        elif line.startswith("#"):
            errors.append(f"line {ln}: stray comment {line!r}")
        elif not SAMPLE_RE.match(line):
            errors.append(f"line {ln}: malformed sample {line!r}")
        else:
            sampled.add(line.split("{")[0].split(" ")[0])
    for name in sampled:
        base = re.sub(r"_(sum|count)$", "", name)
        if base not in typed and name not in typed:
            errors.append(f"sample {name} has no TYPE line")
    if helped != typed:
        errors.append(f"HELP/TYPE mismatch: {sorted(helped ^ typed)}")
    for q in ('quantile="0.5"', 'quantile="0.99"', 'quantile="0.999"'):
        if q not in text:
            errors.append(f"missing histogram quantile sample {q}")
    return errors


def main() -> int:
    errors = []
    runtime, text, snap = runtime_catalog_and_text()
    errors.extend(check_exposition(text))
    try:
        json.dumps(snap)
    except (TypeError, ValueError) as exc:
        errors.append(f"snapshot not JSON-able: {exc}")
    if set(snap) != {name for name, _, _ in runtime}:
        errors.append("snapshot families != catalog families")
    documented = doc_catalog()
    for entry in sorted(runtime - documented):
        errors.append(f"undocumented metric (not in docs/OBSERVABILITY.md): {entry}")
    for entry in sorted(documented - runtime):
        errors.append(f"documented metric missing from the port's registry: {entry}")
    for e in errors:
        print(f"ERROR: {e}")
    print(f"check_metrics_torch: {len(runtime)} families, "
          f"{'FAIL' if errors else 'ok'} ({len(errors)} problems)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
