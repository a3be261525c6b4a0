"""Lightweight metrics registry: counters, gauges, log-bucketed histograms.

The observability backbone behind `ServingStats` (`retrieval/serving.py`)
and `launch/serve.py --metrics-port` (a pure-Python copy of the JAX
package's registry: same families, same exposition).  Design constraints,
in order:

  * **O(1) memory, zero steady-state allocation.**  Histograms are
    log-bucketed (geometric bucket edges ``GROWTH**i``): one sparse
    ``dict[int, int]`` per series regardless of how many values are
    observed, so a long-running server's latency history never grows.
  * **Exact quantile bounds.**  A log-bucketed histogram cannot return the
    exact p50/p99/p999, but it CAN return exact *bounds*: the true
    quantile provably lies inside the bucket the cumulative count crosses,
    so ``quantile_bounds(q)`` is an exact enclosure and ``quantile(q)``
    (the geometric bucket midpoint, clamped to the observed min/max) has
    relative error <= ``sqrt(GROWTH) - 1`` (~4.5% at the default growth).
  * **Mergeable.**  Bucket counts add: ``Histogram.merge`` /
    ``MetricsRegistry.merge`` aggregate per-engine registries into one
    process- or fleet-level view without losing quantile fidelity.
  * **Label support.**  Each metric is a *family*; ``labels(phase=...)``
    (or the ``inc/set/observe(..., phase=...)`` shorthand) resolves the
    child series.  Families used today: ``phase``, ``device``, ``scan``,
    ``rerank``, ``bucket``.
  * **Two expositions.**  ``render_prometheus()`` emits Prometheus text
    format 0.0.4 (histograms as summaries with ``quantile`` labels, which
    scrape without server-side bucket config); ``snapshot()`` emits a
    JSON-able dict (the ``/metrics.json`` endpoint).
    ``tools/check_metrics_torch.py`` validates both the format and that
    the family catalog matches docs/OBSERVABILITY.md exactly.

`NULL_REGISTRY` is the do-nothing twin (`ServingEngine(metrics=False)`);
it keeps every call site branch-free while making "observability off"
measurable.
"""

from __future__ import annotations

import json
import math

# Default histogram bucket growth factor: bucket i covers
# (GROWTH**(i-1), GROWTH**i].  2**(1/8) => 8 buckets per octave, quantile
# midpoint relative error <= sqrt(GROWTH)-1 ~= 4.4%, and the full
# 1us..100s latency range still fits in ~215 (sparse) buckets.
GROWTH = 2.0 ** 0.125

_TYPES = ("counter", "gauge", "histogram")


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _format_value(v: float) -> str:
    """Prometheus sample-value formatting (inf/nan spelled out)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotone counter series (one labelset of a counter family)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class Gauge:
    """Set-to-current-value series (occupancy, tombstones, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Log-bucketed distribution sketch with exact quantile bounds.

    Positive values land in bucket ``ceil(log(v)/log(growth))`` (edges at
    ``growth**i``); values <= 0 land in a dedicated zero bucket ordered
    below every positive one.  Memory is O(distinct buckets) and every
    observation is O(1) dict work.  ``merge`` adds bucket counts, so
    sketches from different engines/hosts aggregate losslessly (the
    bounds stay exact for the union).
    """

    __slots__ = ("growth", "_log_g", "buckets", "zero", "count", "sum",
                 "min", "max")

    def __init__(self, growth: float = GROWTH):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.buckets: dict[int, int] = {}
        self.zero = 0          # observations <= 0 (recorded as value 0)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero += 1
            return
        idx = math.ceil(math.log(value) / self._log_g - 1e-12)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same growth) into this one."""
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with growth {other.growth} "
                f"into {self.growth}"
            )
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def _bucket_at_rank(self, rank: int) -> int | None:
        """Bucket index holding the rank-th (0-based) smallest value;
        None for the zero bucket."""
        if rank < self.zero:
            return None
        seen = self.zero
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank < seen:
                return idx
        return max(self.buckets) if self.buckets else None

    def quantile_bounds(self, q: float) -> tuple[float, float]:
        """Exact (lower, upper) enclosure of the q-th percentile.

        The true percentile of the observed multiset lies in the returned
        closed interval: log bucketing loses *where* in a bucket a value
        fell, never *which* bucket."""
        if self.count == 0:
            return (0.0, 0.0)
        rank = min(self.count - 1, max(0, math.ceil(q / 100.0 * self.count) - 1))
        idx = self._bucket_at_rank(rank)
        if idx is None:
            return (min(self.min, 0.0), 0.0)
        lo = self.growth ** (idx - 1)
        hi = self.growth ** idx
        # the observed extrema tighten the edge buckets for free; the
        # intersection is non-empty because the quantile lies in both
        return (max(lo, min(self.min, hi)), min(hi, self.max))

    def quantile(self, q: float) -> float:
        """Point estimate: geometric bucket midpoint, clamped to the exact
        bounds (relative error <= sqrt(growth) - 1)."""
        if self.count == 0:
            return 0.0
        lo, hi = self.quantile_bounds(q)
        if lo <= 0.0 or hi <= 0.0:
            return hi
        return min(max(math.sqrt(lo * hi), lo), hi)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class _Family:
    """One registered metric family: a name + type + label names, holding
    one series (`Counter`/`Gauge`/`Histogram`) per label-value tuple."""

    __slots__ = ("name", "type", "help", "label_names", "series", "growth")

    def __init__(self, name, mtype, help_text, label_names, growth=GROWTH):
        self.name = name
        self.type = mtype
        self.help = help_text
        self.label_names = tuple(label_names)
        self.growth = growth
        self.series: dict[tuple, object] = {}
        if not self.label_names:  # unlabeled family: eager default series
            self._make(())

    def _make(self, key: tuple):
        if self.type == "counter":
            s = Counter()
        elif self.type == "gauge":
            s = Gauge()
        else:
            s = Histogram(self.growth)
        self.series[key] = s
        return s

    def labels(self, **labels):
        """Resolve (creating on first use) the child series for `labels`."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        s = self.series.get(key)
        return s if s is not None else self._make(key)

    # shorthand so call sites don't spell .labels(...) for the common case
    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)

    def get(self, **labels) -> float:
        """Current value (counter/gauge) of one series; 0 if untouched."""
        key = tuple(str(labels[n]) for n in self.label_names)
        s = self.series.get(key)
        return float(s.value) if s is not None else 0.0


class _NullSeries:
    """Do-nothing series/family: every mutator is a no-op."""

    __slots__ = ()

    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def labels(self, **labels):
        return self

    def get(self, **labels) -> float:
        return 0.0

    def quantile(self, q: float) -> float:
        return 0.0

    def quantile_bounds(self, q: float) -> tuple[float, float]:
        return (0.0, 0.0)

    def mean(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0


NULL_SERIES = _NullSeries()


class MetricsRegistry:
    """Registry of metric families; the unit of exposition and merging."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    # ------------------------- registration --------------------------- #

    def _register(self, name, mtype, help_text, labels, growth=GROWTH):
        fam = self._families.get(name)
        if fam is not None:
            if fam.type != mtype or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {mtype}/{tuple(labels)}"
                    f" (was {fam.type}/{fam.label_names})"
                )
            return fam
        fam = _Family(name, mtype, help_text, labels, growth)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help_text: str, labels: tuple = ()):
        return self._register(name, "counter", help_text, labels)

    def gauge(self, name: str, help_text: str, labels: tuple = ()):
        return self._register(name, "gauge", help_text, labels)

    def histogram(self, name: str, help_text: str, labels: tuple = (),
                  growth: float = GROWTH):
        return self._register(name, "histogram", help_text, labels, growth)

    def families(self) -> dict[str, _Family]:
        return dict(self._families)

    def catalog(self) -> list[tuple[str, str, tuple]]:
        """[(name, type, label_names)] — what check_metrics compares to
        the docs/OBSERVABILITY.md table."""
        return [
            (f.name, f.type, f.label_names)
            for f in self._families.values()
        ]

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (counters add, gauges take the other's
        last value, histograms merge bucket-wise)."""
        for name, fam in other._families.items():
            mine = self._register(name, fam.type, fam.help, fam.label_names,
                                  fam.growth)
            for key, s in fam.series.items():
                if key not in mine.series:
                    mine._make(key)
                m = mine.series[key]
                if fam.type == "histogram":
                    m.merge(s)
                elif fam.type == "counter":
                    m.value += s.value
                else:
                    m.value = s.value

    # -------------------------- exposition ---------------------------- #

    @staticmethod
    def _label_str(names: tuple, values: tuple, extra: str = "") -> str:
        parts = [
            f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4.

        Histograms are exposed as summaries (`quantile` labels for
        p50/p99/p999 plus `_sum`/`_count`): client-side quantiles scrape
        without bucket configuration and keep the catalog compact."""
        lines: list[str] = []
        for fam in self._families.values():
            ptype = "summary" if fam.type == "histogram" else fam.type
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {ptype}")
            for key, s in sorted(fam.series.items()):
                if fam.type == "histogram":
                    for q in (50.0, 99.0, 99.9):
                        ls = self._label_str(
                            fam.label_names, key,
                            f'quantile="{q / 100.0:g}"',
                        )
                        lines.append(
                            f"{fam.name}{ls} {_format_value(s.quantile(q))}"
                        )
                    ls = self._label_str(fam.label_names, key)
                    lines.append(f"{fam.name}_sum{ls} {_format_value(s.sum)}")
                    lines.append(f"{fam.name}_count{ls} {s.count}")
                else:
                    ls = self._label_str(fam.label_names, key)
                    lines.append(f"{fam.name}{ls} {_format_value(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump of every series (the `/metrics.json` document and
        a smoke run's record)."""
        out: dict = {}
        for fam in self._families.values():
            samples = []
            for key, s in sorted(fam.series.items()):
                labels = dict(zip(fam.label_names, key))
                if fam.type == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": s.count,
                        "sum": s.sum,
                        "p50": s.quantile(50.0),
                        "p99": s.quantile(99.0),
                        "p999": s.quantile(99.9),
                        "max": None if s.count == 0 else s.max,
                    })
                else:
                    samples.append({"labels": labels, "value": s.value})
            out[fam.name] = {
                "type": fam.type,
                "help": fam.help,
                "labels": list(fam.label_names),
                "samples": samples,
            }
        return out

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)


class NullRegistry:
    """API-compatible no-op registry (`ServingEngine(metrics=False)`)."""

    def counter(self, name, help_text, labels=()):
        return NULL_SERIES

    def gauge(self, name, help_text, labels=()):
        return NULL_SERIES

    def histogram(self, name, help_text, labels=(), growth=GROWTH):
        return NULL_SERIES

    def families(self) -> dict:
        return {}

    def catalog(self) -> list:
        return []

    def merge(self, other) -> None:
        pass

    def render_prometheus(self) -> str:
        return ""

    def snapshot(self) -> dict:
        return {}

    def render_json(self) -> str:
        return "{}"


NULL_REGISTRY = NullRegistry()
