"""Per-micro-batch span tracing for the query cascade.

Every serving micro-batch produces one span *tree* rooted at a ``batch``
span covering plan -> collect end-to-end; the serving/engine/mutation
layers attach phase children (``plan`` > ``schedule``/``densify``/
``emit_tiles``, ``delta``, ``dispatch`` > ``rerank_dispatch``,
``dispatch_wait``, ``collect``, ``merge``; compactions get their own
``compaction`` root).  Completed roots land in a bounded ring buffer
(O(1) memory) and export as Chrome trace-event JSON — load the file (or
the ``/traces`` endpoint body) straight into https://ui.perfetto.dev.

Because pipelined serving interleaves batch i's device wait with batch
i+1's host planning on ONE thread, concurrent batch trees are exported on
rotating virtual tracks (``lane-0..N``): Chrome's per-tid stack
discipline holds within a tree by construction, and overlapping batches
render side by side instead of corrupting each other.

Overhead control:

  * sampling — ``Tracer(sample=0.25)`` records every 4th batch tree
    (deterministic accumulator, not RNG, so twin runs trace identically);
    unsampled batches pay two method calls and no allocation;
  * ``NULL_TRACER`` — the do-nothing twin used when tracing is off, so
    instrumented call sites stay branch-free;
  * nested engine spans are *child-only* (``root=False``): outside a
    sampled batch (or when only the engine is instrumented) they
    evaporate instead of polluting the ring with partial trees.

Tracing is observability, never behavior: spans wrap timing reads only,
and `tests/test_torch_obs.py` pins bit-identical serving results + zero
steady-state builds with tracing on vs off.

``Tracer(profiler=True)`` additionally brackets every recorded span in a
``torch.profiler.record_function`` range so spans line up with the CUDA
kernels on the timeline when a ``torch.profiler`` trace is being captured
(opt-in: the range objects cost more than the spans themselves).
"""

from __future__ import annotations

import collections
import json
import threading
import time

# virtual Chrome tracks concurrent span trees rotate over (must exceed
# any sane pipeline depth so overlapping batches never share a track)
EXPORT_LANES = 8


class Span:
    """One timed node of a span tree (times are `time.perf_counter`)."""

    __slots__ = ("name", "t0", "t1", "args", "children")

    def __init__(self, name: str, t0: float, args: dict | None = None):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.args = args or {}
        self.children: list[Span] = []

    def add(self, name: str, t0: float, t1: float, **args) -> "Span":
        """Attach a pre-stamped child (for phases timed outside a ctx)."""
        child = Span(name, t0, args)
        child.t1 = t1
        self.children.append(child)
        return child

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


class _NullSpan:
    """Absorbing no-op span: context manager, `add`, attribute writes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, name, t0, t1, **args):
        return self

    def walk(self):
        return iter(())

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager recording one span; created by `Tracer.span`."""

    __slots__ = ("_tracer", "_span", "_annotation")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._annotation = None

    def __enter__(self) -> Span:
        tr = self._tracer
        tr._stack_of().append(self._span)
        if tr.profiler:
            self._annotation = tr._annotate(self._span.name)
        return self._span

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        span = self._span
        span.t1 = time.perf_counter()
        stack = tr._stack_of()
        if stack and stack[-1] is span:
            stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


class Tracer:
    """Bounded-ring span recorder with deterministic batch sampling.

    Args:
      ring: completed root trees retained (older trees are dropped FIFO —
        O(1) memory for arbitrarily long serving streams).
      sample: fraction of batch trees recorded (1.0 = all).  Deterministic
        accumulator sampling: exactly ``round(n * sample)`` of n batches
        record, independent of timing, so twin runs sample identically.
      profiler: bracket every recorded span in a
        ``torch.profiler.record_function`` range (opt-in).
    """

    def __init__(self, ring: int = 1024, sample: float = 1.0,
                 profiler: bool = False):
        self.sample = float(sample)
        self.profiler = bool(profiler)
        self._roots: collections.deque[Span] = collections.deque(maxlen=ring)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._acc = 0.0          # sampling accumulator
        self.batches_seen = 0    # batch spans offered (sampled or not)
        self.batches_recorded = 0
        self.dropped = 0         # completed roots evicted by the ring

    # ------------------------- span creation -------------------------- #

    def _stack_of(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _annotate(self, name: str):
        try:
            import torch.profiler

            ann = torch.profiler.record_function(name)
            ann.__enter__()
            return ann
        except Exception:  # profiler unavailable: spans still record
            return None

    def span(self, name: str, parent: Span | None = None,
             root: bool = True, **args):
        """Context manager recording `name` as a span.

        Parenting, in priority order: explicit `parent` (a detached root,
        e.g. the batch span) > the innermost open span on this thread >
        a new root tree.  `root=False` makes the span *child-only*: with
        no parent available it becomes `NULL_SPAN` (used by engine-level
        sub-spans so they only record inside a sampled batch)."""
        if parent is NULL_SPAN:
            return NULL_SPAN
        t0 = time.perf_counter()
        span = Span(name, t0, args)
        if parent is not None:
            parent.children.append(span)
            return _SpanCtx(self, span)
        stack = self._stack_of()
        if stack:
            stack[-1].children.append(span)
            return _SpanCtx(self, span)
        if not root:
            return NULL_SPAN
        return _RootSpanCtx(self, span)

    def begin_batch(self, **args) -> Span:
        """Open one batch root span (the sampling decision point).

        Returns `NULL_SPAN` for unsampled batches — every child span /
        `add` call on it evaporates.  Close with `end_batch`."""
        self.batches_seen += 1
        self._acc += self.sample
        if self._acc < 1.0 - 1e-9:
            return NULL_SPAN
        self._acc -= 1.0
        self.batches_recorded += 1
        return Span("batch", time.perf_counter(), args)

    def end_batch(self, span: Span) -> None:
        """Close a batch root and commit its tree to the ring."""
        if span is NULL_SPAN or not isinstance(span, Span):
            return
        span.t1 = time.perf_counter()
        self._commit_root(span)

    def _commit_root(self, span: Span) -> None:
        with self._lock:
            if len(self._roots) == self._roots.maxlen:
                self.dropped += 1
            self._roots.append(span)

    # --------------------------- inspection --------------------------- #

    def roots(self) -> list[Span]:
        """Snapshot of the completed root trees currently in the ring."""
        with self._lock:
            return list(self._roots)

    def clear(self) -> None:
        with self._lock:
            self._roots.clear()

    # ---------------------------- export ------------------------------ #

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).

        Each root tree is emitted as complete ("X") events on a rotating
        virtual track; timestamps are microseconds relative to the oldest
        retained root."""
        roots = self.roots()
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "upanns-serving"}},
        ]
        lanes = min(EXPORT_LANES, max(len(roots), 1))
        for lane in range(lanes):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": lane,
                "args": {"name": f"lane-{lane}"},
            })
        base = min((r.t0 for r in roots), default=0.0)
        for seq, root in enumerate(roots):
            tid = seq % lanes
            for span in root.walk():
                events.append({
                    "name": span.name,
                    "cat": "serving",
                    "ph": "X",
                    "pid": 0,
                    "tid": tid,
                    "ts": (span.t0 - base) * 1e6,
                    "dur": max(span.t1 - span.t0, 0.0) * 1e6,
                    "args": {str(k): v for k, v in span.args.items()},
                })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "batches_seen": self.batches_seen,
                "batches_recorded": self.batches_recorded,
                "dropped": self.dropped,
                "sample": self.sample,
            },
        }

    def write_chrome(self, path: str) -> None:
        """Write the Chrome trace JSON to `path` (open in Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)
            f.write("\n")


class _RootSpanCtx(_SpanCtx):
    """Span ctx that commits to the ring when it closes as a tree root."""

    __slots__ = ()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        self._tracer._commit_root(self._span)
        return False


class _NullTracer:
    """Do-nothing tracer: observability off, call sites unchanged."""

    sample = 0.0
    profiler = False
    batches_seen = 0
    batches_recorded = 0
    dropped = 0

    def span(self, name, parent=None, root=True, **args):
        return NULL_SPAN

    def begin_batch(self, **args):
        return NULL_SPAN

    def end_batch(self, span):
        pass

    def roots(self):
        return []

    def clear(self):
        pass

    def export_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_chrome(), f)
            f.write("\n")


NULL_TRACER = _NullTracer()
