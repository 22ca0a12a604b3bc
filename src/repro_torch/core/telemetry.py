"""Operation telemetry: spans + a unified metrics registry.

The port's own copy of ``repro.core.telemetry``: every counter the engine
exposes is registered under a stable dotted name and read into one flat
dict by :func:`metrics_snapshot` (a fixed key set, the reference's STATS
schema); ``with trace(engine):`` arms a module-global tracer and
``with span("name"):`` records host wall time plus the delta of every
registered counter across the span.

On CUDA a span reads the host clock around work the host only enqueued,
so it times the enqueue unless the caller synchronizes; spans stay as
they are, and device timings come from CUDA events in ``chip_smoke.py``.

Spans never enter the WAL, and traces are derived state. Cost when
disarmed: ``span()`` is one global load + ``is None`` test returning a
singleton no-op context manager. Spans mark operations, never rows.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "register_span", "register_metric", "registered_spans",
    "registered_metrics", "Metrics", "metrics_snapshot", "stats_json",
    "Span", "Tracer", "span", "trace", "current", "render_spans",
    "chrome_trace_events", "write_chrome_trace", "STATS_SCHEMA",
]

#: version of the ``stats_json`` document: the reference's, with the same
#: key set
STATS_SCHEMA = 3

#: span name -> human description. Populated at import time by the modules
#: that own the operations, exactly like the crash-point registry.
_SPANS: Dict[str, str] = {}

#: metric name -> human description. Registered HERE (below) rather than at
#: the owning modules so the full key set — the stats JSON schema — reads
#: in one place.
_METRICS: Dict[str, str] = {}


def _register(registry: Dict[str, str], kind: str, name: str,
              doc: str) -> str:
    if registry.get(name, doc) != doc:
        raise ValueError(f"{kind} {name!r} registered twice "
                         "with different docs")
    registry[name] = doc
    return name


def register_span(name: str, doc: str) -> str:
    """Register a span name at import time; returns the name so the owning
    module can bind it to a constant. Re-registration with the same doc is
    a no-op (module reimport); with a different doc it is a bug."""
    return _register(_SPANS, "span", name, doc)


def register_metric(name: str, doc: str) -> str:
    """Register a dotted metric name (same semantics as crash points)."""
    return _register(_METRICS, "metric", name, doc)


def registered_spans() -> Dict[str, str]:
    return dict(_SPANS)


def registered_metrics() -> Dict[str, str]:
    return dict(_METRICS)


# --------------------------------------------------------------------------
# the metric name table — the one place the stats schema is defined
# --------------------------------------------------------------------------

for _n, _d in (
    ("delta.objects_scanned", "objects visited by signed_delta"),
    ("delta.objects_skipped_shared", "objects skipped as shared lineage"),
    ("delta.rows_scanned", "rows materialized while building deltas"),
    ("delta.bytes_scanned", "payload bytes touched while building deltas"),
    ("commit.rows_rehashed", "rows whose signatures were recomputed at seal"),
    ("commit.rows_carried", "rows whose signatures were carried (zero-rehash)"),
    ("commit.lob_rows_hashed", "LOB rows hashed at seal"),
    ("commit.apply_sorts", "full lexsorts paid at seal"),
    ("commit.apply_sort_merged", "seals that merged presorted runs"),
    ("commit.apply_sort_skipped", "seals that skipped sorting entirely"),
    ("vis.builds", "visibility entries built from scratch"),
    ("vis.extends", "visibility entries extended in place"),
    ("vis.derives", "visibility entries derived from a cached ancestor"),
    ("vis.hits", "visibility-cache lookups"),
    ("cache.delta_hits", "signed-delta streams served from the delta cache"),
    ("wal.frames", "WAL records appended"),
    ("wal.bytes", "bytes written to the durable store"),
    ("wal.fsyncs", "fsync calls on the durable store"),
    ("gc.objects_freed", "objects swept by gc"),
    ("gc.versions_pruned", "table versions pruned by gc"),
    ("gc.pinned_horizons", "versions kept alive by pins at last gc"),
    ("probe.queries", "key/rowsig signatures submitted to the probe paths"),
    ("probe.objects_probed", "sealed objects probed by the fused kernel"),
    ("probe.objects_pruned", "objects skipped entirely by zone maps"),
    ("probe.hits", "probe queries resolved to a visible rowid"),
    ("probe.expansions", "equal-key runs expanded past their head"),
    ("probe.shard_parts", "key-range shard partitions merged"),
    ("store.hits", "object gets served from the heap tier (packs attached)"),
    ("store.faults", "objects faulted in from the pack tier on get"),
    ("store.spills", "objects spilled to the pack tier"),
    ("store.evictions", "heap-tier entries evicted to the pack tier"),
    ("store.bytes_packed", "pack-blob bytes freshly written to disk"),
    ("store.objects_pushed", "pack objects shipped to a remote by push"),
    ("store.objects_pulled", "pack objects fetched from a remote"),
):
    register_metric(_n, _d)


class Metrics:
    """A cumulative counter bag (attached to ``ObjectStore`` as
    ``store.metrics``) for counters that have no natural home object —
    the delta.* and gc.* totals, whose per-call stats objects are
    transient."""

    __slots__ = ("counters",)

    def __init__(self):
        self.counters: Dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        if n:
            self.counters[name] = self.counters.get(name, 0) + n

    def reset(self) -> None:
        self.counters.clear()


def metrics_snapshot(engine) -> Dict[str, int]:
    """One flat dict of every registered metric for ``engine``.

    Every registered name is present (zero-defaulted) so the key set is
    stable — it IS the ``datagit stats`` JSON schema. ``engine=None``
    yields all zeros (a tracer armed before the store is loaded)."""
    snap = {name: 0 for name in _METRICS}
    if engine is None:
        return snap
    cs = engine.commit_stats
    snap["commit.rows_rehashed"] = cs.rows_rehashed
    snap["commit.rows_carried"] = cs.rows_carried
    snap["commit.lob_rows_hashed"] = cs.lob_rows_hashed
    snap["commit.apply_sorts"] = cs.apply_sorts
    snap["commit.apply_sort_merged"] = cs.apply_sort_merged
    snap["commit.apply_sort_skipped"] = cs.apply_sort_skipped
    store = engine.store
    vc = store.vis_cache
    if vc is not None:
        snap["vis.builds"] = vc.builds
        snap["vis.extends"] = vc.extends
        snap["vis.derives"] = vc.derives
        snap["vis.hits"] = vc.hits
    dc = store.delta_cache
    if dc is not None:
        snap["cache.delta_hits"] = dc.hits
    w = engine.wal
    snap["wal.frames"] = w.frames
    snap["wal.bytes"] = w.bytes_written
    snap["wal.fsyncs"] = w.fsyncs
    for name, v in store.metrics.counters.items():
        snap[name] = v
    return snap


def stats_json(engine) -> Dict[str, Any]:
    """The pinned ``datagit stats --format json`` document."""
    return {"schema": STATS_SCHEMA,
            "metrics": dict(sorted(metrics_snapshot(engine).items()))}


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

class Span:
    """One timed operation: monotonic duration + counter deltas + children.

    Created armed-path only (``span()`` returns the no-op singleton when
    no tracer is active). Counter deltas are ``snapshot_at_exit -
    snapshot_at_enter`` over the union of keys, so a tracer whose engine
    was bound mid-flight (the CLI arms before the store loads) still
    renders — pre-bind baselines are simply all zeros."""

    __slots__ = ("name", "tracer", "t0_rel", "dur_s", "counters",
                 "children", "_base", "_t0")

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self.tracer = tracer
        self.t0_rel = 0.0
        self.dur_s = 0.0
        self.counters: Dict[str, int] = {}
        self.children: List["Span"] = []

    def __enter__(self) -> "Span":
        tr = self.tracer
        parent = tr._stack[-1] if tr._stack else None
        (parent.children if parent is not None else tr.roots).append(self)
        tr._stack.append(self)
        self._base = metrics_snapshot(tr.engine)
        self._t0 = perf_counter()
        self.t0_rel = self._t0 - tr.t0
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = perf_counter() - self._t0
        base = self._base
        now = metrics_snapshot(self.tracer.engine)
        deltas = {}
        for k in now.keys() | base.keys():
            d = now.get(k, 0) - base.get(k, 0)
            if d:
                deltas[k] = d
        self.counters = deltas
        self.tracer._stack.pop()
        return False


class _NullSpan:
    """The disarmed ``span()`` result: a do-nothing context manager.
    One module-level singleton — no allocation on the hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()

#: the armed tracer (None = disarmed). One slot, module-global — arming is
#: an operator/test surface, not a concurrency feature (same contract as
#: ``faults._ACTIVE``).
_ACTIVE: Optional["Tracer"] = None


def span(name: str):
    """Open a span if a tracer is armed; a no-op context manager otherwise.

    Disarmed cost is the crash-point pattern: one global load + ``is
    None`` test + return of a singleton."""
    if _ACTIVE is None:
        return _NULL
    return _ACTIVE._open(name)


class Tracer:
    """Collects a forest of spans for one armed window.

    ``engine`` may be None at arm time (the CLI arms before the store is
    replayed, so the replay span itself is captured); call
    :meth:`bind` once the engine exists."""

    def __init__(self, engine=None):
        self.engine = engine
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        self.t0 = perf_counter()

    def bind(self, engine) -> None:
        self.engine = engine

    def _open(self, name: str) -> Span:
        if name not in _SPANS:
            raise KeyError(f"span {name!r} is not registered "
                           "(telemetry.register_span at import time)")
        return Span(name, self)


@contextmanager
def trace(engine=None) -> Iterator[Tracer]:
    """Arm a tracer for the duration of the block (no nesting)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a Tracer is already armed")
    t = Tracer(engine)
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = None


def current() -> Optional[Tracer]:
    """The armed tracer, or None."""
    return _ACTIVE


# --------------------------------------------------------------------------
# rendering / export
# --------------------------------------------------------------------------

def _display_counters(counters: Dict[str, int]) -> Dict[str, int]:
    """Counter deltas for display: every nonzero delta, PLUS every
    registered metric of any dotted group with at least one changed
    counter — zeros included. This is what makes invariants *observable*:
    a commit that carried rows shows ``commit.rows_rehashed=0`` instead
    of silently omitting it."""
    groups = {k.split(".", 1)[0] for k in counters}
    shown = dict(counters)
    for name in _METRICS:
        if name not in shown and name.split(".", 1)[0] in groups:
            shown[name] = 0
    return dict(sorted(shown.items()))


def render_spans(spans: List[Span], indent: int = 0) -> List[str]:
    """Text span tree (the ``EXPLAIN`` body): one line per span with its
    wall time, then its counter deltas, then children indented."""
    lines: List[str] = []
    pad = "  " * indent
    for s in spans:
        lines.append(f"{pad}{s.name}  [{s.dur_s * 1e3:.3f} ms]")
        shown = _display_counters(s.counters)
        if shown:
            pairs = " ".join(f"{k}={v}" for k, v in shown.items())
            lines.append(f"{pad}  {pairs}")
        lines.extend(render_spans(s.children, indent + 1))
    return lines


def chrome_trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """Flatten a tracer's span forest into Chrome-tracing complete
    events (``ph: "X"``), timestamps in microseconds relative to arm."""
    events: List[Dict[str, Any]] = []

    def walk(s: Span) -> None:
        events.append({
            "name": s.name,
            "cat": "datagit",
            "ph": "X",
            "ts": round(s.t0_rel * 1e6, 3),
            "dur": round(s.dur_s * 1e6, 3),
            "pid": 1,
            "tid": 1,
            "args": dict(sorted(s.counters.items())),
        })
        for c in s.children:
            walk(c)

    for r in tracer.roots:
        walk(r)
    return events


def write_chrome_trace(path: str, tracer: Tracer) -> None:
    """Write the span forest as Chrome-tracing JSON, one event per line
    (loads in Perfetto / ``chrome://tracing``; the array format is also
    line-splittable for streaming consumers)."""
    events = chrome_trace_events(tracer)
    with open(path, "w") as f:
        f.write("[\n")
        for i, ev in enumerate(events):
            tail = ",\n" if i + 1 < len(events) else "\n"
            f.write(json.dumps(ev, sort_keys=True) + tail)
        f.write("]\n")
