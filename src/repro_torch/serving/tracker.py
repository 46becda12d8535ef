"""Pluggable serving telemetry: the ``Tracker`` protocol and its sinks (a
copy of the reference's ``serving/tracker.py``, with the same record
schema).

Every layer of the serving stack — the async front end, the SLO budget
scheduler, the fleet — emits structured time-series records through ONE
seam: a tracker is anything with ``log(record)`` / ``finish()``.  The
sinks here are a jsonl file, an in-memory ring buffer and a composite
fan-out, so tests and the smoke run read the stream without a metrics
backend.

Record schema (:func:`validate_record`): every record carries

* ``kind`` — ``"engine_window"`` | ``"request"`` | ``"event"``
* ``t``    — seconds, caller-supplied monotonic clock

plus per-kind required fields:

* ``engine_window`` — ``ring``, ``step``, ``dt_ms`` and a ``delta`` dict
  of **non-negative** ``EngineStats`` counter deltas since the previous
  window
* ``request`` — ``rid``, ``status`` (completed|failed|cancelled|
  rejected), ``tokens``, ``ttft_ms``, ``ms_per_token``
* ``event`` — ``name`` plus free-form detail

EngineStats delta accounting
----------------------------
``EngineStats`` counters are cumulative for the life of the engine,
across ``reset()`` too (the engine banks the subsystem counters' bases
at a reset, so assigned fields like ``preemptions`` and the prefix
counters never fall back).  :class:`EngineTap` keeps the previous
snapshot and emits only the per-window delta, so every delta is
``>= 0`` and the deltas sum back to the final cumulative counters.  The
port's ``graph_captures`` / ``graph_replays`` are counters like any
other: a CUDA graph captured in the middle of a served run shows in the
window that captured it.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import fields as dc_fields
from typing import Any, Deque, Dict, Iterable, List, Optional

# EngineStats fields excluded from delta accounting: gauges (a high-water
# mark is not a flow) and wall (float accumulation, carried as dt_ms on
# the window record itself)
GAUGE_FIELDS = frozenset({"peak_pool_blocks", "wall"})

KINDS = ("engine_window", "request", "event")
REQUEST_STATUSES = ("completed", "failed", "cancelled", "rejected")
_REQUIRED = {
    "engine_window": ("ring", "step", "dt_ms", "delta"),
    "request": ("rid", "status", "tokens", "ttft_ms", "ms_per_token"),
    "event": ("name",),
}


def validate_record(rec: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``rec`` is schema-valid (see the module
    docstring).  The sinks validate on write, so a malformed record fails
    its producer, never a reader downstream."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    kind = rec.get("kind")
    if kind not in KINDS:
        raise ValueError(f"record kind={kind!r} not in {KINDS}")
    t = rec.get("t")
    if not isinstance(t, (int, float)) or t != t:  # NaN guard
        raise ValueError(f"record t={t!r} must be a finite number")
    missing = [k for k in _REQUIRED[kind] if k not in rec]
    if missing:
        raise ValueError(f"{kind} record missing fields {missing}")
    if kind == "engine_window":
        delta = rec["delta"]
        if not isinstance(delta, dict):
            raise ValueError("engine_window delta must be a dict")
        neg = {k: v for k, v in delta.items() if v < 0}
        if neg:
            raise ValueError(
                f"engine_window delta went negative: {neg} — cumulative "
                "EngineStats regressed (reset() base accounting broken?)")
        if rec["dt_ms"] < 0:
            raise ValueError(f"dt_ms={rec['dt_ms']} must be >= 0")
    elif kind == "request":
        if rec["status"] not in REQUEST_STATUSES:
            raise ValueError(f"request status={rec['status']!r} not in "
                             f"{REQUEST_STATUSES}")
        if rec["tokens"] < 0:
            raise ValueError(f"tokens={rec['tokens']} must be >= 0")


class Tracker:
    """Protocol base: ``log`` one record, ``finish`` flushes and closes.
    The base is a null sink, so a front end without telemetry calls
    through it unconditionally."""

    def log(self, rec: Dict[str, Any]) -> None:  # pragma: no cover
        pass

    def finish(self) -> None:
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class NullTracker(Tracker):
    """Explicit no-op sink (the default when telemetry is off)."""


class JsonlTracker(Tracker):
    """One schema-validated JSON object per line, written in order;
    :func:`read_jsonl` reads it back."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = open(self.path, "w", encoding="utf-8")
        self.written = 0

    def log(self, rec: Dict[str, Any]) -> None:
        validate_record(rec)
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self.written += 1

    def finish(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a jsonl tracker file, validating every record again."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            validate_record(rec)
            out.append(rec)
    return out


class RingBufferTracker(Tracker):
    """Keep the last ``capacity`` records in memory (a bounded recent
    window, never an unbounded history)."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self._buf: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self.seen = 0                  # total logged, incl. overwritten

    def log(self, rec: Dict[str, Any]) -> None:
        validate_record(rec)
        self._buf.append(rec)
        self.seen += 1

    def records(self) -> List[Dict[str, Any]]:
        return list(self._buf)

    def window(self, n: int) -> List[Dict[str, Any]]:
        """The most recent ``min(n, len)`` records, oldest first."""
        if n < 0:
            raise ValueError(f"n={n} must be >= 0")
        buf = list(self._buf)
        return buf[len(buf) - min(n, len(buf)):]


class CompositeTracker(Tracker):
    """Fan one stream out to several sinks."""

    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log(self, rec: Dict[str, Any]) -> None:
        for tr in self.trackers:
            tr.log(rec)

    def finish(self) -> None:
        for tr in self.trackers:
            tr.finish()


# ---------------------------------------------------------------------------
# EngineStats snapshot / delta (the tracker seam)
# ---------------------------------------------------------------------------

def counter_fields(stats) -> List[str]:
    """The monotone counter fields of an ``EngineStats`` (all but the
    gauges), read from the dataclass, so a new counter reaches the
    telemetry without a change here."""
    return [f.name for f in dc_fields(stats) if f.name not in GAUGE_FIELDS]


def snapshot_stats(stats) -> Dict[str, int]:
    """Copy the cumulative counters out of an ``EngineStats``."""
    return {k: getattr(stats, k) for k in counter_fields(stats)}


def stats_delta(prev: Dict[str, int], cur: Dict[str, int]) -> Dict[str, int]:
    """Per-window counter flow between two snapshots.  Raises if any
    counter fell: cumulative EngineStats are monotone by contract, so a
    negative delta is a fault upstream, never something to clamp."""
    d = {k: cur[k] - prev.get(k, 0) for k in cur}
    neg = {k: v for k, v in d.items() if v < 0}
    if neg:
        raise ValueError(f"EngineStats counters regressed: {neg}")
    return d


class EngineTap:
    """Snapshot-and-diff adapter from one engine's ``EngineStats`` to
    ``engine_window`` records.  Quiet windows (all-zero delta) are
    skipped, so an idle fleet does not flood the sink."""

    def __init__(self, engine, ring: int = 0):
        self.engine = engine
        self.ring = ring
        self._prev = snapshot_stats(engine.stats)
        self.windows = 0

    def emit(self, tracker: Tracker, t: float,
             dt_ms: float = 0.0) -> Optional[Dict[str, Any]]:
        cur = snapshot_stats(self.engine.stats)
        delta = stats_delta(self._prev, cur)
        self._prev = cur
        if not any(delta.values()):
            return None
        rec = {"kind": "engine_window", "t": float(t), "ring": self.ring,
               "step": self.engine.stats.steps,
               "dt_ms": float(max(dt_ms, 0.0)), "delta": delta}
        tracker.log(rec)
        self.windows += 1
        return rec


class RequestTimeline:
    """Per-request latency timestamps: submit, first token (TTFT), every
    token (ms/token), terminal status.  The front end owns one per
    stream and emits a ``request`` record at its end."""

    def __init__(self, rid: int, t_submit: float,
                 tenant: Optional[str] = None):
        self.rid = rid
        self.tenant = tenant
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.tokens = 0

    def on_token(self, t: float) -> None:
        if self.t_first is None:
            self.t_first = t
        self.t_last = t
        self.tokens += 1

    @property
    def ttft_ms(self) -> float:
        if self.t_first is None:
            return float("nan")
        return (self.t_first - self.t_submit) * 1e3

    @property
    def ms_per_token(self) -> float:
        """Mean inter-token latency over the decode phase (TTFT excluded;
        a stream of 0 or 1 tokens has no decode phase: 0)."""
        if self.tokens < 2 or self.t_first is None or self.t_last is None:
            return 0.0
        return (self.t_last - self.t_first) * 1e3 / (self.tokens - 1)

    def record(self, status: str, t: float) -> Dict[str, Any]:
        rec = {"kind": "request", "t": float(t), "rid": self.rid,
               "status": status, "tokens": self.tokens,
               "ttft_ms": (self.ttft_ms if self.t_first is not None
                           else -1.0),
               "ms_per_token": self.ms_per_token}
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        return rec
