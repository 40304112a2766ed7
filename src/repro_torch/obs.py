"""Telemetry for the port: an own copy of the reference's metric registry
(``repro.obs.registry``) and an in-memory ``Telemetry`` / ``NullTelemetry``
pair with the reference's surface (``counter``, ``gauge``, ``histogram``,
``emit``, ``span``).

A span fenced on CUDA work calls ``torch.cuda.synchronize()`` at exit, so it
measures device execution rather than the asynchronous launch.  The JSONL
sink, the recompile watchdog and the reversible audit are not ported yet:
events stay in ``Telemetry.events``.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Sequence

import torch

#: default histogram bucket upper bounds (seconds): 0.5 ms .. ~2 min
DEFAULT_TIME_BUCKETS_S: List[float] = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value with high/low-water tracking."""

    __slots__ = ("name", "value", "max", "min")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self.max: Optional[float] = None
        self.min: Optional[float] = None

    def set(self, v: float):
        v = float(v)
        self.value = v
        self.max = v if self.max is None else max(self.max, v)
        self.min = v if self.min is None else min(self.min, v)

    def snapshot(self):
        return {"value": self.value, "max": self.max, "min": self.min}


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max."""

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        bs = list(buckets if buckets is not None else DEFAULT_TIME_BUCKETS_S)
        if bs != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must be strictly "
                             f"increasing, got {bs}")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        if math.isnan(v):
            raise ValueError(f"histogram {self.name}: observed NaN")
        i = 0
        while i < len(self.buckets) and v > self.buckets[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-resolution percentile; exact min/max at the extremes."""
        if self.count == 0:
            return None
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        rank = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i < len(self.buckets):
                    return min(self.buckets[i], self.max)
                return self.max
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self):
        return {"buckets": self.buckets, "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}


class Registry:
    """Named instrument store; ``snapshot()`` is JSON-ready."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, *args)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(f"instrument {name!r} already registered as "
                             f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> dict:
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(self._instruments.items()):
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms"}[type(inst)]
            out[kind][name] = inst.snapshot()
        return out


# ---------------------------------------------------------------- telemetry

def _fence(fence):
    """Wait for the device work behind ``fence`` (tensors, nested dicts /
    lists of them, or a zero-arg callable returning one)."""
    if fence is None:
        return
    obj = fence() if callable(fence) else fence
    stack, cuda = [obj], None
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                cuda = x.device
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    if cuda is not None:
        torch.cuda.synchronize(cuda)


class Span(dict):
    """Handle yielded by ``span``: carries ``dur_s`` after the block exits."""


class Telemetry:
    """In-memory telemetry: a registry plus a list of emitted events."""

    enabled = True

    def __init__(self, registry: Optional[Registry] = None, **meta):
        self.registry = registry or Registry()
        self.events: List[dict] = []
        self.emit("run_start", **meta)

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self.registry.histogram(name, buckets)

    def emit(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, "t": time.time(), **fields}
        self.events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, name: str, fence=None, observe: bool = True, **labels):
        """Timed block; ``fence`` makes it wait for the device work it names.
        The duration also lands in the ``span.<name>`` histogram."""
        sp = Span(name=name, t0=time.time(), **labels)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            _fence(fence)
            sp["dur_s"] = time.perf_counter() - t0
            self.emit("span", **sp)
            if observe:
                self.histogram(f"span.{name}").observe(sp["dur_s"])


class _NullInstrument:
    def inc(self, n: int = 1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


class NullTelemetry:
    """Same surface as ``Telemetry``, zero bookkeeping."""

    enabled = False
    _instrument = _NullInstrument()

    def __init__(self, *a, **k):
        self.registry = None

    def counter(self, name):
        return self._instrument

    def gauge(self, name):
        return self._instrument

    def histogram(self, name, buckets=None):
        return self._instrument

    def emit(self, kind, **fields):
        return {}

    @contextlib.contextmanager
    def span(self, name, fence=None, observe: bool = True, **labels):
        # still times (and fences) so callers may read sp["dur_s"]
        sp = Span(name=name, **labels)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            _fence(fence)
            sp["dur_s"] = time.perf_counter() - t0


def as_telemetry(t, **meta):
    """None -> no-op; an existing Telemetry/NullTelemetry passes through.  A
    path (the reference's JSONL sink) is not ported yet."""
    if t is None:
        return NullTelemetry()
    if isinstance(t, (Telemetry, NullTelemetry)):
        return t
    raise NotImplementedError(
        "telemetry to a JSONL path: the sink is not ported yet (ROADMAP.md "
        "queue 1, telemetry); pass a repro_torch.obs.Telemetry instead")
