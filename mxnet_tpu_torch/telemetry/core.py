"""Telemetry core: the metrics registry and the event ring.

Counterpart of `mxnet_tpu/telemetry/core.py` (and `record_event` of its
`recorder.py`), reduced to what the generation-serving path reads: counters,
gauges, histograms under the same metric names, a snapshot, and a bounded
ring of events. Updates are lock-free attribute arithmetic (the GIL
coalesces them; a sample that loses one increment under a thread race is
accepted); creating a metric takes the registry lock once. `rank` reads
the launcher's rank as the JAX package does (the profiler stamps it on its
traces). Windowed views, SLOs, tracing spans, the JSONL flusher and the
Prometheus endpoint are not ported yet.
"""
from __future__ import annotations

import collections
import os
import threading
import time

from .. import env as _env

__all__ = ["counter", "gauge", "histogram", "get_registry", "snapshot",
           "record_event", "events", "rank", "LATENCY_BOUNDS"]

# default histogram boundaries: latencies in SECONDS
LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                  60.0, 120.0, 300.0)


def _render_labels(labels):
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, str(v).replace('"', '\\"'))
                     for k, v in sorted(labels.items()))
    return "{%s}" % inner


class Counter:
    """Monotonic counter."""

    kind = "counter"
    __slots__ = ("name", "labels", "_value")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0

    def inc(self, amount=1):
        self._value += amount

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-value gauge."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_value")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0

    def set(self, value):
        self._value = value

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-boundary histogram (count/sum/min/max + per-bucket counts)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name, labels=None, bounds=None):
        self.name = name
        self.labels = dict(labels or {})
        self.bounds = tuple(bounds if bounds is not None else LATENCY_BOUNDS)
        self._counts = [0] * (len(self.bounds) + 1)  # last: +Inf
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, value):
        i = 0
        n = len(self.bounds)
        while i < n and value > self.bounds[i]:
            i += 1
        self._counts[i] += 1
        self._count += 1
        self._sum += value
        if self._min is None or value < self._min:
            self._min = value
        if self._max is None or value > self._max:
            self._max = value

    def quantile(self, q):
        """Bucket-interpolated quantile of every observation so far (None
        before the first); the +Inf bucket clamps to the top bound."""
        if not self._count:
            return None
        target = max(1e-12, q * self._count)
        cum = 0.0
        lower = 0.0
        for bound, c in zip(self.bounds, self._counts):
            if c and cum + c >= target:
                return lower + (bound - lower) * ((target - cum) / c)
            cum += c
            lower = bound
        return self.bounds[-1]

    def snapshot(self):
        buckets = {}
        cum = 0
        for b, c in zip(self.bounds, self._counts):
            cum += c
            buckets["%g" % b] = cum
        buckets["+Inf"] = self._count
        return {"type": "histogram", "count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max, "buckets": buckets}


class Registry:
    """(name, labels) -> metric. Creation is locked; updates are not."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name, labels, **kwargs):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kwargs)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError("telemetry metric %r already registered as %s"
                            % (name, m.kind))
        return m

    def counter(self, name, labels=None):
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name, labels=None):
        return self._get_or_make(Gauge, name, labels)

    def histogram(self, name, labels=None, bounds=None):
        return self._get_or_make(Histogram, name, labels, bounds=bounds)

    def metrics(self):
        return list(self._metrics.values())

    def snapshot(self):
        return {m.name + _render_labels(m.labels): m.snapshot()
                for m in self.metrics()}


_REGISTRY = Registry()
# bounded ring of (wall ts, kind, fields); deque appends are GIL-atomic
_EVENTS = collections.deque(maxlen=1024)


def get_registry():
    return _REGISTRY


def counter(name, labels=None):
    return _REGISTRY.counter(name, labels)


def gauge(name, labels=None):
    return _REGISTRY.gauge(name, labels)


def histogram(name, labels=None, bounds=None):
    return _REGISTRY.histogram(name, labels, bounds)


def snapshot():
    return _REGISTRY.snapshot()


def record_event(kind, **fields):
    """Append one event to the bounded ring (oldest dropped first)."""
    _EVENTS.append((time.time(), kind, fields))


def events():
    """Snapshot of the ring, oldest first."""
    return [{"ts": ts, "event": kind, "fields": dict(fields)}
            for ts, kind, fields in list(_EVENTS)]


def rank():
    """This process's rank from the launcher env protocol (telemetry must
    work before and without a process group)."""
    for name in ("MXTPU_PROCESS_ID", "DMLC_WORKER_ID", "OMPI_COMM_WORLD_RANK",
                 "PMI_RANK", "SLURM_PROCID"):
        # MXTPU leg through the typed registry; scheduler vars stay raw
        # (they're other systems' protocol, not ours to register)
        v = _env.raw(name) if name.startswith("MXTPU_") \
            else os.environ.get(name)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0
