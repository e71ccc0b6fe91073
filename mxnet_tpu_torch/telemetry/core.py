"""Telemetry core: the metrics registry, the event ring and the JSONL files.

Counterpart of `mxnet_tpu/telemetry/core.py` (and `record_event` of its
`recorder.py`): counters, gauges, histograms under the same metric names, a
snapshot, a bounded ring of events, and the per-process JSONL file
(``$MXTPU_TELEMETRY_DIR/telemetry-rank<R>-pid<P>.jsonl``) whose
``{"kind": "event" | "span" | "metrics"}`` lines are the JAX package's, so
`tools/trace_merge.py` reads either package's files. Updates are lock-free
attribute arithmetic (the GIL coalesces them; a sample that loses one
increment under a thread race is accepted); creating a metric takes the
registry lock once. The flusher thread starts at the first event or span
when the directory is set, and a final flush runs at exit. `rank` reads
the launcher's rank as the JAX package does. The windowed views, the
histogram exemplars and the Prometheus endpoint wait with the SLO slice
(``telemetry/slo.py``, ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time

from .. import env as _env

__all__ = ["counter", "gauge", "histogram", "get_registry", "snapshot",
           "record_event", "events", "rank", "restart_generation",
           "telemetry_dir", "flush", "ensure_flusher", "LATENCY_BOUNDS"]

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

    def observe(self, value, exemplar=None):
        """Count ``value``; ``exemplar`` (a trace id) is accepted for the
        JAX signature and not kept: exemplars wait with the windowed
        views."""
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

    def remove(self, name, labels=None):
        """Drop one series (exact name and labels); True when it existed
        (a removed replica's gauges must not linger)."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._metrics.pop(key, None) is not None

    def metrics(self):
        return list(self._metrics.values())

    def snapshot(self):
        return {m.name + _render_labels(m.labels): m.snapshot()
                for m in self.metrics()}


class _State:
    """The flusher's module state in one place (reset after fork)."""

    def __init__(self):
        self.owner_pid = os.getpid()
        self.flusher = None           # the flusher thread, or None
        self.flusher_decided = False  # the directory checked once
        self.flush_fail_logged = False


_STATE = _State()
# serializes ensure_flusher's cold path only (two threads must not start
# two flushers); the decided flag keeps the hot path lock-free
_DECIDE_LOCK = threading.Lock()
_REGISTRY = Registry()
# bounded ring of (wall ts, kind, fields); deque appends are GIL-atomic
_EVENTS = collections.deque(maxlen=1024)
# events not yet written to the JSONL file (each lands in one flush)
_PENDING_EVENTS = collections.deque(maxlen=8192)


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
    """Append one event to the bounded ring (oldest dropped first) and
    queue it for the next JSONL flush."""
    ev = (time.time(), kind, fields)
    _EVENTS.append(ev)
    _PENDING_EVENTS.append(ev)
    ensure_flusher()


def drain_pending_events():
    """Hand the queued events to the flusher (each to one flush)."""
    out = []
    while True:
        try:
            out.append(_PENDING_EVENTS.popleft())
        except IndexError:
            return out


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


def restart_generation():
    """The supervision generation this process belongs to (0 = first
    launch; a replica pool's respawns count up)."""
    return _env.get("MXTPU_RESTART_GENERATION")


def telemetry_dir():
    """The JSONL output directory, or None when unset."""
    return _env.raw("MXTPU_TELEMETRY_DIR") or None


# ---------------------------------------------------------------------------
# JSONL flush
# ---------------------------------------------------------------------------

def _jsonl_path(directory):
    return os.path.join(directory, "telemetry-rank%d-pid%d.jsonl"
                        % (rank(), os.getpid()))


def flush(directory=None, reason="manual"):
    """Append the queued events and spans and one metrics-snapshot line to
    this process's JSONL file. Returns the path written, or None when no
    directory is configured (or the write failed: warned once)."""
    from . import tracing

    directory = directory or telemetry_dir()
    if not directory:
        return None
    path = _jsonl_path(directory)
    try:
        os.makedirs(directory, exist_ok=True)
        lines = [json.dumps({"kind": "event", "ts": ev[0], "event": ev[1],
                             "fields": ev[2]}, default=str)
                 for ev in drain_pending_events()]
        lines += [json.dumps(sp, default=str)
                  for sp in tracing.drain_pending()]
        lines.append(json.dumps({
            "kind": "metrics",
            "ts": time.time(),
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "rank": rank(),
            "pid": os.getpid(),
            "generation": restart_generation(),
            "reason": reason,
            "metrics": snapshot(),
        }, default=str))
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
        return path
    except OSError as e:
        if not _STATE.flush_fail_logged:
            _STATE.flush_fail_logged = True
            import logging

            logging.getLogger("mxnet_tpu_torch.telemetry").warning(
                "telemetry flush to %s failed: %s (further failures "
                "silenced)", directory, e)
        return None


def _flusher_loop(period):
    while True:
        time.sleep(period)
        if os.getpid() != _STATE.owner_pid:
            return  # a forked child inherited the marker, not the thread
        flush(reason="periodic")


def ensure_flusher():
    """Start the periodic JSONL flusher once, at the first event or span,
    when ``MXTPU_TELEMETRY_DIR`` is set (the decision is cached: set the
    directory before the process starts recording)."""
    if _STATE.flusher_decided:
        return
    with _DECIDE_LOCK:
        if _STATE.flusher_decided:
            return
        _STATE.flusher_decided = True
        if not telemetry_dir():
            return
        period = _env.get("MXTPU_TELEMETRY_FLUSH_S")
        t = threading.Thread(target=_flusher_loop,
                             args=(max(0.25, period),),
                             name="mxtpu-telemetry-flush", daemon=True)
        _STATE.flusher = t
        t.start()


@atexit.register
def _flush_at_exit():
    try:
        if os.getpid() == _STATE.owner_pid:
            flush(reason="exit")
    except Exception:
        pass


def _reset_after_fork():
    """A forked child (a DataLoader worker) must not believe it has the
    parent's flusher thread; it starts its own lazily if configured."""
    _STATE.owner_pid = os.getpid()
    _STATE.flusher = None
    _STATE.flusher_decided = False


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)
