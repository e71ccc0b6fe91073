"""Telemetry core: the metrics registry, its windowed views and its two
export paths.

Counterpart of `mxnet_tpu/telemetry/core.py`, pure stdlib as there:

  * `counter` / `gauge` / `histogram`: a process-wide registry under the
    JAX package's metric names. Updates are lock-free attribute arithmetic
    (the GIL coalesces them; a sample that loses one increment under a
    thread race is accepted), so every read path is signal-safe; creating
    a metric takes the registry lock once.
  * windowed views: `roll_windows` appends one snapshot a metric to a
    bounded ring (``MXTPU_SLO_WINDOW_MS`` resolution, sized to
    ``MXTPU_SLO_SLOW_WINDOW_S``), and `Counter.windowed_delta` /
    `windowed_rate` / `seconds_since_change`, `Gauge.windowed_values` /
    `windowed_stats` and `Histogram.windowed` / `windowed_quantile` diff
    the live value against it. Every clock read takes an explicit
    ``now=``.
  * JSONL flush: with ``MXTPU_TELEMETRY_DIR`` set, a daemon thread appends
    the queued events and spans and one metrics snapshot every
    ``MXTPU_TELEMETRY_FLUSH_S`` to ``telemetry-rank<R>-pid<P>.jsonl``
    (`tools/trace_merge.py` reads either package's files), and once more
    at exit.
  * Prometheus text: `prometheus_text()`, served with ``/statusz`` by
    `start_http_server` (``MXTPU_TELEMETRY_PORT`` + rank, or an explicit
    call; port 0 picks a free one).

``MXTPU_TELEMETRY=0`` turns the layer into no-ops. The event ring lives in
`recorder.py`, as in the JAX package; ``record_event``, ``events`` and
``drain_pending_events`` stay reachable here by those names.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time

from .. import env as _env

__all__ = [
    "enabled", "set_enabled", "counter", "gauge", "histogram", "get_registry",
    "snapshot", "prometheus_text", "flush", "start_http_server",
    "stop_http_server", "rank",
    "restart_generation", "telemetry_dir", "roll_windows",
    "quantile_from_deltas", "ensure_flusher", "ensure_http",
    "LATENCY_BOUNDS", "BYTE_BOUNDS", "record_event", "events",
    "drain_pending_events",
]


class _State:
    """Mutable module state in one place (re-read by tests / after fork)."""

    def __init__(self):
        self.enabled = _env.get("MXTPU_TELEMETRY")
        self.owner_pid = os.getpid()
        self.flusher = None          # flusher thread (or None)
        self.flusher_decided = False  # env checked once (hot-path guard)
        self.http_server = None      # (server, thread, port) or None
        self.http_decided = False
        self.flush_fail_logged = False
        self.last_roll = None        # wall ts of the last window roll


_STATE = _State()

# serializes the ensure_* cold paths only: record_event fires from every
# serving/telemetry thread, and an unlocked decided-flag check-then-act
# could start TWO flusher/exporter threads on a cold-start race. The hot
# path (decided flag already set) never touches this lock.
_DECIDE_LOCK = threading.Lock()


def enabled():
    """Is the metrics layer active? (``MXTPU_TELEMETRY``, default on.)"""
    return _STATE.enabled


def set_enabled(value):
    """Runtime toggle (the overhead microbenchmark and bench A-B rows use
    this; processes normally configure via ``MXTPU_TELEMETRY``)."""
    _STATE.enabled = bool(value)


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
    """The JSONL/flight-recorder output directory, or None when unset."""
    return _env.raw("MXTPU_TELEMETRY_DIR") or None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

# default histogram boundaries: step/op/collective latencies in SECONDS
LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                  60.0, 120.0, 300.0)
# payload sizes in BYTES (4KiB .. 4GiB, power-of-4)
BYTE_BOUNDS = tuple(float(4096 * 4 ** i) for i in range(11))


# ---------------------------------------------------------------------------
# windowed views (docs/observability.md §SLOs)
#
# Every cumulative metric can additionally keep a bounded ring of periodic
# snapshots; diffing the live value against the newest snapshot at-or-before
# the window start yields "rate over the last 60s" / "p99 over the last 60s"
# without touching the lock-free dispatch hot path (inc/observe are
# unchanged — the roller reads cumulative state from the side). Rings are
# created at the first `roll_windows()` call, so processes that never roll
# pay nothing. Resolution is `MXTPU_SLO_WINDOW_MS`; the ring is sized to
# cover `MXTPU_SLO_SLOW_WINDOW_S` (the longest burn-rate window the SLO
# evaluator asks for), capped so a misconfigured resolution cannot grow it
# without bound.
# ---------------------------------------------------------------------------

def _window_s():
    return max(0.05, _env.get("MXTPU_SLO_WINDOW_MS") / 1e3)


def _win_maxlen(window_s):
    slow = max(60.0, _env.get("MXTPU_SLO_SLOW_WINDOW_S"))
    return max(16, min(4096, int(slow / window_s) + 2))


def _win_entries(win):
    """Stable list copy of a snapshot ring. A roller appending during the
    copy raises RuntimeError (deque mutated during iteration) — retry a
    few times; the ring mutates at window cadence, so one retry wins."""
    for _ in range(4):
        try:
            return list(win)
        except RuntimeError:
            continue
    return []


def _win_base(entries, cutoff):
    """The ring entry CLOSEST to ``cutoff`` (ties to the older side) —
    the window baseline. Picking strictly the entry before the cutoff
    would attribute everything since a long-quiet epoch's last roll to
    the window; the closest entry bounds the attribution error by half
    the roll resolution instead. Falls back to the oldest entry (partial
    coverage: the ring does not span the window yet); None on an empty
    ring."""
    older = None
    newer = None
    for e in reversed(entries):
        if e[0] <= cutoff:
            older = e
            break
        newer = e
    if older is None:
        return entries[0] if entries else None
    if newer is not None and (newer[0] - cutoff) < (cutoff - older[0]):
        return newer
    return older


def quantile_from_deltas(bounds, deltas, count, q):
    """Bucket-interpolated quantile from per-bucket counts (the windowed
    delta shape). Shared by `Histogram.windowed_quantile` and the SLO
    evaluator's multi-series merge. +Inf overflow clamps to the top
    finite bound."""
    target = max(1e-12, q * count)
    cum = 0.0
    lower = 0.0
    for bound, d in zip(bounds, deltas):
        if d:
            if cum + d >= target:
                return lower + (bound - lower) * ((target - cum) / d)
            cum += d
        lower = bound
    return bounds[-1] if bounds else None


def roll_windows(now=None, force=False):
    """Append one snapshot to every metric's window ring. Called from the
    JSONL flusher and the SLO evaluator (both off the hot path); throttled
    to the `MXTPU_SLO_WINDOW_MS` resolution so racing callers do not burn
    ring coverage. Returns the number of metrics rolled (0 when skipped)."""
    if not _STATE.enabled:
        return 0
    if now is None:
        now = time.time()
    w = _window_s()
    last = _STATE.last_roll
    if not force and last is not None and now - last < 0.9 * w:
        return 0
    # two rollers racing the throttle at worst append two entries for one
    # interval — queries diff by timestamp, so coverage only improves
    _STATE.last_roll = now  # GIL-atomic: roll-throttle stamp
    maxlen = _win_maxlen(w)
    n = 0
    for m in _REGISTRY.metrics():
        if hasattr(m, "_roll"):
            m._roll(now, maxlen)
            n += 1
    return n


def _render_labels(labels):
    if not labels:
        return ""
    inner = ",".join('%s="%s"' % (k, str(v).replace('"', '\\"'))
                     for k, v in sorted(labels.items()))
    return "{%s}" % inner


class Counter:
    """Monotonic counter (int or float). `inc` is lock-free."""

    kind = "counter"
    __slots__ = ("name", "labels", "_value", "_win", "_win_changed")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0
        self._win = None          # snapshot ring: (ts, cumulative value)
        self._win_changed = None  # ts of the last roll that saw growth

    def inc(self, amount=1):
        if _STATE.enabled:
            self._value += amount

    @property
    def value(self):
        return self._value

    def _roll(self, now, maxlen):
        win = self._win
        v = self._value
        if win is None:
            win = self._win = collections.deque(maxlen=maxlen)
            self._win_changed = now
        elif win[-1][1] != v:
            # staleness signal: when did this counter last move?
            self._win_changed = now  # GIL-atomic: roller-only stamp
        win.append((now, v))  # GIL-atomic: lock-free ring

    def windowed_delta(self, seconds, now=None):
        """``(delta, elapsed_s)`` of this counter over the trailing window
        (diffed against the rolled ring); None before the first roll. The
        elapsed figure is the REAL baseline age — shorter than ``seconds``
        while the ring is still filling."""
        win = self._win
        if not win:
            return None
        if now is None:
            now = time.time()
        base = _win_base(_win_entries(win), now - seconds)
        if base is None:
            return None
        return (self._value - base[1], max(1e-9, now - base[0]))

    def windowed_rate(self, seconds, now=None):
        """Per-second increase over the trailing window (None: no ring)."""
        d = self.windowed_delta(seconds, now)
        if d is None:
            return None
        return d[0] / d[1]

    def seconds_since_change(self, now=None):
        """Seconds since a roll last observed this counter moving (the SLO
        staleness signal); None before the first roll."""
        ts = self._win_changed
        if ts is None:
            return None
        if now is None:
            now = time.time()
        return max(0.0, now - ts)

    def snapshot(self):
        return {"type": "counter", "value": self._value}

    def expose(self, lines):
        lines.append("%s%s %s" % (self.name, _render_labels(self.labels),
                                  _fmt_num(self._value)))


class Gauge:
    """Last-value gauge. `set`/`inc`/`dec` are lock-free."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_value", "_win")

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._win = None  # snapshot ring: (ts, value) samples

    def set(self, value):
        if _STATE.enabled:
            self._value = value

    def inc(self, amount=1):
        if _STATE.enabled:
            self._value += amount

    def dec(self, amount=1):
        if _STATE.enabled:
            self._value -= amount

    @property
    def value(self):
        return self._value

    def _roll(self, now, maxlen):
        win = self._win
        if win is None:
            win = self._win = collections.deque(maxlen=maxlen)
        win.append((now, self._value))  # GIL-atomic: lock-free ring

    def windowed_values(self, seconds, now=None):
        """Rolled ``(ts, value)`` samples inside the trailing window, plus
        the live value as the newest sample ([] before the first roll —
        the live value alone is not window evidence)."""
        win = self._win
        if not win:
            return []
        if now is None:
            now = time.time()
        cutoff = now - seconds
        out = [(ts, v) for ts, v in _win_entries(win) if ts >= cutoff]
        out.append((now, self._value))
        return out

    def windowed_stats(self, seconds, now=None):
        """{'min','max','avg','samples'} over the trailing window, or None
        before the first roll."""
        vals = [v for _, v in self.windowed_values(seconds, now)]
        if not vals:
            return None
        return {"min": min(vals), "max": max(vals),
                "avg": sum(vals) / len(vals), "samples": len(vals)}

    def snapshot(self):
        return {"type": "gauge", "value": self._value}

    def expose(self, lines):
        lines.append("%s%s %s" % (self.name, _render_labels(self.labels),
                                  _fmt_num(self._value)))


class Histogram:
    """Fixed-boundary histogram (count/sum/min/max + cumulative buckets).

    `observe` touches a handful of attributes without a lock; a torn read
    during a concurrent snapshot skews one sample, which is the accepted
    trade for a dispatch-rate-safe hot path.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_exemplars", "_win")

    def __init__(self, name, labels=None, bounds=None):
        self.name = name
        self.labels = dict(labels or {})
        self.bounds = tuple(bounds if bounds is not None else LATENCY_BOUNDS)
        self._counts = [0] * (len(self.bounds) + 1)  # last: +Inf
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._exemplars = None  # bucket index -> (value, trace_id, ts)
        self._win = None        # ring: (ts, counts tuple, count, sum)

    def observe(self, value, exemplar=None):
        """Record one observation. ``exemplar`` (a trace id) attaches the
        observation's trace to its latency bucket — the last exemplar per
        bucket is kept (Prometheus OpenMetrics semantics), so a p99
        outlier in the tail bucket links to a renderable trace."""
        if not _STATE.enabled:
            return
        i = 0
        bounds = self.bounds
        n = len(bounds)
        # linear scan beats bisect for <=~24 bounds and tiny values land
        # in the first buckets anyway
        while i < n and value > bounds[i]:
            i += 1
        self._counts[i] += 1
        self._count += 1
        self._sum += value
        if self._min is None or value < self._min:
            self._min = value
        if self._max is None or value > self._max:
            self._max = value
        if exemplar is not None:
            ex = self._exemplars
            if ex is None:
                ex = self._exemplars = {}
            ex[i] = (value, exemplar, time.time())

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def _roll(self, now, maxlen):
        win = self._win
        if win is None:
            win = self._win = collections.deque(maxlen=maxlen)
        # tuple() of the live counts list may interleave with a concurrent
        # observe — one torn sample per roll is the accepted lock-free trade
        win.append((now, tuple(self._counts), self._count,
                    self._sum))  # GIL-atomic: lock-free ring

    def windowed(self, seconds, now=None):
        """Delta view over the trailing window, diffed against the rolled
        ring: ``{'count','sum','rate','elapsed','bounds','bucket_deltas'}``
        (bucket_deltas are PER-BUCKET deltas, len(bounds)+1 with the +Inf
        overflow last). None before the first roll."""
        win = self._win
        if not win:
            return None
        if now is None:
            now = time.time()
        base = _win_base(_win_entries(win), now - seconds)
        if base is None:
            return None
        counts = list(self._counts)
        deltas = [max(0, c - b) for c, b in zip(counts, base[1])]
        dcount = max(0, self._count - base[2])
        elapsed = max(1e-9, now - base[0])
        return {"count": dcount, "sum": self._sum - base[3],
                "rate": dcount / elapsed, "elapsed": elapsed,
                "bounds": self.bounds, "bucket_deltas": deltas}

    def windowed_quantile(self, q, seconds, now=None):
        """Bucket-interpolated quantile of the observations inside the
        trailing window; None when the window saw none (or no ring yet).
        Observations in the +Inf overflow bucket clamp to the top finite
        bound — windowed quantiles can never exceed it."""
        w = self.windowed(seconds, now)
        if not w or w["count"] <= 0:
            return None
        return quantile_from_deltas(self.bounds, w["bucket_deltas"],
                                    w["count"], q)

    def quantile(self, q):
        """Bucket-interpolated quantile of every observation so far (None
        before the first); the +Inf bucket clamps to the top bound."""
        if not self._count:
            return None
        return quantile_from_deltas(self.bounds, self._counts, self._count,
                                    q)

    def _bucket_le(self, i):
        return "%g" % self.bounds[i] if i < len(self.bounds) else "+Inf"

    def exemplars(self):
        """Bucket upper-bound -> {value, trace, ts} for buckets that saw a
        traced observation ({} when none did)."""
        ex = self._exemplars
        if not ex:
            return {}
        return {self._bucket_le(i): {"value": v, "trace": t, "ts": ts}
                for i, (v, t, ts) in sorted(ex.items())}

    def snapshot(self):
        buckets = {}
        cum = 0
        for b, c in zip(self.bounds, self._counts):
            cum += c
            buckets["%g" % b] = cum
        buckets["+Inf"] = self._count
        out = {"type": "histogram", "count": self._count, "sum": self._sum,
               "min": self._min, "max": self._max, "buckets": buckets}
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out

    def expose(self, lines):
        base = dict(self.labels)
        cum = 0
        for b, c in zip(self.bounds, self._counts):
            cum += c
            lab = dict(base)
            lab["le"] = "%g" % b
            lines.append("%s_bucket%s %d" % (self.name, _render_labels(lab),
                                             cum))
        lab = dict(base)
        lab["le"] = "+Inf"
        lines.append("%s_bucket%s %d" % (self.name, _render_labels(lab),
                                         self._count))
        lines.append("%s_sum%s %s" % (self.name, _render_labels(base),
                                      _fmt_num(self._sum)))
        lines.append("%s_count%s %d" % (self.name, _render_labels(base),
                                        self._count))


def _fmt_num(v):
    if isinstance(v, float):
        return repr(v)
    return str(v)


class _NullMetric:
    """Shared no-op stand-in handed out when telemetry is hard-disabled at
    process start — call sites keep working with zero cost."""

    kind = "null"
    name = "null"
    labels: dict = {}
    value = 0
    count = 0
    sum = 0.0

    def inc(self, amount=1):
        pass

    def dec(self, amount=1):
        pass

    def set(self, value):
        pass

    def observe(self, value, exemplar=None):
        pass

    def exemplars(self):
        return {}

    def windowed_delta(self, seconds, now=None):
        return None

    def windowed_rate(self, seconds, now=None):
        return None

    def seconds_since_change(self, now=None):
        return None

    def windowed_values(self, seconds, now=None):
        return []

    def windowed_stats(self, seconds, now=None):
        return None

    def windowed(self, seconds, now=None):
        return None

    def windowed_quantile(self, q, seconds, now=None):
        return None

    def snapshot(self):
        return {"type": "null"}

    def expose(self, lines):
        pass


_NULL = _NullMetric()


class Registry:
    """Name -> metric map. Creation is locked; lookups and updates are not."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name, labels, **kwargs):
        key = (name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError("telemetry metric %r already registered as %s"
                                % (name, m.kind))
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kwargs)
                self._metrics[key] = m
        return m

    def counter(self, name, labels=None):
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name, labels=None):
        return self._get_or_make(Gauge, name, labels)

    def histogram(self, name, labels=None, bounds=None):
        return self._get_or_make(Histogram, name, labels, bounds=bounds)

    def remove(self, name, labels=None):
        """Drop one metric series (exact name + labels). The SLO engine
        retires its per-objective gauges here when an objective is
        unregistered — a model unloaded mid-breach must not export a
        permanently-breaching `mxtpu_slo_healthy` series forever. Returns
        True when the series existed."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            return self._metrics.pop(key, None) is not None

    def metrics(self):
        # dict copy is atomic enough under the GIL; callers iterate the copy
        return list(self._metrics.values())

    def snapshot(self):
        out = {}
        for m in self.metrics():
            key = m.name + _render_labels(m.labels)
            out[key] = m.snapshot()
        return out

    def prometheus_text(self):
        typed = {}
        for m in self.metrics():
            typed.setdefault((m.name, m.kind), []).append(m)
        lines = []
        for (name, kind), ms in sorted(typed.items()):
            lines.append("# TYPE %s %s" % (name, kind))
            for m in ms:
                m.expose(lines)
        return "\n".join(lines) + "\n"


_REGISTRY = Registry()


def get_registry():
    return _REGISTRY


def counter(name, labels=None):
    if not _STATE.enabled:
        return _NULL
    return _REGISTRY.counter(name, labels)


def gauge(name, labels=None):
    if not _STATE.enabled:
        return _NULL
    return _REGISTRY.gauge(name, labels)


def histogram(name, labels=None, bounds=None):
    if not _STATE.enabled:
        return _NULL
    return _REGISTRY.histogram(name, labels, bounds)


def snapshot():
    return _REGISTRY.snapshot()


def prometheus_text():
    return _REGISTRY.prometheus_text()


# ---------------------------------------------------------------------------
# JSONL flush
# ---------------------------------------------------------------------------

def _jsonl_path(directory):
    return os.path.join(directory, "telemetry-rank%d-pid%d.jsonl"
                        % (rank(), os.getpid()))


def flush(directory=None, reason="manual"):
    """Append one metrics-snapshot line (plus any queued events) to the
    telemetry JSONL file. No-op (returns None) when no directory is
    configured; returns the path written otherwise."""
    directory = directory or telemetry_dir()
    if not directory or not _STATE.enabled:
        return None
    from . import memory
    from . import recorder
    from . import tracing

    # refresh the memory gauges (RSS / VmHWM, the card's figures) so every
    # snapshot line carries current residency
    memory.sample()
    # the window roller rides the flusher cadence: every flush appends one
    # ring snapshot (throttled to MXTPU_SLO_WINDOW_MS) so windowed
    # rate/quantile views stay live even without the SLO evaluator thread
    roll_windows()
    path = _jsonl_path(directory)
    try:
        os.makedirs(directory, exist_ok=True)
        lines = []
        for ev in recorder.drain_pending_events():
            lines.append(json.dumps(
                {"kind": "event", "ts": ev[0], "event": ev[1],
                 "fields": ev[2]}, default=str))
        for sp in tracing.drain_pending():
            lines.append(json.dumps(sp, default=str))
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
            # flusher/atexit/api callers race benignly: the worst case is
            # one duplicate warning line, and a lock here would put a
            # mutex on the telemetry failure path
            _STATE.flush_fail_logged = True  # GIL-atomic: warn once-ish
            import logging

            logging.getLogger("mxnet_tpu_torch.telemetry").warning(
                "telemetry flush to %s failed: %s (further failures "
                "silenced)", directory, e)
        return None


def _flusher_loop(period):
    while True:
        time.sleep(period)
        if os.getpid() != _STATE.owner_pid:
            return  # forked child inherited the thread state marker only
        flush(reason="periodic")


def ensure_flusher():
    """Start the periodic JSONL flusher once (called lazily from the first
    instrumented event). The env decision is cached after the first look —
    this sits on the per-step hot path, so configure ``MXTPU_TELEMETRY_DIR``
    before the process starts recording (launcher/env protocol), not
    mid-run."""
    if _STATE.flusher_decided:
        return
    with _DECIDE_LOCK:  # double-checked: only the cold path locks
        if _STATE.flusher_decided:
            return
        _STATE.flusher_decided = True
        if not _STATE.enabled or not telemetry_dir():
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
    """A forked child (a DataLoader worker) must not inherit flusher or
    http thread markers pointing at threads that did not survive the
    fork; they restart lazily in the child if configured."""
    _STATE.owner_pid = os.getpid()
    _STATE.flusher = None
    _STATE.flusher_decided = False
    _STATE.http_server = None
    _STATE.http_decided = False


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


# ---------------------------------------------------------------------------
# Prometheus text-exposition endpoint
# ---------------------------------------------------------------------------

def start_http_server(port=None, addr="0.0.0.0"):
    """Serve `prometheus_text()` at /metrics on a daemon thread; returns the
    bound port. Explicit-call form of the ``MXTPU_TELEMETRY_PORT`` env path
    (port 0 binds a free port — tests). Idempotent per process."""
    if _STATE.http_server is not None:
        return _STATE.http_server[2]
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if port is None:
        raw = _env.raw("MXTPU_TELEMETRY_PORT")
        if raw is None:
            return None
        port = int(raw)  # malformed -> ValueError, caught by ensure_http
        if port:
            # one exporter per rank on a shared host: offset by rank
            port += rank()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/statusz":
                # the always-on debug page: SLO verdicts, windowed rates,
                # memory and pool state
                from . import slo

                query = self.path.split("?", 1)[1] if "?" in self.path \
                    else ""
                fmt = "text" if "format=text" in query else "json"
                ctype, body = slo.render_statusz(fmt)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path not in ("", "/metrics"):
                self.send_error(404)
                return
            from . import memory

            memory.sample()  # scrape-time residency refresh
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # no access-log spam on stderr
            pass

    server = ThreadingHTTPServer((addr, port), _Handler)
    t = threading.Thread(target=server.serve_forever,
                         name="mxtpu-telemetry-http", daemon=True)
    t.start()
    bound = server.server_address[1]
    _STATE.http_server = (server, t, bound)
    return bound


def stop_http_server():
    """Shut the endpoint down and join its thread (a later
    `start_http_server` binds anew). Returns True when one was running."""
    entry = _STATE.http_server
    _STATE.http_server = None
    if entry is None or entry[0] is None:
        return False
    server, thread, _ = entry
    server.shutdown()
    server.server_close()
    thread.join(timeout=5.0)
    return True


def ensure_http():
    """Start the exporter if ``MXTPU_TELEMETRY_PORT`` asks for one (lazy,
    called from the first instrumented event; env decision cached — set the
    port before the process starts recording)."""
    if _STATE.http_decided:
        return
    if not _STATE.enabled:
        return
    with _DECIDE_LOCK:  # double-checked: a cold-start race here would
        #                 bind two exporters (see ensure_flusher)
        if _STATE.http_decided:
            return
        _STATE.http_decided = True
    if _env.raw("MXTPU_TELEMETRY_PORT") is None:
        return
    try:
        start_http_server()
    except (OSError, ValueError) as e:
        # bind failure or a malformed MXTPU_TELEMETRY_PORT: telemetry must
        # never take the training process down
        import logging

        logging.getLogger("mxnet_tpu_torch.telemetry").warning(
            "telemetry endpoint bind failed: %s (metrics endpoint disabled "
            "for this process)", e)
        _STATE.http_server = (None, None, None)  # don't retry every event


def __getattr__(name):
    # the event ring moved to recorder.py (recorder imports this module,
    # so the names resolve lazily)
    if name in ("record_event", "events", "drain_pending_events"):
        from . import recorder

        return getattr(recorder, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
