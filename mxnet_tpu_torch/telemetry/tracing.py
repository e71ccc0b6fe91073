"""Distributed tracing: causal request spans across processes.

Counterpart of `mxnet_tpu/telemetry/tracing.py` (pure stdlib in both
packages; the port keeps its own copy). The metrics layer (core.py) says
how much and how often; this module says where one request spent its
time across the serving topology (HTTP server -> pool router -> replica
worker):

  * a **trace** is one request: a 16-hex ``trace_id`` plus a tree of
    **spans** (8-hex ``span_id`` / ``parent_id``), each with a wall-clock
    start, a duration, a ``component`` lane (server/router/worker/decode)
    and free-form attrs;
  * **context propagation**: a thread-local stack of active spans in
    process, the ``x-mxtpu-trace`` header (``<trace_id>-<span_id>-<flags>``)
    at HTTP admission, a compact tuple on the supervisor's wire frames
    between router and replica, and ``MXTPU_TRACE_CONTEXT`` from a parent
    process;
  * **sampling**: roots record at ``MXTPU_TRACE_SAMPLE`` probability; an
    incoming context's sampled flag is always honored. The slow-request
    hatch (``MXTPU_TRACE_SLOW_MS``) buffers unsampled local spans and emits
    them after the fact when the root overruns;
  * **emission**: spans land in the telemetry JSONL as ``{"kind": "span",
    ...}`` lines (written by core.flush), with everything
    `tools/trace_merge.py` needs to draw one timeline a trace across every
    process.

Starting and stopping a span is a list append and pop on a thread-local
stack (also registered in a plain dict, `active_spans`); emission is a
bounded deque append. When nothing arms tracing (rate 0, no slow hatch, no
inherited context, no collector), ``root()`` costs one cached-bool check.
"""
from __future__ import annotations

import collections
import os
import random
import threading
import time

from .. import env as _env
from . import core

__all__ = [
    "SpanRef", "Span", "configure", "mint", "root", "span", "emit_span",
    "current", "current_trace_id", "capture", "header_value", "parse_header",
    "to_wire", "from_wire", "active_spans", "drain_pending", "set_collector",
    "HEADER", "TRACE_ID_LEN", "SPAN_ID_LEN",
]

HEADER = "x-mxtpu-trace"
TRACE_ID_LEN = 16
SPAN_ID_LEN = 8
_PENDING_MAX = 8192    # bounded emission queue (between JSONL flushes)
_BUFFER_MAX = 512      # deferred spans retained per slow-hatch trace


def _gen_id(nhex):
    # random.getrandbits is atomic under the GIL and much cheaper than
    # os.urandom per span; ids only need collision resistance within a
    # trace-retention window, not cryptographic strength
    return "%0*x" % (nhex, random.getrandbits(nhex * 4))


class _TraceState:
    """Module state in one place (reset by configure() and after fork)."""

    def __init__(self):
        self.sample = None       # None = read env lazily
        self.slow_ms = None
        self.configured = False  # explicit configure() wins over env
        self.armed = None        # cached "can anything record?" decision
        self.ambient = None      # SpanRef from MXTPU_TRACE_CONTEXT
        self.ambient_read = False
        self.collector = None    # optional in-process sink


_STATE = _TraceState()
_PENDING = collections.deque(maxlen=_PENDING_MAX)   # emitted span records
_BUFFER = {}     # trace_id -> [records] awaiting a slow-hatch verdict
_TLS = threading.local()
_ACTIVE = {}     # thread ident -> that thread's span stack (the SAME list
                 # object the thread mutates; dict store/delete is atomic
                 # under the GIL, so a snapshot needs no lock)


def _reset_after_fork():
    globals()["_PENDING"] = collections.deque(maxlen=_PENDING_MAX)
    _BUFFER.clear()
    _ACTIVE.clear()
    _STATE.armed = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


def configure(sample=None, slow_ms=None):
    """Runtime override of ``MXTPU_TRACE_SAMPLE`` / ``MXTPU_TRACE_SLOW_MS``
    (tests and tools; processes normally configure via env before the
    first span). Pass None to re-read the env on next use."""
    _STATE.sample = sample
    _STATE.slow_ms = slow_ms
    _STATE.configured = sample is not None or slow_ms is not None
    _STATE.armed = None


def set_collector(fn):
    """Install (or clear, with None) an in-process span sink: every
    emitted record is also handed to ``fn(record)``, so a tool can read
    phase breakdowns without reading files back."""
    _STATE.collector = fn
    _STATE.armed = None


def _sample_rate():
    if _STATE.configured:
        return _STATE.sample or 0.0
    return _env.get("MXTPU_TRACE_SAMPLE") or 0.0


def _slow_ms():
    if _STATE.configured:
        return _STATE.slow_ms
    return _env.get("MXTPU_TRACE_SLOW_MS")


def _ambient():
    """The SpanRef inherited via ``MXTPU_TRACE_CONTEXT`` (parent process
    -> child), parsed once."""
    if not _STATE.ambient_read:
        _STATE.ambient_read = True
        raw = _env.raw("MXTPU_TRACE_CONTEXT")
        if raw:
            _STATE.ambient = parse_header(raw)
    return _STATE.ambient


def _armed():
    """Can any root span record? Cached — this is the only cost on the
    hot path when tracing is off."""
    if _STATE.armed is None:
        _STATE.armed = bool(
            _sample_rate() > 0.0 or _slow_ms() is not None
            or _ambient() is not None or _STATE.collector is not None)
    return _STATE.armed


# ---------------------------------------------------------------------------
# references: a point in a trace (what crosses process/thread boundaries)
# ---------------------------------------------------------------------------

class SpanRef:
    """A (trace, span) coordinate plus recording flags — the value that
    travels on headers, wire frames and ``ServeRequest``s. ``sampled``
    means spans parented here are emitted immediately; ``deferred`` means
    they are buffered pending the local root's slow-hatch verdict."""

    __slots__ = ("trace_id", "span_id", "sampled", "deferred")

    def __init__(self, trace_id, span_id=None, sampled=False, deferred=False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.deferred = deferred

    @property
    def recorded(self):
        return self.sampled or self.deferred


def mint(ref=None):
    """Mint the trace context for a new root (HTTP admission):
    honor an incoming ``ref`` verbatim, else draw the sampling decision.
    Always returns a SpanRef — the ids exist (for the response header /
    correlation) even when nothing records."""
    if ref is not None:
        return ref
    if not _armed():
        return SpanRef(_gen_id(TRACE_ID_LEN))
    sampled = (_STATE.collector is not None
               or random.random() < _sample_rate())
    deferred = not sampled and _slow_ms() is not None
    return SpanRef(_gen_id(TRACE_ID_LEN), sampled=sampled, deferred=deferred)


def header_value(ref):
    """``x-mxtpu-trace`` encoding: ``<trace_id>-<span_id>-<flags>``
    (flags bit 0 = sampled)."""
    return "%s-%s-%02d" % (ref.trace_id, ref.span_id or "0" * SPAN_ID_LEN,
                           1 if ref.sampled else 0)


def parse_header(value):
    """Parse an ``x-mxtpu-trace`` header (or ``MXTPU_TRACE_CONTEXT``).
    Returns a SpanRef, or None when malformed — a bad header from a
    client must never 500 the request, it just starts a fresh trace."""
    try:
        trace_id, span_id, flags = value.strip().split("-")
        int(trace_id, 16)
        int(span_id, 16)
        return SpanRef(trace_id.lower(), span_id.lower(),
                       sampled=bool(int(flags) & 1))
    except (ValueError, AttributeError):
        return None


def to_wire(ref):
    """Compact tuple for pickle frames (router → replica worker)."""
    if ref is None:
        return None
    return (ref.trace_id, ref.span_id, bool(ref.sampled))


def from_wire(t):
    if not t:
        return None
    return SpanRef(t[0], t[1], sampled=bool(t[2]))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span:
    """One live span; use via the ``root()``/``span()`` context managers.
    Doubles as a SpanRef for its children (same attribute names)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled", "deferred",
                 "name", "component", "attrs", "_t0", "_wall0", "_is_root")

    def __init__(self, name, trace_id, parent_id, sampled, deferred,
                 component, attrs, is_root):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _gen_id(SPAN_ID_LEN)
        self.parent_id = parent_id
        self.sampled = sampled
        self.deferred = deferred
        self.component = component
        self.attrs = attrs
        self._is_root = is_root
        self._t0 = time.monotonic()
        self._wall0 = time.time()

    @property
    def recorded(self):
        return self.sampled or self.deferred

    def set_attr(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    # -- context manager ---------------------------------------------------
    def __enter__(self):
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        if not stack:
            # register only while spans are open, so the table holds no
            # entries for idle/dead threads
            _ACTIVE[threading.get_ident()] = stack
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack is not None and self in stack:   # unbalanced exits
            stack.remove(self)
        if stack is not None and not stack:
            _ACTIVE.pop(threading.get_ident(), None)
        dur_s = time.monotonic() - self._t0
        if exc_type is not None:
            self.set_attr("error", exc_type.__name__)
        _emit(self.name, self.trace_id, self.span_id, self.parent_id,
              self.component, self._wall0, dur_s, self.attrs,
              sampled=self.sampled, deferred=self.deferred)
        if self._is_root and self.deferred:
            _settle_deferred(self.trace_id, dur_s)
        return False


class _NullSpan:
    """Shared no-op stand-in when nothing records — all API, zero cost."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    sampled = False
    deferred = False
    recorded = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set_attr(self, key, value):
        pass


_NULL = _NullSpan()


def root(name, component=None, attrs=None, ref=None):
    """Open a ROOT span: a new trace (sampling drawn via `mint`) or the
    continuation of an incoming ``ref`` (header/wire/ambient). Training
    steps parent under the launcher's ambient context automatically."""
    if ref is None:
        if not _armed():
            return _NULL
        ref = _ambient()
        if ref is not None:
            # join the launch trace; record if the launcher sampled the
            # run OR the local rate samples this step
            sampled = ref.sampled or random.random() < _sample_rate()
            deferred = not sampled and _slow_ms() is not None
            if not (sampled or deferred):
                return _NULL
            return Span(name, ref.trace_id, ref.span_id, sampled, deferred,
                        component, dict(attrs) if attrs else None, True)
        ref = mint()
    if not ref.recorded:
        return _NULL
    return Span(name, ref.trace_id, ref.span_id, ref.sampled, ref.deferred,
                component, dict(attrs) if attrs else None, True)


def span(name, component=None, attrs=None, parent=None):
    """Open a child span under ``parent`` (default: this thread's current
    span). No recording parent -> shared no-op span."""
    if parent is None:
        parent = current()
    if parent is None or not parent.recorded:
        return _NULL
    return Span(name, parent.trace_id, parent.span_id, parent.sampled,
                parent.deferred, component or getattr(parent, "component",
                                                      None),
                dict(attrs) if attrs else None, False)


def emit_span(name, start_wall, dur_s, parent, component=None, attrs=None,
              span_id=None):
    """Emit a RETROACTIVE span from measured times (phases whose start
    predates knowing they matter: queue wait, data wait). ``parent`` is a
    Span/SpanRef; returns the span id (None when not recorded).
    ``span_id`` pre-assigns the id — the pool router mints the dispatch
    span's id BEFORE the wire send so the replica can parent under it."""
    if parent is None or not parent.recorded:
        return None
    if span_id is None:
        span_id = _gen_id(SPAN_ID_LEN)
    _emit(name, parent.trace_id, span_id, parent.span_id, component,
          start_wall, dur_s, dict(attrs) if attrs else None,
          sampled=parent.sampled, deferred=parent.deferred)
    return span_id


def child_ref(parent):
    """Pre-mint a (parent-attached) SpanRef with a fresh span id, for a
    span whose record will be emitted later under that id (see
    ``emit_span(span_id=...)``). None when ``parent`` records nothing."""
    if parent is None or not parent.recorded:
        return None
    return SpanRef(parent.trace_id, _gen_id(SPAN_ID_LEN),
                   sampled=parent.sampled, deferred=parent.deferred)


def current():
    """This thread's innermost active span (None outside any span)."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def current_trace_id():
    """Trace id of the active span, for histogram exemplars (None when
    no recorded span is active)."""
    sp = current()
    return sp.trace_id if sp is not None and sp.recorded else None


def capture():
    """Capture the calling thread's span context for another thread to
    parent under (ServeRequest admission). Returns a SpanRef or None."""
    sp = current()
    if sp is None or not sp.recorded:
        return None
    return SpanRef(sp.trace_id, sp.span_id, sampled=sp.sampled,
                   deferred=sp.deferred)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def _emit(name, trace_id, span_id, parent_id, component, start_wall, dur_s,
          attrs, sampled, deferred):
    rec = {
        "kind": "span",
        "name": name,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
        "component": component,
        "ts": start_wall,
        "dur_us": dur_s * 1e6,
        "pid": os.getpid(),
        "rank": core.rank(),
        "thread": threading.current_thread().name,
    }
    if attrs:
        rec["attrs"] = attrs
    if sampled:
        _PENDING.append(rec)
        collector = _STATE.collector
        if collector is not None:
            try:
                collector(rec)
            except Exception:
                pass  # a tool's sink must never break the traced path
        core.ensure_flusher()
    elif deferred:
        buf = _BUFFER.get(trace_id)
        if buf is None:
            buf = _BUFFER[trace_id] = []
        if len(buf) < _BUFFER_MAX:
            buf.append(rec)


def _settle_deferred(trace_id, root_dur_s):
    """Root-close verdict for an unsampled trace under the slow hatch:
    emit the buffered spans when the root overran, discard otherwise."""
    buf = _BUFFER.pop(trace_id, None)
    if not buf:
        return
    slow = _slow_ms()
    if slow is None or root_dur_s * 1e3 < slow:
        return
    for rec in buf:
        rec["slow"] = True
        _PENDING.append(rec)
    collector = _STATE.collector
    if collector is not None:
        for rec in buf:
            try:
                collector(rec)
            except Exception:
                pass
    core.ensure_flusher()


def drain_pending():
    """Hand emitted span records to the JSONL flusher (core.flush)."""
    out = []
    while True:
        try:
            out.append(_PENDING.popleft())
        except IndexError:
            return out


# ---------------------------------------------------------------------------
# open spans
# ---------------------------------------------------------------------------

def active_spans():
    """Snapshot of every thread's currently-open spans, outermost first,
    so a hang answers "stuck in which phase". Signal-safe by
    construction: iterates plain dict/list copies, takes no lock,
    allocates only small dicts."""
    now = time.monotonic()
    out = {}
    for ident, stack in list(_ACTIVE.items()):
        spans = []
        for sp in list(stack):
            spans.append({
                "name": sp.name,
                "component": sp.component,
                "trace": sp.trace_id,
                "span": sp.span_id,
                "parent": sp.parent_id,
                "open_s": round(now - sp._t0, 3),
            })
        if spans:
            out[str(ident)] = spans
    return out
