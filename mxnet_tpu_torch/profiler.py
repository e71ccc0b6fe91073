"""Profiler: chrome://tracing output + aggregate stats.

Counterpart of `mxnet_tpu/profiler.py` (reference: src/profiler/profiler.h:87
emitting chrome-trace JSON; Python front python/mxnet/profiler.py —
set_config/set_state/dump, scoped Domain/Task/Frame/Event/Counter/Marker;
the engine wraps every op in a ProfileOperator when profiling is on,
graph_executor.cc:1309). The op hook lives at the port's three dispatch
sites: `ndarray.invoke` (one "imperative" event an op), `Executor.forward`
/ `backward` (``ExecutorForward`` / ``ExecutorBackward``, "symbolic") and
`autograd.backward` (one ``_backward_<op>`` event a recorded op, from hooks
on its outputs' autograd nodes, attached only while profiling is active);
a Gluon layer without children called through the façade is one
"imperative" event too, named by its class (`gluon/block.py`).
Kernel-level traces of the card come from `torch.profiler` through
`start_xla_trace` / `stop_xla_trace`, the names the JAX package gives its
xplane trace.

Op timing semantics: CUDA launches are asynchronous; by default the
recorded duration is dispatch time. Set ``profile_sync=True`` in
`set_config` (or env MXTPU_PROFILE_SYNC=1) to synchronize the card after
each recorded op and record its device time too (the analogue of the
reference's engine-side start/end stamps). On the CPU an op's time is its
own either way.
"""
from __future__ import annotations

import json
import threading
import time

from . import env as _env
from .base import MXNetError
from .telemetry import core as _telemetry

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "Domain", "Task", "Frame", "Event", "Counter", "Marker",
           "start_xla_trace", "stop_xla_trace"]

_lock = threading.Lock()
_events = []            # chrome trace event dicts
_aggregate = {}         # name -> [count, total_us, min_us, max_us]
_tids = {}              # thread ident -> (stable small tid, registered name)
_rank_cache = [None]    # launcher rank, resolved once (stamps trace pids)
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
    "profile_sync": _env.get("MXTPU_PROFILE_SYNC"),
}
_state = {"running": False, "paused": False}
_t0 = time.perf_counter()


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def is_active():
    return _state["running"] and not _state["paused"]


def profile_sync():
    return _config["profile_sync"]


def set_config(**kwargs):
    """Configure (reference: profiler.py set_config — filename, profile_all,
    profile_symbolic/imperative/memory/api, aggregate_stats)."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError("unknown profiler config keys: %s" % sorted(unknown))
    _config.update(kwargs)


def set_state(state_="stop"):
    """'run' | 'stop' (reference: profiler.py set_state)."""
    if state_ not in ("run", "stop"):
        raise MXNetError("profiler state must be 'run' or 'stop'")
    _state["running"] = state_ == "run"
    _state["paused"] = False


def state():
    return "run" if _state["running"] else "stop"


def pause():
    _state["paused"] = True


def resume():
    _state["paused"] = False


def _rank():
    """Trace pid = launcher rank, so merged multi-rank traces show one
    process lane per rank (tools/trace_merge.py)."""
    if _rank_cache[0] is None:
        _rank_cache[0] = _telemetry.rank()
    return _rank_cache[0]


def _tid():
    """Stable per-thread small id. First use of a thread also emits its
    chrome-trace `thread_name` metadata event so merged traces show named
    lanes. torch's autograd engine runs a CUDA backward on a thread of its
    own, which gets a lane of its own here."""
    ident = threading.get_ident()
    entry = _tids.get(ident)
    if entry is None:
        with _lock:
            entry = _tids.get(ident)
            if entry is None:
                name = threading.current_thread().name
                entry = (len(_tids) + 1, name)
                _tids[ident] = entry
                _events.append({"ph": "M", "name": "thread_name",
                                "pid": _rank(), "tid": entry[0],
                                "args": {"name": name}})
    return entry[0]


def _emit(name, cat, start_us, dur_us, args=None):
    ev = {"name": name, "cat": cat, "ph": "X", "ts": start_us, "dur": dur_us,
          "pid": _rank(), "tid": _tid()}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)
        if _config["aggregate_stats"]:
            st = _aggregate.setdefault(name, [0, 0.0, float("inf"), 0.0])
            st[0] += 1
            st[1] += dur_us
            st[2] = min(st[2], dur_us)
            st[3] = max(st[3], dur_us)


def _category_enabled(cat):
    if _config["profile_all"]:
        return True
    if cat == "imperative":
        return _config["profile_imperative"]
    if cat == "symbolic":
        return _config["profile_symbolic"]
    if cat == "api":
        return _config["profile_api"]
    return True


def record_op(name, start_us, dur_us, cat="imperative"):
    """Called from the dispatch layer around each op (the ProfileOperator
    hook, reference profiler.h:1085). `cat` is the reference's
    profile_imperative / profile_symbolic config split."""
    if _category_enabled(cat):
        _emit(name, cat, start_us, dur_us)


def _block_results(results):
    """Wait for the card to finish the work behind ``results`` (tensors,
    NDArrays or nested sequences of them): a synchronize of the device of
    the first CUDA tensor found. Nothing to wait for on the CPU."""
    import torch

    stack = [results]
    while stack:
        r = stack.pop()
        if isinstance(r, (tuple, list)):
            stack.extend(r)
            continue
        t = getattr(r, "_data", r)
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


_DISPATCH_COUNTERS = {}


def _dispatch_counter(cat):
    c = _DISPATCH_COUNTERS.get(cat)
    if c is None:
        c = _telemetry.counter("mxtpu_op_dispatch_total", {"cat": cat})
        _DISPATCH_COUNTERS[cat] = c
    return c


def timed_call(name, fn, args, cat="imperative"):
    """Run fn(*args), recording it as one op event when profiling is active
    (single shared wrapper for every dispatch site). Always counts the
    dispatch in telemetry (`mxtpu_op_dispatch_total{cat}`) — the always-on
    layer rides the same choke point the profiler hook uses."""
    _dispatch_counter(cat).inc()
    if not is_active() or not _category_enabled(cat):
        return fn(*args)
    t0 = _now_us()
    results = fn(*args)
    if profile_sync():
        _block_results(results)
    record_op(name, t0, _now_us() - t0, cat=cat)
    return results


def backward_hooks_wanted():
    """Whether a recorded op should carry backward hooks now (profiling
    active, imperative ops recorded)."""
    return is_active() and _category_enabled("imperative")


def hook_backward(name, outputs):
    """Record the backward of one recorded op as a ``_backward_<name>``
    event: a pre-hook on the autograd node that produced ``outputs`` (the
    first that requires grad) stamps the start, a post-hook on it the end,
    on whichever thread torch's engine runs it. The event covers that node,
    which for an op computed by one torch function is the op's whole
    backward. Attached only when `backward_hooks_wanted`, so an op recorded
    without profiling carries no hook."""
    node = next((o.grad_fn for o in outputs
                 if getattr(o, "grad_fn", None) is not None), None)
    if node is None:
        return
    label = "_backward_" + name
    start = []

    def pre(grad_outputs):
        start.append(_now_us())

    def post(grad_inputs, grad_outputs):
        if not start:
            return
        t0 = start.pop()
        if is_active():
            if profile_sync():
                _block_results(grad_inputs)
            record_op(label, t0, _now_us() - t0)

    node.register_prehook(pre)
    node.register_hook(post)


def record_memory(name, nbytes):
    if _config["profile_memory"] or _config["profile_all"]:
        pid = _rank()
        with _lock:
            _events.append({"name": "memory", "ph": "C", "ts": _now_us(),
                            "pid": pid, "args": {name: nbytes}})


def dump(finished=True, profile_process="worker"):
    """Write the chrome trace file (reference: profiler.py dump ->
    MXDumpProfile). Open it at chrome://tracing or perfetto.dev; merge
    per-rank dumps with tools/trace_merge.py (each dump stamps pid=rank and
    carries process_name/thread_name metadata so the merged timeline shows
    named rank/thread lanes).

    `finished=True` (default) also RESETS the aggregate-stats table, not
    just the event list — back-to-back profiling runs must not mix rows
    (the reference's dump-finished semantics)."""
    r = _rank()
    meta = [
        {"ph": "M", "name": "process_name", "pid": r, "tid": 0,
         "args": {"name": "rank %d (%s)" % (r, profile_process)}},
        {"ph": "M", "name": "process_sort_index", "pid": r, "tid": 0,
         "args": {"sort_index": r}},
    ]
    with _lock:
        data = {"traceEvents": meta + list(_events), "displayTimeUnit": "ms"}
    with open(_config["filename"], "w") as f:
        json.dump(data, f)
    if finished:
        with _lock:
            _events.clear()
            _aggregate.clear()
            # the next run re-registers threads (their thread_name metadata
            # events were just cleared with the event list)
            _tids.clear()


def dumps(reset=False):
    """Aggregate summary table string (reference: profiler.py dumps ->
    MXAggregateProfileStatsPrint)."""
    with _lock:
        rows = sorted(_aggregate.items(), key=lambda kv: -kv[1][1])
        out = ["%-40s %10s %14s %14s %14s %14s" %
               ("Name", "Calls", "Total(ms)", "Avg(ms)", "Min(ms)", "Max(ms)")]
        for name, (cnt, tot, mn, mx) in rows:
            out.append("%-40s %10d %14.3f %14.3f %14.3f %14.3f" %
                       (name, cnt, tot / 1e3, tot / cnt / 1e3, mn / 1e3, mx / 1e3))
        if reset:
            _aggregate.clear()
    return "\n".join(out)


# --------------------------------------------------------------------------
# scoped objects (reference: profiler.py Domain/Task/Frame/Event/Counter/Marker)
# --------------------------------------------------------------------------

class Domain:
    """Grouping namespace (reference: profiler.py Domain)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(name, self)

    def new_counter(self, name, value=None):
        return Counter(name, self, value)

    def new_marker(self, name):
        return Marker(name, self)


class _Scoped:
    _cat = "task"

    def __init__(self, name, domain=None):
        self.name = name
        self.domain = domain
        self._start = None

    def start(self):
        self._start = _now_us()
        return self

    def stop(self):
        if self._start is None:
            return
        if is_active():
            nm = self.name if self.domain is None else \
                "%s::%s" % (self.domain.name, self.name)
            _emit(nm, self._cat, self._start, _now_us() - self._start)
        self._start = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_Scoped):
    _cat = "task"


class Frame(_Scoped):
    _cat = "frame"


class Event(_Scoped):
    _cat = "event"


class Counter:
    """Numeric counter series (reference: profiler.py Counter)."""

    def __init__(self, name, domain=None, value=None):
        self.name = name
        self.domain = domain
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._value = value
        if is_active():
            pid = _rank()
            with _lock:
                _events.append({"name": self.name, "ph": "C", "ts": _now_us(),
                                "pid": pid, "args": {self.name: value}})

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    """Instant event (reference: profiler.py Marker)."""

    def __init__(self, name, domain=None):
        self.name = name
        self.domain = domain

    def mark(self, scope="process"):
        if is_active():
            pid, tid = _rank(), _tid()
            with _lock:
                _events.append({"name": self.name, "ph": "i", "ts": _now_us(),
                                "pid": pid, "tid": tid,
                                "s": {"process": "p", "thread": "t",
                                      "global": "g"}.get(scope, "p")})


# --------------------------------------------------------------------------
# kernel-level tracing — torch.profiler over the host and the card (the
# JAX package's xplane trace of the TPU, under the same names)
# --------------------------------------------------------------------------

_xla_trace = [None, None]   # (torch.profiler.profile, log_dir) while tracing


def start_xla_trace(log_dir="/tmp/mxtpu_xla_trace"):
    """Start a `torch.profiler` trace of the host and (when there is one)
    the card; `stop_xla_trace` writes its chrome trace into ``log_dir``."""
    import torch

    if _xla_trace[0] is not None:
        raise MXNetError("a trace is already running (stop_xla_trace first)")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _xla_trace[0], _xla_trace[1] = prof, log_dir
    return log_dir


def stop_xla_trace():
    """Stop the trace and write it as ``log_dir/trace_rank<r>.json``;
    returns ``log_dir``."""
    import os

    prof, d = _xla_trace
    if prof is None:
        raise MXNetError("no trace is running (start_xla_trace first)")
    _xla_trace[0] = _xla_trace[1] = None
    prof.__exit__(None, None, None)
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(d, "trace_rank%d.json" % _rank()))
    return d
