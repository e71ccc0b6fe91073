"""Flight recorder: the recent-events ring, the alerts ring, the hang
watchdog and the dumps.

Counterpart of `mxnet_tpu/telemetry/recorder.py`, pure stdlib. Each
process keeps its last ``MXTPU_FLIGHTREC_EVENTS`` telemetry events in a
ring (and queues them for the JSONL flush), and the SLO engine's breach /
recovery transitions in a separate ``MXTPU_SLO_ALERTS`` ring. A dump
writes them with every thread's stack, the active spans, the memory and
goodput blocks and a metrics snapshot to
``flightrec-rank<R>-pid<P>.json`` in ``MXTPU_TELEMETRY_DIR`` (else the
temp dir) and names the path on stderr. Three triggers:

  * the watchdog: ``MXTPU_WATCHDOG_TIMEOUT`` seconds without a completed
    training step (armed by the first `record_step`); then the default
    action exits with ``MXTPU_WATCHDOG_EXIT_CODE`` (43) so the launcher
    restarts the group, and ``MXTPU_WATCHDOG_ACTION=dump`` keeps running;
  * SIGUSR1 (the launcher sends it before its teardown; ``kill -USR1``);
    the handler installs from the main thread only;
  * `dump(reason)` from code.

Signal safety: the rings are bare deques (atomic appends) and the metrics
lock-free (`core.py`), so a dump from a signal handler cannot deadlock on
state the interrupted thread holds.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

from .. import env as _env
from . import core
from . import goodput  # imported HERE, not inside dump(): an import in a
from . import memory  # signal handler could deadlock on the import lock
from . import tracing

__all__ = ["record_event", "record_step", "events", "dump", "dump_path",
           "last_step", "install_signal_handler", "drain_pending_events",
           "record_alert", "alerts"]


def _ring_size():
    return max(16, _env.get("MXTPU_FLIGHTREC_EVENTS"))


class _RecState:
    def __init__(self):
        self.ring = collections.deque(maxlen=_ring_size())
        self.pending = collections.deque(maxlen=4096)  # JSONL flush queue
        # SLO breach/recovery transitions, kept SEPARATELY from the event
        # ring: a busy process churns hundreds of events between two
        # alerts, and the one question a hang dump must answer — "which
        # objective was burning?" — must not age out of a shared ring
        self.alerts = collections.deque(
            maxlen=max(4, _env.get("MXTPU_SLO_ALERTS")))
        self.last_step = None        # (step, monotonic_t, wall_t)
        self.watchdog = None
        self.watchdog_decided = False  # env checked once (hot-path guard)
        self.signal_installed = False
        self.dump_seq = 0


_REC = _RecState()


def _reset_after_fork():
    st = _RecState()
    # a forked data worker keeps the parent's history visible (harmless)
    # but gets its own watchdog/signal/pending state
    st.ring = _REC.ring.copy()
    globals()["_REC"] = st


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

def record_event(kind, **fields):
    """Append a telemetry event to the flight-recorder ring (and queue it
    for the next JSONL flush). Cheap: two deque appends."""
    if not core._STATE.enabled:
        return
    ev = (time.time(), kind, fields)
    # bare deque appends, lock-free BY DESIGN: every thread (and the
    # watchdog) records events, and the SIGUSR1 dump path reads the ring
    # from signal context — a lock here is exactly the deadlock the
    # flight recorder exists to diagnose (module docstring)
    _REC.ring.append(ev)  # GIL-atomic: signal-safe ring
    _REC.pending.append(ev)  # GIL-atomic: signal-safe queue
    core.ensure_flusher()
    core.ensure_http()


def drain_pending_events():
    """Hand the queued (not-yet-flushed) events to the JSONL flusher."""
    out = []
    while True:
        try:
            # deque.popleft is GIL-atomic; racing flushers each drain a
            # disjoint subset (an event lands in exactly one JSONL line)
            out.append(_REC.pending.popleft())  # GIL-atomic: drain
        except IndexError:
            return out


def events():
    """Snapshot of the ring (oldest first)."""
    return [{"ts": ts, "event": kind, "fields": dict(fields)}
            for ts, kind, fields in list(_REC.ring)]


def record_alert(kind, fields):
    """Append one SLO transition (`slo_breach` / `slo_recovered`) to the
    bounded alerts ring (`MXTPU_SLO_ALERTS`). Same lock-free deque
    discipline as the event ring — dumps read it from signal context."""
    if not core._STATE.enabled:
        return
    _REC.alerts.append(  # GIL-atomic: signal-safe alerts ring
        (time.time(), kind, dict(fields or {})))


def alerts():
    """Snapshot of the alerts ring (oldest first) — carried in every
    flight-recorder dump and the /statusz page."""
    return [{"ts": ts, "event": kind, "fields": dict(fields)}
            for ts, kind, fields in list(_REC.alerts)]


def last_step():
    """(step, seconds_since) of the newest recorded step, or None."""
    ls = _REC.last_step
    if ls is None:
        return None
    return ls[0], time.monotonic() - ls[1]


def record_step(step=None):
    """Mark a training-step completion: feeds the watchdog deadline, the
    ring, and installs the SIGUSR1 handler / watchdog thread on first use."""
    if not core._STATE.enabled:
        return
    # one immutable tuple store: the watchdog reads (and on `dump` action
    # re-arms) last_step concurrently — a reader sees the old tuple or
    # the new one, never a half-written pair; locking the per-step hot
    # path is the cost this design refuses
    # GIL-atomic: a tuple swap, and a signal-safe ring append
    _REC.last_step = (step, time.monotonic(), time.time())
    _REC.ring.append((time.time(), "step", {"step": step}))
    install_signal_handler()
    _ensure_watchdog()
    core.ensure_flusher()
    core.ensure_http()


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

def dump_path():
    directory = core.telemetry_dir() or tempfile.gettempdir()
    return os.path.join(directory, "flightrec-rank%d-pid%d.json"
                        % (core.rank(), os.getpid()))


def _thread_stacks():
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        name, daemon = names.get(ident, ("unknown-%d" % ident, None))
        out.append({
            "name": name,
            "ident": ident,
            "daemon": daemon,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    out.sort(key=lambda t: (t["name"] != "MainThread", t["name"]))
    return out


def dump(reason, path=None):
    """Write the flight-recorder dump (thread stacks + ring + metrics) and
    announce its path on stderr. Returns the path, or None on failure
    (a dump must never take the process down on its own)."""
    try:
        path = path or dump_path()
        ls = last_step()
        payload = {
            "version": 1,
            "reason": reason,
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "ts": time.time(),
            "rank": core.rank(),
            "pid": os.getpid(),
            "generation": core.restart_generation(),
            "argv": list(sys.argv),
            "last_step": None if ls is None else
                {"step": ls[0], "seconds_since": round(ls[1], 3)},
            # which phase each thread is stuck in, straight from the
            # span table (lock-free dict snapshot: signal-safe)
            "active_spans": tracing.active_spans(),
            # what was resident: RSS/VmHWM (fresh /proc read), last-polled
            # device stats, NDArray live counts, top executables by temp
            # bytes — every hang/OOM dump says where the memory went
            "memory": memory.snapshot(),
            # where the training wall-clock went: windowed goodput
            # fraction + cumulative per-phase totals (docs §Goodput;
            # lock-free value reads — signal-safe)
            "goodput": goodput.snapshot(),
            # which objective was burning when the process hung: the
            # bounded slo_breach/slo_recovered ring (docs §SLOs)
            "alerts": alerts(),
            "threads": _thread_stacks(),
            "events": events(),
            "metrics": core.snapshot(),
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # raced increments (watchdog + signal + api dumps) at worst reuse
        # a tmp suffix; os.replace keeps the final dump file consistent —
        # and this path must stay lock-free (it runs in signal context)
        _REC.dump_seq += 1  # GIL-atomic: tmp-name nonce
        tmp = "%s.tmp-%d" % (path, _REC.dump_seq)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        sys.stderr.write(
            "[flight-recorder] rank %d pid %d dumped to %s (reason: %s)\n"
            % (core.rank(), os.getpid(), path, reason))
        sys.stderr.flush()
        return path
    except Exception as e:  # diagnosis must never crash the patient
        try:
            sys.stderr.write("[flight-recorder] dump failed: %r\n" % (e,))
            sys.stderr.flush()
        except Exception:
            pass
        return None


# ---------------------------------------------------------------------------
# SIGUSR1
# ---------------------------------------------------------------------------

def _on_sigusr1(signum, frame):
    dump("SIGUSR1")
    prev = getattr(_on_sigusr1, "_prev", None)
    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL,
                                       _on_sigusr1):
        # chaining the handler someone installed before us preserves their
        # behavior; its safety is theirs to guarantee (it would have run in
        # this same signal context had we never replaced it)
        prev(signum, frame)


def install_signal_handler():
    """Install the SIGUSR1 dump handler (main thread only — elsewhere the
    attempt is silently skipped and retried from a later main-thread call).
    Chains any pre-existing handler."""
    if _REC.signal_installed or not hasattr(signal, "SIGUSR1"):
        return
    try:
        prev = signal.signal(signal.SIGUSR1, _on_sigusr1)
    except ValueError:        # not the main thread
        return
    _on_sigusr1._prev = prev
    _REC.signal_installed = True


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def _watchdog_timeout():
    t = _env.get("MXTPU_WATCHDOG_TIMEOUT")
    return t if t is not None and t > 0 else None


def _watchdog_loop(timeout):
    poll = max(0.05, min(1.0, timeout / 4.0))
    while True:
        time.sleep(poll)
        if os.getpid() != core._STATE.owner_pid:
            return
        ls = _REC.last_step
        if ls is None:
            continue
        stalled = time.monotonic() - ls[1]
        if stalled <= timeout:
            continue
        record_event("watchdog_fired", step=ls[0],
                     stalled_s=round(stalled, 3), timeout_s=timeout)
        dump("watchdog: no step completed in %.1fs (timeout %gs, last "
             "step %s)" % (stalled, timeout, ls[0]))
        core.flush(reason="watchdog")
        action = _env.get("MXTPU_WATCHDOG_ACTION").lower()
        if action == "dump":
            # keep running, re-arm from now
            # re-arm: same atomic-tuple-swap contract as record_step (a
            # step completing concurrently just re-arms again, harmless)
            # GIL-atomic: a tuple swap
            _REC.last_step = (ls[0], time.monotonic(), time.time())
            continue
        # a typo'd exit code must not disarm the abort (get falls back)
        code = _env.get("MXTPU_WATCHDOG_EXIT_CODE")
        sys.stderr.write(
            "[flight-recorder] rank %d aborting hung process (exit %d) so "
            "the launcher can tear down / restart the group\n"
            % (core.rank(), code))
        sys.stderr.flush()
        os._exit(code)


def _ensure_watchdog():
    # env decision cached: this sits on the per-step hot path. Configure
    # MXTPU_WATCHDOG_TIMEOUT before the first training step.
    if _REC.watchdog_decided:
        return
    _REC.watchdog_decided = True
    timeout = _watchdog_timeout()
    if timeout is None:
        return
    t = threading.Thread(target=_watchdog_loop, args=(timeout,),
                         name="mxtpu-watchdog", daemon=True)
    _REC.watchdog = t
    t.start()
