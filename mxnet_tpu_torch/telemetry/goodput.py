"""Training goodput accounting: per-step stall attribution and cumulative
phase totals.

Counterpart of `mxnet_tpu/telemetry/goodput.py`, pure stdlib. A training
step brackets itself with :func:`step_start` / :func:`step_end` and
attributes slices of its wall time to exhaustive, non-overlapping phases:
``data_wait``, ``host_dispatch`` (Python between step entry and
:func:`mark_launch` that no finer phase claimed), ``compile``,
``compute``, ``checkpoint_stall``, ``collective`` and ``other`` (the
remainder, never negative). Per-step phases land in
``mxtpu_step_phase_seconds{phase=}`` histograms and cumulative
``mxtpu_goodput_phase_seconds_total{phase=}`` counters; a rolling window
of the last ``MXTPU_GOODPUT_WINDOW_STEPS`` steps feeds the
``mxtpu_goodput_fraction`` gauge (windowed compute / wall) and the
``/statusz`` ``training`` block; time between steps accumulates in the
cumulative-only ``between_steps`` phase.

The port's trainers bracket their steps as the JAX package's do:
`DistributedTrainer.step` (kind "dist"), `gluon.Trainer.step` ("train"),
`Module.fit` ("fit", back-dated to the data wait) and
`PipelineTrainer.step` ("pipeline"). Accounting state
is thread-local; the read paths used by signal handlers (:func:`snapshot`,
:func:`statusz_block`) are lock-free.
"""
import atexit
import collections
import threading
import time

from .. import env as _env
from . import core as _core
from . import tracing as _tracing

# step-internal phases (each has a per-step histogram series);
# ``between_steps`` additionally exists as a cumulative-only counter label
PHASES = ("data_wait", "host_dispatch", "compile", "compute",
          "checkpoint_stall", "collective", "other")

_TLS = threading.local()

# rolling (wall, compute, stall_phase, stall_seconds) of recent steps —
# sized lazily from MXTPU_GOODPUT_WINDOW_STEPS at first step
_WINDOW = collections.deque(maxlen=128)
_WINDOW_SIZED = False

_FIRST_STEP_TS = None  # wall-clock ts of the first completed step
_PROC_T0 = time.time()  # module import ≈ process start (post-fork exec)

_METRICS = None  # (hist_by_phase, ctr_by_phase, wall_ctr, frac_gauge)

_ATEXIT_REGISTERED = False


def _enabled():
    return _core._STATE.enabled and _env.get("MXTPU_GOODPUT")


def _metrics():
    global _METRICS, _WINDOW_SIZED, _WINDOW
    m = _METRICS
    if m is None:
        hists = {p: _core.histogram("mxtpu_step_phase_seconds",
                                    {"phase": p}) for p in PHASES}
        ctrs = {p: _core.counter("mxtpu_goodput_phase_seconds_total",
                                 {"phase": p})
                for p in PHASES + ("between_steps",)}
        m = _METRICS = (hists, ctrs,
                        _core.counter("mxtpu_goodput_wall_seconds_total"),
                        _core.gauge("mxtpu_goodput_fraction"))
    if not _WINDOW_SIZED:
        n = max(8, int(_env.get("MXTPU_GOODPUT_WINDOW_STEPS")))
        if n != _WINDOW.maxlen:
            _WINDOW = collections.deque(_WINDOW, maxlen=n)
        _WINDOW_SIZED = True  # GIL-atomic: one-time sizing latch
    return m


def _acct():
    return getattr(_TLS, "acct", None)


def step_start(kind="train", t0=None):
    """Open a step accounting bracket. ``t0`` back-dates the step start
    (``module.fit`` opens the bracket only after a successful iterator
    ``next()`` so StopIteration leaves no dangling bracket, but the wait
    itself belongs to the step). A bracket left open by a step that
    raised is silently discarded — no trainer nests one step inside
    another, so an open bracket here can only be stale."""
    if not _enabled():
        return
    now = time.perf_counter()
    t0 = now if t0 is None else t0
    # idle time since the previous step's end that no out-of-step add()
    # claimed: the training loop doing neither compute nor a named stall
    last_end = getattr(_TLS, "last_end", None)
    if last_end is not None and t0 > last_end:
        claimed = getattr(_TLS, "gap_attr", 0.0)
        gap = max(0.0, (t0 - last_end) - claimed)
        if gap > 0.0:
            _metrics()[1]["between_steps"].inc(gap)
    _TLS.gap_attr = 0.0
    _TLS.acct = {"kind": kind, "t0": t0, "phases": {}, "launched": False}
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        _ATEXIT_REGISTERED = True  # GIL-atomic: one-time latch
        # Registered at first step (AFTER core registered its final flush),
        # so LIFO atexit publishes the abandoned bracket before the flush.
        atexit.register(finalize)


def add(phase, seconds):
    """Attribute ``seconds`` to ``phase``. Inside an open bracket the time
    joins the current step; outside (async checkpoint submit between
    steps, compile at trainer construction) it goes straight to the
    cumulative counter and reduces the next ``between_steps`` gap."""
    if seconds <= 0.0 or phase not in PHASES or not _enabled():
        return
    a = _acct()
    if a is not None:
        ph = a["phases"]
        ph[phase] = ph.get(phase, 0.0) + seconds
        return
    _metrics()[1][phase].inc(seconds)
    _TLS.gap_attr = getattr(_TLS, "gap_attr", 0.0) + seconds


class phase:
    """``with goodput.phase("compute"):`` — attribute the block's elapsed
    time, MINUS whatever finer-grained attribution happened inside the
    block (an op resolving through the compile registry mid-step adds
    ``compile`` seconds; they must not also count as ``compute``). Keeps
    phases non-overlapping by construction. Cheap no-op when disabled."""

    __slots__ = ("_name", "_t0", "_nested0")

    def __init__(self, name):
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        a = _acct()
        self._nested0 = sum(a["phases"].values()) if a is not None else None
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        a = _acct()
        if a is not None and self._nested0 is not None:
            elapsed -= sum(a["phases"].values()) - self._nested0
        add(self._name, elapsed)
        return False


def mark_launch():
    """Stamp the executable-launch point: everything since step start that
    no finer phase claimed becomes ``host_dispatch`` (argument wrapping,
    cache lookups, Python glue before the device gets work)."""
    a = _acct()
    if a is None or a["launched"]:
        return
    a["launched"] = True
    elapsed = time.perf_counter() - a["t0"]
    ph = a["phases"]
    add("host_dispatch", elapsed - sum(ph.values()))


def step_end(step=None, examples=None):
    """Close the bracket: fill ``other`` with the unattributed remainder,
    publish per-phase histograms (exemplar = the step's sampled trace id,
    if any) + cumulative counters, advance the rolling window and the
    ``mxtpu_goodput_fraction`` gauge. Returns the step's phase dict
    (plus ``wall``) — tests assert exhaustiveness on it."""
    a = _acct()
    if a is None:
        return None
    _TLS.acct = None
    now = time.perf_counter()
    _TLS.last_end = now
    wall = max(0.0, now - a["t0"])
    ph = a["phases"]
    attributed = sum(ph.values())
    if attributed < wall:
        ph["other"] = ph.get("other", 0.0) + (wall - attributed)
    hists, ctrs, wall_ctr, frac = _metrics()
    tid = _tracing.current_trace_id()
    for p, v in ph.items():
        if v > 0.0:
            hists[p].observe(v, exemplar=tid)
            ctrs[p].inc(v)
    wall_ctr.inc(wall)

    compute = ph.get("compute", 0.0)
    stall_phase, stall_s = None, 0.0
    for p, v in ph.items():
        if p != "compute" and v > stall_s:
            stall_phase, stall_s = p, v
    _WINDOW.append((wall, compute, stall_phase, stall_s))
    w_wall = w_compute = 0.0
    for e in _win_steps():
        w_wall += e[0]
        w_compute += e[1]
    if w_wall > 0.0:
        frac.set(w_compute / w_wall)

    global _FIRST_STEP_TS
    if _FIRST_STEP_TS is None:
        _FIRST_STEP_TS = time.time()  # GIL-atomic: one-time stamp
        # the launcher ledger joins this against generation start to price
        # restart cost (rendezvous + restore + first-step compile).
        # ``startup_s`` runs module import → first step START (the step
        # itself is already phase-attributed — no double counting);
        # ``step_wall_s`` lets tools/goodput_report.py anchor the
        # attributed window's wall-clock start at ``ts - step_wall_s``.
        # Lazy import: recorder imports goodput for dumps, not the reverse.
        from . import recorder as _recorder

        _recorder.record_event(
            "goodput_first_step", trainer=a["kind"],
            generation=_core.restart_generation(),
            startup_s=round(max(0.0, _FIRST_STEP_TS - wall - _PROC_T0), 3),
            step_wall_s=round(wall, 4))
    out = dict(ph)
    out["wall"] = wall
    return out


def finalize():
    """Salvage an abandoned step bracket at process exit: a SIGTERM mid-
    step unwinds through ``phase.__exit__`` (so e.g. the seconds blocked
    in a dead peer's allreduce DID land in the bracket's ``collective``
    slot) but never reaches :func:`step_end`. Publish those accumulated
    phases to the cumulative counters so the rank's final telemetry flush
    carries them — registered at the first :func:`step_start` so LIFO
    atexit runs it before core's final flush. Reads the CALLING thread's
    bracket (atexit → main thread, where training loops run); a bracket
    open on another thread at exit is lost, which only widens the
    report's honest ``shutdown`` remainder."""
    a = _acct()
    if a is None or not _enabled():
        return
    _TLS.acct = None
    ph = a["phases"]
    attributed = sum(ph.values())
    if attributed <= 0.0:
        return
    _, ctrs, wall_ctr, _ = _metrics()
    for p, v in ph.items():
        if v > 0.0:
            ctrs[p].inc(v)
    # wall advances only by what was attributed: the tail between the
    # last phase exit and interpreter death is exit handling, not step
    # time — the report prices it from launcher timestamps instead.
    wall_ctr.inc(attributed)


def _win_steps():
    """Stable copy of the rolling step window (same retry discipline as
    core._win_entries — a trainer thread appending during a signal-context
    read raises RuntimeError)."""
    for _ in range(4):
        try:
            return list(_WINDOW)
        except RuntimeError:
            continue
    return []


def totals():
    """Cumulative attributed seconds per phase (including
    ``between_steps``) + total step wall. Plain value reads —
    signal-safe."""
    m = _METRICS
    if m is None:
        return {"phases": {}, "wall": 0.0}
    return {"phases": {p: c._value for p, c in m[1].items() if c._value},
            "wall": m[2]._value}


def statusz_block():
    """The `/statusz` ``training`` block: windowed goodput fraction, top
    stall phase over the window, cumulative totals, startup cost."""
    entries = _win_steps()
    w_wall = sum(e[0] for e in entries)
    w_compute = sum(e[1] for e in entries)
    stalls = {}
    for e in entries:
        if e[2] is not None:
            stalls[e[2]] = stalls.get(e[2], 0.0) + e[3]
    top = max(stalls.items(), key=lambda kv: kv[1]) if stalls else None
    block = {
        "enabled": bool(_enabled()),
        "window_steps": len(entries),
        "goodput_fraction": round(w_compute / w_wall, 4) if w_wall else None,
        "top_stall_phase": top[0] if top else None,
        "top_stall_seconds": round(top[1], 4) if top else 0.0,
        "totals": totals(),
    }
    if _FIRST_STEP_TS is not None:
        block["first_step_startup_s"] = round(_FIRST_STEP_TS - _PROC_T0, 3)
    return block


def snapshot():
    """Flight-recorder dump payload: statusz block shape (signal-safe)."""
    return statusz_block()


def _reset_for_tests():
    global _WINDOW, _WINDOW_SIZED, _METRICS, _FIRST_STEP_TS
    _WINDOW = collections.deque(maxlen=128)
    _WINDOW_SIZED = False
    _METRICS = None
    _FIRST_STEP_TS = None
    _TLS.acct = None
    _TLS.last_end = None
    _TLS.gap_attr = 0.0
