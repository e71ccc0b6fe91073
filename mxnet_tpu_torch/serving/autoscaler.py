"""Elastic autoscaling: the controller that closes the loop from load to
memory budget to replica count.

Counterpart of `mxnet_tpu/serving/autoscaler.py`:

  * **scale up** when an SLO objective scoped to a served model pages
    (p99 latency burn, queue-depth ceiling, availability) for
    ``MXTPU_AUTOSCALE_UP_WINDOWS`` consecutive laps. The new replica is
    admitted against the ``MXTPU_SERVE_MEMORY_BUDGET`` headroom (one more
    ``memory_bytes`` copy: every replica process holds a full copy of the
    weights, and a generation replica its KV pool), reclaiming cold
    residency first when short, and grows the pool IN PLACE
    (`ReplicaPool.add_replica`).
  * **scale down with a drain** on sustained idle
    (``MXTPU_AUTOSCALE_IDLE_S`` since the model's request counters last
    moved), never below the model's ``min_replicas``
    (`ReplicaPool.remove_replica(drain=True)`: the drained member finishes
    its work, or it fails over exactly once).
  * **hysteresis**: consecutive breached laps on the way up, the idle
    clock on the way down, and one ``MXTPU_AUTOSCALE_COOLDOWN_S`` between
    any two actions on a model.

Every decision shows: ``mxtpu_autoscale_decisions_total{action=}``,
``autoscale_{up,down,evict,blocked}`` events (`record_decision`, shared
with the repository's budget-pressure reclaim), the
``mxtpu_serve_replicas{model=}`` gauge (the pool's) and a bounded decision
trail on ``/statusz`` (`ServingServer.attach_autoscaler`).

The controller is one named daemon thread (``mxtpu-autoscaler``, joined
by `stop`). It reads `slo.verdicts()` and touches no CUDA: only the
replica processes do. With no objectives registered it only scales down.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import env as _env
from .. import telemetry
from ..base import MXNetError
from ..telemetry import core as _tm_core
from ..telemetry import memory as _tm_memory
from ..telemetry import slo as _slo

__all__ = ["Autoscaler", "record_decision", "request_age_s",
           "min_replicas", "max_replicas"]

_ACTIONS = ("up", "down", "evict", "blocked")

# the "has this model seen traffic lately" signals: predict admissions
# and generated tokens (LM pools have no request counter on the router)
_IDLE_METRICS = ("mxtpu_serve_requests_total",
                 "mxtpu_serve_generated_tokens_total")


def record_decision(action, model, **fields):
    """Publish one autoscaling decision: the
    ``mxtpu_autoscale_decisions_total{action=}`` counter plus an
    ``autoscale_<action>`` flight-recorder event, so ``/statusz`` and
    every watchdog/SIGUSR1 dump can explain what the controller (or the
    repository's budget-pressure bin-packing) did and why."""
    if action not in _ACTIONS:
        raise MXNetError("unknown autoscale action %r (one of %s)"
                         % (action, "|".join(_ACTIONS)))
    telemetry.counter("mxtpu_autoscale_decisions_total",
                      {"action": action}).inc()
    telemetry.record_event("autoscale_%s" % action, model=model, **fields)


def request_age_s(model_label, now=None):
    """Seconds since the model's request counters last moved (the
    windowed-staleness view) — the scale-down / eviction idle
    clock. None when no windowed signal exists yet (rings not rolled, or
    the model never saw a request)."""
    if now is None:
        now = time.time()
    _tm_core.roll_windows(now)  # throttled; staleness needs fresh rings
    age = None
    for m in _tm_core.get_registry().metrics():
        if m.name not in _IDLE_METRICS \
                or m.labels.get("model") != model_label:
            continue
        if not hasattr(m, "seconds_since_change"):
            continue
        s = m.seconds_since_change(now)
        if s is not None and (age is None or s < age):
            age = s  # ANY moving series keeps the model "hot"
    return age


def idle_age_s(model, now=None):
    """The effective idle age for scaling decisions: counter staleness
    when available, else time since load (a model that never served a
    request is as cold as its publish)."""
    if now is None:
        now = time.time()
    label = "%s/%d" % (model.name, model.version)
    age = request_age_s(label, now)
    if age is None:
        loaded = getattr(model, "loaded_at", None)
        age = max(0.0, now - loaded) if loaded else 0.0
    return age


def min_replicas(model):
    """The floor the autoscaler (and budget-pressure shrinking) honors
    for one served model: the model's declared ``min_replicas`` or the
    ``MXTPU_AUTOSCALE_MIN_REPLICAS`` default."""
    v = getattr(model, "min_replicas", None)
    if v is None:
        v = _env.get("MXTPU_AUTOSCALE_MIN_REPLICAS")
    return max(1, int(v))


def max_replicas(model):
    """The ceiling for scale-up: the model's declared ``max_replicas``
    or the ``MXTPU_AUTOSCALE_MAX_REPLICAS`` default (never below the
    floor)."""
    v = getattr(model, "max_replicas", None)
    if v is None:
        v = _env.get("MXTPU_AUTOSCALE_MAX_REPLICAS")
    return max(min_replicas(model), int(v))


class Autoscaler:
    """The per-server scaling controller over one `ModelRepository`.

    Parameters (all default to the ``MXTPU_AUTOSCALE_*`` registry):

    interval_ms : evaluation-lap period.
    up_windows : consecutive breached laps before a scale-up (the fast
        hysteresis — one noisy window never scales).
    idle_s : sustained idle (no request-counter movement) before a
        scale-down drain.
    cooldown_s : minimum seconds between two scaling actions on one
        model (up or down), so a decision's effect lands before the
        next one is taken.
    start : spawn the controller thread immediately (tests pass False
        and drive `evaluate_once` deterministically).
    """

    def __init__(self, repository, interval_ms=None, up_windows=None,
                 idle_s=None, cooldown_s=None, start=True):
        self.repository = repository
        if interval_ms is None:
            interval_ms = _env.get("MXTPU_AUTOSCALE_INTERVAL_MS")
        self.interval_s = max(0.05, float(interval_ms) / 1e3)
        if up_windows is None:
            up_windows = _env.get("MXTPU_AUTOSCALE_UP_WINDOWS")
        self.up_windows = max(1, int(up_windows))
        if idle_s is None:
            idle_s = _env.get("MXTPU_AUTOSCALE_IDLE_S")
        self.idle_s = max(0.0, float(idle_s))
        if cooldown_s is None:
            cooldown_s = _env.get("MXTPU_AUTOSCALE_COOLDOWN_S")
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._state = {}  # model label -> {"breach_laps", "last_scale"}
        # bounded decision trail for /statusz (deque appends/snapshots
        # are GIL-atomic; single-writer = the evaluating thread)
        self._decisions = collections.deque(maxlen=64)
        self._thread = None
        self._stop_event = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Start (or restart) the controller thread. Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        ev = threading.Event()
        t = threading.Thread(target=self._loop, args=(ev,),
                             name="mxtpu-autoscaler", daemon=True)
        self._stop_event = ev
        self._thread = t
        t.start()
        return self

    def stop(self, join=True):
        """Stop (and join) the controller thread."""
        t = self._thread
        ev = self._stop_event
        self._thread = None
        self._stop_event = None
        if ev is not None:
            ev.set()
        if t is not None and join:
            t.join(timeout=30.0)

    def running(self):
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self, stop_event):
        # stop_event captured as a local: a stop()/start() cycle
        # replaces the instance attribute and the OLD thread must keep
        # honoring the event it was started with
        while not stop_event.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # the controller must never die
                telemetry.record_event("autoscale_error", error=repr(e))

    # -- evaluation --------------------------------------------------------
    def evaluate_once(self, now=None, verdicts=None):
        """One controller lap over every pooled model. ``verdicts``
        injects a pre-computed verdict list (unit tests); the live path
        consumes `slo.verdicts()`. Returns the decisions taken."""
        if now is None:
            now = time.time()
        if verdicts is None:
            verdicts = _slo.verdicts()
        else:
            _tm_core.roll_windows(now)  # verdicts() would have rolled
        by_model = {}
        for v in verdicts:
            label = (v.get("labels") or {}).get("model")
            if label:
                by_model.setdefault(label, []).append(v)
        decisions = []
        for model in self.repository.models():
            pool = getattr(model, "pool", None)
            if pool is None:
                continue  # in-process models have no replica dimension
            try:
                d = self._evaluate_model(model, pool, by_model, now)
            except Exception as e:
                telemetry.record_event(
                    "autoscale_error", error=repr(e),
                    model="%s/%d" % (model.name, model.version))
                continue
            if d is not None:
                decisions.append(d)
        return decisions

    def _evaluate_model(self, model, pool, by_model, now):
        label = "%s/%d" % (model.name, model.version)
        # GIL-atomic: one evaluating thread at a time (the loop, or a test
        # driving evaluate_once with the loop stopped); readers snapshot
        # with a dict copy
        st = self._state.setdefault(
            label, {"breach_laps": 0, "last_scale": 0.0})
        paging = [v["slo"] for v in by_model.get(label, ())
                  if v.get("page")]
        if paging:
            st["breach_laps"] += 1
        else:
            st["breach_laps"] = 0
            st.pop("blocked_reason", None)  # episode over: re-arm blocked
        cooling = (now - st["last_scale"]) < self.cooldown_s
        if paging:
            if st["breach_laps"] < self.up_windows or cooling:
                return None  # hysteresis: breach must sustain
            return self._scale_up(model, pool, label, st, paging, now)
        if cooling or pool.size <= min_replicas(model):
            return None
        age = idle_age_s(model, now)
        if age < self.idle_s:
            return None
        return self._scale_down(model, pool, label, st, age, now)

    def _resident_bytes(self):
        return sum(getattr(m, "effective_memory_bytes", None) or 0
                   for m in self.repository.models())

    def _blocked(self, label, st, now, reason, **fields):
        """One blocked decision per sustained breach episode — a breach
        pinned at the ceiling must not re-fire the event every lap."""
        st["breach_laps"] = 0
        if st.get("blocked_reason") == reason:
            return None
        st["blocked_reason"] = reason
        return self._note("blocked", label, now, reason=reason, **fields)

    def _scale_up(self, model, pool, label, st, paging, now):
        size = pool.size
        if size >= max_replicas(model):
            return self._blocked(label, st, now, "max_replicas",
                                 size=size,
                                 max_replicas=max_replicas(model),
                                 slos=paging)
        # one more replica = one more full copy of the model resident
        # (docs/observability.md §Memory): admit it against the budget
        # headroom, reclaiming cold residency first when short
        needed = getattr(model, "memory_bytes", None)
        limit, warn_only = _tm_memory.serve_memory_budget()
        if needed and limit and not warn_only:
            headroom = limit - self._resident_bytes()
            if needed > headroom:
                reclaim = getattr(self.repository, "reclaim_memory", None)
                if reclaim is not None:
                    headroom += reclaim(needed - headroom, exclude=label,
                                        reason="scale_up")
            if needed > headroom:
                return self._blocked(label, st, now, "memory_budget",
                                     needed_bytes=needed,
                                     headroom_bytes=max(0, headroom),
                                     budget_bytes=limit, slos=paging)
        replica = pool.add_replica()
        st["last_scale"] = now
        st["breach_laps"] = 0
        st.pop("blocked_reason", None)
        self._publish_footprint(model)
        return self._note("up", label, now, replica=replica,
                          size=pool.size, slos=paging)

    def _scale_down(self, model, pool, label, st, age, now):
        try:
            # the floor re-checks ATOMICALLY inside remove_replica: a
            # concurrent budget-pressure reclaim may have shrunk the
            # pool since this lap's size read
            replica = pool.remove_replica(drain=True,
                                          floor=min_replicas(model))
        except MXNetError:
            return None  # lost the race to another remover: no-op lap
        st["last_scale"] = time.time()  # the drain itself took time
        self._publish_footprint(model)
        return self._note("down", label, now, reason="idle",
                          replica=replica, size=pool.size,
                          idle_s=round(age, 3))

    def _publish_footprint(self, model):
        """Refresh the model's effective-footprint gauge after a resize
        (every replica holds a full copy, so the budget-facing figure
        just changed)."""
        eff = getattr(model, "effective_memory_bytes", None)
        if eff:
            telemetry.gauge(
                "mxtpu_serve_model_memory_bytes",
                {"model": "%s/%d" % (model.name, model.version)}).set(eff)

    def _note(self, action, label, now, **fields):
        record_decision(action, label, **fields)
        d = dict(fields, action=action, model=label, ts=now)
        # GIL-atomic: a bounded deque append from one evaluating thread;
        # describe() snapshots it with list()
        self._decisions.append(d)
        return d

    # -- observability -----------------------------------------------------
    def describe(self):
        """Plain-dict controller state for ``/statusz`` (lock-free:
        GIL-atomic snapshot reads only — the page must answer even when
        a drain is in progress)."""
        return {
            "running": self.running(),
            "interval_s": self.interval_s,
            "up_windows": self.up_windows,
            "idle_s": self.idle_s,
            "cooldown_s": self.cooldown_s,
            "models": {label: dict(st)
                       for label, st in dict(self._state).items()},
            "decisions": list(self._decisions),
        }
