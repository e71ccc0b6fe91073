"""SLO engine: declarative objectives, burn-rate evaluation, /statusz.

Counterpart of `mxnet_tpu/telemetry/slo.py`, pure stdlib, under its
objective names, metric names and event kinds:

  * **Objectives**: typed and declarative: a latency quantile under X, an
    error rate (availability), a gauge ceiling or floor (queue depth, KV
    occupancy, MFU), staleness (a counter that stopped moving). Serving
    wires its own at load (`wire_serving_objectives`,
    `wire_generate_objectives`), training its optional ones at the first
    step (`wire_training`), and a JSON spec file (``MXTPU_SLO_SPEC``) adds
    more. A malformed spec raises `SLOSpecError` at once.
  * **Evaluator**: one named daemon thread (``mxtpu-slo-evaluator``,
    joined by `stop`) rolls the window rings, computes multi-window burn
    rates (fast page-level windows, a slow ticket-level one), publishes
    ``mxtpu_slo_{healthy,burn_rate,budget_remaining}`` and records
    ``slo_breach`` / ``slo_recovered`` events and alerts.
  * **`verdicts()`** / `compute_verdicts(now=)`: the verdicts as plain
    dicts, the autoscaler's input.
  * **`/statusz`**: `statusz_payload()` joins the verdicts with windowed
    key rates, pool health, the memory snapshot and the slowest traced
    exemplars; `render_statusz` serves it as JSON or text. It reads
    lock-free snapshots and ring diffs only.

Burn rate: every objective reduces to a bad fraction over a window and a
budget (the allowed bad fraction); ``burn = bad / budget``, 1.0 consuming
the budget exactly at the allowed rate. A page needs every fast window at
``MXTPU_SLO_BURN_PAGE`` or above; the slow window drives the ticket and
``budget_remaining``. ``MXTPU_SLO=0`` disables the engine (the rings
still roll for the raw windowed views).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

from .. import env as _env
from . import core
from . import goodput
from . import memory
from . import recorder

__all__ = [
    "SLOSpecError", "Objective", "register", "unregister",
    "unregister_model", "objectives", "clear", "load_spec", "verdicts",
    "compute_verdicts", "ensure_evaluator", "start", "stop", "running",
    "statusz_payload", "render_statusz", "wire_serving_objectives",
    "wire_generate_objectives", "wire_training",
]

_METRIC_NAME_RE = re.compile(r"^mxtpu_[a-z0-9_]+$")

_KINDS = ("latency_quantile", "error_rate", "gauge_ceiling", "gauge_floor",
          "staleness")

# the eager-validation catalog: metric names an objective may target. The
# docs/observability.md Metrics table is the authoritative registry
# (metric-registry lint enforces it); this is the SUBSET that makes sense
# as an SLO signal, so a spec naming a metric that will never exist fails
# at load instead of evaluating no_data forever. Live registry names are
# also accepted (tests and bespoke instrumentation), and an objective can
# opt out with ``allow_unknown_metric``.
_SPEC_METRICS = frozenset((
    "mxtpu_serve_request_seconds", "mxtpu_serve_queue_seconds",
    "mxtpu_serve_compute_seconds", "mxtpu_serve_requests_total",
    "mxtpu_serve_rejected_total", "mxtpu_serve_http_requests_total",
    "mxtpu_serve_queue_depth", "mxtpu_serve_batch_occupancy",
    "mxtpu_serve_examples_total", "mxtpu_serve_batches_total",
    "mxtpu_serve_intertoken_seconds", "mxtpu_serve_prefill_seconds",
    "mxtpu_serve_generated_tokens_total", "mxtpu_serve_decode_steps_total",
    "mxtpu_serve_kv_pages_used", "mxtpu_serve_kv_pages_total",
    "mxtpu_serve_kv_occupancy", "mxtpu_serve_active_sequences",
    "mxtpu_serve_pool_healthy", "mxtpu_serve_pool_size",
    "mxtpu_step_seconds", "mxtpu_steps_total", "mxtpu_step_mfu",
    "mxtpu_examples_per_sec", "mxtpu_examples_total",
    "mxtpu_data_wait_seconds_total", "mxtpu_collective_seconds",
    "mxtpu_checkpoint_seconds", "mxtpu_device_bytes_in_use",
    "mxtpu_process_rss_bytes", "mxtpu_ndarray_live_bytes",
    "mxtpu_step_phase_seconds", "mxtpu_goodput_fraction",
    "mxtpu_goodput_phase_seconds_total", "mxtpu_goodput_wall_seconds_total",
    "mxtpu_checkpoint_stall_seconds",
))


class SLOSpecError(ValueError):
    """Typed error for a malformed SLO spec or objective declaration
    (bad JSON, unknown kind, unknown metric, missing/ill-typed field)."""


def enabled():
    """Is the SLO engine on? (``MXTPU_SLO``, default on; also requires the
    metrics layer itself to be enabled.)"""
    return _env.get("MXTPU_SLO") and core._STATE.enabled


def _fast_windows():
    raw = _env.raw("MXTPU_SLO_FAST_WINDOWS") or "60,300"
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue
        if w > 0:
            out.append(w)
    return out or [60.0, 300.0]


def _eval_period_s():
    ms = _env.get("MXTPU_SLO_EVAL_MS")
    if ms is None or ms <= 0:
        return core._window_s()
    return max(0.05, ms / 1e3)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _check_metric_name(name, allow_unknown):
    if not isinstance(name, str) or not _METRIC_NAME_RE.match(name or ""):
        raise SLOSpecError(
            "SLO metric name %r is not a valid mxtpu_* metric name" % (name,))
    if allow_unknown or name in _SPEC_METRICS:
        return
    for m in core.get_registry().metrics():
        if m.name == name:
            return
    raise SLOSpecError(
        "SLO objective targets unknown metric %r — not in the objective "
        "catalog and not registered in this process; fix the name (see "
        "docs/observability.md Metrics table) or set "
        "allow_unknown_metric=true" % (name,))


def _check_selectors(field, raw, allow_unknown):
    """Normalize an error_rate selector list to [(name, labels), ...]."""
    if not isinstance(raw, (list, tuple)) or not raw:
        raise SLOSpecError("error_rate objective needs a non-empty %r "
                           "selector list" % (field,))
    out = []
    for sel in raw:
        if isinstance(sel, str):
            name, labels = sel, {}
        elif isinstance(sel, (list, tuple)) and len(sel) == 2:
            name, labels = sel
        elif isinstance(sel, dict):
            name, labels = sel.get("metric"), sel.get("labels") or {}
        else:
            raise SLOSpecError("bad %r selector %r (want a metric name, "
                               "(name, labels) pair, or {'metric':, "
                               "'labels':})" % (field, sel))
        if not isinstance(labels, dict):
            raise SLOSpecError("selector labels for %r must be an object, "
                               "got %r" % (name, labels))
        _check_metric_name(name, allow_unknown)
        out.append((name, dict(labels)))
    return out


class Objective:
    """One declarative objective. Validation is EAGER: a malformed
    declaration raises `SLOSpecError` at construction, never at
    evaluation time."""

    __slots__ = ("name", "kind", "metric", "labels", "threshold", "quantile",
                 "budget", "bad", "total", "fast_windows", "slow_window",
                 "burn_page", "burn_ticket", "description")

    def __init__(self, name, kind, metric=None, labels=None, threshold=None,
                 quantile=0.99, budget=None, bad=None, total=None,
                 fast_windows=None, slow_window=None, burn_page=None,
                 burn_ticket=None, description="",
                 allow_unknown_metric=False):
        if not name or not isinstance(name, str):
            raise SLOSpecError("objective needs a non-empty string name, "
                              "got %r" % (name,))
        if kind not in _KINDS:
            raise SLOSpecError("objective %r: unknown kind %r (one of %s)"
                               % (name, kind, "|".join(_KINDS)))
        self.name = name
        self.kind = kind
        self.labels = dict(labels or {})
        self.description = description or ""
        if kind == "error_rate":
            self.metric = None
            self.bad = _check_selectors("bad", bad, allow_unknown_metric)
            self.total = _check_selectors("total", total,
                                          allow_unknown_metric)
            if budget is None:
                raise SLOSpecError(
                    "error_rate objective %r needs a budget (allowed bad "
                    "fraction, e.g. 0.001) or an availability target"
                    % name)
        else:
            if bad or total:
                raise SLOSpecError("objective %r: bad=/total= selectors "
                                   "are error_rate-only" % name)
            _check_metric_name(metric, allow_unknown_metric)
            self.metric = metric
            self.bad = self.total = None
            if threshold is None:
                raise SLOSpecError("objective %r (%s) needs a threshold"
                                   % (name, kind))
        if threshold is not None:
            try:
                threshold = float(threshold)
            except (TypeError, ValueError):
                raise SLOSpecError("objective %r: threshold %r is not a "
                                   "number" % (name, threshold)) from None
            if threshold <= 0 and kind != "gauge_floor":
                raise SLOSpecError("objective %r: threshold must be > 0, "
                                   "got %g" % (name, threshold))
        self.threshold = threshold
        try:
            quantile = float(quantile)
        except (TypeError, ValueError):
            raise SLOSpecError("objective %r: quantile %r is not a number"
                               % (name, quantile)) from None
        if not 0.0 < quantile < 1.0:
            raise SLOSpecError("objective %r: quantile must be in (0, 1), "
                               "got %g" % (name, quantile))
        self.quantile = quantile
        if budget is None:
            # latency: the quantile IS the budget (p99 => 1% may be slow);
            # gauges: a quarter of the window's samples may violate before
            # the objective burns at rate 1
            budget = (1.0 - quantile) if kind == "latency_quantile" else 0.25
        try:
            budget = float(budget)
        except (TypeError, ValueError):
            raise SLOSpecError("objective %r: budget %r is not a number"
                               % (name, budget)) from None
        if not 0.0 < budget <= 1.0:
            raise SLOSpecError("objective %r: budget must be in (0, 1], "
                               "got %g" % (name, budget))
        self.budget = budget
        self.fast_windows = [float(w) for w in
                             (fast_windows or _fast_windows())]
        if not self.fast_windows or min(self.fast_windows) <= 0:
            raise SLOSpecError("objective %r: fast_windows must be "
                               "positive seconds" % name)
        self.slow_window = float(slow_window if slow_window is not None
                                 else _env.get("MXTPU_SLO_SLOW_WINDOW_S"))
        self.burn_page = float(burn_page if burn_page is not None
                               else _env.get("MXTPU_SLO_BURN_PAGE"))
        self.burn_ticket = float(burn_ticket if burn_ticket is not None
                                 else _env.get("MXTPU_SLO_BURN_TICKET"))

    _SPEC_KEYS = frozenset((
        "name", "kind", "metric", "labels", "threshold", "threshold_ms",
        "quantile", "budget", "availability", "bad", "total",
        "fast_windows", "slow_window", "burn_page", "burn_ticket",
        "description", "allow_unknown_metric"))

    @classmethod
    def from_spec(cls, entry):
        """One objective from a spec-file JSON object. Unknown keys are an
        eager error (a typo'd ``treshold_ms`` must not silently leave the
        default in force)."""
        if not isinstance(entry, dict):
            raise SLOSpecError("spec objective must be a JSON object, got "
                               "%r" % (entry,))
        unknown = sorted(set(entry) - cls._SPEC_KEYS)
        if unknown:
            raise SLOSpecError("spec objective %r: unknown key(s) %s"
                               % (entry.get("name"), ", ".join(unknown)))
        kwargs = {k: entry[k] for k in entry
                  if k in cls._SPEC_KEYS and k not in
                  ("name", "kind", "threshold_ms", "availability")}
        threshold = entry.get("threshold")
        if entry.get("threshold_ms") is not None:
            if threshold is not None:
                raise SLOSpecError("spec objective %r: give threshold OR "
                                   "threshold_ms, not both"
                                   % entry.get("name"))
            try:
                threshold = float(entry["threshold_ms"]) / 1e3
            except (TypeError, ValueError):
                raise SLOSpecError(
                    "spec objective %r: threshold_ms %r is not a number"
                    % (entry.get("name"),
                       entry.get("threshold_ms"))) from None
        kwargs["threshold"] = threshold
        if entry.get("availability") is not None:
            if entry.get("budget") is not None:
                raise SLOSpecError("spec objective %r: give budget OR "
                                   "availability, not both"
                                   % entry.get("name"))
            try:
                avail = float(entry["availability"])
            except (TypeError, ValueError):
                raise SLOSpecError(
                    "spec objective %r: availability %r is not a number"
                    % (entry.get("name"), entry.get("availability"))) \
                    from None
            if not 0.0 < avail < 1.0:
                raise SLOSpecError("spec objective %r: availability must "
                                   "be in (0, 1)" % entry.get("name"))
            kwargs["budget"] = 1.0 - avail
        return cls(entry.get("name"), entry.get("kind"), **kwargs)

    def to_dict(self):
        return {"name": self.name, "kind": self.kind, "metric": self.metric,
                "labels": dict(self.labels), "threshold": self.threshold,
                "quantile": self.quantile, "budget": self.budget,
                "bad": self.bad, "total": self.total,
                "fast_windows": list(self.fast_windows),
                "slow_window": self.slow_window,
                "burn_page": self.burn_page,
                "burn_ticket": self.burn_ticket,
                "description": self.description}


# ---------------------------------------------------------------------------
# engine state
# ---------------------------------------------------------------------------

class _SLOState:
    def __init__(self):
        self.owner_pid = os.getpid()
        self.objectives = {}      # name -> Objective (writes under _REG_LOCK)
        self.spec_objectives = {}  # name -> Objective as declared in the
        #                            spec file — survives unregister_model
        #                            so a model reload restores them
        self.thread = None        # evaluator thread (or None)
        self.stop_event = None
        self.spec_loaded = False
        self.last_verdicts = None  # {"ts":, "verdicts": [...]} plain swap
        self.breaching = {}        # objective name -> breach-start ts
        self.wired_train = set()   # trainer kinds already wired
        self.eval_errors = 0


_STATE = _SLOState()

# serializes registration/spec-load/evaluator start-stop (cold paths);
# NEVER taken on the verdict-compute / statusz read path, which stays
# lock-free by construction
_REG_LOCK = threading.Lock()


def _reset_after_fork():
    st = _SLOState()
    st.objectives = dict(_STATE.objectives)  # declarations survive the fork
    st.spec_objectives = dict(_STATE.spec_objectives)
    st.spec_loaded = _STATE.spec_loaded
    st.wired_train = set(_STATE.wired_train)
    globals()["_STATE"] = st


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_after_fork)


def register(objective, replace=True):
    """Register (or replace) one objective; starts the evaluator when the
    engine is enabled. Returns the registered objective."""
    if not isinstance(objective, Objective):
        raise SLOSpecError("register() wants an Objective, got %r"
                           % (objective,))
    with _REG_LOCK:
        if not replace and objective.name in _STATE.objectives:
            return _STATE.objectives[objective.name]
        _STATE.objectives[objective.name] = objective
    ensure_evaluator()
    return objective


def _drop_gauges(name):
    """Retire one objective's published gauge series: a model unloaded
    while breaching must not export `mxtpu_slo_healthy{...}=0` forever —
    an alert that could never resolve."""
    reg = core.get_registry()
    labels = {"slo": name}
    for mname in ("mxtpu_slo_healthy", "mxtpu_slo_burn_rate",
                  "mxtpu_slo_budget_remaining"):
        reg.remove(mname, labels)


def unregister(name):
    """Drop one objective by name (idempotent), retiring its gauges."""
    with _REG_LOCK:
        _STATE.objectives.pop(name, None)
        _STATE.breaching.pop(name, None)
    _drop_gauges(name)  # outside _REG_LOCK: registry lock stays a leaf


def unregister_model(model_label):
    """Drop every objective scoped to a served model (its batcher/scheduler
    is closing; verdicts for a gone model are noise)."""
    with _REG_LOCK:
        dropped = [n for n, o in _STATE.objectives.items()
                   if o.labels.get("model") == model_label]
        for name in dropped:
            _STATE.objectives.pop(name, None)
            _STATE.breaching.pop(name, None)
    for name in dropped:
        _drop_gauges(name)


def objectives():
    """Registered objectives (copy; dict copy is GIL-atomic — no lock on
    the read path)."""
    return list(_STATE.objectives.values())


def clear():
    """Drop every objective (tests)."""
    with _REG_LOCK:
        _STATE.objectives.clear()
        _STATE.breaching.clear()
        _STATE.spec_objectives.clear()
        _STATE.spec_loaded = False


# ---------------------------------------------------------------------------
# spec file
# ---------------------------------------------------------------------------

def load_spec(path=None):
    """Load objectives from a JSON spec file (default: ``MXTPU_SLO_SPEC``)
    and register them. Returns the objectives registered. Every failure is
    a typed, EAGER `SLOSpecError`."""
    path = path or _env.raw("MXTPU_SLO_SPEC")
    if not path:
        return []
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        raise SLOSpecError("cannot read SLO spec %s: %s" % (path, e)) \
            from None
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise SLOSpecError("SLO spec %s is not valid JSON: %s" % (path, e)) \
            from None
    if not isinstance(doc, dict) or not isinstance(doc.get("objectives"),
                                                   list):
        raise SLOSpecError("SLO spec %s must be an object with an "
                           "'objectives' array" % path)
    objs = [Objective.from_spec(entry) for entry in doc["objectives"]]
    for obj in objs:
        with _REG_LOCK:
            # remembered separately: unregister_model drops the LIVE
            # objective when its model unloads, but a reload of the same
            # model must restore the operator's declaration, not fall
            # back to the env-default built-in
            _STATE.spec_objectives[obj.name] = obj
        register(obj)
    return objs


def _restore_spec_for(model_label):
    """Re-register the spec file's objectives scoped to a (re)loading
    model — replace=True, so they beat the just-wired built-ins."""
    for obj in list(_STATE.spec_objectives.values()):
        if obj.labels.get("model") == model_label:
            register(obj)


def _ensure_spec():
    if _STATE.spec_loaded:
        return
    with _REG_LOCK:
        if _STATE.spec_loaded:
            return
        # set BEFORE loading: load_spec -> register -> ensure_evaluator
        # re-enters here, and the flag is the recursion guard
        _STATE.spec_loaded = True
    if _env.raw("MXTPU_SLO_SPEC"):
        try:
            load_spec()
        except Exception:
            # a failed load must not latch: the operator fixes the spec
            # file and the next model load retries (and re-raises) —
            # otherwise the corrected objectives silently never register
            _STATE.spec_loaded = False  # GIL-atomic: unlatch on failure
            raise


# ---------------------------------------------------------------------------
# evaluation (lock-free: ring diffs + live values only — this is the path
# /statusz and the signal-safety walk go through)
# ---------------------------------------------------------------------------

def _metric_index():
    """One name -> [metric series] map from a single registry scan —
    every selector lookup in a compute_verdicts pass resolves against it
    instead of re-walking the whole registry per selector per window."""
    idx = {}
    for m in core.get_registry().metrics():
        idx.setdefault(m.name, []).append(m)
    return idx


def _match(name, labels, index=None):
    """Every registered metric with this name whose labels are a superset
    of ``labels`` (multi-series selectors sum across e.g. the rejection
    reasons of one model)."""
    if index is None:
        index = _metric_index()
    out = []
    for m in index.get(name, ()):
        ml = m.labels
        ok = True
        for k, v in (labels or {}).items():
            if ml.get(k) != v:
                ok = False
                break
        if ok:
            out.append(m)
    return out


def _counter_window(selectors, seconds, now, index=None):
    """Summed (delta, elapsed) across selector-matched counters over the
    trailing window; None when no matched counter has a ring yet."""
    delta = 0.0
    elapsed = 0.0
    seen = False
    for name, labels in selectors:
        for m in _match(name, labels, index):
            if not hasattr(m, "windowed_delta"):
                continue
            d = m.windowed_delta(seconds, now)
            if d is None:
                continue
            seen = True
            delta += d[0]
            if d[1] > elapsed:
                elapsed = d[1]
    if not seen:
        return None
    return (delta, elapsed)


def _merged_hist_window(name, labels, seconds, now, index=None):
    """Bucket-delta window merged across every matching histogram series
    (same metric name => same bounds by construction); None when no
    series has a ring yet."""
    bounds = None
    deltas = None
    count = 0
    total = 0.0
    elapsed = 0.0
    for m in _match(name, labels, index):
        if not hasattr(m, "windowed"):
            continue
        w = m.windowed(seconds, now)
        if w is None:
            continue
        if bounds is None:
            bounds = w["bounds"]
            deltas = list(w["bucket_deltas"])
        elif w["bounds"] == bounds:
            deltas = [a + b for a, b in zip(deltas, w["bucket_deltas"])]
        else:
            continue  # mismatched custom bounds: skip rather than corrupt
        count += w["count"]
        total += w["sum"]
        if w["elapsed"] > elapsed:
            elapsed = w["elapsed"]
    if bounds is None:
        return None
    return {"bounds": bounds, "bucket_deltas": deltas, "count": count,
            "sum": total, "elapsed": elapsed}


def _frac_over(bounds, deltas, count, threshold):
    """Fraction of windowed observations above ``threshold``. Buckets
    whose upper bound is <= threshold are provably good; the bucket
    spanning the threshold counts bad (conservative)."""
    if count <= 0:
        return 0.0
    good = 0.0
    for bound, d in zip(bounds, deltas):
        if bound <= threshold:
            good += d
        else:
            break
    return max(0.0, count - good) / count


def _window_burn(obj, seconds, now, index=None):
    """One window's burn figure for one objective:
    {'burn','value','count','no_data'} — burn 1.0 = consuming the error
    budget exactly at the allowed rate over this window."""
    if obj.kind == "latency_quantile":
        w = _merged_hist_window(obj.metric, obj.labels, seconds, now,
                                index)
        if w is None or w["count"] <= 0:
            return {"burn": 0.0, "value": None, "count": 0, "no_data": True}
        value = core.quantile_from_deltas(w["bounds"], w["bucket_deltas"],
                                          w["count"], obj.quantile)
        bad = _frac_over(w["bounds"], w["bucket_deltas"], w["count"],
                         obj.threshold)
        return {"burn": min(1e6, bad / obj.budget), "value": value,
                "count": w["count"], "no_data": False}
    if obj.kind == "error_rate":
        total = _counter_window(obj.total, seconds, now, index)
        if total is None or total[0] <= 0:
            return {"burn": 0.0, "value": None, "count": 0, "no_data": True}
        bad = _counter_window(obj.bad, seconds, now, index)
        frac = max(0.0, (bad[0] if bad else 0.0)) / total[0]
        return {"burn": min(1e6, frac / obj.budget), "value": frac,
                "count": int(total[0]), "no_data": False}
    if obj.kind in ("gauge_ceiling", "gauge_floor"):
        samples = []
        for m in _match(obj.metric, obj.labels, index):
            if hasattr(m, "windowed_values"):
                samples.extend(v for _, v in
                               m.windowed_values(seconds, now))
        if not samples:
            return {"burn": 0.0, "value": None, "count": 0, "no_data": True}
        if obj.kind == "gauge_ceiling":
            viol = sum(1 for v in samples if v > obj.threshold)
            value = max(samples)
        else:
            viol = sum(1 for v in samples if v < obj.threshold)
            value = min(samples)
        frac = viol / float(len(samples))
        return {"burn": min(1e6, frac / obj.budget), "value": value,
                "count": len(samples), "no_data": False}
    # staleness: seconds since the counter last moved, vs the threshold
    stale = None
    for m in _match(obj.metric, obj.labels, index):
        if not hasattr(m, "seconds_since_change"):
            continue
        s = m.seconds_since_change(now)
        if s is not None and (stale is None or s < stale):
            stale = s  # ANY live series keeps the signal fresh
    if stale is None:
        return {"burn": 0.0, "value": None, "count": 0, "no_data": True}
    return {"burn": min(1e6, stale / obj.threshold), "value": stale,
            "count": 1, "no_data": False}


def _exemplar_for(obj, index=None):
    """The offending metric's tail exemplar (highest-bucket traced
    observation) for a latency objective — the trace id a breach event
    names so the page links to a renderable trace."""
    if obj.kind != "latency_quantile":
        return None
    best = None
    for m in _match(obj.metric, obj.labels, index):
        if not hasattr(m, "exemplars"):
            continue
        for ex in m.exemplars().values():
            if best is None or ex["value"] > best["value"]:
                best = ex
    return best


def _eval_objective(obj, now, index=None):
    """Full multi-window verdict for one objective (a plain dict — the
    `verdicts()` API shape)."""
    if index is None:
        index = _metric_index()
    windows = {}
    for w in obj.fast_windows:
        windows["%gs" % w] = dict(_window_burn(obj, w, now, index),
                                   window_s=w)
    slow_key = "%gs" % obj.slow_window
    if slow_key not in windows:
        windows[slow_key] = dict(_window_burn(obj, obj.slow_window, now,
                                              index),
                                 window_s=obj.slow_window)
    fast = [windows["%gs" % w] for w in obj.fast_windows]
    slow = windows[slow_key]
    fast_with_data = [r for r in fast if not r["no_data"]]
    page = bool(fast) and len(fast_with_data) == len(fast) and \
        min(r["burn"] for r in fast) >= obj.burn_page
    ticket = (not slow["no_data"]) and slow["burn"] >= obj.burn_ticket
    burn = max((r["burn"] for r in fast_with_data), default=0.0)
    no_data = not fast_with_data and slow["no_data"]
    if slow["no_data"]:
        budget_remaining = None
    else:
        budget_remaining = min(1.0, max(0.0, 1.0 - slow["burn"]))
    value = fast_with_data[0]["value"] if fast_with_data else None
    ex = _exemplar_for(obj, index)
    return {
        "slo": obj.name,
        "kind": obj.kind,
        "metric": obj.metric or [s[0] for s in (obj.bad or [])],
        "labels": dict(obj.labels),
        "description": obj.description,
        "threshold": obj.threshold,
        "quantile": obj.quantile if obj.kind == "latency_quantile" else None,
        "budget": obj.budget,
        "healthy": not page,
        "page": page,
        "ticket": ticket,
        "no_data": no_data,
        "burn_rate": round(burn, 4),
        "budget_remaining": budget_remaining,
        "value": value,
        "windows": windows,
        "exemplar_trace": ex["trace"] if ex else None,
        "exemplar_value": ex["value"] if ex else None,
    }


def compute_verdicts(now=None):
    """Evaluate every registered objective against the current window
    rings (rolling them first, throttled). Pure reads — safe from any
    thread, never takes a library lock, never publishes gauges or events
    (that is the evaluator loop's job)."""
    if now is None:
        now = time.time()
    core.roll_windows(now)
    index = _metric_index()  # ONE registry scan for the whole pass
    return [_eval_objective(obj, now, index) for obj in objectives()]


def verdicts():
    """Current per-objective verdicts: the evaluator's last published set
    when fresh, else computed on the spot. THE programmatic hook the
    autoscaler consumes (scale up when a queue-depth/p99 verdict
    pages, scale down when budgets sit untouched)."""
    return _fresh_verdicts(time.time(), update=True)


# ---------------------------------------------------------------------------
# evaluator thread
# ---------------------------------------------------------------------------

def _slo_gauges(name):
    labels = {"slo": name}
    reg = core.get_registry()
    return (reg.gauge("mxtpu_slo_healthy", labels),
            reg.gauge("mxtpu_slo_burn_rate", labels),
            reg.gauge("mxtpu_slo_budget_remaining", labels))


def _publish(verds, now):
    """Gauge + transition-event publication (evaluator thread only, so
    breach/recovery transitions are single-writer)."""
    for v in verds:
        name = v["slo"]
        if name not in _STATE.objectives:
            continue  # unregistered since this lap's compute: don't
            #           resurrect the gauges _drop_gauges just retired
        g_ok, g_burn, g_budget = _slo_gauges(name)
        g_ok.set(1 if v["healthy"] else 0)
        g_burn.set(v["burn_rate"])
        if v["budget_remaining"] is not None:
            g_budget.set(v["budget_remaining"])
        since = _STATE.breaching.get(name)
        if v["page"] and since is None:
            # transition state is SINGLE-WRITER (this runs only on the
            # evaluator thread); the registration paths' locked pops only
            # delete entries for objectives being dropped entirely
            _STATE.breaching[name] = now  # evaluator-only state
            fields = {"slo": name, "objective_kind": v["kind"],
                      "metric": v["metric"], "labels": v["labels"],
                      "burn_rate": v["burn_rate"],
                      "threshold": v["threshold"], "value": v["value"],
                      "budget_remaining": v["budget_remaining"],
                      "exemplar_trace": v["exemplar_trace"]}
            recorder.record_event("slo_breach", **fields)
            recorder.record_alert("slo_breach", fields)
        elif since is not None and not v["page"]:
            _STATE.breaching.pop(name, None)  # evaluator-only state
            fields = {"slo": name, "objective_kind": v["kind"],
                      "burned_for_s": round(now - since, 3),
                      "burn_rate": v["burn_rate"], "value": v["value"]}
            recorder.record_event("slo_recovered", **fields)
            recorder.record_alert("slo_recovered", fields)
        if name not in _STATE.objectives:
            # unregister_model ran BETWEEN the membership check above and
            # the gauge writes: self-heal by retiring what we just set
            # (whichever of the two drops runs last leaves a clean state)
            _STATE.breaching.pop(name, None)  # evaluator-only state
            _drop_gauges(name)


def _evaluate_and_publish(now=None):
    if now is None:
        now = time.time()
    verds = compute_verdicts(now)
    # whole-dict swap; statusz/verdicts() readers see old or new, whole
    # GIL-atomic: a whole-dict swap
    _STATE.last_verdicts = {"ts": now, "verdicts": verds}
    _publish(verds, now)
    return verds


def _evaluator_loop(stop_event):
    # stop_event captured as a local: a stop()/start() cycle replaces
    # _STATE.stop_event, and the OLD thread must keep honoring the event
    # it was started with
    while not stop_event.wait(_eval_period_s()):
        if os.getpid() != _STATE.owner_pid:
            return  # forked child inherited the state marker only
        if not enabled():
            continue  # runtime-disabled: keep the thread, skip the work
        try:
            _evaluate_and_publish()
        except Exception as e:  # the evaluator must never die
            _STATE.eval_errors += 1  # GIL-atomic: error tally
            recorder.record_event("slo_evaluator_error", error=repr(e))


def ensure_evaluator():
    """Start the evaluator once objectives exist and the engine is enabled
    (lazy; called from registration). Idempotent."""
    if _STATE.thread is not None or not enabled():
        return
    _ensure_spec()
    with _REG_LOCK:
        if _STATE.thread is not None or not _STATE.objectives:
            return
        ev = threading.Event()
        t = threading.Thread(target=_evaluator_loop, args=(ev,),
                             name="mxtpu-slo-evaluator", daemon=True)
        _STATE.stop_event = ev
        _STATE.thread = t
        # start INSIDE the lock: a concurrent stop() that wins the lock
        # next must never see (and try to join) a not-yet-started thread
        t.start()


def start():
    """Explicit evaluator start (loads ``MXTPU_SLO_SPEC`` first)."""
    _ensure_spec()
    ensure_evaluator()
    return running()


def stop(join=True):
    """Stop (and join) the evaluator thread; a later register()/start()
    spawns a fresh one."""
    with _REG_LOCK:
        t = _STATE.thread
        ev = _STATE.stop_event
        _STATE.thread = None
        _STATE.stop_event = None
    if t is None:
        return
    if ev is not None:
        ev.set()
    if join:
        t.join(timeout=5.0)


def running():
    t = _STATE.thread
    return t is not None and t.is_alive()


# ---------------------------------------------------------------------------
# built-in objective wiring (serving / generation / training)
# ---------------------------------------------------------------------------

def wire_serving_objectives(model_label, queue_depth=None):
    """Default serving objectives for one served model, registered at
    batcher creation: request-latency p99, availability, queue-depth
    ceiling. Thresholds come from the ``MXTPU_SLO_SERVE_*`` env knobs; a
    spec file can replace any of them by registering the same name."""
    if not enabled():
        return
    labels = {"model": model_label}
    # replace=False: an operator's MXTPU_SLO_SPEC objective of the same
    # name (loaded before the model) must win over the env-default one
    register(Objective(
        "serve-p99:%s" % model_label, "latency_quantile",
        metric="mxtpu_serve_request_seconds", labels=labels,
        quantile=0.99,
        threshold=_env.get("MXTPU_SLO_SERVE_P99_MS") / 1e3,
        description="p99 request latency (admission to resolution)"),
        replace=False)
    avail = _env.get("MXTPU_SLO_SERVE_AVAILABILITY")
    register(Objective(
        "serve-availability:%s" % model_label, "error_rate",
        bad=[("mxtpu_serve_rejected_total", labels)],
        # denominator = every request that ASKED: admitted ones land in
        # requests_total (deadline expiries included — they were
        # admitted, so adding rejected{deadline} here would double-count
        # them and halve the measured burn in a pure-504 outage);
        # queue-full/shed rejections never reach requests_total and are
        # added explicitly
        total=[("mxtpu_serve_requests_total", labels),
               ("mxtpu_serve_rejected_total",
                dict(labels, reason="queue_full")),
               ("mxtpu_serve_rejected_total", dict(labels, reason="shed"))],
        budget=max(1e-6, 1.0 - avail), labels=labels,
        description="fraction of requests deterministically rejected "
                    "(429 queue-full, 504 deadline, 503 shed)"),
        replace=False)
    if queue_depth:
        register(Objective(
            "serve-queue-depth:%s" % model_label, "gauge_ceiling",
            metric="mxtpu_serve_queue_depth", labels=labels,
            threshold=max(1.0, _env.get("MXTPU_SLO_SERVE_QUEUE_FRAC")
                          * queue_depth),
            description="admission queue sitting near its depth limit "
                        "(the page before 429s; the autoscaler's "
                        "scale-up signal)"),
            replace=False)
    # a reload of a model whose spec objectives were dropped at unload
    # gets the operator's declarations back, not just the env defaults
    _restore_spec_for(model_label)


def wire_generate_objectives(model_label, queue_depth=None):
    """Default generation-serving objectives: inter-token p99 + KV-page
    occupancy ceiling (+ the shared queue-depth ceiling)."""
    if not enabled():
        return
    labels = {"model": model_label}
    # replace=False: spec-file objectives of the same name take precedence
    register(Objective(
        "serve-intertoken-p99:%s" % model_label, "latency_quantile",
        metric="mxtpu_serve_intertoken_seconds", labels=labels,
        quantile=0.99,
        threshold=_env.get("MXTPU_SLO_INTERTOKEN_P99_MS") / 1e3,
        description="p99 latency between consecutive tokens of one "
                    "sequence (what a streaming client feels)"),
        replace=False)
    register(Objective(
        "serve-kv-occupancy:%s" % model_label, "gauge_ceiling",
        metric="mxtpu_serve_kv_occupancy", labels=labels,
        threshold=_env.get("MXTPU_SLO_KV_OCCUPANCY"),
        description="KV-page pool occupancy (used/total); pinned above "
                    "the ceiling means admissions queue on page "
                    "pressure"), replace=False)
    if queue_depth:
        register(Objective(
            "serve-queue-depth:%s" % model_label, "gauge_ceiling",
            metric="mxtpu_serve_queue_depth", labels=labels,
            threshold=max(1.0, _env.get("MXTPU_SLO_SERVE_QUEUE_FRAC")
                          * queue_depth),
            description="generation admission queue near its depth "
                        "limit"), replace=False)
    _restore_spec_for(model_label)


def wire_training(kind):
    """Optional training objectives per trainer kind, registered at the
    first `observe_step` for that kind — only when the matching
    ``MXTPU_SLO_STEP_*`` / ``MXTPU_SLO_MFU_FLOOR`` knob is set (a CPU
    test run must not page on MFU)."""
    wired = _STATE.wired_train
    if kind in wired:
        return
    wired.add(kind)  # GIL-atomic: idempotent set add
    if not enabled():
        return
    labels = {"kind": kind}
    step_s = _env.get("MXTPU_SLO_STEP_SECONDS")
    if step_s:
        register(Objective(
            "train-step-p99:%s" % kind, "latency_quantile",
            metric="mxtpu_step_seconds", labels=labels, quantile=0.99,
            threshold=step_s,
            description="p99 optimizer-step wall time"), replace=False)
    mfu = _env.get("MXTPU_SLO_MFU_FLOOR")
    if mfu:
        register(Objective(
            "train-mfu-floor:%s" % kind, "gauge_floor",
            metric="mxtpu_step_mfu", labels=labels, threshold=mfu,
            description="achieved-MFU floor (input starvation / "
                        "de-optimized step / sick chip)"), replace=False)
    stale_s = _env.get("MXTPU_SLO_STEP_STALENESS_S")
    if stale_s:
        register(Objective(
            "train-step-staleness:%s" % kind, "staleness",
            metric="mxtpu_steps_total", labels=labels, threshold=stale_s,
            description="seconds without a completed step (SLO-shaped "
                        "watchdog)"), replace=False)
    goodput_floor = _env.get("MXTPU_SLO_GOODPUT_FLOOR")
    if goodput_floor:
        # one unlabeled gauge per process (the goodput accountant is
        # trainer-agnostic), so the objective registers once — the first
        # trainer kind to step wins the race harmlessly
        register(Objective(
            "train-goodput-floor", "gauge_floor",
            metric="mxtpu_goodput_fraction", threshold=goodput_floor,
            description="windowed goodput floor: compute ÷ wall over the "
                        "last MXTPU_GOODPUT_WINDOW_STEPS steps "
                        "(docs/observability.md §Goodput)"), replace=False)


# ---------------------------------------------------------------------------
# /statusz — the "what is wrong right now" page
# ---------------------------------------------------------------------------

_RATE_WINDOW_S = 60.0


def _fresh_verdicts(now, update=False):
    """The cached verdict set when fresh, else a fresh compute. A
    future-stamped cache (clock jump; tests driving synthetic
    timestamps) is stale too, not eternally fresh. ``update`` re-caches
    a fresh compute (the `verdicts()` API path; the statusz path leaves
    the cache alone — a cache hit must never extend its own
    freshness)."""
    lv = _STATE.last_verdicts
    if lv is not None and 0 <= now - lv["ts"] <= 3 * _eval_period_s() + 1.0:
        return lv["verdicts"]
    out = compute_verdicts(now)
    if update:
        # benign swap: racing writers each publish a complete, fresh set
        # GIL-atomic: a whole-dict swap
        _STATE.last_verdicts = {"ts": now, "verdicts": out}
    return out


def _series_key(m):
    return m.name + core._render_labels(m.labels)


def _key_rates(now):
    """Windowed key figures over the last `_RATE_WINDOW_S`: per-model rps
    + latency p50/p99, decode tokens/sec + inter-token p99, training step
    rate/p99 + live MFU. Everything here is a ring diff — no locks."""
    out = {"window_s": _RATE_WINDOW_S, "serving": {}, "generate": {},
           "training": {}}
    w = _RATE_WINDOW_S
    for m in core.get_registry().metrics():
        if m.name == "mxtpu_serve_request_seconds":
            row = out["serving"].setdefault(m.labels.get("model", "?"), {})
            wd = m.windowed(w, now)
            if wd:
                row["rps"] = round(wd["rate"], 3)
                row["requests"] = wd["count"]
            p50 = m.windowed_quantile(0.50, w, now)
            p99 = m.windowed_quantile(0.99, w, now)
            row["p50_ms"] = None if p50 is None else round(p50 * 1e3, 3)
            row["p99_ms"] = None if p99 is None else round(p99 * 1e3, 3)
        elif m.name == "mxtpu_serve_queue_depth":
            row = out["serving"].setdefault(m.labels.get("model", "?"), {})
            row["queue_depth"] = m.value
        elif m.name == "mxtpu_serve_generated_tokens_total":
            row = out["generate"].setdefault(m.labels.get("model", "?"), {})
            r = m.windowed_rate(w, now)
            row["tokens_per_sec"] = None if r is None else round(r, 3)
        elif m.name == "mxtpu_serve_intertoken_seconds":
            row = out["generate"].setdefault(m.labels.get("model", "?"), {})
            p99 = m.windowed_quantile(0.99, w, now)
            row["intertoken_p99_ms"] = None if p99 is None \
                else round(p99 * 1e3, 3)
        elif m.name == "mxtpu_serve_kv_occupancy":
            row = out["generate"].setdefault(m.labels.get("model", "?"), {})
            row["kv_occupancy"] = round(m.value, 4)
        elif m.name == "mxtpu_step_seconds":
            row = out["training"].setdefault(m.labels.get("kind", "?"), {})
            wd = m.windowed(w, now)
            if wd:
                row["steps_per_sec"] = round(wd["rate"], 3)
            p99 = m.windowed_quantile(0.99, w, now)
            row["step_p99_s"] = None if p99 is None else round(p99, 4)
        elif m.name == "mxtpu_step_mfu":
            row = out["training"].setdefault(m.labels.get("kind", "?"), {})
            row["mfu"] = round(m.value, 4)
    return out


def _pool_health():
    """Replica-pool health from the published gauges (never the pool's own
    locked describe()): healthy/size + per-replica restart generations."""
    pools = {}
    for m in core.get_registry().metrics():
        if m.name == "mxtpu_serve_pool_healthy":
            pools.setdefault(m.labels.get("model", "?"),
                             {})["healthy"] = int(m.value)
        elif m.name == "mxtpu_serve_pool_size":
            pools.setdefault(m.labels.get("model", "?"),
                             {})["size"] = int(m.value)
        elif m.name == "mxtpu_serve_replica_generation":
            row = pools.setdefault(m.labels.get("model", "?"), {})
            row.setdefault("generations", {})[
                m.labels.get("replica", "?")] = int(m.value)
    return pools


_COMPILE_METRICS = (
    "mxtpu_jit_cache_lookup_total", "mxtpu_jit_cache_miss_total",
    "mxtpu_compile_cache_hit_total", "mxtpu_compile_cache_evict_total",
    "mxtpu_compile_cache_entries", "mxtpu_compile_cache_persist_hit_total",
    "mxtpu_compile_cache_persist_store_total",
    "mxtpu_compile_cache_persist_bad_total")


def _compile_stats():
    """Executable-cache hit/persist figures from the lock-free counters
    (the registry's own stats() takes its lock — off limits here)."""
    out = {}
    for m in core.get_registry().metrics():
        if m.name in _COMPILE_METRICS:
            key = m.name[len("mxtpu_"):]
            out[key] = out.get(key, 0) + m.value
    return out


def _slowest_exemplars(top_n=10):
    """The slowest traced observation per histogram (tail-bucket exemplar),
    worst first: the "render THIS trace" shortlist."""
    rows = []
    for m in core.get_registry().metrics():
        if m.kind != "histogram":
            continue
        best = None
        for ex in m.exemplars().values():
            if best is None or ex["value"] > best["value"]:
                best = ex
        if best is not None:
            rows.append({"metric": _series_key(m),
                         "value": best["value"], "trace": best["trace"],
                         "ts": best["ts"]})
    rows.sort(key=lambda r: -r["value"])
    return rows[:top_n]


def statusz_payload(extra=None):
    """The /statusz document: SLO verdicts + alerts, windowed key rates,
    pool health, compile-cache stats, the memory snapshot and slowest
    exemplars. Signal-safe by construction — lock-free snapshot and ring
    reads only, so the page answers even when the process is wedged on a
    library lock."""
    now = time.time()
    core.roll_windows(now)
    payload = {
        "version": 1,
        "ts": now,
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "rank": core.rank(),
        "pid": os.getpid(),
        "generation": core.restart_generation(),
        "slo": {
            "enabled": enabled(),
            "evaluator_running": running(),
            "eval_errors": _STATE.eval_errors,
            "objectives": len(_STATE.objectives),
            "verdicts": _fresh_verdicts(now),
            "alerts": recorder.alerts(),
        },
        "rates": _key_rates(now),
        "pools": _pool_health(),
        "compile_cache": _compile_stats(),
        "memory": memory.snapshot(),
        "training": goodput.statusz_block(),
        "slowest_exemplars": _slowest_exemplars(),
    }
    if extra:
        payload.update(extra)
    return payload


def render_statusz(fmt="json", extra=None):
    """(content_type, body_bytes) for a /statusz reply — shared by the
    ServingServer route and the telemetry exporter."""
    payload = statusz_payload(extra=extra)
    if fmt == "text":
        return ("text/plain; charset=utf-8",
                _render_text(payload).encode())
    return ("application/json",
            (json.dumps(payload, indent=1, default=str) + "\n").encode())


def _render_text(payload):
    """Terse human rendering (the `?format=text` view for a terminal)."""
    lines = ["statusz @ %s rank=%s pid=%s" % (payload["utc"],
                                              payload["rank"],
                                              payload["pid"])]
    slo = payload["slo"]
    lines.append("slo: enabled=%s evaluator=%s objectives=%d"
                 % (slo["enabled"], slo["evaluator_running"],
                    slo["objectives"]))
    for v in slo["verdicts"]:
        state = "NO_DATA" if v["no_data"] else (
            "BREACH" if v["page"] else ("ticket" if v["ticket"] else "ok"))
        lines.append(
            "  [%-7s] %s burn=%.2f budget_left=%s value=%s thr=%s%s"
            % (state, v["slo"], v["burn_rate"],
               "-" if v["budget_remaining"] is None
               else "%.2f" % v["budget_remaining"],
               "-" if v["value"] is None else "%.4g" % v["value"],
               "-" if v["threshold"] is None else "%g" % v["threshold"],
               " trace=%s" % v["exemplar_trace"]
               if v["exemplar_trace"] else ""))
    for name, fields in sorted(payload["rates"]["serving"].items()):
        lines.append("  serve %s: %s" % (name, fields))
    for name, fields in sorted(payload["rates"]["generate"].items()):
        lines.append("  decode %s: %s" % (name, fields))
    for kind, fields in sorted(payload["rates"]["training"].items()):
        lines.append("  train %s: %s" % (kind, fields))
    tr = payload.get("training") or {}
    if tr.get("window_steps"):
        lines.append("goodput: frac=%s over %d steps top_stall=%s (%.4gs)"
                     % (tr.get("goodput_fraction"), tr["window_steps"],
                        tr.get("top_stall_phase"),
                        tr.get("top_stall_seconds", 0.0)))
    for name, pool in sorted(payload["pools"].items()):
        lines.append("  pool %s: %s" % (name, pool))
    if payload["compile_cache"]:
        lines.append("compile: %s" % payload["compile_cache"])
    proc = (payload["memory"] or {}).get("process") or {}
    lines.append("memory: rss=%s vmhwm=%s" % (proc.get("rss"),
                                              proc.get("vmhwm")))
    for a in slo["alerts"]:
        lines.append("alert: %s %s" % (a.get("event"), a.get("fields")))
    for ex in payload["slowest_exemplars"][:5]:
        lines.append("slow: %.4gs %s trace=%s"
                     % (ex["value"], ex["metric"], ex["trace"]))
    return "\n".join(lines) + "\n"
