"""Fault injection for the serving path.

Counterpart of the serving part of `mxnet_tpu/parallel/resilience.py`:
`fault_spec` parses every ``MXTPU_FAULT_INJECT`` action the JAX package
knows, so one string parses (or raises) the same way in both packages, and
the replica worker's batch-boundary hook fires the serving actions:

    MXTPU_FAULT_INJECT="kill_replica@batch=3,replica=0"   hard replica death
    MXTPU_FAULT_INJECT="wedge_replica@batch=5,replica=1"  park the replica
                                                          forever mid-batch
    MXTPU_FAULT_INJECT="slow_reply@batch=2,ms=500"        delay one reply

and the repository fires the load surge at a model's publish
(`maybe_inject_load_surge`, the autoscaler's chaos vector):

    MXTPU_FAULT_INJECT="load_surge@after=0,rps=200,duration=3"
        a synthetic open-loop burst of single-example requests into the
        model's admission queue, ``rps`` a second for ``duration`` s,
        starting ``after`` s into serving

Conditions: ``batch`` (required for serving actions), ``after`` (required
for ``load_surge``), ``replica`` (default any), ``gen`` (the replica's
respawn generation, default 0, so a respawned replica does not fire
again), ``code`` (exit status of ``kill_replica``, default 42), ``ms``
(``slow_reply``'s delay, default 1000), ``rps`` / ``duration`` (default
100 / 2); the training, checkpoint and data actions and their conditions
parse too.

The checkpoint manager, the training-step and data-stall hooks and the
preemption handler are ROADMAP queue 1 item 13's. Each raises here,
naming its item.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time

from .. import env as _env
from .. import telemetry
from ..base import MXNetError

__all__ = ["CheckpointManager", "maybe_inject_fault",
           "maybe_inject_serving_fault", "maybe_inject_load_surge",
           "fault_spec", "restart_generation",
           "install_preemption_handler", "preemption_requested",
           "maybe_preempt_exit", "preempt_exit_code", "preempt_grace_s"]

_LOG = logging.getLogger("mxnet_tpu_torch.resilience")

_FAULT_EXIT_CODE = 42
_TRAIN_ACTIONS = ("kill", "exc", "hang", "corrupt_ckpt", "preempt")
_CKPT_ACTIONS = ("kill_during_ckpt",)
_SERVE_ACTIONS = ("kill_replica", "wedge_replica", "slow_reply")
_SURGE_ACTIONS = ("load_surge",)
_DATA_ACTIONS = ("slow_batch",)
_UNPARSED = object()
_fault_cache = _UNPARSED


def restart_generation():
    """Which supervision generation this process belongs to (0 = first
    launch); a replica pool exports ``MXTPU_RESTART_GENERATION`` on every
    respawn."""
    return _env.get("MXTPU_RESTART_GENERATION")


def fault_spec(env=None):
    """Parse ``MXTPU_FAULT_INJECT`` (or ``env``) into a list of {action,
    step, rank, gen, code, dir, batch, replica, ms, after, rps, duration,
    grace} dicts. A malformed entry raises `MXNetError` at once: a typo'd
    injection that silently never fires would void the test using it."""
    raw = (_env.raw("MXTPU_FAULT_INJECT") or "") if env is None else env
    entries = []
    known = (_TRAIN_ACTIONS + _CKPT_ACTIONS + _SERVE_ACTIONS +
             _SURGE_ACTIONS + _DATA_ACTIONS)
    for part in raw.replace(";", " ").split():
        action, _, conds = part.partition("@")
        if action not in known:
            raise MXNetError("MXTPU_FAULT_INJECT: unknown action %r in %r "
                             "(%s)" % (action, part, "|".join(known)))
        entry = {"action": action, "step": None, "rank": None,
                 "gen": 0, "code": _FAULT_EXIT_CODE, "dir": None,
                 "batch": None, "replica": None, "ms": 1000,
                 "after": None, "rps": 100, "duration": 2, "grace": None}
        for cond in filter(None, conds.split(",")):
            k, eq, v = cond.partition("=")
            if not eq or k not in entry or k == "action":
                raise MXNetError("MXTPU_FAULT_INJECT: bad condition %r in %r"
                                 % (cond, part))
            try:
                entry[k] = v if k == "dir" else int(v)
            except ValueError:
                raise MXNetError(
                    "MXTPU_FAULT_INJECT: %s= wants an integer, got %r in %r"
                    % (k, v, part)) from None
        when = "after" if action in _SURGE_ACTIONS \
            else ("batch" if action in _SERVE_ACTIONS else "step")
        if entry[when] is None:
            raise MXNetError("MXTPU_FAULT_INJECT: %r needs a %s= condition"
                             % (part, when))
        entries.append(entry)
    return entries


def _entries():
    """The parsed spec, memoized: the no-op path stays one check."""
    global _fault_cache
    if _fault_cache is _UNPARSED:
        _fault_cache = fault_spec() if _env.raw("MXTPU_FAULT_INJECT") \
            else []
    return _fault_cache


def _exit_hard(code):
    """Hard death without cleanup handlers (the SIGKILL / OOM stand-in);
    stdio is flushed so the log ends at the right line."""
    for s in (sys.stdout, sys.stderr):
        try:
            s.flush()
        except Exception:
            pass
    os._exit(code)


def maybe_inject_serving_fault(batch, replica):
    """Replica worker's batch-boundary hook (`serving.supervisor`): fires
    ``kill_replica`` / ``wedge_replica`` / ``slow_reply`` when this
    replica's batch sequence number matches. ``gen=`` matches the
    replica's respawn generation, default 0, so a respawned replica does
    not fire again and recovery is observable."""
    if not _entries():
        return
    gen = restart_generation()
    for e in _entries():
        if e["action"] not in _SERVE_ACTIONS:
            continue
        if e["batch"] != batch or e["gen"] != gen:
            continue
        if e["replica"] is not None and e["replica"] != replica:
            continue
        _fire_serving(e, batch, replica)


def _fire_serving(entry, batch, replica):
    action = entry["action"]
    _LOG.warning("MXTPU_FAULT_INJECT firing: %s at batch=%d replica=%d "
                 "gen=%d", action, batch, replica, restart_generation())
    if action == "kill_replica":
        _exit_hard(entry["code"])
    if action == "wedge_replica":
        # park mid-batch for good: the router must see the silence on its
        # heartbeat deadline, eject this replica (process-group teardown)
        # and fail the batch over; SIGKILL is the only way out
        while True:
            time.sleep(3600)
    if action == "slow_reply":
        time.sleep(entry["ms"] / 1e3)


def maybe_inject_load_surge(model):
    """Server-side chaos hook (`ModelRepository.add`): arm one synthetic
    open-loop burst thread (``mxtpu-fault-load-surge``) a matching
    ``load_surge@after=,rps=,duration=`` entry against the just-published
    model's admission queue. The burst submits fire-and-forget
    single-example requests at ``rps`` for ``duration`` s: real
    admissions, so the queue depth, ``mxtpu_serve_request_seconds`` and
    the SLO burn rates move as under real traffic. Sheds (429 / 503) are
    counted, not raised. Predict models only (a model without
    ``example_shapes`` is skipped). Returns the threads armed."""
    if not _entries():
        return []
    shapes = getattr(model, "example_shapes", None)
    if not shapes:
        return []
    gen = restart_generation()
    threads = []
    for e in _entries():
        if e["action"] not in _SURGE_ACTIONS or e["gen"] != gen:
            continue
        t = threading.Thread(target=_surge_worker, args=(model, dict(e)),
                             name="mxtpu-fault-load-surge", daemon=True)
        t.start()
        threads.append(t)
    return threads


def _surge_worker(model, entry):
    import numpy as _np

    from ..serving.batcher import DrainingError, ModelUnavailableError

    time.sleep(max(0, entry["after"]))
    rps = max(1, entry["rps"])
    duration = max(0, entry["duration"])
    timeout_s = _env.get("MXTPU_SERVE_TIMEOUT_MS") / 1e3
    dtypes = getattr(model, "input_dtypes", None) or {}
    arrays = {k: _np.zeros((1,) + tuple(s), dtype=dtypes.get(k, "float32"))
              for k, s in model.example_shapes.items()}
    telemetry.record_event("fault_load_surge", model=model.name,
                           version=model.version, rps=rps,
                           duration_s=duration)
    _LOG.warning("MXTPU_FAULT_INJECT firing: load_surge on %s/%s "
                 "(%d rps for %ds)", model.name, model.version, rps,
                 duration)
    fired = shed = 0
    period = 1.0 / rps
    end = time.monotonic() + duration
    next_t = time.monotonic()
    while time.monotonic() < end:
        try:
            # open loop: submit and walk away; the resolution (or 504)
            # lands on a request nobody waits on
            model._batcher.submit(arrays,
                                  deadline=time.monotonic() + timeout_s)
            fired += 1
        except (DrainingError, ModelUnavailableError):
            break  # the model is draining or gone: stop, so the shed and
            #        availability series the surge exercises stay clean
        except MXNetError:
            shed += 1  # a 429 / 503 shed: admission doing its job
        except Exception:
            break  # the model was torn down under the surge
        next_t += period
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    telemetry.record_event("fault_load_surge_done", model=model.name,
                           version=model.version, fired=fired, shed=shed)


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def _unported(what, item):
    return MXNetError("%s is not ported yet (ROADMAP queue 1 item %s)"
                      % (what, item))


class CheckpointManager:
    """The crash-consistent checkpoint manager: item 13."""

    def __init__(self, *args, **kwargs):
        raise _unported("parallel.resilience.CheckpointManager", 13)


def maybe_inject_fault(step):
    """The training-step fault hook: item 13."""
    raise _unported("the training-step fault hook (maybe_inject_fault)", 13)


def maybe_inject_data_stall(batch):
    """The data-pipeline stall hook: item 13."""
    raise _unported("the data-stall fault hook (maybe_inject_data_stall)",
                    13)




def install_preemption_handler(grace_s=None):
    raise _unported("the preemption handler", 13)


def preemption_requested():
    raise _unported("the preemption handler", 13)


def preempt_grace_s():
    raise _unported("the preemption handler", 13)


def preempt_exit_code():
    raise _unported("the preemption handler", 13)


def maybe_preempt_exit(emergency_save=None, rank=None):
    raise _unported("the preemption handler", 13)
