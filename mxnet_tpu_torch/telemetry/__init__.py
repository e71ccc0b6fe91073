"""Metrics, events, spans, the flight recorder and the SLO engine
(counterpart of `mxnet_tpu.telemetry`).

  * `counter` / `gauge` / `histogram`: lock-free metrics with windowed
    views, the JSONL flush (``MXTPU_TELEMETRY_DIR``) and the Prometheus
    endpoint with ``/statusz`` (``MXTPU_TELEMETRY_PORT``): `core.py`;
  * `record_event` / `record_step` / `dump`: the event ring, the hang
    watchdog and the SIGUSR1 dumps: `recorder.py`;
  * `observe_step`: the call a training step makes.

The SLO engine (`slo`), FLOP accounting (`flops`), memory attribution
(`memory`), goodput accounting (`goodput`) and tracing (`tracing`) are
submodules, as in the JAX package.
"""
from __future__ import annotations

from .core import (  # noqa: F401
    BYTE_BOUNDS, LATENCY_BOUNDS, counter, enabled, flush, gauge,
    get_registry, histogram, prometheus_text, rank, restart_generation,
    set_enabled, snapshot, start_http_server, stop_http_server,
    telemetry_dir,
)
from .recorder import (  # noqa: F401
    dump, dump_path, events, install_signal_handler, last_step, record_event,
    record_step,
)
from . import core as _core
from . import flops  # noqa: F401
from . import goodput  # noqa: F401
from . import memory  # noqa: F401
from . import slo  # noqa: F401
from . import tracing
from ..base import MXNetError

__all__ = [
    "counter", "gauge", "histogram", "enabled", "set_enabled", "snapshot",
    "prometheus_text", "flush", "start_http_server", "stop_http_server",
    "get_registry",
    "record_event", "record_step", "events", "dump", "dump_path",
    "last_step", "install_signal_handler", "observe_step", "set_step_flops",
    "rank", "restart_generation", "telemetry_dir", "tracing", "flops",
    "goodput", "memory", "slo", "LATENCY_BOUNDS", "BYTE_BOUNDS",
]


def set_step_flops(flops):
    """The achieved-MFU gauge is not ported (ROADMAP queue 1 item 13, with
    `slo.wire_training`'s MFU floor)."""
    raise MXNetError("telemetry.set_step_flops feeds the MFU gauge, which "
                     "is not ported yet (ROADMAP queue 1 item 13)")


_STEP_METRICS = {}  # kind -> (hist, steps, examples, eps): the per-step
                    # path pays no registry lookups


def _step_metrics(kind):
    m = _STEP_METRICS.get(kind)
    if m is None:
        labels = {"kind": kind}
        m = (_core._REGISTRY.histogram("mxtpu_step_seconds", labels),
             _core._REGISTRY.counter("mxtpu_steps_total", labels),
             _core._REGISTRY.counter("mxtpu_examples_total", labels),
             _core._REGISTRY.gauge("mxtpu_examples_per_sec", labels))
        _STEP_METRICS[kind] = m
    return m


def observe_step(duration_s, examples=None, step=None, kind="train"):
    """Record one training step under the JAX package's names, labelled
    ``kind``: the ``mxtpu_step_seconds`` histogram (with the step's trace
    id as exemplar when it is traced), the ``mxtpu_steps_total`` and
    ``mxtpu_examples_total`` counters, the ``mxtpu_examples_per_sec``
    gauge, and the flight recorder's heartbeat (`record_step`, which feeds
    the watchdog). The MFU gauge, the training SLO objectives and the
    per-step memory probe wait with the trainers' goodput hooks (ROADMAP
    queue 1 item 13)."""
    if not _core._STATE.enabled:
        return
    hist, c_steps, c_examples, g_eps = _step_metrics(kind)
    hist.observe(duration_s, exemplar=tracing.current_trace_id())
    c_steps.inc()
    if examples is not None and duration_s > 0:
        c_examples.inc(int(examples))
        g_eps.set(examples / duration_s)
    record_step(step)
