"""Metrics, events, spans, the flight recorder and the SLO engine
(counterpart of `mxnet_tpu.telemetry`).

  * `counter` / `gauge` / `histogram`: lock-free metrics with windowed
    views, the JSONL flush (``MXTPU_TELEMETRY_DIR``) and the Prometheus
    endpoint with ``/statusz`` (``MXTPU_TELEMETRY_PORT``): `core.py`;
  * `record_event` / `record_step` / `dump`: the event ring, the hang
    watchdog and the SIGUSR1 dumps: `recorder.py`;
  * `observe_step`: the call every trainer's step makes: step seconds,
    examples/s, the achieved MFU (`set_step_flops`, ``MXTPU_STEP_FLOPS``,
    or the automatic count of `flops`) and the watchdog's heartbeat.

The SLO engine (`slo`), FLOP accounting (`flops`), memory attribution
(`memory`), goodput accounting (`goodput`) and tracing (`tracing`) are
submodules, as in the JAX package.
"""
from __future__ import annotations

from .. import env as _env
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

__all__ = [
    "counter", "gauge", "histogram", "enabled", "set_enabled", "snapshot",
    "prometheus_text", "flush", "start_http_server", "stop_http_server",
    "get_registry",
    "record_event", "record_step", "events", "dump", "dump_path",
    "last_step", "install_signal_handler", "observe_step", "set_step_flops",
    "rank", "restart_generation", "telemetry_dir", "tracing", "flops",
    "goodput", "memory", "slo", "LATENCY_BOUNDS", "BYTE_BOUNDS",
]


# ---------------------------------------------------------------------------
# step-level instrumentation (shared by gluon.Trainer, DistributedTrainer,
# PipelineTrainer and the Module.fit loop)
# ---------------------------------------------------------------------------

_STEP_FLOPS = [None]     # model FLOPs an optimizer step (fwd + bwd), if set
_PEAK_FLOPS = [False]    # False = not resolved yet; None = unknown card


def set_step_flops(flops):
    """Declare the model's FLOPs a training step, so `observe_step`
    publishes the achieved MFU against `runtime.chip_peak_tflops`.
    ``MXTPU_STEP_FLOPS`` is the environment's spelling; 0 or None clears
    it, and the automatic count (`flops`) takes over."""
    _STEP_FLOPS[0] = float(flops) if flops else None


if _env.is_set("MXTPU_STEP_FLOPS"):
    _step_flops_env = _env.get("MXTPU_STEP_FLOPS")
    if _step_flops_env is not None:  # a malformed value leaves it unset
        set_step_flops(_step_flops_env)


def _peak_flops():
    """Summed peak bf16 FLOP/s of the visible CUDA cards (resolved once;
    None on the CPU or for a card the peak table lacks)."""
    if _PEAK_FLOPS[0] is False:
        import torch

        from .. import runtime

        per_card = runtime.chip_peak_tflops()
        _PEAK_FLOPS[0] = per_card * 1e12 * torch.cuda.device_count() \
            if per_card else None
    return _PEAK_FLOPS[0]


_STEP_METRICS = {}  # kind -> (hist, steps, examples, eps, mfu, auto): the
                    # per-step path pays no registry lookups


def _step_metrics(kind):
    m = _STEP_METRICS.get(kind)
    if m is None:
        labels = {"kind": kind}
        m = (_core._REGISTRY.histogram("mxtpu_step_seconds", labels),
             _core._REGISTRY.counter("mxtpu_steps_total", labels),
             _core._REGISTRY.counter("mxtpu_examples_total", labels),
             _core._REGISTRY.gauge("mxtpu_examples_per_sec", labels),
             _core._REGISTRY.gauge("mxtpu_step_mfu", labels),
             _core._REGISTRY.gauge("mxtpu_step_flops_auto", labels))
        _STEP_METRICS[kind] = m
    return m


def observe_step(duration_s, examples=None, step=None, kind="train"):
    """Record one training step under the JAX package's names, labelled
    ``kind``: the ``mxtpu_step_seconds`` histogram (with the step's trace
    id as exemplar when it is traced), the per-step peak-memory growth,
    the ``mxtpu_steps_total`` and ``mxtpu_examples_total`` counters, the
    ``mxtpu_examples_per_sec`` gauge, the achieved-MFU gauge
    ``mxtpu_step_mfu`` (FLOPs from `set_step_flops` when declared, else
    the automatic count since the last step, also published as
    ``mxtpu_step_flops_auto``), and the flight recorder's heartbeat
    (`record_step`, which feeds the watchdog). The first step of each
    ``kind`` registers its optional SLO objectives (`slo.wire_training`).
    Host clocks and counters only: nothing here waits for the card."""
    if not _core._STATE.enabled:
        return
    if kind not in slo._STATE.wired_train:
        slo.wire_training(kind)
    hist, c_steps, c_examples, g_eps, g_mfu, g_auto = _step_metrics(kind)
    trace_id = tracing.current_trace_id()
    hist.observe(duration_s, exemplar=trace_id)
    memory.observe_step_delta(exemplar=trace_id)
    memory.ensure_poller()
    c_steps.inc()
    if examples is not None and duration_s > 0:
        c_examples.inc(int(examples))
        g_eps.set(examples / duration_s)
    auto = flops.take_step_delta() if flops.enabled() else 0.0
    step_flops = _STEP_FLOPS[0] or auto
    if step_flops and duration_s > 0:
        if auto and not _STEP_FLOPS[0]:
            g_auto.set(auto)
        peak = _peak_flops()
        if peak:
            g_mfu.set((step_flops / duration_s) / peak)
    record_step(step)
