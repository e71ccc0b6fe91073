"""Metrics, events, spans and their JSONL files (counterpart of
`mxnet_tpu.telemetry`)."""
from . import tracing
from .core import (LATENCY_BOUNDS, counter, events, flush, gauge,
                   get_registry, histogram, record_event, snapshot,
                   telemetry_dir)

__all__ = ["counter", "gauge", "histogram", "get_registry", "snapshot",
           "record_event", "events", "flush", "telemetry_dir", "tracing",
           "LATENCY_BOUNDS", "observe_step"]


def observe_step(duration_s, examples=None, step=None, kind="train"):
    """Record one training step under the JAX package's names, labelled
    ``kind``: the ``mxtpu_step_seconds`` histogram, the
    ``mxtpu_steps_total`` and ``mxtpu_examples_total`` counters and the
    ``mxtpu_examples_per_sec`` gauge. ``step`` is accepted for the JAX
    signature; the flight recorder it feeds there is not ported."""
    labels = {"kind": kind}
    histogram("mxtpu_step_seconds", labels).observe(duration_s)
    counter("mxtpu_steps_total", labels).inc()
    if examples is not None and duration_s > 0:
        counter("mxtpu_examples_total", labels).inc(int(examples))
        gauge("mxtpu_examples_per_sec", labels).set(examples / duration_s)
