"""Automatic FLOP accounting: a callable's FLOPs counted once a shape
signature, then added at every call.

Counterpart of `mxnet_tpu/telemetry/flops.py`, under its names. The JAX
package asks XLA's HLO cost analysis what an executable costs; the port
counts one real call with `torch.utils.flop_counter.FlopCounterMode` (the
matrix products and convolutions PyTorch dispatches) and remembers the
figure under the call's shape signature (`PerShapeFlops`, `instrument`),
so later calls cost a dict lookup and one float add. The serving layer
prices each padding bucket the same way at warm-up (`counted_call`).

The port's own CUDA kernels run outside PyTorch's dispatcher and are
invisible to that counter, so each one that does arithmetic reports its
FLOPs by formula from its shapes where it launches (`kernel`): the count
the counter gives its plain version on the CPU at the same shapes (the
paged decode attention ``4 * B * H * L * D``, L the page table's token
capacity; flash attention ``4``, ``6`` and ``8 * BH * Lq * Lk * D`` for
the forward, dQ and dK/dV; each LSTM kernel ``8 * T * B * H^2``). The
conv-epilogue kernels do elementwise work, which neither XLA's count nor
the counter's includes, and report nothing. Inside a counted call the
figure joins the count; inside an instrumented call already priced it is
part of the remembered figure; anywhere else it accumulates directly. A
kernel's backward runs on the autograd engine's device thread, so the
autograd Functions carry their forward's accumulator to it (`sink`,
`reporting_to`): the plain version on the CPU is counted by the counter
alone, and no kernel is counted twice.

The trainers' eager step is counted once a shape signature by
`instrument` (the counterpart of the JAX package instrumenting its step
executable): the step's first call at a signature runs under the counter,
which the smoke's warm-up steps absorb, and every later step adds the
remembered figure. `observe_step` takes the FLOPs since the previous step
(`take_step_delta`), and `last_step_flops` keeps the last nonzero one.

``MXTPU_TRACE_FLOPS=0`` (or ``MXTPU_TELEMETRY=0``) turns all of it off.
"""
from __future__ import annotations

import threading

from .. import env as _env
from . import core

__all__ = ["enabled", "accumulate", "total", "take_step_delta",
           "last_step_flops", "kernel", "sink", "reporting_to",
           "counted_call", "measure", "PerShapeFlops", "instrument"]


class _FlopState:
    def __init__(self):
        self.enabled = None     # None = read env lazily, cache after
        self.total = 0.0        # FLOPs executed since process start
        self.step_mark = 0.0    # total at the last observe_step
        self.last_step = None   # FLOPs attributed to the last step


_STATE = _FlopState()
# per thread: the kernel FLOPs of the counted call in progress (a
# one-element list), _PRICED inside an instrumented call whose figure is
# already known, or None
_TLS = threading.local()
_PRICED = object()


def enabled():
    """Is automatic accounting on? (``MXTPU_TRACE_FLOPS``, default on;
    cached: flip it before the first count, not mid-run.)"""
    if _STATE.enabled is None:
        _STATE.enabled = bool(core._STATE.enabled
                              and _env.get("MXTPU_TRACE_FLOPS"))
    return _STATE.enabled


def accumulate(flops):
    """Record one execution costing ``flops``: a plain float add."""
    if flops:
        _STATE.total += flops


def total():
    """FLOPs executed by counted callables since process start."""
    return _STATE.total


def take_step_delta():
    """FLOPs executed since the previous call: the automatic per-step
    count `observe_step` uses when no manual value is declared."""
    t = _STATE.total
    delta = t - _STATE.step_mark
    _STATE.step_mark = t
    if delta > 0:
        _STATE.last_step = delta
    return delta


def last_step_flops():
    """The most recent nonzero per-step FLOP count (the smoke prints it
    beside PERF.md's hand count)."""
    return _STATE.last_step


def kernel(flops):
    """A CUDA kernel of the port reports its FLOPs (by formula) where it
    launches."""
    if not flops or not enabled():
        return
    acc = getattr(_TLS, "acc", None)
    if acc is None:
        _STATE.total += flops
    elif acc is not _PRICED:
        acc[0] += flops


def sink():
    """Where a kernel launched on this thread now reports: the counted
    call's accumulator, the priced mark, or None. An autograd Function
    keeps its forward's and hands it to its backward (`reporting_to`)."""
    return getattr(_TLS, "acc", None)


class reporting_to:
    """``with reporting_to(s):`` kernels launched on this thread report to
    ``s`` (a value of `sink`), as they did where ``s`` was taken."""

    __slots__ = ("_acc", "_prev")

    def __init__(self, acc):
        self._acc = acc

    def __enter__(self):
        self._prev = getattr(_TLS, "acc", None)
        _TLS.acc = self._acc
        return self

    def __exit__(self, *exc):
        _TLS.acc = self._prev


class _NoModules:
    """Stands in for `FlopCounterMode`'s module tracker: every count goes
    to the total ("Global") alone."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _flop_counter():
    """A `FlopCounterMode` without the import its first use pays and
    without its module tracker. torch guards a dispatch mode's handler
    against dynamo tracing with a wrapper that imports ``torch._dynamo``
    the first time it runs: seconds, once in every process, and so in
    every replica's warm-up; the port traces nothing with dynamo, so the
    handler is marked as guarded already (a torch without the wrapper is
    left as it is). The tracker attributes counts to modules through
    backward hooks that `torch.autograd.grad` refuses (the trainers'
    step takes its gradients so), and the port reads only the total."""
    from torch.utils import flop_counter

    handler = getattr(flop_counter, "_FlopCounterMode", None)
    raw = getattr(getattr(handler, "__torch_dispatch__", None),
                  "__wrapped__", None)
    if raw is not None and getattr(raw, "__dynamo_disable", None) is None:
        setattr(raw, "__dynamo_disable", raw)
    counter = flop_counter.FlopCounterMode(display=False)
    counter.mod_tracker = _NoModules()
    return counter


def counted_call(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under `FlopCounterMode`:
    ``(result, flops)``, the kernels' formulas included. ``flops`` is None
    when accounting is off (the call runs all the same). The counter
    intercepts every op of the call but never synchronises the device."""
    if not enabled():
        return fn(*args, **kwargs), None
    prev = getattr(_TLS, "acc", None)
    acc = [0.0]
    _TLS.acc = acc
    try:
        with _flop_counter() as counter:
            out = fn(*args, **kwargs)
    finally:
        _TLS.acc = prev
    if isinstance(prev, list):
        prev[0] += acc[0]   # an enclosing count misses kernels otherwise
    return out, float(counter.get_total_flops()) + acc[0]


def measure(fn, args, kwargs=None):
    """FLOPs of one execution of ``fn`` on ``args``. Unlike the JAX
    package's lowering, this RUNS the call once. None when off."""
    return counted_call(fn, *args, **(kwargs or {}))[1]


def _shape_sig(x):
    """Hashable shape/dtype signature of a (possibly nested) argument.
    What is not an array (a scalar, a generator, None) does not enter it:
    the products the counter sees follow the arrays' shapes."""
    if isinstance(x, (tuple, list)):
        return tuple(_shape_sig(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted((str(k), _shape_sig(v)) for k, v in x.items()))
    shape = getattr(x, "shape", None)
    if shape is None:
        return None
    return (tuple(shape), str(getattr(x, "dtype", "")))


class PerShapeFlops:
    """Per-shape-signature FLOP memo of one callable: the first call with
    a new signature is counted (`counted_call`), later ones add the
    remembered figure. Calling it calls the wrapped callable."""

    __slots__ = ("_fn", "_by_sig")

    def __init__(self, fn):
        self._fn = fn
        self._by_sig = {}

    def __call__(self, *args):
        if getattr(_TLS, "acc", None) is not None:
            return self._fn(*args)   # an enclosing count covers the call
        sig = _shape_sig(args)
        flops = self._by_sig.get(sig)
        if flops is None:
            out, flops = counted_call(self._fn, *args)
            self._by_sig[sig] = flops
        else:
            _TLS.acc = _PRICED
            try:
                out = self._fn(*args)
            finally:
                _TLS.acc = None
        accumulate(flops)
        return out


def instrument(fn):
    """Wrap ``fn`` so every call feeds the accumulator (`PerShapeFlops`);
    ``fn`` itself when accounting is off."""
    if not enabled():
        return fn
    return PerShapeFlops(fn)
