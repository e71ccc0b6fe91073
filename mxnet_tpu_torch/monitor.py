"""Monitor: statistics of each output of a forward during training
(counterpart of `mxnet_tpu/monitor.py`; reference: python/mxnet/monitor.py
:34, the executor's monitor callback graph_executor.cc:1319-1341).

`install` attaches it to an `Executor` (`set_monitor_callback`, which the
executor calls with each output's name and array after every forward) or
to a module (`install_monitor`, which forwards to its executors). Between
`tic` and `toc` of every ``interval``-th batch it queues ``stat_func`` of
each output whose name matches ``pattern``; `toc_print` logs the rows
through `log` and counts them in ``mxtpu_monitor_rows_total``.
"""
from __future__ import annotations

import re

from . import log as _log
from . import telemetry
from .ndarray import NDArray

__all__ = ["Monitor"]

_LOG = _log.get_logger("mxnet_tpu_torch.monitor", level=_log.INFO)


class Monitor:
    """reference: monitor.py:34.

    interval: batches between collections; stat_func: NDArray -> NDArray
    (default mean(|x|)); pattern: a regular expression on the output's
    name; sort: the rows sorted by name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.abs().mean()

        self.interval = interval
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.queue = []
        self.step = 0
        self.activated = False
        self.exes = []

    def stat_helper(self, name, arr):
        """The executor's callback: queue ``stat_func(arr)`` while
        collecting and ``name`` matches."""
        if not self.activated or not self.re_pattern.match(name):
            return
        if isinstance(arr, NDArray):
            self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        """Attach to an executor, or to anything with `install_monitor`
        (a module) (reference: monitor.py install_to_executor)."""
        if hasattr(exe, "set_monitor_callback"):
            exe.set_monitor_callback(self.stat_helper)
        else:
            exe.install_monitor(self)
        self.exes.append(exe)

    install_to_executor = install

    def tic(self):
        """Start collecting for this batch, every ``interval`` batches
        (reference: monitor.py:87)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: ``[(step, name, stat)]``, each statistic as the
        string of its first 10 values (reference: monitor.py:95)."""
        if not self.activated:
            return []
        self.activated = False
        queue = sorted(self.queue, key=lambda q: q[1]) if self.sort \
            else self.queue
        res = []
        for step, name, stat in queue:
            if isinstance(stat, NDArray):
                stat = str(stat.asnumpy().reshape(-1)[:10].tolist())
            res.append((step, name, stat))
        self.queue = []
        return res

    def toc_print(self):
        """`toc`'s rows, logged and counted in telemetry (reference:
        monitor.py:118)."""
        rows = self.toc()
        telemetry.counter("mxtpu_monitor_rows_total").inc(len(rows))
        for step, name, stat in rows:
            _LOG.info("Batch: %7d %30s %s", step, name, stat)
