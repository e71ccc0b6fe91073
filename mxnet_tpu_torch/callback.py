"""Training callbacks (counterpart of `mxnet_tpu/callback.py`; reference:
python/mxnet/callback.py — do_checkpoint :55, Speedometer :120,
log_train_metric, ProgressBar, module_checkpoint).

Progress goes to the ``mxnet_tpu_torch.callback`` logger at INFO, and each
number a callback logs is also set on a telemetry gauge
(``mxtpu_speedometer_samples_per_sec``, ``mxtpu_train_metric``), as in the
JAX package.
"""
from __future__ import annotations

import logging
import time

from . import telemetry

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar",
           "module_checkpoint"]

_LOG = logging.getLogger("mxnet_tpu_torch.callback")
_LOG.setLevel(logging.INFO)


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving a checkpoint every ``period`` epochs
    (reference: callback.py:55)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from . import model

            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback calling ``mod.save_checkpoint`` every ``period``
    epochs (reference: callback.py module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches (reference: callback.py log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                _LOG.info("Iter[%d] Batch[%d] Train-%s=%f",
                          param.epoch, param.nbatch, name, value)
                telemetry.gauge("mxtpu_train_metric",
                                {"metric": name}).set(float(value))
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Batch-end callback logging samples/s every ``frequent`` batches
    (reference: callback.py:120)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        telemetry.gauge("mxtpu_speedometer_samples_per_sec").set(speed)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                telemetry.gauge("mxtpu_train_metric",
                                {"metric": name}).set(float(value))
            if self.auto_reset:
                param.eval_metric.reset()
            _LOG.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                      param.epoch, count, speed,
                      "".join("\t%s=%f" % kv for kv in name_value))
        else:
            _LOG.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                      param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """Batch-end callback drawing a progress bar (reference: callback.py
    ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        _LOG.info("[%s] %s%s\r", prog_bar, percents, "%")
