"""TensorBoard metric logging (counterpart of
`mxnet_tpu/contrib/tensorboard.py`; reference: python/mxnet/contrib/tensorboard.py
LogMetricsCallback). Gated on a SummaryWriter being importable, exactly as
the reference gates on the `tensorboard` package."""
from __future__ import annotations

__all__ = ["LogMetricsCallback"]


class LogMetricsCallback:
    """Batch-end callback streaming eval metrics to TensorBoard
    (reference: contrib/tensorboard.py:40)."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.summary_writer = SummaryWriter(logging_dir)
        except ImportError:
            try:
                from tensorboardX import SummaryWriter

                self.summary_writer = SummaryWriter(logging_dir)
            except ImportError:
                raise ImportError(
                    "LogMetricsCallback requires a SummaryWriter provider "
                    "(torch.utils.tensorboard or tensorboardX)")

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
