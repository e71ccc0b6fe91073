"""Losses (counterpart of `mxnet_tpu/gluon/loss.py`: `Loss` and
`SoftmaxCrossEntropyLoss`). A loss maps (pred, label) to one value per
sample, the mean over every axis but the batch axis."""
from __future__ import annotations

from torch import nn

from ..ops import nn as _ops

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(nn.Module):
    """Base loss: ``weight`` scales every sample's loss."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, loss):
        if self._weight is not None:
            loss = loss * self._weight
        axes = [a for a in range(loss.dim())
                if a != self._batch_axis % loss.dim()]
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` per sample, with integer labels over
    ``axis`` (default -1). Dense label distributions and log-probability
    inputs are not ported yet."""

    def __init__(self, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis

    def forward(self, pred, label):
        logp = _ops.log_softmax(pred, axis=self._axis)
        idx = label.long()
        if idx.dim() == logp.dim() - 1:
            idx = idx.unsqueeze(self._axis)
        return self._finish(-logp.gather(self._axis, idx))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
