"""Evaluation metrics (counterpart of `mxnet_tpu/metric.py`: `EvalMetric`,
`Accuracy`, `TopKAccuracy`).

The same ``update(labels, preds)`` protocol over lists of tensors or
arrays; the arithmetic runs on host numpy, so each update copies its
inputs to the host once (the boundary the JAX package crosses too).
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy"]


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def _check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError("labels and preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


class EvalMetric:
    """Base metric: a running ``sum_metric`` over ``num_inst``."""

    def __init__(self, name, **kwargs):
        self.name = str(name)
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


class Accuracy(EvalMetric):
    """Share of samples whose argmax over ``axis`` equals the label."""

    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).ravel()
            label = label.astype(_np.int32).ravel()
            self.sum_metric += int((pred == label).sum())
            self.num_inst += len(label)


class TopKAccuracy(EvalMetric):
    """Share of samples whose label is among the ``top_k`` highest
    predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name, top_k=top_k)
        if top_k <= 1:
            raise MXNetError("use Accuracy for top_k=1")
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32).ravel()
            order = _np.argsort(_as_numpy(pred).astype(_np.float32), axis=-1)
            top = order[:, order.shape[1] - self.top_k:]
            self.sum_metric += int((top == label[:, None]).any(axis=1).sum())
            self.num_inst += order.shape[0]
