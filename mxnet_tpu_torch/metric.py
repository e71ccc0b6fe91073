"""Evaluation metrics (counterpart of `mxnet_tpu/metric.py`; reference:
python/mxnet/metric.py): the registry (`register` / `create`),
`EvalMetric`, `CompositeEvalMetric`, Accuracy, TopKAccuracy, F1, MCC,
Perplexity, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, PCC, Loss, Torch, Caffe, `CustomMetric` and `np`.

The same ``update(labels, preds)`` protocol over lists of NDArrays, tensors
or arrays; the arithmetic runs on host numpy, so each update copies its
inputs to the host once (the boundary the JAX package crosses too). Pure
Python over numpy: the port keeps its own copy of the JAX package's
arithmetic.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "PCC", "Loss",
           "Torch", "Caffe", "CustomMetric", "np", "create", "register"]

_REGISTRY = {}


def register(klass, name=None):
    """Register a metric class under its lower-case name (or ``name``)."""
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """reference: metric.py create"""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    cls = _REGISTRY.get(str(metric).lower())
    if cls is None:
        raise MXNetError("unknown metric %r (ported: %s)"
                         % (metric, sorted(_REGISTRY)))
    return cls(*args, **kwargs)


def _as_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def _picked(pred, label):
    """Row i of ``pred`` (reshaped to (-1, K)) at column ``label[i]`` (a
    negative label counts from the end, as numpy indexes), float64 on the
    host. A tensor or NDArray is gathered where it lies, so only these N
    values leave the card, not the (N, K) prediction."""
    t = pred._data if hasattr(pred, "_data") else pred
    if not isinstance(t, torch.Tensor):
        p = _np.asarray(pred).astype(_np.float64)
        p = p.reshape(-1, p.shape[-1])
        return p[_np.arange(label.shape[0]), label]
    t = t.detach().reshape(-1, t.shape[-1])[:label.shape[0]]
    idx = torch.from_numpy(label.astype(_np.int64)).to(t.device)
    return t.gather(1, idx.remainder(t.shape[1])[:, None])[:, 0].double() \
        .cpu().numpy()


class EvalMetric:
    """Base metric (reference: metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

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
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """reference: metric.py:278"""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(i) for i in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name) if not isinstance(name, list) else names.extend(name)
            values.append(value) if not isinstance(value, list) else values.extend(value)
        return (names, values)


def _check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError("labels and preds count mismatch: %d vs %d"
                         % (len(labels), len(preds)))


@register
class Accuracy(EvalMetric):
    """reference: metric.py:440"""

    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).flat
            label = label.astype(_np.int32).flat
            self.sum_metric += (_np.asarray(pred) == _np.asarray(label)).sum()
            self.num_inst += len(_np.asarray(label))


@register
class TopKAccuracy(EvalMetric):
    """reference: metric.py:513"""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "use Accuracy for top_k=1"
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        _check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32)
            pred = _np.argsort(_as_numpy(pred).astype(_np.float32), axis=-1)
            num_samples = pred.shape[0]
            num_classes = pred.shape[1]
            top = pred[:, num_classes - self.top_k:]
            for j in range(self.top_k):
                self.sum_metric += (top[:, j].flat == label.flat).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    """Binary F1 (reference: metric.py:751)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self.reset()

    def reset(self):
        self._tp = self._fp = self._fn = 0.0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32).ravel()
            pred = _as_numpy(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.astype(_np.int32).ravel()
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    """Matthews correlation (reference: metric.py:845)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.reset()

    def reset(self):
        self._tp = self._fp = self._fn = self._tn = 0.0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32).ravel()
            pred = _as_numpy(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.astype(_np.int32).ravel()
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            denom = math.sqrt((self._tp + self._fp) * (self._tp + self._fn) *
                              (self._tn + self._fp) * (self._tn + self._fn))
            mcc = ((self._tp * self._tn - self._fp * self._fn) / denom) if denom else 0.0
            self.sum_metric = mcc
            self.num_inst = 1


@register
class Perplexity(EvalMetric):
    """reference: metric.py:960"""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names, ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype(_np.int32).reshape(-1)
            probs = _picked(pred, label)
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    """reference: metric.py:1278"""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype(_np.int64)
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class PearsonCorrelation(EvalMetric):
    """reference: metric.py:1422"""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self.sum_metric += _np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class PCC(MCC):
    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Loss(EvalMetric):
    """Mean of a loss output (reference: metric.py:1610)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = _as_numpy(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class CustomMetric(EvalMetric):
    """reference: metric.py CustomMetric"""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__ if feval.__name__ != "<lambda>" else "custom()"
        super().__init__("custom(%s)" % name if "(" not in name else name,
                         output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            _check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy function (reference: metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


register(Accuracy, "acc")
register(TopKAccuracy, "top_k_acc")
register(CrossEntropy, "ce")
register(NegativeLogLikelihood, "nll_loss")
