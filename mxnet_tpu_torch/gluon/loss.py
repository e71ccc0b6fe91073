"""Losses (counterpart of `mxnet_tpu/gluon/loss.py`; reference:
python/mxnet/gluon/loss.py): L2, L1, sigmoid binary and softmax cross
entropy, KL divergence, Huber, hinge, squared hinge, logistic, triplet,
Poisson NLL, cosine embedding and CTC, as `HybridBlock`s that compute on
tensors (called with NDArrays they return NDArrays). A loss maps (pred,
label) to one value a sample, the mean over every axis but ``batch_axis``,
after the ``weight`` (a number) and the ``sample_weight`` input (broadcast)
scale it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ..ops import nn as _ops
from ..ops import rnn as _rnn_ops
from .nn.basic_layers import _Layer

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


def _weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _like(x, y):
    return x.reshape(y.shape)


def _softrelu(x):
    return _F.softplus(x)


class Loss(_Layer):
    """Base loss: ``weight`` scales every sample's loss; the result is a
    mean over every axis but ``batch_axis``."""

    def __init__(self, weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean(self, loss):
        axes = [a for a in range(loss.dim())
                if a != self._batch_axis % loss.dim()]
        return loss.mean(dim=axes) if axes else loss

    def _finish(self, loss, sample_weight=None, weight=None):
        return self._mean(_weighting(loss, self._weight if weight is None
                                     else weight, sample_weight))


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (_like(label, pred) - pred).square()
        return self._finish(loss, sample_weight, self._weight / 2)


class L1Loss(Loss):
    """``|label - pred|``."""

    def forward(self, pred, label, sample_weight=None):
        return self._finish((_like(label, pred) - pred).abs(), sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (or of ``pred`` itself with
    ``from_sigmoid``), with an optional ``pos_weight`` on the positives."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu(-pred.abs())
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-pred.abs()) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        return self._finish(loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` along ``axis`` (default -1). Integer
    labels (``sparse_label``) are clipped to [0, K - 1], as ``pick``'s
    default mode does; ``sparse_label=False`` takes a distribution over
    the axis; ``from_logits`` takes ``pred`` as log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else _ops.log_softmax(pred, axis=self._axis)
        ax = self._axis % logp.dim()
        if self._sparse_label:
            idx = label.long().clamp(0, logp.shape[ax] - 1)
            if idx.dim() == logp.dim() - 1:
                idx = idx.unsqueeze(ax)
            loss = -logp.gather(ax, idx)
        else:
            loss = -(logp * _like(label, logp)).sum(dim=ax, keepdim=True)
        return self._finish(loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` being log-probabilities
    (``from_logits``, the default) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._finish(loss, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification over the `CTCLoss` op
    (reference: loss.py CTCLoss). ``layout`` "NTC" or "TNC" for pred,
    ``label_layout`` "NT" or "TN"; labels are zero-based with the blank the
    last class (``blank_label="last"``), and the op's ``use_data_lengths``
    / ``use_label_lengths`` follow from whether ``pred_lengths`` /
    ``label_lengths`` are given. One loss a sample, weighted."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _rnn_ops.ctc_loss(
            pred, label, pred_lengths, label_lengths,
            use_data_lengths=pred_lengths is not None,
            use_label_lengths=label_lengths is not None, blank_label="last")
        return _weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho / 2`` beyond ``rho``, ``d^2 / (2 rho)`` within."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = (_like(label, pred) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        return self._finish(loss, sample_weight)


class HingeLoss(Loss):
    """``relu(margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _like(label, pred))
        return self._finish(loss, sample_weight)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _like(label, pred)).square()
        return self._finish(loss, sample_weight)


class LogisticLoss(Loss):
    """Logistic loss; ``label_format`` "signed" takes labels in {-1, 1},
    "binary" in {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu(-pred.abs())
        return self._finish(loss, sample_weight)


class TripletLoss(Loss):
    """``relu(|pos - pred|^2 - |neg - pred|^2 + margin)`` a sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = (_like(positive, pred) - pred).square() \
            - (_like(negative, pred) - pred).square()
        axes = [a for a in range(d.dim())
                if a != self._batch_axis % d.dim()]
        loss = torch.relu((d.sum(dim=axes) if axes else d) + self._margin)
        return _weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, a mean over every element;
    ``compute_full`` adds Stirling's term for targets above 1."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _like(target, pred)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + epsilon) - target \
                + 0.5 * torch.log(2 * target * math.pi + epsilon)
            loss = loss + torch.where(target <= 1,
                                      torch.zeros_like(stirling), stirling)
        return _weighting(loss, self._weight, sample_weight).mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``relu(cos - margin)``
    otherwise, a sample."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        a = input1.reshape(input1.shape[0], -1)
        b = input2.reshape(input2.shape[0], -1)
        cos = (a * b).sum(dim=1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _weighting(loss, self._weight, sample_weight)
