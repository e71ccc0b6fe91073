"""DistributedTrainer: the training step of the port (counterpart of
`mxnet_tpu/parallel/trainer.py`), on one card.

One `step(data, label)` is: forward in the compute dtype, the loss
``mean(loss(pred, label))`` in f32, the gradients, and the optimizer's
update of every trainable parameter. As in the JAX package:

* with ``amp_dtype`` (bfloat16), every trainable floating parameter and
  the data are cast to it INSIDE the autograd graph
  (`torch.func.functional_call` with ``p.to(amp)``), so the gradients come
  back f32 onto the f32 master weights; the BatchNorm running statistics
  (buffers) stay f32. `torch.autocast` is not used: its per-op rules are
  not the JAX package's cast;
* the loss is a batch mean, so the gradients are batch means and
  ``rescale_grad`` stays the optimizer's own value.

The step runs eagerly (the JAX package jit-compiles it into one
executable); the parameters are the block's own tensors, updated in place.
A mesh of more than one device is not ported yet (it needs the NCCL
collectives of a later slice).
"""
from __future__ import annotations

import time

import torch

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError

__all__ = ["DistributedTrainer"]

_AMP = {None: None, "float32": None, torch.float32: None,
        "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def _amp_dtype(amp):
    if amp not in _AMP:
        raise MXNetError("amp_dtype must be None, float32 or bfloat16, got "
                         "%r" % (amp,))
    return _AMP[amp]


class DistributedTrainer:
    """Training of ``block`` (a `torch.nn.Module` whose parameters are on
    one device) with ``optimizer`` (a name such as ``"sgd"`` plus
    ``optimizer_params``, or an `Optimizer`), ``loss`` (callable(pred,
    label) -> per-sample loss) and optional ``amp_dtype``. ``mesh``: None
    or a sequence of one device."""

    def __init__(self, block, optimizer, optimizer_params=None, loss=None,
                 mesh=None, amp_dtype=None):
        if mesh is not None:
            devices = list(mesh) if isinstance(mesh, (list, tuple)) \
                else [mesh]
            if len(devices) != 1:
                raise MXNetError("DistributedTrainer: a mesh of %d devices "
                                 "is not ported yet (one card; NCCL comes "
                                 "in a later slice)" % len(devices))
        self._block = block
        self._loss = loss
        self._amp = _amp_dtype(amp_dtype)
        # sorted by name, as the JAX trainer orders its parameters
        items = sorted((n, p) for n, p in block.named_parameters()
                       if p.requires_grad)
        if not items:
            raise MXNetError("block has no trainable parameters")
        self._names = [n for n, _ in items]
        self._params = [p for _, p in items]
        self._device = self._params[0].device
        if any(p.device != self._device for p in self._params):
            raise MXNetError("DistributedTrainer: the block's parameters "
                             "are on more than one device")
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [self._optimizer.create_state(i, p)
                        for i, p in enumerate(self._params)]
        self._step_count = 0

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _batch(self, a, cast):
        t = torch.as_tensor(a).to(self._device, non_blocking=True)
        if cast and self._amp is not None and t.is_floating_point():
            t = t.to(self._amp)
        return t

    def step(self, data, label=None):
        """One training step; returns the loss as a 0-d f32 tensor on the
        device (no host sync). The recorded step seconds
        (`telemetry.observe_step`, kind "dist") are host time of the call:
        without a sync they track the device only once its launch queue is
        full."""
        t0 = time.perf_counter()
        if self._loss is not None and label is None:
            raise MXNetError("this trainer was built with a loss that takes "
                             "(pred, label); step() needs a label argument")
        x = self._batch(data, cast=True)
        y = None if label is None else self._batch(label, cast=False)
        self._step_count += 1
        o = self._optimizer
        o.num_update = max(self._step_count + o.begin_num_update,
                           o.num_update)
        self._block.train()
        with torch.enable_grad():
            if self._amp is None:
                out = self._block(x)
            else:
                cast = {n: p.to(self._amp)
                        for n, p in zip(self._names, self._params)}
                out = torch.func.functional_call(self._block, cast, (x,))
            pred = out[0] if isinstance(out, (list, tuple)) else out
            per_sample = pred if self._loss is None else self._loss(pred, y)
            loss = per_sample.float().mean()
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
        # the range names the update's kernels in a torch.profiler trace
        with torch.profiler.record_function("trainer.optimizer"):
            for i, (p, g, s) in enumerate(zip(self._params, grads,
                                              self._states)):
                # a parameter the loss does not reach (BERT's pooler under
                # an MLM head) gets a zero gradient, as from jax.grad
                o.update(i, p, torch.zeros_like(p) if g is None else g, s)
        telemetry.observe_step(time.perf_counter() - t0,
                               examples=int(x.shape[0]),
                               step=self._step_count, kind="dist")
        return loss.detach()

    def prefetch(self, it, depth=None):
        """``it`` wrapped in a `data.DevicePrefetcher` onto this trainer's
        device: the copy of batch N+1 overlaps step N."""
        from ..data import DevicePrefetcher

        return DevicePrefetcher(it, depth=depth, mesh=self._device,
                                src="sharded")

    def forward(self, data, is_train=False):
        """Forward of the block in f32 without gradients; in training mode
        (``is_train``) BatchNorm uses batch statistics and advances its
        running statistics."""
        was = self._block.training
        self._block.train(is_train)
        try:
            with torch.no_grad():
                return self._block(self._batch(data, cast=False))
        finally:
            self._block.train(was)

    def sync_params(self):
        """Nothing to copy: the trainer updates the block's own parameters
        in place (the JAX trainer keeps separate device arrays and copies
        them back here)."""
