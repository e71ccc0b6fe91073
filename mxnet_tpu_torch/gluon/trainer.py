"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py:32`;
reference: python/mxnet/gluon/trainer.py), on one device.

`step(batch_size)` sets the optimizer's ``rescale_grad`` to ``scale /
batch_size``, refuses a parameter whose gradient no backward has written
since the last step (unless ``ignore_stale_grad``), and applies the
optimizer to every parameter whose ``grad_req`` is not null, in place and
off the tape. It reads each Parameter's arrays at every step, so a trainer
built before the first forward (deferred shapes) works. Each step feeds
the port's telemetry (`telemetry.observe_step`, kind "train"), as the JAX
package's does.

A parameter whose ``grad_stype`` is row_sparse gets its gradient cast to
row_sparse before the update when the optimizer ``supports_sparse``, so
the optimizer takes its lazy row update (JAX `Trainer._update`); any
other optimizer gets the dense gradient. ``kvstore`` ("device", "local",
a ``local_*`` name or a single-process `kvstore.KVStore`) and
``compression_params`` are accepted and, as in the JAX package, unused on
one device: there is nothing to reduce.

The states file of `save_states` is the port's own (pickled host arrays
and the optimizer's attributes); `load_states` restores it. Several
contexts, a distributed kvstore, ``sharded=True``, `step_batch`,
`prefetch` and the sharded checkpoints raise: they are ROADMAP queue 1
item 11 part 2.
"""
from __future__ import annotations

import pickle
import time

from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError, atomic_writer
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _multi_card(what):
    return MXNetError("Trainer: %s is not ported yet (ROADMAP queue 1 item "
                      "11 part 2)" % what)


class Trainer:
    """Applies an optimizer to a set of Parameters (reference:
    trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, sharded=None, block=None, loss=None,
                 mesh=None, sharding_rules=None, amp_dtype=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a list or dict of Parameters")
        if sharded:
            raise _multi_card("sharded=True (the fused sharded step)")
        from .. import kvstore as _kvs

        if isinstance(kvstore, str):
            _kvs.create(kvstore)   # raises for the multi-card names
        elif kvstore is not None and not isinstance(kvstore, _kvs.KVStore):
            raise MXNetError("kvstore must be a name or a KVStore, not %r"
                             % (kvstore,))
        self._compression_params = compression_params
        self._params = []
        self._param2idx = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise MXNetError("invalid parameter %r" % (p,))
            self._params.append(p)
            self._param2idx[p.name] = i
        for p in self._params:
            if len(p.list_ctx()) > 1:
                raise _multi_card("a parameter on several contexts")
        optimizer_params = optimizer_params or {}
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be empty when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._scale = self._optimizer.rescale_grad
        self._updater = opt.get_updater(self._optimizer)
        self._step_count = 0

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr_scheduler(o.num_update) if o.lr_scheduler else o.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def step_count(self):
        """Completed `step` calls (kept by `save_states`)."""
        return self._step_count

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size`` and update every parameter
        (reference: trainer.py:298)."""
        t0 = time.perf_counter()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)
        self._step_count += 1
        telemetry.observe_step(time.perf_counter() - t0,
                               examples=batch_size, step=self._step_count)

    def allreduce_grads(self):
        """Nothing to reduce: one device holds every gradient."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of `step`, after `allreduce_grads`."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            arr = param.data()
            if not arr._fresh_grad and not ignore_stale_grad:
                raise MXNetError(
                    "Gradient of Parameter `%s` on context %s has not been "
                    "updated by backward since last step. Set "
                    "ignore_stale_grad=True to suppress"
                    % (param.name, arr.context))
            grad = param.grad()
            if param.grad_stype == "row_sparse" \
                    and self._optimizer.supports_sparse:
                grad = grad.tostype("row_sparse")
            self._updater(i, grad, arr)
            arr._fresh_grad = False

    def step_batch(self, data, label=None):
        raise _multi_card("step_batch (the promoted sharded step)")

    def prefetch(self, it, depth=None):
        raise _multi_card("prefetch (the promoted sharded step)")

    def sync_params(self):
        """Nothing to copy: the Parameters are the training copies."""

    def save_sharded_checkpoint(self, manager, step=None, meta=None):
        raise _multi_card("save_sharded_checkpoint")

    def emergency_sharded_checkpoint(self, manager, meta=None):
        raise _multi_card("emergency_sharded_checkpoint")

    def restore_sharded_checkpoint(self, manager, step=None):
        raise _multi_card("restore_sharded_checkpoint")

    def save_states(self, fname):
        """Write the optimizer's states, its attributes and the step count
        to ``fname``, atomically (reference: trainer.py:429)."""
        blob = {"__mxtpu_torch_trainer_states__": 1,
                "updater": self._updater.get_states(dump_optimizer=True),
                "step_count": self._step_count}
        with atomic_writer(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_states(self, fname):
        """Restore a file of `save_states` (reference: trainer.py:458)."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        if not (isinstance(blob, dict)
                and "__mxtpu_torch_trainer_states__" in blob):
            raise MXNetError("%s is not a states file of this package's "
                             "Trainer" % fname)
        param_dict = self._optimizer.param_dict
        self._updater.set_states(blob["updater"])
        self._optimizer.param_dict = param_dict
        self._updater.optimizer = self._optimizer
        self._step_count = int(blob.get("step_count", 0))
