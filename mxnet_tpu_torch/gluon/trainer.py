"""Gluon Trainer (counterpart of `mxnet_tpu/gluon/trainer.py:32`;
reference: python/mxnet/gluon/trainer.py), over one or several contexts
and kvstores.

`step(batch_size)` sets the optimizer's ``rescale_grad`` to ``scale /
batch_size``, sums each parameter's gradients over its copies
(`allreduce_grads`), refuses a copy whose gradient no backward has
written since the last step (unless ``ignore_stale_grad``), and applies
the optimizer to every copy of every parameter whose ``grad_req`` is not
null, in place and off the tape, with one updater (and so one set of
optimizer states) a context. It reads each Parameter's arrays at every
step, so a trainer built before the first forward (deferred shapes)
works. Each step is instrumented as the JAX package's is: a goodput
bracket (kind "train": the sum over copies and ranks is ``collective``,
the update ``compute``), a ``train.step`` trace root with
``train.allreduce`` and ``train.optimizer`` spans, and
`telemetry.observe_step` (kind "train"). The forward and backward run
before `step`, outside the trainer, so the step's automatic FLOP count
holds only what the port's kernels report; `telemetry.set_step_flops`
declares the model's.

The kvstore is made at the first step, as the JAX package's
``_init_kvstore`` makes it: none on one context with a single-process
store (nothing to reduce); with several contexts and no store the
gradients are summed in context order (JAX `Trainer._allreduce_grads`);
with a store (``device``, ``local``, a ``dist_*`` name or a `KVStore`)
each parameter's gradients are pushed and pulled one key at a time. A
distributed store with one context a process is the reference's usual
multi-card run (one process a card, `mxnet_tpu_torch.launch`): its
`init` hands every rank rank 0's values, and every push sums over ranks.
``compression_params`` sets the store's 2-bit compression.
``update_on_kvstore`` is recorded and, as in the JAX package, the update
stays with the trainer (the same numbers as an update in the store).

A parameter whose ``grad_stype`` is row_sparse gets its gradient cast to
row_sparse before the update when the optimizer ``supports_sparse``, so
the optimizer takes its lazy row update (JAX `Trainer._update`); any
other optimizer gets the dense gradient.

The states file of `save_states` is the port's own (pickled host arrays
and the optimizer's attributes); `load_states` restores it. After each
step the step-boundary fault hook runs when ``MXTPU_FAULT_INJECT`` is
set (`parallel.resilience.maybe_inject_fault`).
``sharded=True``, `step_batch` and `prefetch` raise: the fused sharded
step is ROADMAP queue 1 item 2 (its persistent tier item 13). The sharded
checkpoints need it, as in the JAX package, and raise with the JAX
package's message; an op-by-op Trainer checkpoints through `save_states`
and `load_states`.
"""
from __future__ import annotations

import pickle
import time

from .. import env as _env
from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError, atomic_writer
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _not_ported(what):
    return MXNetError("Trainer: %s is not ported yet (the fused sharded "
                      "step is ROADMAP queue 1 item 2; its persistent "
                      "compile tier item 13)" % what)


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
            raise _not_ported("sharded=True (the fused sharded step)")
        from .. import kvstore as _kvs

        if kvstore is not None and not isinstance(kvstore, (str,
                                                            _kvs.KVStore)):
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
        self._contexts = self._check_contexts()
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
        self._updaters = [opt.get_updater(self._optimizer)]
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
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

    @property
    def _updater(self):
        return self._updaters[0]

    def _check_contexts(self):
        """The parameters' contexts, which must be one list for all of
        them (a parameter not made yet is skipped)."""
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if not ctx:
                continue
            if contexts is not None and contexts != ctx:
                raise MXNetError("All Parameters must be initialized on the "
                                 "same set of contexts: %s has %s, not %s"
                                 % (param.name, ctx, contexts))
            contexts = ctx
        return contexts or []

    def _is_dist_kvstore(self):
        """Whether the store spans processes, which needs the sums even on
        one context a process (reference: trainer.py:169, ``'dist' in
        kvstore.type``)."""
        kt = self._kvstore_type
        if isinstance(kt, str):
            return "dist" in kt or kt in ("horovod", "tpu")
        return getattr(kt, "num_workers", 1) > 1

    def _init_kvstore(self):
        """Make the kvstore at the first step (reference: trainer.py:169):
        only with several contexts or a distributed store. A distributed
        store's `init` gives every rank rank 0's values, pulled into every
        copy."""
        from .. import kvstore as _kvs

        self._kv_initialized = True
        self._contexts = self._check_contexts()
        kt = self._kvstore_type
        if not kt or (len(self._contexts) < 2
                      and not self._is_dist_kvstore()):
            self._kvstore = None
            return
        kv = _kvs.create(kt) if isinstance(kt, str) else kt
        self._kvstore = kv
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        for i, param in enumerate(self._params):
            if param._nd is not None:
                self._init_key(i, param)

    def _init_key(self, i, param):
        self._kvstore.init(i, param.list_data()[0])
        if self._is_dist_kvstore():
            # every rank trains rank 0's replica
            self._kvstore.pull(i, out=param.list_data())

    def _ensure_updaters(self):
        while len(self._updaters) < max(1, len(self._contexts)):
            self._updaters.append(opt.get_updater(self._optimizer))

    def step(self, batch_size, ignore_stale_grad=False):
        """Sum the gradients over the copies (and ranks), rescale by ``1 /
        batch_size`` and update every copy (reference: trainer.py:298)."""
        t0 = time.perf_counter()
        telemetry.goodput.step_start(kind="train", t0=t0)
        # a traced step records its reduce and update as spans (a no-op
        # span when tracing is not armed)
        with telemetry.tracing.root("train.step", component="train",
                                    attrs={"step": self._step_count + 1}):
            if not self._kv_initialized:
                self._init_kvstore()
            self._optimizer.rescale_grad = self._scale / batch_size
            with telemetry.tracing.span("train.allreduce"), \
                    telemetry.goodput.phase("collective"):
                self._allreduce_grads()
            telemetry.goodput.mark_launch()
            with telemetry.tracing.span("train.optimizer"), \
                    telemetry.goodput.phase("compute"):
                self._update(ignore_stale_grad)
            self._step_count += 1
            telemetry.observe_step(time.perf_counter() - t0,
                                   examples=batch_size, step=self._step_count)
            telemetry.goodput.step_end(step=self._step_count)
        # the step-boundary fault hook; the guard keeps even the import off
        # the step's path when injection is not armed
        if _env.is_set("MXTPU_FAULT_INJECT"):
            from ..parallel import resilience

            resilience.maybe_inject_fault(self._step_count)

    def allreduce_grads(self):
        """Sum each parameter's gradients over its copies (and ranks),
        into every copy's gradient (reference: trainer.py:327)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        if len(self._contexts) < 2 and self._kvstore is None:
            return
        kv = self._kvstore
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            grads = param.list_grad()
            if kv is not None:
                if i not in kv._store:   # made after the store (deferred)
                    self._init_key(i, param)
                kv.push(i, grads)
                kv.pull(i, out=grads)
            else:
                # context order, as the JAX package adds them
                total = grads[0]
                for g in grads[1:]:
                    total = total + g.as_in_context(total.context)
                for g in grads:
                    g._set_data(total._data.to(g._data.device))

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of `step`, after `allreduce_grads`."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        self._ensure_updaters()
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            arrays = param.list_data()
            if not ignore_stale_grad:
                for arr in arrays:
                    if not arr._fresh_grad:
                        raise MXNetError(
                            "Gradient of Parameter `%s` on context %s has "
                            "not been updated by backward since last step. "
                            "Set ignore_stale_grad=True to suppress"
                            % (param.name, arr.context))
            for upd, arr, grad in zip(self._updaters, arrays,
                                      param.list_grad()):
                if param.grad_stype == "row_sparse" \
                        and self._optimizer.supports_sparse:
                    grad = grad.tostype("row_sparse")
                upd(i, grad, arr)
                arr._fresh_grad = False

    def step_batch(self, data, label=None):
        raise _not_ported("step_batch (the promoted sharded step)")

    def prefetch(self, it, depth=None):
        raise _not_ported("prefetch (the promoted sharded step)")

    def sync_params(self):
        """Nothing to copy: the Parameters are the training copies."""

    @staticmethod
    def _require_sharded(what):
        raise MXNetError(
            "%s needs the promoted sharded trainer (sharded=True + "
            "block=, or MXTPU_SHARDED_STEP=1); op-by-op trainers "
            "checkpoint via save_states/load_states (the promoted sharded "
            "trainer is not ported yet: ROADMAP queue 1 item 2)" % what)

    def save_sharded_checkpoint(self, manager, step=None, meta=None):
        self._require_sharded("save_sharded_checkpoint")

    def emergency_sharded_checkpoint(self, manager, meta=None):
        self._require_sharded("emergency_sharded_checkpoint")

    def restore_sharded_checkpoint(self, manager, step=None):
        self._require_sharded("restore_sharded_checkpoint")

    def save_states(self, fname):
        """Write the optimizer's states (the first context's, as the JAX
        package writes them), its attributes and the step count to
        ``fname``, atomically (reference: trainer.py:429)."""
        blob = {"__mxtpu_torch_trainer_states__": 1,
                "updater": self._updaters[0].get_states(
                    dump_optimizer=True),
                "step_count": self._step_count}
        with atomic_writer(fname, "wb") as f:
            pickle.dump(blob, f)

    def load_states(self, fname):
        """Restore a file of `save_states` into every context's updater
        (reference: trainer.py:458)."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        if not (isinstance(blob, dict)
                and "__mxtpu_torch_trainer_states__" in blob):
            raise MXNetError("%s is not a states file of this package's "
                             "Trainer" % fname)
        param_dict = self._optimizer.param_dict
        self._ensure_updaters()
        for updater in self._updaters:
            updater.set_states(blob["updater"])
            self._optimizer.param_dict = param_dict
            updater.optimizer = self._optimizer
        self._step_count = int(blob.get("step_count", 0))
