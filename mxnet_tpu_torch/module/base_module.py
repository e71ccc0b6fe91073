"""BaseModule: the symbolic training-loop interface (counterpart of
`mxnet_tpu/module/base_module.py`; reference:
python/mxnet/module/base_module.py — fit :409, forward_backward :193).

`fit` is the reference's epoch loop of `forward_backward`, `update`,
`update_metric` and the callbacks, with `score` on the evaluation data.
Each step is instrumented as the JAX package's is: a goodput bracket
(kind "fit") back-dated to the wait on the data iterator, a
``train.step`` trace root with the wait as a child span, the step's
FLOPs counted once a batch signature, `telemetry.observe_step`, and the
``mxtpu_data_wait_seconds_total`` / ``mxtpu_data_compute_seconds_total``
counters (``src="fit"``). ``checkpoint_dir`` / ``checkpoint_period`` /
``resume`` give crash-consistent checkpoints and auto-resume through
`parallel.resilience.CheckpointManager`, with graceful preemption (an
emergency checkpoint mid-epoch that carries the batch cursor) and the
step-boundary fault hook; ``monitor`` installs a `Monitor` and prints its
rows every batch. The fused one-step path (the captured step, ROADMAP
queue 1 item 2) is not ported: `fit` always runs `forward_backward` and
`update`.
"""
from __future__ import annotations

import logging
import time

from .. import env as _env
from ..base import MXNetError, unpad_outputs
from .. import metric as metric_mod
from .. import ndarray as nd

__all__ = ["BaseModule", "BatchEndParam"]


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


class BaseModule(object):
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.inputs_need_grad = False
        self._symbol = None

    # -- abstract interface (Module implements) ----------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, *args, **kwargs):
        raise NotImplementedError()

    def init_params(self, *args, **kwargs):
        raise NotImplementedError()

    # -- composite ops -----------------------------------------------------
    def forward_backward(self, data_batch):
        """reference: base_module.py:193."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def supports_fused_step(self):
        """The fused one-step path is not ported (ROADMAP queue 1 item 2):
        `fit` always runs `forward_backward` and `update`."""
        return False

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Forward ``eval_data`` (``is_train=False``) into ``eval_metric``;
        its name-value pairs (reference: base_module.py score)."""
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=locals()))
        for cb in _as_list(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                             eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data``, padding removed, concatenated over
        the batches (reference: base_module.py predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            output_list.append(unpad_outputs(self.get_outputs(), pad,
                                             copy=True))
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for o in output_list:
                if len(o) != num_outputs:
                    raise MXNetError("cannot merge batches with different "
                                     "numbers of outputs")
            merged = [nd.concat(*[o[i] for o in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` over ``eval_data``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = getattr(eval_batch, "pad", 0) or 0
            yield unpad_outputs(self.get_outputs(), pad), nbatch, eval_batch

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_dir=None, checkpoint_period=1, resume=None):
        """The symbolic training loop (reference: base_module.py:409): bind,
        init_params (``initializer`` default `Uniform(0.01)`),
        init_optimizer, then each epoch every batch's `forward_backward`,
        `update`, `update_metric` and ``batch_end_callback``; at the
        epoch's end ``epoch_end_callback(epoch, symbol, arg_params,
        aux_params)`` and `score` on ``eval_data``. With
        ``MXTPU_DATA_PREFETCH`` set the batches come through a
        `data.DevicePrefetcher` onto the module's device.

        Fault tolerance (docs/fault_tolerance.md): ``checkpoint_dir``
        saves a crash-consistent checkpoint (parameters, optimizer states,
        the random state, the epoch) every ``checkpoint_period`` epochs
        through `parallel.resilience.CheckpointManager`; ``resume="auto"``
        restores the newest complete one, so a restarted generation goes
        on from there, and ``resume=<epoch>`` pins one (`MXNetError` if
        it does not verify). With ``checkpoint_dir`` a SIGTERM no longer
        kills the step: the step finishes, an emergency checkpoint lands
        within ``MXTPU_PREEMPT_GRACE_S`` with the batches done in the epoch
        (and the iterator's ``state()`` where it has one), and the process
        exits ``MXTPU_PREEMPT_EXIT_CODE``; the resumed `fit` skips those
        batches (or restores the cursor) and ends where an uninterrupted
        run would. ``monitor``: a `Monitor` installed on the module, its
        ``tic`` before and ``toc_print`` after every batch."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform

        initializer = initializer or Uniform(0.01)
        mgr = None
        if checkpoint_dir is not None:
            from ..parallel.resilience import CheckpointManager

            mgr = CheckpointManager(checkpoint_dir)
        elif resume is not None:
            raise MXNetError("fit(resume=...) needs checkpoint_dir=")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        resume_skip = 0
        data_restored = False
        if mgr is not None and resume is not None:
            header = mgr.restore(
                load_params=self.load_params,
                load_states=self.load_optimizer_states,
                step=None if resume == "auto" else int(resume))
            # None only for resume="auto" without a complete checkpoint (a
            # fresh start); an explicit epoch that does not verify raised
            if header is not None:
                begin_epoch = int(header["meta"].get(
                    "epoch", header["step"])) + 1
                # a preemption checkpoint lands mid-epoch: its weights hold
                # the first `batches_done` updates of that epoch, which the
                # resumed epoch skips instead of applying again
                resume_skip = int(header["meta"].get("batches_done", 0))
                # an iterator with a cursor restores it exactly; its
                # set_state arms a one-shot skip of the epoch's reset
                data_state = header["meta"].get("data_state")
                if data_state is not None and \
                        hasattr(train_data, "set_state"):
                    train_data.set_state(data_state)
                    data_restored = True
                self.logger.info(
                    "resumed from checkpoint step %d (%s); continuing at "
                    "epoch %d%s%s", header["step"], mgr.directory,
                    begin_epoch,
                    " batch %d" % resume_skip if resume_skip else "",
                    " (exact data cursor)" if data_restored else "")
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        from .. import telemetry
        from ..parallel import resilience

        # with checkpoints configured, SIGTERM raises a flag instead of
        # killing the step; the step boundary below lands the emergency
        # checkpoint and exits with the preemption code
        if mgr is not None:
            resilience.install_preemption_handler()

        # the input pipeline's starvation: seconds waiting on the data
        # iterator against seconds in forward, backward and update
        tm_wait = telemetry.counter("mxtpu_data_wait_seconds_total",
                                    {"src": "fit"})
        tm_compute = telemetry.counter("mxtpu_data_compute_seconds_total",
                                       {"src": "fit"})
        # the step's FLOPs, counted once a batch signature
        counted = telemetry.flops.instrument(self._fit_compute)

        # MXTPU_DATA_PREFETCH: batch N+1's host work and its copy to this
        # module's device overlap batch N's compute
        use_prefetch = _env.get("MXTPU_DATA_PREFETCH")
        fit_updates = 0
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            batches = iter(train_data)
            nbatch = 0
            if epoch == begin_epoch and resume_skip:
                if data_restored:
                    # the restored cursor is past these batches already:
                    # only the numbering catches up
                    nbatch = resume_skip
                else:
                    for _ in range(resume_skip):
                        try:
                            next(batches)
                        except StopIteration:
                            break
                        nbatch += 1
            prefetcher = None
            if use_prefetch:
                from ..data import DevicePrefetcher

                # the one executor's device: the first context's
                ctx = getattr(self, "_context", None)
                if isinstance(ctx, (list, tuple)):
                    ctx = ctx[0]
                batches = prefetcher = DevicePrefetcher(batches, mesh=ctx,
                                                        src="fit")
            try:
                while True:
                    t_wait = time.perf_counter()
                    try:
                        data_batch = next(batches)
                    except StopIteration:
                        break
                    t_step = time.perf_counter()
                    tm_wait.inc(t_step - t_wait)
                    # the goodput bracket opens back-dated to the wait
                    # (which belongs to the step), after a successful
                    # next(), so StopIteration leaves no bracket open
                    telemetry.goodput.step_start(kind="fit", t0=t_wait)
                    telemetry.goodput.add("data_wait", t_step - t_wait)
                    if monitor is not None:
                        monitor.tic()
                    # one root span a step; the wait predates the root and
                    # is emitted as a child with its measured times
                    with telemetry.tracing.root(
                            "train.step", component="train",
                            attrs={"step": fit_updates + 1,
                                   "kind": "fit"}) as t_span:
                        telemetry.tracing.emit_span(
                            "train.data_wait",
                            time.time() - (t_step - t_wait), t_step - t_wait,
                            t_span, component="train")
                        telemetry.goodput.mark_launch()
                        counted(_batch_arrays(data_batch), data_batch)
                        fit_updates += 1
                        examples = None
                        try:
                            examples = int(data_batch.data[0].shape[0])
                        except (AttributeError, IndexError, TypeError):
                            pass
                        telemetry.observe_step(time.perf_counter() - t_step,
                                               examples=examples,
                                               step=fit_updates, kind="fit")
                        telemetry.goodput.step_end(step=fit_updates)
                    # the step-boundary fault hook: updates since this
                    # process started
                    resilience.maybe_inject_fault(fit_updates)
                    if mgr is not None and resilience.preemption_requested():
                        if prefetcher is not None:
                            # the pipeline stops first: its threads joined,
                            # its delivered-batch cursor final
                            prefetcher.close()
                        resilience.maybe_preempt_exit(
                            emergency_save=lambda: self._emergency_save(
                                mgr, epoch, nbatch + 1,
                                prefetcher or train_data))
                    self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        monitor.toc_print()
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals()))
                    nbatch += 1
                    tm_compute.inc(time.perf_counter() - t_step)
            finally:
                if prefetcher is not None:
                    prefetcher.close()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            if mgr is not None and (epoch + 1) % checkpoint_period == 0:
                mgr.save(epoch, save_params=self.save_params,
                         save_states=self.save_optimizer_states,
                         meta={"epoch": epoch})
            arg_p, aux_p = self.get_params()
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

    def _emergency_save(self, mgr, epoch, batches_done, cursor):
        """The preemption's checkpoint, mid-epoch: meta ``epoch`` is the
        one before, so the resumed `fit` enters the interrupted epoch, and
        ``batches_done`` the batches whose updates these weights hold;
        ``data_state`` is the iterator's cursor where it has one."""
        meta = {"epoch": epoch - 1, "preempt": True,
                "batches_done": batches_done}
        if hasattr(cursor, "state"):
            try:
                meta["data_state"] = cursor.state()
            except MXNetError:
                pass  # the inner iterator has no cursor
        mgr.save(epoch, save_params=self.save_params,
                 save_states=self.save_optimizer_states, meta=meta)

    def _fit_compute(self, arrays, data_batch):
        """One `fit` step's forward, backward and update (``arrays``, the
        batch's, give `telemetry.flops.instrument` its signature)."""
        from .. import telemetry

        with telemetry.tracing.span("train.fwd_bwd"), \
                telemetry.goodput.phase("compute"):
            self.forward_backward(data_batch)
        with telemetry.tracing.span("train.optimizer"), \
                telemetry.goodput.phase("compute"):
            self.update()

    # -- misc --------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def install_monitor(self, mon):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()


def _batch_arrays(data_batch):
    """A batch's data and label arrays, in order (its FLOP signature)."""
    return list(data_batch.data or []) + list(
        getattr(data_batch, "label", None) or [])


class BatchEndParam(object):
    """What a batch-end callback gets (reference: callback BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]
