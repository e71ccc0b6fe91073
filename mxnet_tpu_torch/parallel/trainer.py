"""DistributedTrainer: the training step of the port (counterpart of
`mxnet_tpu/parallel/trainer.py`), over a mesh of every axis.

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
  ``rescale_grad`` stays the optimizer's own value;
* ``loss_inputs`` picks what a model with several outputs feeds the loss
  (a gluon loss Block gets the first output, a plain callable all of
  them), and `step` returns the loss as an `NDArray`.

Over a mesh (`parallel.make_mesh`, one process a device) a step gives
what the JAX package's GSPMD step gives, the unsharded step on the global
batch:

* the global batch is split over ``dp`` x ``fsdp`` (dp-major, as
  `batch_spec`); the ranks that differ only on ``tp``, ``sp``, ``pp`` or
  ``ep`` hold the same rows;
* a parameter whose spec (`ShardingRules`) names ``tp`` or ``fsdp`` lives
  on its rank as its block (`sharding.shard_array`), and so do its
  optimizer states; the forward gathers the block in the graph
  (`sharding.unshard`: over fsdp the gradient is then reduce-scattered,
  summed in rank order; over tp, where the ranks compute the same thing,
  each keeps its own block of it);
* an MoE expert table of shape (E, ...) whose spec is ``ep`` lives on its
  ``ep`` rank as rows [q E/ep, (q+1) E/ep), and the forward runs on those
  rows; the MoE ops route over the mesh (`mesh.step_scope`);
* BatchNorm's statistics are the global batch's: inside the step scope
  the conv-epilogue kernels gather each rank's raw sums over dp x fsdp
  (`ops.pallas_kernels.conv_epilogue`);
* each rank's loss is its shard's mean; the gradients and the loss are
  summed over dp x fsdp in rank order (one flat all-gather a dtype; dp
  alone for an fsdp block, already summed over fsdp) and divided by
  dp x fsdp, so every parameter gets the global gradient;
* rank 0's parameters are broadcast when the trainer is built, and
  `sync_params` gathers every block back into each rank's block.

At world size 1 the step launches what it launched before this layer
existed: no collective and no host sync.
"""
from __future__ import annotations

import time

import torch

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError
from . import collectives as coll
from .mesh import (DATA, DP, EP, FSDP, TP, Mesh, current_mesh, is_shard,
                   step_scope)
from .sharding import ShardingRules, gather_array, shard_array, unshard

__all__ = ["DistributedTrainer"]

_AMP = {None: None, "float32": None, torch.float32: None,
        "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}

def _amp_dtype(amp):
    if amp not in _AMP:
        raise MXNetError("amp_dtype must be None, float32 or bfloat16, got "
                         "%r" % (amp,))
    return _AMP[amp]


def _mesh_of(mesh):
    """``mesh`` as a `Mesh`: None is the current mesh; a device or a
    sequence of one device (this package's earlier form) is a one-device
    mesh."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is not None:
        devices = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
        if len(devices) != 1:
            raise MXNetError("DistributedTrainer: a mesh is a "
                             "parallel.make_mesh over the process group, "
                             "one device a process; got a list of %d "
                             "devices" % len(devices))
    return current_mesh()


def _bucket_sum(tensors, ax, scale):
    """``tensors`` summed over the mesh axis ``ax`` in rank order and
    multiplied by ``scale``: one all-gather a dtype."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        t0 = time.perf_counter()
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = coll._sum(flat, ax) * scale
        coll._observe_collective("all_reduce", [flat],
                                 time.perf_counter() - t0)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def broadcast_from_rank0(block, params, device):
    """Rank 0's ``params`` and ``block``'s floating buffers onto every rank
    (one broadcast a dtype): replicated values start identical, as the JAX
    package's one logical array."""
    tensors = list(params) + [b for b in block.buffers()
                              if b.is_floating_point()]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = coll.broadcast_arrays(
                torch.cat([t.reshape(-1) for t in ts]), [device])[0]
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


class DistributedTrainer:
    """Training of ``block`` (a `torch.nn.Module`, such as a gluon Block,
    whose parameters are on this rank's device) with ``optimizer`` (a name
    such as ``"sgd"`` plus ``optimizer_params``, or an `Optimizer`),
    ``loss`` (callable(pred, label) -> per-sample loss), optional
    ``amp_dtype``, over ``mesh`` (default `current_mesh()`; see the module
    docstring) with ``rules`` (a `ShardingRules`).

    ``loss_inputs``: what a model with several outputs feeds the loss —
    "pred" (the first output), "outputs" (the whole tuple, for auxiliary
    terms such as MoE's load-balance and z-losses) or None (default:
    gluon loss Blocks get "pred", plain callables "outputs")."""

    def __init__(self, block, optimizer, optimizer_params=None, loss=None,
                 mesh=None, rules=None, amp_dtype=None, loss_inputs=None):
        if loss_inputs not in (None, "pred", "outputs"):
            raise MXNetError("loss_inputs must be None, 'pred' or 'outputs'")
        self._mesh = mesh = _mesh_of(mesh)
        world = coll.num_workers()
        if mesh.size != world:
            raise MXNetError("DistributedTrainer: a mesh of %d devices over "
                             "a world of %d processes (one device a "
                             "process)" % (mesh.size, world))
        self._data = mesh.axis(DATA)
        self._block = block
        self._loss = loss
        self._loss_inputs = loss_inputs
        self._amp = _amp_dtype(amp_dtype)
        rules = rules or ShardingRules()
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
        if world > 1:
            broadcast_from_rank0(block, self._params, self._device)
        # the gluon names (what the sharding rules match), else the
        # module's own
        gluon = {}
        if hasattr(block, "collect_params"):
            gluon = {id(p.var): n for n, p in block.collect_params().items()
                     if p.var is not None}
        self._param_names = [gluon.get(id(p), n)
                             for n, p in zip(self._names, self._params)]
        self._specs = [rules.spec_for(n, p.shape, mesh)
                       for n, p in zip(self._param_names, self._params)]
        # the values the step trains: the block's own tensors, but this
        # rank's block of a tensor split over ep, tp or fsdp
        self._arrays = []
        self._experts = []   # split over ep (the forward keeps the rows)
        self._sharded = []   # split over any axis
        self._gathered = []  # split over tp or fsdp (gathered in forward)
        for i, (spec, p) in enumerate(zip(self._specs, self._params)):
            for d, entry in enumerate(spec):
                if entry is not None and (entry not in (EP, TP, FSDP)
                                          or entry == EP and d > 0):
                    raise MXNetError(
                        "DistributedTrainer: %s's spec %s: a dimension "
                        "splits over tp or fsdp, or ep on dimension 0"
                        % (self._param_names[i], spec))
            split = [e for e in spec if e is not None
                     and mesh.axis(e).size > 1]
            if not split:
                self._arrays.append(p)
                continue
            part = shard_array(p.detach(), mesh, spec)
            self._arrays.append(part.clone().requires_grad_(True))
            self._sharded.append(i)
            if EP in split:
                self._experts.append(i)
            if TP in split or FSDP in split:
                self._gathered.append(i)
        # the axis each gradient is summed over: dp x fsdp, or dp for a
        # block over fsdp, whose gather's conjugate summed it over fsdp
        self._grad_axes = [
            DP if FSDP in tuple(spec) and mesh.axis(FSDP).size > 1 else DATA
            for spec in self._specs]
        opt = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer, **(optimizer_params or {}))
        self._optimizer = opt
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [self._optimizer.create_state(i, a)
                        for i, a in enumerate(self._arrays)]
        self._step_count = 0
        self._counted = None   # the step, FLOP-counted once a signature

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def mesh(self):
        return self._mesh

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _batch(self, a, cast):
        """``a`` on the device: this rank's dp x fsdp rows of the global
        batch (a shard a mesh-bound prefetcher placed is taken as it
        is)."""
        from ..ndarray import NDArray

        if isinstance(a, NDArray):
            a = a._data
        t = torch.as_tensor(a)
        ax = self._data
        if ax.size > 1 and not is_shard(t):
            if t.shape[0] % ax.size:
                raise MXNetError("DistributedTrainer: a global batch of %d "
                                 "rows does not split over dp x fsdp=%d"
                                 % (t.shape[0], ax.size))
            n = t.shape[0] // ax.size
            t = t[ax.index * n:(ax.index + 1) * n]
        t = t.to(self._device, non_blocking=True)
        if cast and self._amp is not None and t.is_floating_point():
            t = t.to(self._amp)
        return t

    def _call(self, x):
        """The block's forward on ``x`` over the trained values (blocks
        gathered over tp / fsdp, cast to the compute dtype first)."""
        values = {}
        for i, (n, a) in enumerate(zip(self._names, self._arrays)):
            if self._amp is not None:
                a = a.to(self._amp)
            elif i not in self._sharded:
                continue
            if i in self._gathered:
                a = unshard(a, self._mesh, self._specs[i])
            values[n] = a
        if not values:
            return self._block(x)
        return torch.func.functional_call(self._block, values, (x,))

    def _loss_of(self, out, y):
        pred = out[0] if isinstance(out, (list, tuple)) else out
        if self._loss is None:
            return pred
        mode = self._loss_inputs
        if mode is None:
            from ..gluon.loss import Loss

            mode = "pred" if isinstance(self._loss, Loss) else "outputs"
        if mode == "outputs" and isinstance(out, (list, tuple)) \
                and len(out) > 1:
            return self._loss(tuple(out), y)
        return self._loss(pred, y)

    def step(self, data, label=None, batch_size=None):
        """One training step; returns the global batch's mean loss as an
        `NDArray` of a 0-d f32 tensor on the device (no host sync).
        ``batch_size`` is the JAX signature's and unused: the loss is
        already a batch mean. The step is instrumented as the JAX
        package's is, on host clocks only: a goodput bracket (kind
        "dist": the batch's placement is ``data_wait``, the launch of the
        step ``compute``), a ``train.step`` trace root (component
        "train"), `telemetry.observe_step` (kind "dist"; its seconds are
        host time of the call, which tracks the device only once its
        launch queue is full), and the step's FLOPs, counted once a shape
        signature (`telemetry.flops.instrument`)."""
        from ..ndarray import NDArray

        t0 = time.perf_counter()
        telemetry.goodput.step_start(kind="dist", t0=t0)
        if self._loss is not None and label is None:
            raise MXNetError("this trainer was built with a loss that takes "
                             "(pred, label); step() needs a label argument")
        with telemetry.goodput.phase("data_wait"):
            x = self._batch(data, cast=True)
            y = None if label is None else self._batch(label, cast=False)
        self._step_count += 1
        o = self._optimizer
        o.num_update = max(self._step_count + o.begin_num_update,
                           o.num_update)
        if self._counted is None:
            self._counted = telemetry.flops.instrument(self._train_step)
        with telemetry.tracing.root("train.step", component="train",
                                    attrs={"step": self._step_count,
                                           "kind": "dist"}):
            telemetry.goodput.mark_launch()
            with telemetry.tracing.span("train.fused_step"), \
                    telemetry.goodput.phase("compute"):
                loss = self._counted(x, y)
            telemetry.observe_step(time.perf_counter() - t0,
                                   examples=int(x.shape[0]) * self._data.size,
                                   step=self._step_count, kind="dist")
            telemetry.goodput.step_end(step=self._step_count)
        return NDArray(loss)

    def _train_step(self, x, y):
        """Forward, backward, the sums over ranks and the update of one
        step on the placed batch; returns the mean loss (0-d f32)."""
        o = self._optimizer
        self._block.train()
        with torch.enable_grad(), step_scope(self._mesh):
            out = self._call(x)
            loss = self._loss_of(out, y).float().mean()
            grads = torch.autograd.grad(loss, self._arrays,
                                        allow_unused=True)
        # a parameter the loss does not reach (BERT's pooler under an MLM
        # head) gets a zero gradient, as from jax.grad
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(self._arrays, grads)]
        loss = loss.detach()
        n = self._data.size
        if n > 1:
            grads = self._sum_grads(grads, loss.reshape(1), 1.0 / n)
            loss = grads.pop().reshape(())
        # the range names the update's kernels in a torch.profiler trace
        with torch.profiler.record_function("trainer.optimizer"):
            for i, (a, g, s) in enumerate(zip(self._arrays, grads,
                                              self._states)):
                o.update(i, a, g, s)
        return loss

    def _sum_grads(self, grads, loss, scale):
        """``grads`` each summed over its axis (`_grad_axes`), then
        ``loss`` over dp x fsdp, times ``scale``: one flat all-gather a
        (axis, dtype). Returns the gradients and the loss, in order."""
        tensors = list(grads) + [loss]
        axes = self._grad_axes + [DATA]
        out = [None] * len(tensors)
        for key in dict.fromkeys(axes):
            idx = [i for i, a in enumerate(axes) if a == key]
            ax = self._mesh.axis(key)
            parts = [tensors[i] for i in idx]
            parts = _bucket_sum(parts, ax, scale) if ax.size > 1 \
                else [t * scale for t in parts]
            for i, t in zip(idx, parts):
                out[i] = t
        return out

    def prefetch(self, it, depth=None):
        """``it`` wrapped in a `data.DevicePrefetcher` onto this rank's
        device, each batch cut to the rank's dp x fsdp rows: the copy of
        batch N+1 overlaps step N."""
        from ..data import DevicePrefetcher

        mesh = self._mesh if self._data.size > 1 else self._device
        return DevicePrefetcher(it, depth=depth, mesh=mesh, src="sharded")

    def forward(self, data, is_train=False):
        """Forward of the block over the trained values, in f32 without
        gradients, on the global batch (each rank computes its dp x fsdp
        rows and the rows are gathered); in training mode (``is_train``)
        BatchNorm uses batch statistics and advances its running
        statistics."""
        was = self._block.training
        self._block.train(is_train)
        saved, self._amp = self._amp, None
        try:
            with torch.no_grad(), step_scope(self._mesh):
                out = self._call(self._batch(data, cast=False))
        finally:
            self._amp = saved
            self._block.train(was)
        if self._data.size > 1:
            def gather(t):
                return torch.cat(coll._gather(t, self._data)) \
                    if torch.is_tensor(t) else t

            out = type(out)(gather(t) for t in out) \
                if isinstance(out, (list, tuple)) else gather(out)
        return out

    def sync_params(self):
        """Every rank's block up to date: each parameter split over ep, tp
        or fsdp is gathered into each rank's full tensor (the replicated
        parameters are the block's own, updated in place)."""
        with torch.no_grad():
            for i in self._sharded:
                self._params[i].copy_(gather_array(
                    self._arrays[i].detach(), self._mesh, self._specs[i]))
