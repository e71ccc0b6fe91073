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

Checkpoints, as the JAX package's trainer takes them:

* `save_states` / `load_states`: a pickle blob with the JAX keys
  ``states`` (the optimizer states as numpy leaves, in the JAX package's
  order: the trainable parameters sorted by their gluon names), ``step``
  and ``num_update``, so a blob of either package loads into the other
  where the optimizer's states have the same leaves;
* `save_checkpoint` / `load_checkpoint`: a ``step_%08d/`` directory of
  the port's own (the JAX package writes orbax, which the card's machine
  does not have): ``params``, the block's parameters and buffers by their
  module names in the ``nd.save`` container, and ``states``, the blob
  above. These two and the blob need whole tensors on this rank: at world
  size > 1 a parameter split over tp, fsdp or ep makes them raise;
* `shard_snapshot` / `save_sharded_checkpoint` /
  `restore_sharded_checkpoint`: the per-rank sharded format of
  `resilience.CheckpointManager`. A payload holds, for every parameter,
  buffer and state leaf, its global shape and this rank's block keyed by
  its (start, stop) range a dimension. The same world size and topology
  restore each rank's own blocks; another (an elastic resume) gathers each
  whole array from every shard and cuts this rank's block for the new
  mesh. `emergency_sharded_checkpoint` is the preemption path's solo save;
  it refuses (`MXNetError`) where this rank's blocks do not cover the
  model, a parameter split over ranks, so that no checkpoint that cannot
  be restored becomes the newest;
* `snapshot_params` / `snapshot_states`: host copies taken now, returned
  as `CheckpointManager.save_async` writers.

After each step the step-boundary fault hook runs
(`resilience.maybe_inject_fault`, one check unless ``MXTPU_FAULT_INJECT``
is set).
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .. import env as _env
from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError, atomic_writer
from . import collectives as coll
from .mesh import (DATA, DP, EP, FSDP, TP, Mesh, current_mesh, is_shard,
                   mesh_fingerprint, step_scope)
from .sharding import (ShardingRules, _coordinate, gather_array, shard_array,
                       unshard)

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
    def step_count(self):
        """The steps taken (restored by the checkpoint loaders)."""
        return self._step_count

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
        if _env.is_set("MXTPU_FAULT_INJECT"):
            from . import resilience

            resilience.maybe_inject_fault(self._step_count)
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

    # -- checkpoints -------------------------------------------------------
    def _whole(self, what):
        """Refuse ``what`` where this rank holds only a block of some
        parameter (world size > 1, a split over tp, fsdp or ep)."""
        if self._sharded and coll.num_workers() > 1:
            raise MXNetError(
                "DistributedTrainer.%s needs whole tensors on this rank; "
                "%s is split over the mesh: use save_sharded_checkpoint / "
                "restore_sharded_checkpoint" % (
                    what, self._param_names[self._sharded[0]]))

    def _state_order(self):
        """Indices of the trainable parameters in the JAX package's state
        order (sorted by gluon name)."""
        return sorted(range(len(self._params)),
                      key=lambda i: self._param_names[i])

    def _named_tensors(self):
        """Every parameter and floating buffer of the block by its module
        name: the live tensors a checkpoint holds (a parameter split over
        the mesh by this rank's block)."""
        out = {n: self._arrays[i] for i, n in enumerate(self._names)}
        for n, b in self._block.named_buffers():
            if b is not None and b.is_floating_point():
                out[n] = b
        return out

    def _states_blob(self):
        """The `save_states` blob: host copies of the states."""
        self._whole("save_states")
        return {"states": [_tree_map(_host, self._states[i])
                           for i in self._state_order()],
                "step": self._step_count,
                "num_update": self._optimizer.num_update}

    def snapshot_states(self):
        """Host copies of the optimizer states now, as a writer
        ``fn(fname)`` of the `save_states` file (for
        `CheckpointManager.save_async`)."""
        blob = self._states_blob()

        def write(fname):
            with atomic_writer(fname, "wb") as f:
                pickle.dump(blob, f)
        return write

    def save_states(self, fname):
        """The optimizer states, the step count and ``num_update`` as the
        JAX package's pickle blob, written atomically."""
        self.snapshot_states()(fname)

    def load_states(self, fname):
        """Restore a `save_states` file (either package's): the states are
        copied into the live ones, leaf by leaf."""
        self._whole("load_states")
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        loaded = blob["states"]
        order = self._state_order()
        if len(loaded) != len(order):
            raise MXNetError("states of %d parameters, this trainer has %d"
                             % (len(loaded), len(order)))
        with torch.no_grad():
            for i, st in zip(order, loaded):
                live, saved = _leaves(self._states[i]), _leaves(st)
                if len(live) != len(saved):
                    raise MXNetError(
                        "the states of %s have %d leaves in the file and %d "
                        "here (another optimizer or its multi_precision)"
                        % (self._param_names[i], len(saved), len(live)))
                for t, a in zip(live, saved):
                    t.copy_(torch.as_tensor(np.asarray(a)).to(t.device))
        self._set_cursor(blob["step"], blob["num_update"])

    def _set_cursor(self, step, num_update):
        """The step count and the optimizer's update counts of ``step``
        steps (every parameter is updated once a step)."""
        o = self._optimizer
        self._step_count = int(step)
        o.num_update = int(num_update)
        o._index_update_count = {
            i: o.begin_num_update + self._step_count
            for i in range(len(self._arrays))} if self._step_count else {}

    def snapshot_params(self):
        """Host copies of the block's parameters and floating buffers now,
        as a writer ``fn(fname)`` of the ``nd.save`` container by module
        name (for `CheckpointManager.save_async`)."""
        self._whole("save_params")
        from ..ndarray import ndarray as _nd

        host = {n: _host(t) for n, t in self._named_tensors().items()}
        host = {n: _nd.NDArray(a) if torch.is_tensor(a) else a
                for n, a in host.items()}
        return lambda fname: _nd.save(fname, host)

    def save_params(self, fname):
        """The block's parameters and floating buffers by module name, in
        the ``nd.save`` container."""
        self.snapshot_params()(fname)

    def load_params(self, fname):
        """Copy a `save_params` file into the live tensors."""
        self._whole("load_params")
        from ..context import cpu
        from ..ndarray import ndarray as _nd

        loaded = _nd.load(fname, ctx=cpu())
        live = self._named_tensors()
        missing = sorted(set(live) - set(loaded))
        if missing:
            raise MXNetError("%s lacks %s" % (fname, missing[:5]))
        with torch.no_grad():
            for n, t in live.items():
                t.copy_(loaded[n]._data.to(t.device))

    def save_checkpoint(self, directory, step=0):
        """``<directory>/step_%08d/`` with ``params`` (`save_params`) and
        ``states`` (`save_states`): the port's own layout, where the JAX
        package writes an orbax tree."""
        path = os.path.join(os.path.abspath(os.fspath(directory)),
                            "step_%08d" % step)
        os.makedirs(path, exist_ok=True)
        self.save_params(os.path.join(path, "params"))
        self.save_states(os.path.join(path, "states"))

    def load_checkpoint(self, directory, step=0):
        """Restore a `save_checkpoint` directory."""
        path = os.path.join(os.path.abspath(os.fspath(directory)),
                            "step_%08d" % step)
        self.load_params(os.path.join(path, "params"))
        self.load_states(os.path.join(path, "states"))

    # -- per-rank sharded checkpoints (the resilience format) --------------
    def _block_key(self, i, shape):
        """The (start, stop) range a dimension of this rank's block of
        parameter ``i`` (or of a state leaf of its shape) within the whole
        tensor, and the whole tensor's shape."""
        spec = self._specs[i] if i in self._sharded else ()
        key, full = [], []
        for d, n in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            index, size = (0, 1) if entry is None \
                else _coordinate(self._mesh, entry)
            key.append((index * n, (index + 1) * n))
            full.append(n * size)
        return tuple(key), tuple(full)

    def _entry(self, t, i=None):
        key, full = self._block_key(i, tuple(t.shape)) if i is not None \
            and tuple(t.shape) == tuple(self._arrays[i].shape) \
            else (tuple((0, n) for n in t.shape), tuple(t.shape))
        return {"shape": full, "dtype": str(t.dtype).replace("torch.", ""),
                "pieces": [(key, _host(t))]}

    def shard_snapshot(self):
        """Host copies of this rank's blocks of every parameter, floating
        buffer and state leaf (the async sharded checkpoint's payload; the
        only cost the training thread pays)."""
        index = {n: i for i, n in enumerate(self._names)}
        return {
            "params": {n: self._entry(t, index.get(n))
                       for n, t in self._named_tensors().items()},
            "states": [[self._entry(leaf, i)
                        for leaf in _leaves(self._states[i])]
                       for i in range(len(self._states))],
            "step": self._step_count,
            "num_update": self._optimizer.num_update,
        }

    def _install_shard_payloads(self, payloads, header):
        """The `CheckpointManager.restore_sharded` loader: the parameters,
        buffers, states and cursors from shard payloads. A block this rank
        holds is taken as saved where a payload has it (the fast path);
        else the whole array is put together from every shard's blocks
        (coverage checked) and this rank's block cut from it, for the new
        mesh."""
        plist = [payloads[r] for r in sorted(payloads)]

        def install(t, entries, i, what):
            shape = tuple(entries[0]["shape"])
            pieces = {}
            for e in entries:
                if tuple(e["shape"]) != shape:
                    raise MXNetError(
                        "sharded checkpoint: %s changed shape (saved %r, a "
                        "shard says %r)" % (what, shape, tuple(e["shape"])))
                for key, data in e["pieces"]:
                    pieces[tuple(tuple(p) for p in key)] = data
            want = self._block_key(i, tuple(t.shape))[0] if i is not None \
                and tuple(t.shape) == tuple(self._arrays[i].shape) \
                else tuple((0, n) for n in t.shape)
            data = pieces.get(want)
            if data is None:
                # bf16 blocks put together in f32 (exact both ways)
                pieces = {k: v.float().numpy() if torch.is_tensor(v) else v
                          for k, v in pieces.items()}
                out = np.zeros(shape, pieces[next(iter(pieces))].dtype)
                cover = np.zeros(shape, bool)
                for key, part in pieces.items():
                    slc = tuple(slice(a, b) for a, b in key)
                    out[slc] = part
                    cover[slc] = True
                if not cover.all():
                    raise MXNetError(
                        "sharded checkpoint: the shard set does not cover "
                        "%s — an elastic resume needs every saved rank's "
                        "shard" % what)
                data = out[tuple(slice(a, b) for a, b in want)]
            t.copy_(_from_host(data, t))

        index = {n: i for i, n in enumerate(self._names)}
        with torch.no_grad():
            for n, t in self._named_tensors().items():
                entries = [p["params"].get(n) for p in plist]
                if any(e is None for e in entries):
                    raise MXNetError(
                        "sharded checkpoint: parameter %r missing from a "
                        "shard — the checkpoint was saved for a different "
                        "model" % n)
                install(t, entries, index.get(n), "param %r" % n)
            for k, st in enumerate(self._states):
                live = _leaves(st)
                per = [p["states"][k] for p in plist]
                if any(len(pp) != len(live) for pp in per):
                    raise MXNetError(
                        "sharded checkpoint: optimizer state %d leaf count "
                        "mismatch — saved with a different optimizer" % k)
                for j, leaf in enumerate(live):
                    install(leaf, [pp[j] for pp in per], k,
                            "state[%d][%d]" % (k, j))
        self._set_cursor(plist[0]["step"], plist[0]["num_update"])

    def _shard_identity(self):
        return coll.rank(), coll.num_workers(), mesh_fingerprint(self._mesh)

    def save_sharded_checkpoint(self, manager, step=None, meta=None):
        """This rank's shard of a sharded checkpoint through ``manager``
        (a `resilience.CheckpointManager`): the snapshot on this thread,
        the write and rank 0's manifest on the manager's background
        writer (``MXTPU_CKPT_ASYNC``). Every rank calls it at the same
        step boundary."""
        rank, world, topology = self._shard_identity()
        return manager.save_sharded_async(
            self._step_count if step is None else step,
            self.shard_snapshot(), rank=rank, world_size=world,
            topology=topology, meta=meta)

    def emergency_sharded_checkpoint(self, manager, meta=None):
        """The preemption path's solo synchronous checkpoint: flush the
        manager's async writer, then publish this rank's snapshot as a
        one-shard manifest (rank 0 of world 1), with no help from the other
        ranks (only this one was notified; the others may be waiting in a
        collective). Raises `MXNetError`, after the flush, where this rank's
        blocks do not cover the model (a parameter split over ranks): the
        group then resumes from its last periodic sharded checkpoint."""
        _, world, topology = self._shard_identity()
        manager.flush()
        if world > 1 and self._sharded:
            raise MXNetError(
                "emergency_sharded_checkpoint: %s is split over the mesh, so "
                "this rank's shard alone cannot restore the model; resume "
                "from the last sharded checkpoint of every rank"
                % self._param_names[self._sharded[0]])
        m = dict(meta or {})
        m.setdefault("preempt", True)
        return manager.save_sharded(
            self._step_count, self.shard_snapshot(), rank=0, world_size=1,
            topology=topology, meta=m)

    def restore_sharded_checkpoint(self, manager, step=None):
        """Restore the newest complete sharded checkpoint (or ``step``)
        onto this mesh, resharding when the saved world size or topology
        differs. Returns the manifest, or None when there is none."""
        rank, world, topology = self._shard_identity()
        return manager.restore_sharded(
            self._install_shard_payloads, step=step, rank=rank,
            world_size=world, topology=topology)


def _host(t):
    """A host copy of a tensor: numpy, or a CPU tensor for bf16, which
    numpy has no type for."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _from_host(a, like):
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=like.device, dtype=like.dtype)


def _leaves(st):
    """The tensors of an optimizer state (None, a tensor, or nested
    tuples and lists of them), in order."""
    if st is None:
        return []
    if isinstance(st, (list, tuple)):
        return [t for s in st for t in _leaves(s)]
    return [st._data if hasattr(st, "_data") else st]


def _tree_map(fn, st):
    if st is None:
        return None
    if isinstance(st, (list, tuple)):
        return type(st)(_tree_map(fn, s) for s in st)
    return fn(st._data if hasattr(st, "_data") else st)
