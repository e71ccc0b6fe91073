"""PipelineTrainer: pipeline-parallel training of Gluon models (counterpart
of `mxnet_tpu/parallel/pipeline_trainer.py`).

`pipeline.py` runs uniform stages; this trainer runs a real model, the
BERT encoder stack among them:

* the ends: the embedding front (``prelude``) and the pooler / head
  (``postlude``) run replicated on every ``pp`` rank outside the loop;
  only the uniform stack of cells is pipelined;
* the cells (``pipeline_stages()``'s, or the ``cells`` argument) must be
  homogeneous (the same parameter names, shapes and dtypes) and divide by
  ``pp``; rank i holds the parameters of cells [i c, (i+1) c) (c = cells
  / pp) stacked as (c, ...) tensors, and their optimizer states; the first
  cell is the template each layer runs through
  (`torch.func.functional_call` over that layer's slices);
  `sync_params` gathers the stacks over ``pp`` back into every cell;
* ``num_microbatches`` sets the schedule (the bubble is (pp - 1) / (m +
  pp - 1)); ``remat`` keeps only stage inputs; ``amp_dtype`` (bfloat16)
  casts the parameters and the data inside the graph, over f32 masters,
  as `DistributedTrainer` does;
* a ``dp`` (x ``fsdp``) axis composes: each rank takes its rows of the
  global batch, and the gradients and the loss are summed over them in
  rank order and divided by their count (the ranks of one ``pp`` group
  compute the same ends and the same loss: nothing is summed over
  ``pp``).

Masks (BERT's ``valid_length``) go with their microbatch as pipeline
extras. At world size 1 a step makes no collective and no host sync.

    mesh = make_mesh([("pp", 4)])
    trainer = PipelineTrainer(model, "adam", {"learning_rate": 1e-4},
                              loss=L2Loss(), mesh=mesh)
    loss = trainer.step(tokens, labels)
"""
from __future__ import annotations

import time

import torch

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError
from . import collectives as coll
from .mesh import DATA, PP, current_mesh
from .pipeline import pipeline_local
from .trainer import _amp_dtype, _bucket_sum, broadcast_from_rank0

__all__ = ["PipelineTrainer"]


class _Ends(torch.nn.Module):
    """Runs ``fn`` with ``block`` as a child, so that
    `torch.func.functional_call` can put other values in place of the
    block's parameters for the call."""

    def __init__(self, block):
        super().__init__()
        self.block = block
        self.fn = None

    def forward(self, *args):
        return self.fn(*args)


class PipelineTrainer:
    """Pipeline-parallel training over the ``pp`` mesh axis.

    block : an initialized Block with ``pipeline_stages() -> (prelude,
        cells, postlude)`` (`BERTModel.pipeline_stages`), or any Block with
        ``cells`` / ``prelude`` / ``postlude`` given.
    loss : callable(pred, label) -> per-sample loss (a gluon loss Block).
    prelude : callable(*inputs) -> activation, or (activation, mask);
        default the identity on one input. postlude : callable(activation)
        -> prediction (or a tuple whose first element is it).
    mesh : a mesh with a ``pp`` axis (default `current_mesh()`), over the
        whole process group.
    num_microbatches : default the pipeline depth. remat, amp_dtype: see
        the module docstring."""

    def __init__(self, block, optimizer, optimizer_params=None, loss=None,
                 cells=None, prelude=None, postlude=None, mesh=None,
                 axis_name=PP, num_microbatches=None, remat=False,
                 amp_dtype=None):
        self._block = block
        self._mesh = mesh = mesh or current_mesh()
        if axis_name not in mesh.shape:
            raise MXNetError("mesh has no '%s' axis (axes: %s)"
                             % (axis_name, tuple(mesh.shape)))
        world = coll.num_workers()
        if mesh.size != world:
            raise MXNetError("PipelineTrainer: a mesh of %d devices over a "
                             "world of %d processes (one device a process)"
                             % (mesh.size, world))
        self._ax = mesh.axis(axis_name)
        self._data = mesh.axis(DATA)
        self._pp = mesh.shape[axis_name]
        self._loss = loss
        self._amp = _amp_dtype(amp_dtype)
        self._remat = bool(remat)
        self._num_microbatches = num_microbatches
        if cells is None or prelude is None or postlude is None:
            if not hasattr(block, "pipeline_stages"):
                raise MXNetError(
                    "block does not implement pipeline_stages(); pass "
                    "cells=/prelude=/postlude= explicitly")
            d_pre, d_cells, d_post = block.pipeline_stages()
            cells = cells if cells is not None else d_cells
            prelude = prelude if prelude is not None else d_pre
            postlude = postlude if postlude is not None else d_post
        self._cells = list(cells)
        self._prelude = prelude or (lambda x: x)
        self._postlude = postlude or (lambda x: x)
        if len(self._cells) % self._pp:
            raise MXNetError("%d cells not divisible into %d pipeline "
                             "stages" % (len(self._cells), self._pp))
        self._cps = len(self._cells) // self._pp

        def signature(cell):
            return [(n, tuple(p.shape), p.dtype, p.requires_grad)
                    for n, p in sorted(cell.named_parameters())]

        sigs = [signature(c) for c in self._cells]
        if any(s != sigs[0] for s in sigs[1:]):
            raise MXNetError(
                "pipeline cells are not homogeneous (same local param "
                "names/shapes/dtypes required): %s vs %s"
                % (sigs[0], next(s for s in sigs if s != sigs[0])))
        if any(not req for _, _, _, req in sigs[0]) \
                or any(True for c in self._cells for _ in c.buffers()):
            raise MXNetError("pipeline cells with aux (grad_req='null') "
                             "state are not supported — running stats "
                             "cannot be carried through the stage loop")
        params = sorted(block.named_parameters())
        if not params:
            raise MXNetError("block has no parameters; initialize() it "
                             "first")
        self._device = params[0][1].device
        if world > 1:
            broadcast_from_rank0(block, [p for _, p in params], self._device)
        self._cell_names = [n for n, _ in sorted(
            self._cells[0].named_parameters())]
        in_cells = {id(p) for c in self._cells for p in c.parameters()}
        outer = [(n, p) for n, p in params
                 if id(p) not in in_cells and p.requires_grad]
        self._outer_names = ["block." + n for n, _ in outer]
        self._outer = [p for _, p in outer]
        # this rank's stage: cells [i c, (i+1) c), each parameter stacked
        lo = self._ax.index * self._cps
        mine = self._cells[lo:lo + self._cps]
        self._leaves = []
        with torch.no_grad():
            for j in range(len(self._cell_names)):
                stack = torch.stack([sorted(c.named_parameters())[j][1]
                                     for c in mine])
                self._leaves.append(stack.clone().requires_grad_(True))
        self._ends = _Ends(block)
        opt = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer, **(optimizer_params or {}))
        self._optimizer = opt
        self._arrays = self._outer + self._leaves
        self._states = [opt.create_state(i, a)
                        for i, a in enumerate(self._arrays)]
        self._step_count = 0
        self._counted = None   # the step, FLOP-counted once a signature

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def mesh(self):
        return self._mesh

    def _rows(self, a, cast):
        """``a`` on the device: this rank's dp x fsdp rows of the global
        batch, floating data in the compute dtype when ``cast``."""
        from ..ndarray import NDArray

        if isinstance(a, NDArray):
            a = a._data
        t = torch.as_tensor(a)
        ax = self._data
        if ax.size > 1:
            if t.shape[0] % ax.size:
                raise MXNetError("PipelineTrainer: a global batch of %d rows "
                                 "does not split over dp x fsdp=%d"
                                 % (t.shape[0], ax.size))
            n = t.shape[0] // ax.size
            t = t[ax.index * n:(ax.index + 1) * n]
        t = t.to(self._device, non_blocking=True)
        if cast and self._amp is not None and t.is_floating_point():
            t = t.to(self._amp)
        return t

    def _stage(self, leaves, act, *extras):
        """This rank's stage: its cells in order, each the template cell
        over that layer's slices."""
        cell = self._cells[0]
        for li in range(self._cps):
            values = {n: leaf[li] for n, leaf in zip(self._cell_names,
                                                     leaves)}
            act = torch.func.functional_call(cell, values, (act,) + extras)
        return act

    def _ends_call(self, fn, *args):
        """``fn`` (prelude or postlude) over the trained values of the
        block's parameters (cast to the compute dtype)."""
        if self._amp is None:
            return fn(*args)
        self._ends.fn = fn
        try:
            return torch.func.functional_call(
                self._ends, {n: p.to(self._amp) for n, p in
                             zip(self._outer_names, self._outer)}, args)
        finally:
            self._ends.fn = None

    def _run(self, inputs, remat):
        """prelude -> the pipelined stack -> postlude on this rank's rows;
        returns the prediction."""
        pre = self._ends_call(self._prelude, *inputs)
        act, mask = (pre[0], pre[1]) if isinstance(pre, (tuple, list)) \
            else (pre, None)
        b = act.shape[0]
        m = self._num_microbatches or self._pp
        if b % m:
            raise MXNetError("batch %d not divisible into %d microbatches"
                             % (b, m))

        def split(a):
            return a.reshape((m, b // m) + tuple(a.shape[1:]))

        xs = (split(act),) + (() if mask is None else (split(mask),))
        leaves = self._leaves if self._amp is None \
            else [leaf.to(self._amp) for leaf in self._leaves]
        out = pipeline_local(self._stage, leaves, xs, self._ax, remat)
        pred = self._ends_call(self._postlude,
                               out.reshape((b,) + tuple(out.shape[2:])))
        return pred[0] if isinstance(pred, (list, tuple)) else pred

    def step(self, *batch):
        """One pipelined training step over (inputs..., label); returns the
        global batch's mean loss as an `NDArray` of a 0-d f32 tensor on
        the device (no host sync). Instrumented as `DistributedTrainer.step`
        is, with goodput kind "pipeline" and no trace root, as in the JAX
        package."""
        from ..ndarray import NDArray

        t0 = time.perf_counter()
        telemetry.goodput.step_start(kind="pipeline", t0=t0)
        if self._loss is not None and len(batch) < 2:
            raise MXNetError("step(*inputs, label) needs a label for the "
                             "configured loss")
        with telemetry.goodput.phase("data_wait"):
            inputs = batch[:-1] if self._loss is not None else batch
            inputs = [self._rows(a, cast=True) for a in inputs]
            label = self._rows(batch[-1], cast=False) \
                if self._loss is not None else None
        self._step_count += 1
        o = self._optimizer
        o.num_update = max(self._step_count + o.begin_num_update,
                           o.num_update)
        if self._counted is None:
            self._counted = telemetry.flops.instrument(self._train_step)
        telemetry.goodput.mark_launch()
        with telemetry.goodput.phase("compute"):
            loss = self._counted(inputs, label)
        telemetry.observe_step(time.perf_counter() - t0,
                               examples=int(inputs[0].shape[0])
                               * self._data.size,
                               step=self._step_count, kind="pipeline")
        telemetry.goodput.step_end(step=self._step_count)
        return NDArray(loss)

    def _train_step(self, inputs, label):
        """Forward, backward, the sums over dp and the update of one step
        on the placed rows; returns the mean loss (0-d f32)."""
        o = self._optimizer
        self._block.train()
        with torch.enable_grad():
            pred = self._run(inputs, self._remat)
            loss = pred if self._loss is None else self._loss(pred, label)
            loss = loss.float().mean()
            grads = torch.autograd.grad(loss, self._arrays,
                                        allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(self._arrays, grads)]
        loss = loss.detach()
        n = self._data.size
        if n > 1:
            *grads, loss = _bucket_sum(grads + [loss.reshape(1)], self._data,
                                       1.0 / n)
            loss = loss.reshape(())
        with torch.profiler.record_function("trainer.optimizer"):
            for i, (a, g, s) in enumerate(zip(self._arrays, grads,
                                              self._states)):
                o.update(i, a, g, s)
        return loss

    def forward(self, *batch, is_train=False):
        """The pipelined forward in f32 without gradients on the global
        batch (each rank computes its rows, and the rows are gathered);
        returns the prediction as an `NDArray`."""
        from ..ndarray import NDArray

        was = self._block.training
        self._block.train(is_train)
        saved, self._amp = self._amp, None
        try:
            with torch.no_grad():
                out = self._run([self._rows(a, cast=False) for a in batch],
                                False)
        finally:
            self._amp = saved
            self._block.train(was)
        if self._data.size > 1:
            out = torch.cat(coll._gather(out.contiguous(), self._data))
        return NDArray(out)

    def sync_params(self):
        """Every cell's parameters from the stacks, gathered over ``pp``
        (the ends are the block's own parameters, updated in place)."""
        with torch.no_grad():
            for j, leaf in enumerate(self._leaves):
                full = torch.cat(coll._gather(leaf.detach(), self._ax))
                for c, cell in enumerate(self._cells):
                    sorted(cell.named_parameters())[j][1].copy_(full[c])
