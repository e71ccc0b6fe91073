"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
`mxnet_tpu/parallel/pipeline.py`): the GPipe schedule.

Each ``pp`` rank holds one stage's parameters. The batch is cut into
microbatches; at tick t stage i runs microbatch t - i, and its output (with
the microbatch's ``extras``, such as an attention mask) goes on to stage
i + 1 by `collectives.ppermute`, one point-to-point hop a tick. The last
stage's outputs are summed over the axis (every other rank adds zeros), so
every rank returns them. A stage skips the ticks where it holds no
microbatch (the JAX loop computes them on zeros and drops them).

Stages are shape-preserving in the activation. The backward is the
schedule reversed, written out (`_Pipeline`): at each tick every rank sends
the cotangent of the input it took at the next tick back one stage, by the
inverse hop, and runs its stage's backward for the microbatch it held, so
every rank makes the same collectives in the same order whatever its
graph holds. The input feeds stage 0 alone, so its gradient is summed over
the axis and every rank gets it, as the replicated input of the JAX
``shard_map`` does; the outputs' gradient passes through their sum (it is
replicated). ``remat=True`` keeps only each stage's inputs and runs the
stage again in the backward (`jax.checkpoint`'s trade).

Non-uniform models (embeddings in front, heads behind) are
`PipelineTrainer`'s (pipeline_trainer.py): the ends run replicated, only
the uniform layer stack is pipelined.
"""
from __future__ import annotations

import torch

from . import collectives as _coll
from .mesh import DATA, current_mesh

__all__ = ["pipeline_apply", "pipeline_stack_params"]


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def pipeline_stack_params(param_list):
    """Stack a list of per-stage trees (dicts / lists / tuples of tensors)
    into one tree with a leading stage axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *param_list)


class _Pipeline(torch.autograd.Function):
    """The GPipe loop on this rank and its reversed schedule. ``flat``: the
    stage's parameter leaves (``n_params``), then x and the extras, each an
    (M, mb, ...) stack."""

    @staticmethod
    def forward(ctx, run, ax, remat, n_params, *flat):
        params, xs = flat[:n_params], flat[n_params:]
        n, idx = ax.size, ax.index
        m = xs[0].shape[0]
        hop = [(i, i + 1) for i in range(n - 1)]
        state = tuple(torch.zeros_like(a[0]) for a in xs)
        saved = [None] * m
        outs = [None] * m
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        for t in range(m + n - 1):
            mb = t - idx          # the microbatch this stage holds at tick t
            inp = tuple(a[min(t, m - 1)] for a in xs) if idx == 0 else state
            if 0 <= mb < m:
                a0 = inp[0].detach().requires_grad_(True)
                rng = _rng_state(a0.device) if remat else None
                with torch.set_grad_enabled(not remat):
                    out = run(leaves, a0, *inp[1:])
                saved[mb] = (a0, inp[1:], None if remat else out, rng)
                out = out.detach()
                if idx == n - 1:
                    outs[mb] = out
            else:
                out = torch.zeros_like(inp[0])
            if n > 1 and t < m + n - 2:
                state = tuple(_coll._ppermute(a, ax, hop)
                              for a in (out,) + tuple(inp[1:]))
        res = torch.stack(outs) if idx == n - 1 else torch.zeros_like(xs[0])
        if n > 1:
            res = _coll._sum(res, ax)
        ctx.run, ctx.ax, ctx.remat, ctx.n_params = run, ax, remat, n_params
        ctx.saved, ctx.leaves, ctx.m = saved, leaves, m
        ctx.x_grad = xs[0].requires_grad
        return res

    @staticmethod
    def backward(ctx, g):
        ax, m, leaves = ctx.ax, ctx.m, ctx.leaves
        n, idx = ax.size, ax.index
        back = [(i + 1, i) for i in range(n - 1)]
        pgrads = [None] * len(leaves)
        dx = torch.zeros_like(g) if ctx.x_grad else None
        g_in = None          # the cotangent of the input of the next tick
        for t in reversed(range(m + n - 1)):
            mb = t - idx
            g_out = None
            if n > 1 and t < m + n - 2:
                send = g_in if g_in is not None else torch.zeros_like(g[0])
                g_out = _coll._ppermute(send, ax, back)
            if idx == n - 1 and 0 <= mb < m:
                g_out = g[mb]
            g_in = None
            if not 0 <= mb < m:
                continue
            a0, extras, out, rng = ctx.saved[mb]
            with torch.enable_grad():
                if out is None:
                    # the stage again, under the random state it first ran
                    # with (dropout draws the same masks)
                    with torch.random.fork_rng(
                            devices=[a0.device] if a0.is_cuda else []):
                        _set_rng_state(a0.device, rng)
                        out = ctx.run(leaves, a0, *extras)
                want = [a0] + [p for p in leaves if p.requires_grad]
                got = torch.autograd.grad(out, want, g_out,
                                          allow_unused=True)
            g_in = got[0]
            if idx == 0 and dx is not None:
                dx[mb] = g_in
            got = iter(got[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    d = next(got)
                    if d is not None:
                        # the microbatches' gradients added in f32
                        d = d.float()
                        pgrads[i] = d if pgrads[i] is None else pgrads[i] + d
            ctx.saved[mb] = None
        pgrads = [None if d is None else d.to(p.dtype)
                  for d, p in zip(pgrads, leaves)]
        if dx is not None and n > 1:
            dx = _coll._sum(dx, ax)
        return (None, None, None, None, *pgrads, dx) + \
            (None,) * (len(ctx.needs_input_grad) - 5 - len(leaves))


def _rng_state(dev):
    return (torch.get_rng_state(),
            torch.cuda.get_rng_state(dev) if dev.type == "cuda" else None)


def _set_rng_state(dev, state):
    torch.set_rng_state(state[0])
    if state[1] is not None:
        torch.cuda.set_rng_state(state[1], dev)


def pipeline_local(stage_fn, params, xs, ax, remat=False):
    """The GPipe loop on this rank: ``params`` this stage's tree, ``xs`` =
    (x, *extras), each an (M, mb, ...) microbatch stack (x the same on
    every rank; extras ride along untransformed), ``ax`` the ``pp``
    `_Axis`. Returns the (M, mb, ...) outputs of the last stage on every
    rank, differentiable in ``params`` and x."""
    leaves = _leaves(params)
    rebuild = _rebuilder(params)

    def run(flat, *a):
        return stage_fn(rebuild(flat), *a)

    # with no gradient to take, keep no graph: the stage inputs alone
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in leaves + [xs[0]])
    return _Pipeline.apply(run, ax, bool(remat) or not grad, len(leaves),
                           *leaves, *xs)


def _rebuilder(tree):
    """The function that puts a flat list of leaves back into ``tree``'s
    structure."""
    def build(t, it):
        if isinstance(t, dict):
            return {k: build(t[k], it) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x, it) for x in t)
        return next(it)

    return lambda flat: build(tree, iter(flat))


def pipeline_apply(stage_fn, stacked_params, x, num_microbatches=None,
                   axis_name="pp", mesh=None, extras=(), remat=False):
    """Run ``stage_fn(params_i, act, *extras) -> act`` as a ``pp``-deep
    pipeline.

    stacked_params : tree with a leading stage axis equal to the mesh's
        ``axis_name`` size (`pipeline_stack_params`); rank i runs stage i.
    x : (B, ...) global batch, the same on every rank; split into
        ``num_microbatches`` equal microbatches (default: the pipeline
        depth). With a dp / fsdp axis in the mesh each rank runs its rows
        of every microbatch and the rows are gathered back.
    extras : per-sample tensors (B, ...) that go with each microbatch
        untransformed (attention masks), over the same hops.
    remat : `torch.utils.checkpoint` on each stage.

    Returns the (B, ...) outputs, those of the stages applied in
    sequence."""
    mesh = mesh or current_mesh()
    n = mesh.shape[axis_name]
    lead = {leaf.shape[0] for leaf in _leaves(stacked_params)}
    if lead != {n}:
        raise ValueError(
            "stacked_params leading (stage) axis %s must equal the '%s' "
            "mesh axis size %d" % (sorted(lead), axis_name, n))
    b = x.shape[0]
    m = num_microbatches or n
    if b % m:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (b, m))
    ax = mesh.axis(axis_name)
    data = mesh.axis(DATA)
    params = _tree_map(lambda p: p[ax.index], stacked_params)

    def split(a):
        a = a.reshape((m, b // m) + tuple(a.shape[1:]))
        if data.size > 1:
            k = a.shape[1] // data.size
            a = a[:, data.index * k:(data.index + 1) * k]
        return a

    out = pipeline_local(stage_fn, params,
                         tuple(split(a) for a in (x,) + tuple(extras)), ax,
                         remat)
    if data.size > 1:
        from .sharding import _Unshard

        # the rows gathered feed what every rank computes alike: each rank
        # keeps its own rows' gradient
        out = _Unshard.apply(out, data, 1, False)
    return out.reshape((b,) + tuple(x.shape[1:]))
