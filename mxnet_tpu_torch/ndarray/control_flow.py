"""Control-flow operators on ``mx.nd.contrib``: foreach, while_loop, cond
(counterpart of `mxnet_tpu/ndarray/control_flow.py`; reference:
python/mxnet/ndarray/contrib.py, src/operator/control_flow.cc).

They run eagerly, as the reference's imperative front does: Python loops
over NDArrays, each op of the body an ``mx.nd`` call, so under
``autograd.record()`` every step lands on the tape and ``backward`` needs
nothing more. The JAX package lowers traced calls to ``lax.scan`` /
``lax.cond``; the port has no traced mode (``hybridize`` stays eager).
"""
from __future__ import annotations

from ..base import MXNetError
from .ndarray import NDArray, concat, stack, zeros

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    if x is None:
        return [], True
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _restore(lst, single):
    return lst[0] if single else list(lst)


def _truth(pred):
    return bool(pred.asnumpy().reshape(()).item()) \
        if isinstance(pred, NDArray) else bool(pred)


def foreach(body, data, init_states):
    """Iterate ``body`` over data's first axis, carrying states:
    ``body(data_slice, states) -> (outputs, new_states)``. Returns
    (outputs stacked on a new first axis, final states)."""
    data_list, data_single = _as_list(data)
    states, states_single = _as_list(init_states)
    if not data_list:
        raise MXNetError("foreach: data must be a non-empty NDArray or list")
    length = data_list[0].shape[0]
    if length == 0:
        raise MXNetError("foreach: data has zero-length axis 0, so the "
                         "outputs would be undefined (the reference raises "
                         "too)")
    if any(d.shape[0] != length for d in data_list):
        raise MXNetError("foreach: all data inputs need equal axis-0 length")
    outputs, single_out = None, True
    for i in range(length):
        slices = _restore([d[i] for d in data_list], data_single)
        outs, new_states = body(slices, _restore(states, states_single))
        states, _ = _as_list(new_states)
        outs_l, single_out = _as_list(outs)
        if outputs is None:
            outputs = [[] for _ in outs_l]
        for buf, o in zip(outputs, outs_l):
            buf.append(o)
    stacked = [stack(*buf, axis=0) for buf in outputs]
    return _restore(stacked, single_out), _restore(states, states_single)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func`` while ``cond(*loop_vars)`` holds, at most
    ``max_iterations`` times: ``func(*loop_vars) -> (outputs,
    new_loop_vars)``. Returns (outputs stacked and zero-padded to
    ``max_iterations`` rows, final loop vars), the reference's padding
    contract."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (as in the "
                         "reference)")
    loop_vars, vars_single = _as_list(loop_vars)
    if not loop_vars:
        raise MXNetError("while_loop: loop_vars must be non-empty")
    outputs, single_out, steps = None, True, 0
    while steps < max_iterations and _truth(cond(*loop_vars)):
        outs, new_vars = func(*loop_vars)
        loop_vars, _ = _as_list(new_vars)
        outs_l, single_out = _as_list(outs)
        if outputs is None:
            outputs = [[] for _ in outs_l]
        for buf, o in zip(outputs, outs_l):
            buf.append(o)
        steps += 1
    if outputs is None:
        raise MXNetError("while_loop: cond was false on entry, so the "
                         "outputs are undefined (the reference raises too)")
    stacked = []
    for buf in outputs:
        s = stack(*buf, axis=0)
        if steps < max_iterations:
            pad = zeros((max_iterations - steps,) + tuple(s.shape[1:]),
                        ctx=s.context, dtype=s.dtype)
            s = concat(s, pad, dim=0)
        stacked.append(s)
    return _restore(stacked, single_out), _restore(loop_vars, vars_single)


def cond(pred, then_func, else_func):
    """``then_func()`` if the scalar ``pred`` holds, else ``else_func()``
    (closures without arguments, as in the reference)."""
    return then_func() if _truth(pred) else else_func()
