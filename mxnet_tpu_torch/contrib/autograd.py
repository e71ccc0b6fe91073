"""Legacy contrib autograd API (counterpart of
`mxnet_tpu/contrib/autograd.py`; reference: python/mxnet/contrib/autograd.py
— the deprecated precursor of mx.autograd; reference scripts from the era
import these names). Thin adapters over the port's tape."""
from __future__ import annotations

import functools

from .. import autograd as _ag

__all__ = ["set_is_training", "TrainingStateScope", "train_section",
           "test_section", "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


class _PrevState(tuple):
    """Restore token returned by set_is_training. Truth-tests like the
    reference's previous-bool return (legacy code branches on the result),
    while carrying (recording, training) as a pair so the
    `set_is_training(prev)` round-trip restores a diverged
    train_mode()/pause() scope exactly."""

    __slots__ = ()

    def __bool__(self):
        return bool(self[0] or self[1])


def set_is_training(is_train):
    """reference: contrib/autograd.py:32 — returns the previous state.
    The legacy flag conflated recording with train mode; here both flags
    follow, and the returned value is a bool-compatible restore token
    capturing them as a pair."""
    if isinstance(is_train, tuple):
        rec, train = is_train
    else:
        rec = train = bool(is_train)
    return _PrevState((_ag.set_recording(rec), _ag.set_training(train)))


class TrainingStateScope:
    """reference: contrib/autograd.py:54. The legacy API had one flag;
    the modern tape has two (recording, training) that can diverge, so the
    scope saves and restores them as a pair — feeding one flag's previous
    value into both would corrupt an enclosing train_mode()/pause()."""

    def __init__(self, enter_state):
        self._enter_state = enter_state

    def __enter__(self):
        self._prev_rec = _ag.set_recording(self._enter_state)
        self._prev_train = _ag.set_training(self._enter_state)

    def __exit__(self, *exc):
        _ag.set_recording(self._prev_rec)
        _ag.set_training(self._prev_train)


def train_section():
    """reference: contrib/autograd.py:74."""
    return TrainingStateScope(True)


def test_section():
    """reference: contrib/autograd.py:88."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """reference: contrib/autograd.py:102."""
    _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    """reference: contrib/autograd.py:123."""
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    """reference: contrib/autograd.py:158."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """reference: contrib/autograd.py:163 — returns a function computing
    both gradient wrt the (selected) args and the loss."""
    from ..ndarray import ndarray as _nd

    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for v in variables:
            if not isinstance(v, _nd.NDArray):
                raise TypeError("type %s not supported" % type(v))
        grads = [_nd.zeros(v.shape, ctx=v.context, dtype=str(v.dtype))
                 for v in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        compute_gradient([outputs] if isinstance(outputs, _nd.NDArray)
                         else outputs)
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    """reference: contrib/autograd.py:195."""
    gl = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def wrapped(*args):
        return gl(*args)[0]

    return wrapped
