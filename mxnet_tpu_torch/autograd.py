"""Autograd: the imperative gradient tape, over `torch.autograd`.

Counterpart of `mxnet_tpu/autograd.py` (reference: python/mxnet/autograd.py
and src/imperative/imperative.cc). The JAX package keeps its own tape of
(op, inputs, outputs) and replays a `jax.vjp` of each op backwards; here the
tape is torch's own graph:

- Recording is torch grad mode for calls of the façade (`mx.nd` ops,
  NDArray indexing and views, and Blocks called with NDArrays): each runs
  with grad mode on inside `record()` and off outside it. So a Block
  called outside `record()` builds no graph, and the word LM's LSTM
  layers take the inference kernel there. Tensor-in, tensor-out calls of
  `torch.nn.Module`s keep torch's own grad mode.
- A variable (`mark_variables`, `NDArray.attach_grad`, a gluon
  `Parameter`) is a leaf tensor that requires grad, paired with a gradient
  buffer of its own and a ``grad_req``. `backward` takes
  `torch.autograd.grad` of the heads with respect to every live variable
  (a weak registry) and writes (``write``) or adds (``add``) each
  gradient into the variable's buffer, in place, so a ``grad`` array
  taken before the call sees the new values. A row_sparse buffer
  (`NDArray.attach_grad` with ``stype="row_sparse"``, or one given to
  `mark_variables`) gets the dense gradient cast to row_sparse (summed
  with its earlier value first under ``add``), its components replaced in
  the same object. A variable the heads do not
  reach keeps its old gradient and its stale flag (``_fresh_grad``), which
  `gluon.Trainer` checks.
- A head that is not a scalar gets ones as its head gradient, as in MXNet.
- `Function` is a `torch.autograd.Function` whose forward and backward are
  the user's, on NDArrays.
- `is_training` is the mode of Dropout and BatchNorm in façade calls:
  `record()` trains unless told otherwise, `predict_mode()` does not.

The recording and training flags are per thread, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "set_recording", "set_training"]

_state = threading.local()
# every array marked as a variable and still alive (gluon Parameters' arrays
# included), by id: the candidates `backward` differentiates against. Not a
# WeakSet: that compares arrays with ==, which is elementwise on NDArrays
_VARIABLES = {}


def _register(v):
    key = id(v)
    if key in _VARIABLES and _VARIABLES[key]() is v:
        return

    def forget(ref, key=key):
        if _VARIABLES.get(key) is ref:
            del _VARIABLES[key]

    _VARIABLES[key] = weakref.ref(v, forget)


def _variables():
    return [v for v in (r() for r in list(_VARIABLES.values()))
            if v is not None]


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.facade = 0   # depth of façade Block calls on this thread
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous one (reference:
    MXAutogradSetIsRecording)."""
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train_mode_):
    st = _st()
    prev, st.training = st.training, bool(train_mode_)
    return prev


@contextlib.contextmanager
def _scope(recording=None, training=None):
    st = _st()
    prev_r, prev_t = st.recording, st.training
    if recording is not None:
        st.recording = recording
    if training is not None:
        st.training = training
    try:
        yield
    finally:
        st.recording, st.training = prev_r, prev_t


def record(train_mode=True):
    """Scope: record façade calls for autograd (reference:
    autograd.py:122)."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Scope: stop recording (reference: autograd.py:141)."""
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def _grad_mode():
    """torch grad mode of one façade call: on while recording."""
    return torch.set_grad_enabled(_st().recording)


@contextlib.contextmanager
def _facade():
    """Scope of one façade Block call: torch grad mode follows recording,
    and `layer_training` answers `is_training` for every layer inside,
    whatever its own ``training`` flag."""
    st = _st()
    st.facade += 1
    try:
        with torch.set_grad_enabled(st.recording):
            yield
    finally:
        st.facade -= 1


def layer_training(module):
    """Whether ``module`` (Dropout, BatchNorm, a recurrent layer) runs in
    training mode: `is_training` inside a façade call, else the module's own
    ``training`` flag (``train()`` / ``eval()``, the tensor path)."""
    st = _st()
    return st.training if st.facade else module.training


def mark_variables(variables, gradients, grad_reqs="write"):
    """Pair each array with a gradient buffer and a ``grad_req`` (reference:
    autograd.py:197); a None buffer is made at the first backward that
    reaches the array. The array's tensor becomes a leaf that requires grad
    (a new leaf over the same storage when it was part of a graph)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, not %r"
                             % (req,))
        v._grad, v._grad_req, v._fresh_grad = g, req, False
        t = v._data
        if req == "null":
            continue
        if not (t.is_floating_point() or t.is_complex()):
            raise MXNetError("an array of %s has no gradient" % t.dtype)
        if not (t.is_leaf and t.requires_grad):
            v._data = t.detach().requires_grad_(True)
        _register(v)


def _zeros_like(t):
    from .ndarray.ndarray import NDArray

    return NDArray(torch.zeros_like(
        t, memory_format=torch.contiguous_format).detach())


def _leaves(v):
    """The tensors a variable has been bound to that a live graph may hold:
    its current one, and earlier ones that a write replaced while a graph
    kept them (`NDArray._write`)."""
    out = [v._data] if v._data.requires_grad else []
    if v._leaves:
        v._leaves = [r for r in v._leaves if r() is not None]
        out += [r() for r in v._leaves]
    return out


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise MXNetError("%d heads but %d head gradients"
                         % (len(heads), len(head_grads)))
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue   # not recorded: nothing flows from this head
        if hg is None:
            seed = torch.ones_like(t)
        else:
            seed = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
            seed = seed.to(t.device, t.dtype).expand(t.shape)
        outs.append(t)
        seeds.append(seed)
    return outs, seeds


def _differentiate(outs, seeds, leaves, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(outs, leaves, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError(
                "backward reached part of the graph that a previous backward "
                "freed. Use retain_graph=True on the earlier backward, or "
                "call autograd.backward([...]) once with all heads") from e
        raise


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to every variable, written into
    the variables' buffers by their ``grad_req`` (reference:
    autograd.py:243). While the profiler runs, each recorded op's node
    records one ``_backward_<op>`` event as torch's engine runs it (the
    hooks `profiler.hook_backward` put on it at record time)."""
    outs, seeds = _heads(heads, head_grads)
    if not outs:
        return
    owners, leaves = [], []
    for v in _variables():
        if v._grad_req == "null":
            continue
        for t in _leaves(v):
            owners.append(v)
            leaves.append(t)
    if not leaves:
        return
    grads = _differentiate(outs, seeds, leaves, retain_graph)
    totals = {}
    for v, g in zip(owners, grads):
        if g is not None:
            prev = totals.get(id(v))
            totals[id(v)] = (v, g if prev is None else prev[1] + g)
    with torch.no_grad():
        for v, g in totals.values():
            if v._grad is None:   # a Parameter's, made at first use
                v._grad = _zeros_like(v._data)
            if v._grad.stype == "row_sparse":
                _write_row_sparse(v, g)
            elif v._grad_req == "add":
                buf = v._grad._data
                buf.add_(g.to(buf.dtype))
            else:
                v._grad._data.copy_(g)
            v._fresh_grad = True


def _write_row_sparse(v, g):
    """Cast the dense gradient ``g`` (plus the buffer's value under
    ``add``) to row_sparse, into the buffer object itself, so an alias
    taken before `backward` sees it."""
    from .ndarray.ndarray import NDArray
    from .ndarray.sparse import cast_storage

    buf = v._grad
    dense = g.to(buf._data["data"].dtype)
    if v._grad_req == "add":
        dense = dense + buf.tostype("default")._data
    buf._assign(cast_storage(NDArray(dense), "row_sparse"))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as new
    arrays; the variables' buffers are left as they are (reference:
    autograd.py:270). With ``create_graph`` the results are recorded, so a
    further `backward` or `grad` differentiates through them (second
    order). ``retain_graph`` defaults to True, as in the JAX package."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    retain = True if retain_graph is None else retain_graph
    outs, seeds = _heads(heads, head_grads)
    owners, leaves = [], []
    for i, v in enumerate(variables):
        for t in _leaves(v):
            owners.append(i)
            leaves.append(t)
    if not leaves:
        raise MXNetError("autograd.grad: no variable requires a gradient "
                         "(attach_grad or mark_variables first)")
    grads = _differentiate(outs, seeds, leaves, retain or create_graph,
                           create_graph) if outs else [None] * len(leaves)
    totals = [None] * len(variables)
    for i, g in zip(owners, grads):
        if g is not None:
            totals[i] = g if totals[i] is None else totals[i] + g
    return [NDArray(torch.zeros_like(v._data).detach() if g is None else
                    g if create_graph else g.detach())
            for v, g in zip(variables, totals)]


def get_symbol(x):
    raise MXNetError("autograd.get_symbol: use HybridBlock.export / Symbol API")


class _Bridge(torch.autograd.Function):
    """A user `Function` as a node of torch's graph."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray

        with pause():
            out = fn.forward(*[NDArray(t) for t in tensors])
        fn._single = not isinstance(out, (tuple, list))
        outs = (out,) if fn._single else tuple(out)
        ctx.fn = fn
        # an output that is an input as it came in gets its own storage
        return tuple(o._data.clone() if any(o._data is t for t in tensors)
                     else o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        with pause():
            gs = ctx.fn.backward(*[NDArray(g.contiguous()) for g in grads])
        gs = gs if isinstance(gs, (tuple, list)) else (gs,)
        return (None,) + tuple(None if g is None else g._data for g in gs)


class Function:
    """A differentiable function written by the user (reference:
    autograd.py:365): subclass it, implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays, and call the instance.
    ``backward`` returns one gradient an input."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not (is_recording()
                and any(i._data.requires_grad for i in inputs)):
            with pause():
                return self.forward(*inputs)
        with _grad_mode():
            outs = _Bridge.apply(self, *[i._data for i in inputs])
        outs = tuple(NDArray(o) for o in outs)
        return outs[0] if self._single else outs
