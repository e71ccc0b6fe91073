"""Deployment predictor (counterpart of `mxnet_tpu/predict.py`; reference:
the C predict API, include/mxnet/c_predict_api.h — MXPredCreate,
MXPredSetInput, MXPredForward, MXPredGetOutput, MXPredReshape,
MXPredPartialOut, MXPredFree).

A `Predictor` loads the ``prefix-symbol.json`` + ``prefix-NNNN.params``
artifacts of `HybridBlock.export` / `model.save_checkpoint` (either
package's) and binds an `Executor` with every ``grad_req`` null on one
device. Its ``forward`` runs the graph under no_grad inside
``context.scope`` of that device, so arrays the graph makes mid-forward
(the FusedRNN begin states) land there from any thread, and the ``RNN``
op's LSTM takes ``lstm_infer``. `_clone_with` binds new input shapes over
another predictor's weight tensors (the reference's
MXPredCreateMultiThread / MXPredReshape semantics): the serving
repository's buckets hold one copy of the weights between them.

Not ported yet: `Predictor.export_compiled` and `CompiledPredictor` (the
JAX package serializes an XLA executable; the port's counterpart is the
captured graph of ROADMAP queue 1 items 2 and 13), and the bridge of the
native C predict API, ``_capi_*`` (queue 1 item 13). They raise.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import context as _context
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError, np_dtype, torch_dtype

__all__ = ["Predictor", "CompiledPredictor", "load_ndarray_file"]

# the JAX package's compiled-artifact magic: recognised so that such a file
# is refused by name instead of misread
_MXC_MAGIC = b"MXTPUAOT1\n"


def load_ndarray_file(nd_bytes_or_file):
    """reference: MXNDListCreate — a saved NDArray dict or list (file name
    or bytes), on the CPU."""
    return nd.load(nd_bytes_or_file, ctx=_context.cpu())


def _host(data, dtype):
    """``data`` (NDArray, tensor or array-like) as a tensor of the declared
    ``dtype``, where it lies (numpy input on the host)."""
    if isinstance(data, nd.NDArray):
        data = data._data
    if not torch.is_tensor(data):
        npd = _np.float32 if dtype == "bfloat16" else dtype
        data = torch.from_numpy(_np.array(data, dtype=npd, order="C"))
    return data.to(torch_dtype(dtype))


class Predictor:
    """reference: MXPredCreate / MXPredCreatePartialOut.

    Parameters
    ----------
    symbol_file : path to prefix-symbol.json, a `Symbol`, or the JSON text
    param_file : path to (or bytes of) prefix-NNNN.params
    ctx : device (default `current_context`: the card, or the innermost
        ``context.scope``; without a card it raises unless the CPU is
        asked for)
    input_shapes : dict name -> shape (batch included)
    output_names : optional internal outputs to return (PartialOut)
    input_dtypes : dict name -> dtype of the inputs not float32 (token ids
        of an Embedding: int32)
    """

    def __init__(self, symbol_file, param_file=None, ctx=None,
                 input_shapes=None, output_names=None, input_dtypes=None):
        self._ctx = _context.resolve_device(ctx)
        if isinstance(symbol_file, sym_mod.Symbol):
            symbol = symbol_file
        elif isinstance(symbol_file, str) \
                and symbol_file.lstrip()[:1] == "{":
            symbol = sym_mod.load_json(symbol_file)
        else:
            symbol = sym_mod.load(symbol_file)
        if output_names:
            internals = symbol.get_internals()
            outs = internals.list_outputs()
            picked = []
            for name in output_names:
                if name not in outs:
                    raise MXNetError("output '%s' not in graph (have %s...)"
                                     % (name, outs[:10]))
                picked.append(internals[outs.index(name)])
            symbol = sym_mod.Group(picked)
        self._symbol = symbol
        self._arg_params, self._aux_params = {}, {}
        if param_file is not None:
            from .model import load_params

            self._arg_params, self._aux_params = load_params(param_file)
        if not input_shapes:
            raise MXNetError("input_shapes is required (as in MXPredCreate)")
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._input_dtypes = {k: np_dtype(_np.float32)
                              for k in self._input_shapes}
        self._input_dtypes.update(
            {k: np_dtype(v) for k, v in (input_dtypes or {}).items()})
        self._outputs = None
        self._bind()

    def _bind(self, shared=None):
        """Bind the executor: each input a new zero buffer of its declared
        shape and dtype; each weight and aux state ``shared``'s tensor when
        ``shared`` (another Predictor) is given, else the params file's
        moved to the device."""
        args = {}
        for name in self._symbol.list_arguments():
            if name in self._input_shapes:
                args[name] = nd.zeros(self._input_shapes[name],
                                      ctx=self._ctx,
                                      dtype=self._input_dtypes[name])
            elif shared is not None and name in shared._args:
                args[name] = shared._args[name]
            elif name in self._arg_params:
                args[name] = self._arg_params[name].as_in_context(self._ctx)
            else:
                raise MXNetError(
                    "argument '%s' has neither a param nor an input shape"
                    % name)
        if shared is not None:
            aux = shared._aux_bound
        else:
            aux = {k: v.as_in_context(self._ctx)
                   for k, v in self._aux_params.items()}
        missing = [n for n in self._symbol.list_auxiliary_states()
                   if n not in aux]
        if missing:
            raise MXNetError("aux states %s are not in the params" % missing)
        self._aux_bound = aux
        self._exe = self._symbol.bind(self._ctx, args=args, grad_req="null",
                                      aux_states=aux)
        self._args = args

    # -- the c_predict_api surface ----------------------------------------
    def set_input(self, name, data):
        """reference: MXPredSetInput. Written into the bound buffer, cast to
        the input's declared dtype."""
        if name not in self._input_shapes:
            raise MXNetError("'%s' is not an input (inputs: %s)"
                             % (name, sorted(self._input_shapes)))
        t = _host(data, self._input_dtypes[name])
        if tuple(t.shape) != self._input_shapes[name]:
            raise MXNetError("input '%s' shape %s != declared %s (use "
                             "reshape())" % (name, tuple(t.shape),
                                             self._input_shapes[name]))
        self._args[name]._set_data(t)

    def forward(self, **kwargs):
        """reference: MXPredForward (kwargs are a set_input shorthand)."""
        for k, v in kwargs.items():
            self.set_input(k, v)
        with _context.scope(self._ctx):
            self._outputs = self._exe.forward(is_train=False)
        return self

    def get_output(self, index=0):
        """reference: MXPredGetOutput."""
        if self._outputs is None:
            raise MXNetError("forward() has not been called")
        return self._outputs[index]

    @property
    def num_outputs(self):
        return len(self._symbol.list_outputs())

    def get_output_shape(self, index=0):
        """reference: MXPredGetOutputShape."""
        _, out_shapes, _ = self._symbol.infer_shape(**self._input_shapes)
        return out_shapes[index]

    def reshape(self, new_input_shapes):
        """reference: MXPredReshape — rebind for new input shapes over the
        same weight tensors."""
        unknown = set(new_input_shapes) - set(self._input_shapes)
        if unknown:
            raise MXNetError("reshape: %s are not inputs (inputs: %s)"
                             % (sorted(unknown), sorted(self._input_shapes)))
        self._input_shapes.update(
            {k: tuple(v) for k, v in new_input_shapes.items()})
        self._outputs = None
        self._bind(shared=self)
        return self

    def free(self):
        """reference: MXPredFree (drops the executor and outputs)."""
        self._exe = None
        self._outputs = None

    def export_compiled(self, path=None):
        raise MXNetError(
            "Predictor.export_compiled is not ported yet: the port's "
            "deployment artifact is the captured graph (ROADMAP queue 1 "
            "items 2 and 13)")


class CompiledPredictor:
    """The JAX package's deserialized XLA artifact: not ported yet (ROADMAP
    queue 1 items 2 and 13)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "CompiledPredictor (.mxc artifacts) is not ported yet (ROADMAP "
            "queue 1 items 2 and 13)")

    @staticmethod
    def load(path_or_bytes):
        return CompiledPredictor()


def _clone_with(pred, input_shapes, shared):
    """A new Predictor over ``pred``'s symbol and params at
    ``input_shapes``, binding ``shared``'s weight and aux tensors (the
    tensors themselves: one copy on the device)."""
    new = Predictor.__new__(Predictor)
    new._ctx = pred._ctx
    new._symbol = pred._symbol
    new._arg_params = pred._arg_params
    new._aux_params = pred._aux_params
    new._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
    new._input_dtypes = dict(pred._input_dtypes)
    new._outputs = None
    new._bind(shared=shared)
    return new


def _capi_unported(*args, **kwargs):
    raise MXNetError("the C predict API bridge is not ported yet (ROADMAP "
                     "queue 1 item 13)")


_capi_create = _capi_set_input = _capi_forward = _capi_get_output = \
    _capi_output_shape = _capi_reshape = _capi_clone_shared = \
    _capi_ndlist = _capi_unported
