"""mxnet_tpu_torch.symbol: the declarative graph API (counterpart of
`mxnet_tpu.symbol`; reference: python/mxnet/symbol). The graph is a Python
DAG over the shared op registry; `Symbol.bind` gives an `Executor` that
runs it on torch tensors. See symbol.py."""
from .symbol import (Symbol, var, Variable, Group, load, load_json, pow,
                     maximum, minimum, ones_like, zeros_like)
from . import register as _register

_functions = _register.populate(globals())


def zeros(shape, dtype=None, **kwargs):
    return _functions["_zeros"](shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype=None, **kwargs):
    return _functions["_ones"](shape=shape, dtype=dtype, **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, name=None):
    return _functions["_arange"](start=start, stop=stop, step=step,
                                 repeat=repeat, dtype=dtype, name=name)
