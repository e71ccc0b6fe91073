"""Legacy alias: contrib symbol functions under mx.contrib.symbol
(counterpart of `mxnet_tpu/contrib/symbol.py`; reference: python/mxnet/contrib/symbol.py; the same functions live on
mx.sym.contrib)."""


def __getattr__(name):
    from .. import symbol as _sym

    return getattr(_sym.contrib, name)


def __dir__():
    from .. import symbol as _sym

    return sorted(set(dir(_sym.contrib)))
