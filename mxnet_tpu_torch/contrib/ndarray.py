"""Legacy alias: contrib op functions under mx.contrib.ndarray
(counterpart of `mxnet_tpu/contrib/ndarray.py`; reference: python/mxnet/contrib/ndarray.py — the registration namespace
old scripts import; the same functions live on mx.nd.contrib)."""


def __getattr__(name):
    from .. import ndarray as _nd

    return getattr(_nd.contrib, name)


def __dir__():
    from .. import ndarray as _nd

    return sorted(set(dir(_nd.contrib)))
