"""Contrib subsystems (counterpart of `mxnet_tpu.contrib`; reference:
python/mxnet/contrib/*): the legacy ``autograd`` API, the ``ndarray`` /
``symbol`` namespace aliases, int8 ``quantization``, ``text``,
``tensorboard``, ``io`` (`DataLoaderIter`), ``svrg_optimization`` and the
``tensorrt`` surface. ``onnx`` is not ported yet (ROADMAP queue 1 item
13): ``mx.contrib.onnx`` raises, naming it."""
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import symbol  # noqa: F401
from . import quantization  # noqa: F401
from . import text  # noqa: F401
from . import tensorboard  # noqa: F401
from . import tensorrt  # noqa: F401
from . import io  # noqa: F401
from . import svrg_optimization  # noqa: F401


def __getattr__(name):
    if name in ("onnx", "onnx_proto"):
        from ..base import MXNetError

        raise MXNetError("mx.contrib.onnx is not ported yet (ROADMAP queue 1 "
                         "item 13): import and export of ONNX graphs")
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
