"""Contrib subsystems (counterpart of `mxnet_tpu.contrib`; reference:
python/mxnet/contrib/*): the legacy ``autograd`` API, the ``ndarray`` /
``symbol`` namespace aliases, int8 ``quantization``, ``text``,
``tensorboard``, ``io`` (`DataLoaderIter`), ``svrg_optimization``, the
``tensorrt`` surface, and ``onnx`` (import and export of ONNX graphs over
the ``onnx_proto`` shim when the `onnx` package is not installed)."""
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import symbol  # noqa: F401
from . import quantization  # noqa: F401
from . import text  # noqa: F401
from . import tensorboard  # noqa: F401
from . import tensorrt  # noqa: F401
from . import io  # noqa: F401
from . import svrg_optimization  # noqa: F401
from . import onnx  # noqa: F401
