"""Layers of the port (counterpart of `mxnet_tpu.gluon.nn`: every layer of
its basic and convolution modules, and `Block` / `HybridBlock`)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic_all
from .conv_layers import __all__ as _conv_all
from ..block import Block, HybridBlock

__all__ = list(_basic_all) + list(_conv_all) + ["Block", "HybridBlock"]
