"""Models, layers and losses of the port (counterpart of
`mxnet_tpu.gluon`: the generation, ResNet and BERT training paths)."""
from . import loss, nn

__all__ = ["loss", "nn"]
