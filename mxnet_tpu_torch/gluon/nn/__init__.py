"""Layers of the port (counterpart of `mxnet_tpu.gluon.nn`: the ResNet and
BERT training paths)."""
from .basic_layers import (GELU, Activation, BatchNorm, Dense, Dropout,
                           Embedding, Flatten, HybridSequential, LayerNorm,
                           Sequential)
from .conv_layers import (Conv2D, GlobalAvgPool2D, MaxPool2D,
                          in_channels_last_scope, layout_scope)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "GELU", "HybridSequential", "LayerNorm", "Sequential",
           "Conv2D", "GlobalAvgPool2D", "MaxPool2D",
           "in_channels_last_scope", "layout_scope"]
