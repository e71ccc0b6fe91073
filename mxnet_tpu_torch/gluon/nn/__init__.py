"""Layers of the port (counterpart of `mxnet_tpu.gluon.nn`, the ResNet
training path)."""
from .basic_layers import (Activation, BatchNorm, Dense, Flatten,
                           HybridSequential, Sequential)
from .conv_layers import (Conv2D, GlobalAvgPool2D, MaxPool2D,
                          in_channels_last_scope, layout_scope)

__all__ = ["Activation", "BatchNorm", "Dense", "Flatten", "HybridSequential",
           "Sequential", "Conv2D", "GlobalAvgPool2D", "MaxPool2D",
           "in_channels_last_scope", "layout_scope"]
