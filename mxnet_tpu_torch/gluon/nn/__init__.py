"""Layers of the port (counterpart of `mxnet_tpu.gluon.nn`: the layers of
the ResNet, BERT and word-LM paths, and `Block` / `HybridBlock`)."""
from .basic_layers import (GELU, Activation, BatchNorm, Dense, Dropout,
                           Embedding, Flatten, HybridSequential, LayerNorm,
                           Sequential)
from .conv_layers import (Conv2D, GlobalAvgPool2D, MaxPool2D,
                          in_channels_last_scope, layout_scope)
from ..block import Block, HybridBlock

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten", "GELU", "HybridSequential", "LayerNorm", "Sequential",
           "Conv2D", "GlobalAvgPool2D", "MaxPool2D",
           "in_channels_last_scope", "layout_scope", "Block", "HybridBlock"]
