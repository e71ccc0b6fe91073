"""Models, layers and losses of the port (counterpart of
`mxnet_tpu.gluon`: the generation, ResNet, BERT and word-LM paths)."""
from . import loss, nn, rnn

__all__ = ["loss", "nn", "rnn"]
