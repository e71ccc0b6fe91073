"""Gluon of the port (counterpart of `mxnet_tpu.gluon`): `Parameter`,
`Block`, `HybridBlock`, `SymbolBlock`, `Trainer`, the layers (``nn``, ``rnn``), losses,
utilities, the data API (``data``: datasets, samplers, `DataLoader`, vision
datasets and transforms) and the model zoo."""
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import loss, nn, rnn, utils
from . import data

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock", "SymbolBlock",
           "Trainer",
           "loss", "nn", "rnn", "utils", "data"]
