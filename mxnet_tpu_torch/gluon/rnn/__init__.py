"""Recurrent layers and cells of the port (counterpart of
`mxnet_tpu.gluon.rnn`): the fused layers of ``rnn_layer.py`` and the cells
of ``rnn_cell.py``."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]
