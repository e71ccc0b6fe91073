"""Recurrent layers of the port (counterpart of `mxnet_tpu.gluon.rnn`: the
fused layers; the cells of ``rnn_cell.py`` are not ported yet)."""
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU"]
