"""mx.rnn: the symbolic RNN cell API and the bucketing iterator
(counterpart of `mxnet_tpu.rnn`; reference: python/mxnet/rnn/ — the API
behind example/rnn/bucketing)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .io import encode_sentences, BucketSentenceIter
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "encode_sentences",
           "BucketSentenceIter", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
