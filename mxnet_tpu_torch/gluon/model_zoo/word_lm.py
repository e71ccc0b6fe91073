"""Word-level language model: embedding -> LSTM -> decoder (counterpart of
`mxnet_tpu/gluon/model_zoo/word_lm.py`, after the reference's
example/rnn/word_lm/model.py).

The LSTM is `gluon.rnn.LSTM`, whose layers run the kernels of
``csrc/lstm.cu`` on the card. Child names: ``embedding``, ``rnn``,
``decoder`` (and ``drop`` with dropout); `convert.word_lm_params_from_jax`
maps the JAX model's parameters onto them.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import initializer as _init
from ...context import resolve_device
from .. import rnn
from ..nn import Dense, Dropout, Embedding

__all__ = ["RNNModel"]


class RNNModel(nn.Module):
    """Embedding(vocab, embed) -> optional Dropout -> LSTM(hidden,
    num_layers, TNC) -> optional Dropout -> Dense(vocab, flatten=False).
    ``tie_weights`` shares one `Parameter` between the embedding and the
    decoder (embed_size must equal hidden_size, as in the reference).
    ``device``: where the parameters live (default: the card,
    `context.resolve_device`)."""

    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.5, tie_weights=False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.drop = Dropout(dropout) if dropout else None
        self.embedding = Embedding(vocab_size, embed_size, device=device)
        self.rnn = rnn.LSTM(hidden_size, num_layers=num_layers,
                            dropout=dropout, input_size=embed_size,
                            layout="TNC", device=device)
        if tie_weights and embed_size != hidden_size:
            raise ValueError("tie_weights requires embed_size == hidden_size "
                             "(as in reference)")
        self.decoder = Dense(vocab_size, flatten=False, in_units=hidden_size,
                             device=device)
        if tie_weights:
            self.decoder.weight = self.embedding.weight

    def initialize(self, init="xavier", seed=None):
        """Fill the weights (default Xavier, the embedding included),
        biases 0; see `initializer.initialize`. Returns self."""
        return _init.initialize(self, init, seed)

    def begin_state(self, batch_size, device=None, func=None,
                    dtype=torch.float32):
        """The LSTM's zero states [h, c], each (num_layers, batch, hidden)."""
        return self.rnn.begin_state(batch_size=batch_size, func=func,
                                    device=device, dtype=dtype)

    def forward(self, inputs, state=None):
        """inputs: (T, B) int ids. Returns logits (T, B, vocab), or
        ``(logits, state)`` when a state is given."""
        emb = self.embedding(inputs)
        if self.drop is not None:
            emb = self.drop(emb)
        if state is None:
            out = self.rnn(emb)
        else:
            out, state = self.rnn(emb, state)
        if self.drop is not None:
            out = self.drop(out)
        logits = self.decoder(out)
        if state is None:
            return logits
        return logits, state
