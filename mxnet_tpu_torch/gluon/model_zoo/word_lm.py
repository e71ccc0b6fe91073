"""Word-level language model: embedding -> LSTM -> decoder (counterpart of
`mxnet_tpu/gluon/model_zoo/word_lm.py`, after the reference's
example/rnn/word_lm/model.py).

The LSTM is `gluon.rnn.LSTM`, whose layers run the kernels of
``csrc/lstm.cu`` on the card. Child names: ``embedding``, ``rnn``,
``decoder`` (and ``drop`` with dropout); parameter names the JAX package's
(``rnnmodel0_embed_weight``, ``rnnmodel0_lstm_l0_i2h_weight``,
``rnnmodel0_decoder_weight``, ...). `convert.word_lm_params_from_jax` maps
the JAX model's parameters onto the state dict.
"""
from __future__ import annotations

import torch

from ...context import checked_context
from .. import rnn
from ..nn import Dense, Dropout, Embedding
from ..nn.basic_layers import _Layer

__all__ = ["RNNModel"]


class RNNModel(_Layer):
    """Embedding(vocab, embed) -> optional Dropout -> LSTM(hidden,
    num_layers, TNC) -> optional Dropout -> Dense(vocab, flatten=False).
    ``tie_weights`` shares one `Parameter` between the embedding and the
    decoder (embed_size must equal hidden_size, as in the reference).
    ``device``: where the parameters live (default: the context
    `initialize` is given, else `current_context` then). Called with
    tensors it returns tensors, with NDArrays NDArrays."""

    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.5, tie_weights=False, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = checked_context(device)
        if tie_weights and embed_size != hidden_size:
            raise ValueError("tie_weights requires embed_size == hidden_size "
                             "(as in reference)")
        with self.name_scope():
            self.drop = Dropout(dropout) if dropout else None
            self.embedding = Embedding(vocab_size, embed_size, device=device,
                                       prefix="embed_")
            self.rnn = rnn.LSTM(hidden_size, num_layers=num_layers,
                                dropout=dropout, input_size=embed_size,
                                layout="TNC", device=device, prefix="lstm_")
            if tie_weights:
                self.decoder = Dense(vocab_size, flatten=False,
                                     in_units=hidden_size, device=device,
                                     params=self.embedding.params,
                                     prefix="embed_")
            else:
                self.decoder = Dense(vocab_size, flatten=False,
                                     in_units=hidden_size, device=device,
                                     prefix="decoder_")

    def initialize(self, init="xavier", ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Fill the weights (default Xavier, the embedding included),
        biases 0; see `Block.initialize`. Returns self."""
        return super().initialize(init, ctx, verbose, force_reinit, seed)

    def begin_state(self, batch_size, ctx=None, func=None, device=None,
                    dtype=torch.float32):
        """The LSTM's zero states [h, c], each (num_layers, batch, hidden):
        NDArrays on ``ctx`` when it is given (the JAX package's signature),
        else tensors on ``device`` (default: the parameters')."""
        return self.rnn.begin_state(batch_size=batch_size, func=func,
                                    device=device, dtype=dtype, ctx=ctx)

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
