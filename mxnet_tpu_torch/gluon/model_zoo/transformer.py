"""Transformer encoder cells, the BERT model family and the decoder-only
Transformer LM.

Counterpart of `mxnet_tpu/gluon/model_zoo/transformer.py`, built as the
JAX package builds it: `HybridBlock`s with its prefixes and children
(``proj_query`` with prefix ``query_``, ``attention_norm``, ``ffn.ffn_1``,
an encoder's cells registered as children ``0``, ``1``, ...), so the
parameter names (``collect_params``), ``.params`` files and the module
paths are the JAX package's. Called with NDArrays (``net(mx.nd.zeros(...))``)
or with tensors, each block computes on tensors; like the JAX blocks they
have no symbol form (their shapes come from the input), so ``export``
raises, as it does in the JAX package.

Attention without a mask (BERT without ``valid_length``) runs
`ops.contrib.flash_attention`, whose three CUDA kernels carry the forward
and the backward on the card; with a mask (the LM's causal mask, BERT's
padding mask) it is the JAX package's masked dense path (scores, finite
-1e30 mask, softmax). The generation engine (`serving.generate`) runs a
`TransformerLM`'s cells incrementally over the paged-attention kernel.

``device``: where the parameters are made at construction and where
`initialize` keeps them (default: `BERTModel` `current_context` at
`initialize`, `TransformerLM` the host).
"""
from __future__ import annotations

import math

import torch

from ... import initializer as _init
from ...base import MXNetError
from ...context import checked_context, cpu
from ...ops import contrib as _contrib
from ..nn import Dense, Dropout, Embedding, GELU, LayerNorm
from ..nn.basic_layers import _Layer

__all__ = ["LayerNorm", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder", "BERTModel",
           "bert_12_768_12", "bert_mini", "TransformerLM", "lm_mini",
           "bert_base_lm"]


def _dropout(rate):
    return Dropout(rate) if rate else None


class MultiHeadAttention(_Layer):
    """Multi-head self/cross attention: flash attention without a mask,
    the masked dense path with one; ``dropout`` on the output
    projection."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads != 0:
            raise MXNetError("num_heads (%d) must evenly divide units (%d)"
                             % (num_heads, units))
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.proj_query, self.proj_key, self.proj_value, \
                self.proj_out = (
                    Dense(units, flatten=False, use_bias=use_bias,
                          in_units=units, device=device, prefix=p)
                    for p in ("query_", "key_", "value_", "out_"))
            self.dropout = _dropout(dropout)

    def _split(self, x):
        # (B, L, C) -> (B, H, L, Dh)
        b, length = x.shape[0], x.shape[1]
        return x.reshape(b, length, self._num_heads,
                         self._units // self._num_heads).transpose(1, 2)

    def forward(self, query, key=None, value=None, mask=None):
        """mask: (B, Lq, Lk), nonzero where a query may attend a key."""
        key = query if key is None else key
        value = key if value is None else value
        b, lq = query.shape[0], query.shape[1]
        q = self._split(self.proj_query(query))
        k = self._split(self.proj_key(key))
        v = self._split(self.proj_value(value))
        dh = self._units // self._num_heads
        if mask is None:
            out = _contrib.flash_attention(q, k, v, causal=False,
                                           sm_scale=1.0 / math.sqrt(dh))
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            scores = torch.where(mask.unsqueeze(1) > 0, scores,
                                 torch.full_like(scores, -1e30))
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = self.proj_out(out.transpose(1, 2).reshape(b, lq, self._units))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(_Layer):
    """FFN sublayer with erf GELU; ``dropout`` on its output."""

    def __init__(self, units, hidden_size, dropout=0.0, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = Dense(hidden_size, flatten=False, in_units=units,
                               device=device, prefix="ffn1_")
            self.activation = GELU()
            self.ffn_2 = Dense(units, flatten=False, in_units=hidden_size,
                               device=device, prefix="ffn2_")
            self.dropout = _dropout(dropout)

    def forward(self, x):
        out = self.ffn_2(self.activation(self.ffn_1(x)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(_Layer):
    """Post-LN (BERT-style) encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout,
                                                device=device)
            self.attention_norm = LayerNorm(units, device=device)
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       device=device)
            self.ffn_norm = LayerNorm(units, device=device)

    def forward(self, x, mask=None):
        out = self.attention_norm(x + self.attention(x, x, x, mask))
        return self.ffn_norm(out + self.ffn(out))


def _add_cells(block, n, units, hidden_size, num_heads, dropout, device):
    """``n`` encoder cells (prefixes ``layer<i>_``) registered as the
    block's next children and listed in ``block.cells``, as the JAX
    package does."""
    block.cells = []
    for i in range(n):
        cell = TransformerEncoderCell(units, hidden_size, num_heads, dropout,
                                      device=device, prefix="layer%d_" % i)
        block.register_child(cell)
        block.cells.append(cell)


class TransformerEncoder(_Layer):
    """``num_layers`` encoder cells (children ``0``, ``1``, ...) applied in
    order."""

    def __init__(self, units=512, hidden_size=2048, num_layers=6, num_heads=8,
                 dropout=0.0, device=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            _add_cells(self, num_layers, units, hidden_size, num_heads,
                       dropout, device)

    def forward(self, x, mask=None):
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(_Layer):
    """BERT encoder: token, segment and position embeddings, LayerNorm,
    dropout, the encoder, and the CLS-token pooler (Dense + tanh)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, token_types=2,
                 dropout=0.1, device=None, **kwargs):
        super().__init__(**kwargs)
        self._device = checked_context(device)
        device = self._device
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units, device=device,
                                        prefix="word_")
            self.token_type_embed = Embedding(token_types, units,
                                              device=device,
                                              prefix="segment_")
            self.position_embed = Embedding(max_length, units, device=device,
                                            prefix="pos_")
            self.embed_norm = LayerNorm(units, device=device)
            self.embed_dropout = _dropout(dropout)
            self.encoder = TransformerEncoder(units, hidden_size, num_layers,
                                              num_heads, dropout,
                                              device=device)
            self.pooler = Dense(units, activation="tanh", in_units=units,
                                device=device, prefix="pooler_")

    def initialize(self, init="xavier", ctx=None, verbose=False,
                   force_reinit=False, seed=None):
        """Fill the weights (default Xavier, embeddings included), LayerNorm
        gamma 1 / beta 0, biases 0, on ``ctx`` (default: the device the
        model was built for, else `current_context`); see
        `Block.initialize`. Returns self."""
        return super().initialize(init, self._device if ctx is None else ctx,
                                  verbose, force_reinit, seed)

    def _embed_prelude(self, inputs, token_types=None, valid_length=None):
        """Token + segment + position embeddings, norm and dropout; and the
        (B, Lq, Lk) attention mask from per-sample valid lengths (None
        without them, so attention takes the flash path)."""
        b, length = inputs.shape[0], inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        steps = torch.arange(length, device=inputs.device)
        x = x + self.position_embed(steps)[None]
        x = self.embed_norm(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            keep = steps[None, :] < valid_length.float()[:, None]
            mask = keep[:, None, :].expand(b, length, length)
        return x, mask

    def _pool_postlude(self, seq):
        """The CLS-token pooler (the back end of the pipeline
        decomposition)."""
        return self.pooler(seq[:, 0])

    def forward(self, inputs, token_types=None, valid_length=None):
        """inputs: (B, L) int token ids. Returns (sequence_out (B, L, C),
        pooled_out (B, C))."""
        x, mask = self._embed_prelude(inputs, token_types, valid_length)
        seq = self.encoder(x, mask)
        return seq, self._pool_postlude(seq)

    def pipeline_stages(self):
        """The decomposition `parallel.PipelineTrainer` runs: (prelude,
        cells, postlude). The prelude embeds the tokens (replicated), the
        cells are the homogeneous encoder layers (pipelined over ``pp``),
        the postlude pools; the pooled vector is the prediction (the
        sequence output stays the model's own forward's)."""
        return self._embed_prelude, list(self.encoder.cells), \
            self._pool_postlude


class TransformerLM(_Layer):
    """Decoder-only language model: BERT encoder cells under a causal mask,
    learned positions, and a TIED head (the logits reuse ``word_weight``,
    a parameter of this block). The full-sequence form: the generation
    engine (`serving.generate.TransformerLMEngine`) computes the same
    function incrementally over a paged KV cache. It is built in eval
    mode: its dropout drops in a tensor call only after ``train()``, and in
    a façade call (NDArrays) under ``autograd.record()``, as in the JAX
    package."""

    def __init__(self, vocab_size=1000, units=64, hidden_size=128,
                 num_layers=2, num_heads=2, max_length=256, dropout=0.0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self._config = dict(vocab_size=int(vocab_size), units=int(units),
                            hidden_size=int(hidden_size),
                            num_layers=int(num_layers),
                            num_heads=int(num_heads),
                            max_length=int(max_length),
                            dropout=float(dropout))
        self._device = checked_context(device)
        device = self._device
        with self.name_scope():
            self._param("word_weight", device=device,
                        shape=(vocab_size, units))
            self.position_embed = Embedding(max_length, units, device=device,
                                            prefix="pos_")
            self.embed_norm = LayerNorm(units, device=device)
            self.embed_dropout = _dropout(dropout)
            _add_cells(self, num_layers, units, hidden_size, num_heads,
                       dropout, device)
        self.eval()

    @property
    def config(self):
        """Architecture dict (the generation artifact header)."""
        return dict(self._config)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None, std=0.02):
        """Fill the parameters (`Block.initialize`) with ``init``, by
        default every matrix and embedding from N(0, std) (BERT's
        initializer range), biases 0, norms 1 / 0, drawn on the host from
        ``seed`` (the same weights on every device). ``ctx`` defaults to
        the device the LM was built for, else the host. An int in place of
        ``init`` is the seed. Returns self."""
        if isinstance(init, int) and not isinstance(init, bool):
            init, seed = None, init
        if init is None:
            init = _init.Normal(std)
        if ctx is None:
            ctx = self._device if self._device is not None else cpu()
        return super().initialize(init, ctx, verbose, force_reinit, seed)

    def forward(self, inputs):
        """inputs: (B, L) int token ids -> logits (B, L, V); position t
        sees tokens [0, t]."""
        b, length = inputs.shape[0], inputs.shape[1]
        inputs = inputs.long()
        word = self._held("word_weight")
        pos = torch.arange(length, device=inputs.device)
        x = word[inputs] + self.position_embed(pos)[None]
        x = self.embed_norm(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        causal = pos[None, :] <= pos[:, None]
        mask = causal[None].expand(b, length, length)
        for cell in self.cells:
            x = cell(x, mask)
        return torch.matmul(x, word.t())

    def decode_params(self):
        """The parameters as the structured numpy dict of the JAX package's
        `TransformerLM.decode_params` (see `convert.params_from_jax`)."""
        def arr(block, name):
            return block._held(name).detach().float().cpu().numpy()

        def dense(d):
            return {"w": arr(d, "weight"), "b": arr(d, "bias")}

        def norm(ln):
            return {"g": arr(ln, "gamma"), "b": arr(ln, "beta")}

        layers = []
        for cell in self.cells:
            att = cell.attention
            layers.append({
                "q": dense(att.proj_query), "k": dense(att.proj_key),
                "v": dense(att.proj_value), "o": dense(att.proj_out),
                "attn_norm": norm(cell.attention_norm),
                "ffn1": dense(cell.ffn.ffn_1), "ffn2": dense(cell.ffn.ffn_2),
                "ffn_norm": norm(cell.ffn_norm),
            })
        return {"word": arr(self, "word_weight"),
                "pos": arr(self.position_embed, "weight"),
                "embed_norm": norm(self.embed_norm),
                "layers": layers}

    def param_bytes(self):
        return int(sum(p.numel() * p.element_size()
                       for p in self.parameters()))


def lm_mini(vocab_size=128, **kwargs):
    """Tiny decoder-only LM for tests (2 layers, d=32), as in the JAX
    package."""
    kwargs.setdefault("units", 32)
    kwargs.setdefault("hidden_size", 64)
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("num_heads", 2)
    kwargs.setdefault("max_length", 128)
    return TransformerLM(vocab_size=vocab_size, **kwargs)


def bert_base_lm(vocab_size=30522, **kwargs):
    """The LM at BERT-base width (`bert_12_768_12` geometry of the JAX
    package): 12 layers, 768 units, 3072 hidden, 12 heads, 512 positions."""
    kwargs.setdefault("num_layers", 12)
    return TransformerLM(vocab_size=vocab_size, units=768, hidden_size=3072,
                         num_heads=12, max_length=512, **kwargs)


def bert_12_768_12(vocab_size=30522, **kwargs):
    """BERT-base geometry: 12 layers, 768 units, 3072 hidden, 12 heads, 512
    positions."""
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kwargs)


def bert_mini(vocab_size=1000, **kwargs):
    """Tiny geometry for tests (2 layers, 64 units, 4 heads), as in the JAX
    package."""
    return BERTModel(vocab_size=vocab_size, units=64, hidden_size=128,
                     num_layers=2, num_heads=4, max_length=128, **kwargs)
