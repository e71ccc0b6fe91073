"""Transformer encoder cells, the BERT model family and the decoder-only
Transformer LM.

Counterpart of `mxnet_tpu/gluon/model_zoo/transformer.py` as `nn.Module`s.
Submodule and parameter names follow the JAX blocks (``proj_query``,
``attention_norm.gamma``, ``ffn.ffn_1`` ...) so `convert.py` maps the JAX
package's parameters one to one. Attention without a mask (BERT without
``valid_length``) runs `ops.contrib.flash_attention`, whose three CUDA
kernels carry the forward and the backward on the card; with a mask (the
LM's causal mask, BERT's padding mask) it is the JAX package's masked
dense path (scores, finite -1e30 mask, softmax).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ... import initializer as _init
from ...base import MXNetError
from ...context import resolve_device
from ...ops import contrib as _contrib
from ..nn import Dense, Dropout, Embedding, GELU, LayerNorm

__all__ = ["LayerNorm", "MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder", "BERTModel",
           "bert_12_768_12", "bert_mini", "TransformerLM", "lm_mini",
           "bert_base_lm"]


def _dropout(rate):
    return Dropout(rate) if rate else None


class MultiHeadAttention(nn.Module):
    """Multi-head self/cross attention: flash attention without a mask,
    the masked dense path with one; ``dropout`` on the output
    projection."""

    def __init__(self, units, num_heads, dropout=0.0, device=None):
        super().__init__()
        if units % num_heads != 0:
            raise MXNetError("num_heads (%d) must evenly divide units (%d)"
                             % (num_heads, units))
        self.units = units
        self.num_heads = num_heads
        self.proj_query = nn.Linear(units, units, device=device)
        self.proj_key = nn.Linear(units, units, device=device)
        self.proj_value = nn.Linear(units, units, device=device)
        self.proj_out = nn.Linear(units, units, device=device)
        self.dropout = _dropout(dropout)

    def _split(self, x):
        # (B, L, C) -> (B, H, L, Dh)
        b, length = x.shape[0], x.shape[1]
        return x.reshape(b, length, self.num_heads,
                         self.units // self.num_heads).transpose(1, 2)

    def forward(self, query, key=None, value=None, mask=None):
        """mask: (B, Lq, Lk), nonzero where a query may attend a key."""
        key = query if key is None else key
        value = key if value is None else value
        b, lq = query.shape[0], query.shape[1]
        q = self._split(self.proj_query(query))
        k = self._split(self.proj_key(key))
        v = self._split(self.proj_value(value))
        dh = self.units // self.num_heads
        if mask is None:
            out = _contrib.flash_attention(q, k, v, causal=False,
                                           sm_scale=1.0 / math.sqrt(dh))
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            scores = torch.where(mask.unsqueeze(1) > 0, scores,
                                 torch.full_like(scores, -1e30))
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = self.proj_out(out.transpose(1, 2).reshape(b, lq, self.units))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(nn.Module):
    """FFN sublayer with erf GELU; ``dropout`` on its output."""

    def __init__(self, units, hidden_size, dropout=0.0, device=None):
        super().__init__()
        self.ffn_1 = nn.Linear(units, hidden_size, device=device)
        self.activation = GELU()
        self.ffn_2 = nn.Linear(hidden_size, units, device=device)
        self.dropout = _dropout(dropout)

    def forward(self, x):
        out = self.ffn_2(self.activation(self.ffn_1(x)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(nn.Module):
    """Post-LN (BERT-style) encoder layer."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            device=device)
        self.attention_norm = LayerNorm(units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, device=device)
        self.ffn_norm = LayerNorm(units, device=device)

    def forward(self, x, mask=None):
        out = self.attention_norm(x + self.attention(x, x, x, mask))
        return self.ffn_norm(out + self.ffn(out))


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder cells (``cells.<i>``) applied in order."""

    def __init__(self, units=512, hidden_size=2048, num_layers=6, num_heads=8,
                 dropout=0.0, device=None):
        super().__init__()
        self.cells = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads, dropout,
                                   device=device)
            for _ in range(num_layers))

    def forward(self, x, mask=None):
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(nn.Module):
    """BERT encoder: token, segment and position embeddings, LayerNorm,
    dropout, the encoder, and the CLS-token pooler (Dense + tanh).
    ``device``: where the parameters live (default: the card,
    `context.resolve_device`)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, token_types=2,
                 dropout=0.1, device=None):
        super().__init__()
        device = resolve_device(device)
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.token_type_embed = Embedding(token_types, units, device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_norm = LayerNorm(units, device=device)
        self.embed_dropout = _dropout(dropout)
        self.encoder = TransformerEncoder(units, hidden_size, num_layers,
                                          num_heads, dropout, device=device)
        self.pooler = Dense(units, activation="tanh", in_units=units,
                            device=device)

    def initialize(self, init="xavier", seed=None):
        """Fill the weights (default Xavier, embeddings included), LayerNorm
        gamma 1 / beta 0, biases 0; see `initializer.initialize`. Returns
        self."""
        return _init.initialize(self, init, seed)

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

    def forward(self, inputs, token_types=None, valid_length=None):
        """inputs: (B, L) int token ids. Returns (sequence_out (B, L, C),
        pooled_out (B, C))."""
        x, mask = self._embed_prelude(inputs, token_types, valid_length)
        seq = self.encoder(x, mask)
        return seq, self.pooler(seq[:, 0])


class TransformerLM(nn.Module):
    """Decoder-only language model: BERT encoder cells under a causal mask,
    learned positions, and a TIED head (the logits reuse the word-embedding
    weight). The full-sequence form: the generation engine
    (`serving.generate.TransformerLMEngine`) computes the same function
    incrementally over a paged KV cache. Dropout is an inference no-op and
    is kept in `config` only for the artifact header."""

    def __init__(self, vocab_size=1000, units=64, hidden_size=128,
                 num_layers=2, num_heads=2, max_length=256, dropout=0.0,
                 device=None):
        super().__init__()
        self._config = dict(vocab_size=int(vocab_size), units=int(units),
                            hidden_size=int(hidden_size),
                            num_layers=int(num_layers),
                            num_heads=int(num_heads),
                            max_length=int(max_length),
                            dropout=float(dropout))
        self.word_weight = nn.Parameter(
            torch.empty(vocab_size, units, device=device))
        self.position_embed = nn.Embedding(max_length, units, device=device)
        self.embed_norm = LayerNorm(units, device=device)
        self.cells = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads,
                                   device=device)
            for _ in range(num_layers))
        nn.init.normal_(self.word_weight)

    @property
    def config(self):
        """Architecture dict (the generation artifact header)."""
        return dict(self._config)

    def initialize(self, seed, std=0.02):
        """Random weights from ``seed``: every matrix and embedding from
        N(0, std) (BERT's initializer range), biases 0, norms 1/0. Drawn
        on the host with an explicit generator, so a seed gives the same
        weights on every device."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("gamma"):
                    val = torch.ones(p.shape)
                elif name.endswith(("bias", "beta")):
                    val = torch.zeros(p.shape)
                else:
                    val = torch.normal(0.0, std, tuple(p.shape),
                                       generator=gen)
                p.copy_(val)
        return self

    def forward(self, inputs):
        """inputs: (B, L) int token ids -> logits (B, L, V); position t
        sees tokens [0, t]."""
        b, length = inputs.shape[0], inputs.shape[1]
        inputs = inputs.long()
        pos = torch.arange(length, device=inputs.device)
        x = self.word_weight[inputs] + self.position_embed.weight[pos][None]
        x = self.embed_norm(x)
        causal = pos[None, :] <= pos[:, None]
        mask = causal[None].expand(b, length, length)
        for cell in self.cells:
            x = cell(x, mask)
        return torch.matmul(x, self.word_weight.t())

    def decode_params(self):
        """The parameters as the structured numpy dict of the JAX package's
        `TransformerLM.decode_params` (see `convert.params_from_jax`)."""
        def arr(p):
            return p.detach().float().cpu().numpy()

        def dense(lin):
            return {"w": arr(lin.weight), "b": arr(lin.bias)}

        def norm(ln):
            return {"g": arr(ln.gamma), "b": arr(ln.beta)}

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
        return {"word": arr(self.word_weight),
                "pos": arr(self.position_embed.weight),
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
