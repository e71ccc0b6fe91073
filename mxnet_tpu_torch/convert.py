"""Weights carried between the JAX package and the port.

Two layouts of one `TransformerLM`'s parameters come from the JAX package:

  * ``decode_params()`` — a structured numpy dict (``word``, ``pos``,
    ``embed_norm``, ``layers[i]["q" | "k" | "v" | "o" | "ffn1" | "ffn2" |
    "attn_norm" | "ffn_norm"]``) — read by `params_from_jax`;
  * the ``<prefix>-lm.params`` npz its ``save_lm`` writes, keyed by the
    gluon child path (``word_weight``, ``position_embed.weight``,
    ``embed_norm.gamma``, ``<n>.attention.proj_query.weight`` ...), where
    ``<n>`` is the cell's child index: 2 for the first cell, 3 when the
    block was built with dropout (an ``embed_dropout`` child comes first).
    The port's `TransformerLM` is built as the JAX package's, so these are
    its state-dict keys too: `state_from_npz` reads the file and
    `npz_from_state` writes it.

The other vision nets (ResNet v2, AlexNet, VGG, SqueezeNet, DenseNet,
Inception V3, MobileNet v1 / v2) are built in the port as the JAX package
builds them, with its parameter names: `vision_params_from_jax` places the
JAX net's arrays by those names onto the port net's parameter paths (and
their ``.params`` files cross both ways through ``save_parameters`` /
``load_parameters``).

A ResNet v1's parameters come from the JAX net's ``collect_params()``
as numpy arrays keyed by gluon auto-names (``resnetv10_conv2d0_weight``,
``resnetv10_stage1_batchnorm2_running_var``, ``resnetv10_dense0_bias``
...); `resnet_params_from_jax` maps them onto the port's `ResNetV1` (or
`vision_params_from_jax`, by name: the port builds it as the JAX package
does), and
`bert_params_from_jax` maps a `BERTModel`'s (with or without an output
head) onto the port's `BERTModel`, and `word_lm_params_from_jax` a word-LM
`RNNModel`'s onto the port's `RNNModel`. A symbolic `Module`'s
``get_params()`` needs no renaming: `module_params_from_jax` turns its
numpy arrays into the port's NDArrays on a device.

Every function but `module_params_from_jax` returns plain data (a
``state_dict`` of CPU tensors, or a dict of numpy arrays); the caller loads
it into a module on its device.
NDArrays themselves cross as files: `ndarray.save` / `ndarray.load` use
the JAX package's ``nd.save`` container, both ways.
"""
from __future__ import annotations

import re

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["params_from_jax", "state_from_npz", "npz_from_state",
           "resnet_params_from_jax", "bert_params_from_jax",
           "word_lm_params_from_jax", "module_params_from_jax",
           "vision_params_from_jax"]

_DENSE = {"q": "attention.proj_query", "k": "attention.proj_key",
          "v": "attention.proj_value", "o": "attention.proj_out",
          "ffn1": "ffn.ffn_1", "ffn2": "ffn.ffn_2"}
_NORM = {"attn_norm": "attention_norm", "ffn_norm": "ffn_norm"}
_CELL_KEY = re.compile(r"^(\d+)\.(.+)$")


def _t(a):
    return torch.from_numpy(_np.array(a, dtype=_np.float32, copy=True))


def _cell_offset(dropout):
    """The child index of a `TransformerLM`'s first cell: after
    ``position_embed`` and ``embed_norm``, and ``embed_dropout`` when the
    LM has dropout."""
    return 3 if dropout else 2


def params_from_jax(d, dropout=0.0):
    """``TransformerLM.decode_params()`` of the JAX package -> the state
    dict of the port's `TransformerLM` built with ``dropout``."""
    state = {"word_weight": _t(d["word"]),
             "position_embed.weight": _t(d["pos"]),
             "embed_norm.gamma": _t(d["embed_norm"]["g"]),
             "embed_norm.beta": _t(d["embed_norm"]["b"])}
    for i, layer in enumerate(d["layers"]):
        cell = i + _cell_offset(dropout)
        for short, path in _DENSE.items():
            state["%d.%s.weight" % (cell, path)] = _t(layer[short]["w"])
            state["%d.%s.bias" % (cell, path)] = _t(layer[short]["b"])
        for short, path in _NORM.items():
            state["%d.%s.gamma" % (cell, path)] = _t(layer[short]["g"])
            state["%d.%s.beta" % (cell, path)] = _t(layer[short]["b"])
    return state


def state_from_npz(arrays):
    """The JAX package's ``-lm.params`` arrays (any mapping of key ->
    array, such as an `np.load` result) -> the port's state dict (the
    same keys)."""
    state = {key: _t(arrays[key]) for key in arrays}
    if "word_weight" not in state:
        raise MXNetError("not a TransformerLM parameter file: no "
                         "'word_weight' among %s" % sorted(arrays)[:8])
    return state


def npz_from_state(state, dropout=0.0):
    """The port's state dict -> the arrays of the JAX package's
    ``-lm.params`` (its ``load_lm`` reads the file unchanged). A state
    dict of an LM built with ``dropout`` has the JAX package's keys
    already; one whose cells start at another child index has them
    renumbered from the one ``dropout`` gives."""
    cells = sorted({int(m.group(1)) for m in map(_CELL_KEY.match, state)
                    if m is not None})
    renumber = {c: i + _cell_offset(dropout) for i, c in enumerate(cells)}
    out = {}
    for key, value in state.items():
        m = _CELL_KEY.match(key)
        if m is not None:
            key = "%d.%s" % (renumber[int(m.group(1))], m.group(2))
        out[key] = value.detach().float().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# ResNet v1
# ---------------------------------------------------------------------------

_RESNET_KEY = re.compile(
    r"^(?:stage(\d+)_)?(conv2d|batchnorm|dense)(\d+)_"
    r"(weight|bias|gamma|beta|running_mean|running_var)$")
_BN_FIELDS = ("gamma", "beta", "running_mean", "running_var")


def _kernel_hw(shape, layout):
    return tuple(shape[1:3]) if layout == "NHWC" else tuple(shape[2:4])


def resnet_params_from_jax(params, layout="NHWC", fuse_epilogue=None):
    """The JAX package's ResNet v1 parameters -> the port's `ResNetV1`
    state dict.

    ``params``: name -> numpy array, as ``{k: p.data().asnumpy() for k, p
    in net.collect_params().items()}``, running statistics included, for a
    net built under ``layout`` ("NHWC" inside `layout_scope`, else
    "NCHW"). The names are parsed into (stage, layer type, creation index)
    and placed by the block structure they imply: the block type from the
    first stage's first conv (1x1: bottleneck, 3 convs a block; 3x3: basic,
    2), a downsample conv and BN after the first block's body when a stage
    has one more conv than whole blocks, and a thumbnail stem when there is
    no stem BatchNorm. The keys are those of the graph ``fuse_epilogue``
    names (default: the zoo's, from ``MXTPU_PALLAS_CONV_EPILOGUE``), whose
    reference form holds each ReLU as a paramless ``Activation`` child, as
    the JAX package's does. Raises `MXNetError` on a name, a count or a
    shape it cannot place. The same net's parameters also place by name
    (`vision_params_from_jax`)."""
    from .gluon.model_zoo.vision.resnet import _fuse_epilogue_default

    fused = _fuse_epilogue_default(fuse_epilogue)
    step = 2 if fused else 3    # body children a conv, its BN (, ReLU)
    if layout not in ("NHWC", "NCHW"):
        raise MXNetError("layout must be NHWC or NCHW, got %r" % (layout,))
    prefixes = {k.split("_", 1)[0] for k in params}
    if len(prefixes) != 1:
        raise MXNetError("not one network's parameters: prefixes %s"
                         % sorted(prefixes))
    top = {}      # (kind, index) -> {field: array}
    stages = {}   # stage -> {(kind, index): {field: array}}
    for key, value in params.items():
        m = _RESNET_KEY.match(key.split("_", 1)[1] if "_" in key else key)
        if m is None:
            raise MXNetError("cannot place ResNet parameter %r" % key)
        stage, kind, idx, field = m.groups()
        where = top if stage is None else stages.setdefault(int(stage), {})
        where.setdefault((kind, int(idx)), {})[field] = _np.asarray(value)

    state = {}

    def conv(dst, entry, label):
        w = entry.get("weight") if entry else None
        if w is None or w.ndim != 4 or set(entry) != {"weight"}:
            raise MXNetError("%s: expected one 4-D conv weight, got %s"
                             % (label, {k: v.shape for k, v in
                                        (entry or {}).items()}))
        state[dst + ".weight"] = _t(w)
        return w.shape[0]

    def bn(dst, entry, channels, label):
        if entry is None or set(entry) != set(_BN_FIELDS):
            raise MXNetError("%s: expected BatchNorm %s, got %s"
                             % (label, _BN_FIELDS, sorted(entry or {})))
        for f in _BN_FIELDS:
            if entry[f].shape != (channels,):
                raise MXNetError("%s_%s: shape %s, the conv before it has %d "
                                 "channels" % (label, f, entry[f].shape,
                                               channels))
            state["%s.%s" % (dst, f)] = _t(entry[f])

    if set(top) - {("conv2d", 0), ("batchnorm", 0), ("dense", 0)}:
        raise MXNetError("unexpected top-level layers %s" % sorted(top))
    c0 = conv("features.0", top.get(("conv2d", 0)), "conv2d0")
    offset = 1
    if ("batchnorm", 0) in top:     # 7x7 stem: conv, BN (, ReLU), max pool
        bn("features.1", top[("batchnorm", 0)], c0, "batchnorm0")
        offset = 3 if fused else 4
    if sorted(stages) != list(range(1, len(stages) + 1)) or not stages:
        raise MXNetError("stages must be 1..n, got %s" % sorted(stages))
    first = stages[1].get(("conv2d", 0), {}).get("weight")
    if first is None or first.ndim != 4:
        raise MXNetError("stage1_conv2d0_weight missing or not 4-D")
    per = {(1, 1): 3, (3, 3): 2}.get(_kernel_hw(first.shape, layout))
    if per is None:
        raise MXNetError("cannot tell the block type from stage1_conv2d0 "
                         "kernel %s" % (_kernel_hw(first.shape, layout),))
    for s in sorted(stages):
        layers = stages[s]
        n = sum(1 for kind, _ in layers if kind == "conv2d")
        if sorted(layers) != sorted([("conv2d", k) for k in range(n)]
                                    + [("batchnorm", k) for k in range(n)]):
            raise MXNetError("stage%d: conv2d and batchnorm indices must "
                             "both be 0..%d, got %s"
                             % (s, n - 1, sorted(layers)))
        ds = n % per
        if ds > 1 or n < per:
            raise MXNetError("stage%d: %d convs do not make %d-conv blocks "
                             "(+ one downsample)" % (s, n, per))
        for k in range(n):
            if k < per:
                dst = "features.%d.0.body.%d" % (offset + s - 1, step * k)
            elif ds and k == per:
                dst = "features.%d.0.downsample.0" % (offset + s - 1)
            else:
                j = k - per - ds
                dst = "features.%d.%d.body.%d" % (offset + s - 1,
                                                  1 + j // per,
                                                  step * (j % per))
            label = "stage%d_conv2d%d" % (s, k)
            c = conv(dst, layers[("conv2d", k)], label)
            head, pos = dst.rsplit(".", 1)
            bn("%s.%d" % (head, int(pos) + 1), layers[("batchnorm", k)], c,
               "stage%d_batchnorm%d" % (s, k))
    dense = top.get(("dense", 0))
    if dense is None or set(dense) != {"weight", "bias"} \
            or dense["weight"].ndim != 2 \
            or dense["bias"].shape != dense["weight"].shape[:1]:
        raise MXNetError("dense0: expected weight (classes, C) and bias "
                         "(classes,), got %s" % {k: v.shape for k, v in
                                                 (dense or {}).items()})
    state["output.weight"] = _t(dense["weight"])
    state["output.bias"] = _t(dense["bias"])
    return state


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

_BERT_KEY = re.compile(r"^(.*?)bertmodel\d+_(.+)$")
_BERT_TOP = {"word_weight": "word_embed.weight",
             "segment_weight": "token_type_embed.weight",
             "pos_weight": "position_embed.weight",
             "layernorm0_gamma": "embed_norm.gamma",
             "layernorm0_beta": "embed_norm.beta",
             "pooler_weight": "pooler.weight", "pooler_bias": "pooler.bias"}
_BERT_CELL = re.compile(
    r"^transformerencoder\d+_layer(\d+)_(?:multiheadattention\d+_"
    r"(query|key|value|out)|positionwiseffn\d+_(ffn1|ffn2)|"
    r"layernorm([01]))_(weight|bias|gamma|beta)$")
_BERT_ATT = {"query": "proj_query", "key": "proj_key", "value": "proj_value",
             "out": "proj_out"}
_BERT_NORM = {"0": "attention_norm", "1": "ffn_norm"}


def bert_params_from_jax(params):
    """The JAX package's `BERTModel` parameters -> the port's state dict.

    ``params``: name -> numpy array, as ``{k: p.data().asnumpy() for k, p
    in net.collect_params().items()}`` of a `BERTModel`, or of a block that
    holds one and one output Dense (as bench.py's pretraining block: the
    BERT and an MLM head). The names are parsed by structure (embeddings,
    the embedding norm, ``layer<i>``'s attention projections, norms and
    FFN, the pooler); the layers must be 0..n-1, each complete. Without a
    head the keys are those of the port's `BERTModel`; with one they are
    prefixed ``bert.`` and the head's are ``mlm.weight`` and ``mlm.bias``:
    the state dict of a module whose children are ``bert`` and ``mlm``, as
    bench.py's pretraining block. Raises `MXNetError` on a name it cannot
    place."""
    state, rest, prefixes, layers = {}, {}, set(), {}
    for key, value in params.items():
        m = _BERT_KEY.match(key)
        if m is None:
            rest[key] = value
            continue
        prefixes.add(m.group(1))
        name = m.group(2)
        if name in _BERT_TOP:
            state[_BERT_TOP[name]] = _t(value)
            continue
        c = _BERT_CELL.match(name)
        if c is None:
            raise MXNetError("cannot place BERT parameter %r" % key)
        layer, att, ffn, norm, field = c.groups()
        if att:
            path = "attention.%s" % _BERT_ATT[att]
        elif ffn:
            path = "ffn.ffn_%s" % ffn[-1]
        else:
            path = _BERT_NORM[norm]
        layers.setdefault(int(layer), set()).add("%s.%s" % (path, field))
        state["encoder.%s.%s.%s" % (layer, path, field)] = _t(value)
    if len(prefixes) != 1:
        raise MXNetError("not one BERT model's parameters: prefixes %s"
                         % sorted(prefixes))
    missing = sorted(set(_BERT_TOP.values()) - set(state))
    if missing:
        raise MXNetError("BERT parameters missing: %s" % missing)
    full = set(layers.get(0, ()))
    if sorted(layers) != list(range(len(layers))) or len(full) != 16 \
            or any(fields != full for fields in layers.values()):
        raise MXNetError("BERT layers must be 0..n-1 with 16 parameters "
                         "each, got %s" % {i: len(f) for i, f in
                                           sorted(layers.items())})
    if not rest:
        return state
    dense = {}
    for key, value in rest.items():
        m = re.match(r"^(.*)_(weight|bias)$", key)
        if m is None:
            raise MXNetError("cannot place parameter %r" % key)
        dense.setdefault(m.group(1), {})[m.group(2)] = value
    if len(dense) != 1 or set(next(iter(dense.values()))) != {"weight",
                                                             "bias"}:
        raise MXNetError("expected one head Dense (weight and bias) beside "
                         "the BERT model, got %s" % sorted(rest))
    out = {"bert." + k: v for k, v in state.items()}
    for field, value in next(iter(dense.values())).items():
        out["mlm." + field] = _t(value)
    return out


# ---------------------------------------------------------------------------
# the vision nets built as the JAX package builds them
# ---------------------------------------------------------------------------

def _net_prefix(names):
    """The top block's prefix of a net's parameter names (its alias and
    count, ``inception30_``): the part before the first "_", shared by
    all."""
    prefixes = {n.split("_", 1)[0] + "_" for n in names}
    if len(prefixes) != 1:
        raise MXNetError("not one network's parameters: prefixes %s"
                         % sorted(prefixes))
    return prefixes.pop()


def vision_params_from_jax(params, net):
    """The JAX package's parameters of a vision net -> the state dict of
    the port's ``net`` of the same family and configuration (ResNet v2,
    AlexNet, VGG, SqueezeNet, DenseNet, Inception V3, MobileNet v1 / v2),
    built under the same layout.

    ``params``: name -> numpy array, as ``{k: p.data().asnumpy() for k, p
    in jnet.collect_params().items()}``, running statistics included. Both
    packages name a parameter by its block's prefix chain, which differs
    between the two nets only in the top block's count
    (``inception30_conv0_weight`` against ``inception31_conv0_weight``);
    each array goes to the port parameter of that name, under its module
    path (``features.0.0.weight``, the `state_dict` key). Both store a
    conv weight as the layout gives it, (O, *k, I/g) channels-last, so no
    array is transposed. Raises `MXNetError` on a name it cannot place, a
    port parameter left without an array, or a shape that differs (a
    dimension the port net has not inferred yet, 0, takes the array's).
    Load the result with ``net.load_state_dict`` once the net's
    parameters exist (after a first forward when a shape was deferred)."""
    ours = net._collect_params_with_prefix()
    if not params or not ours:
        raise MXNetError("no parameters to place")
    jprefix = _net_prefix(params)
    tprefix = _net_prefix([p.name for p in ours.values()])
    by_name = {}
    for path, p in ours.items():
        by_name.setdefault(p.name[len(tprefix):], []).append((path, p))
    state, missing = {}, []
    for rest, places in by_name.items():
        key = jprefix + rest
        if key not in params:
            missing.append(key)
            continue
        arr = _np.asarray(params[key])
        for path, p in places:
            shape = p.shape or ()
            if len(shape) != arr.ndim or any(
                    s not in (0, a) for s, a in zip(shape, arr.shape)):
                raise MXNetError("%s: the JAX array has shape %s, the port "
                                 "parameter %s" % (key, arr.shape, shape))
            state[path] = _t(arr)
    extra = sorted(set(params) - {jprefix + r for r in by_name})
    if missing or extra:
        raise MXNetError("cannot place the parameters onto %s: missing %s, "
                         "not in the port net %s"
                         % (type(net).__name__, missing[:8], extra[:8]))
    return state


# ---------------------------------------------------------------------------
# Word LM
# ---------------------------------------------------------------------------

_WORD_LM_KEY = re.compile(
    r"^(.*?)(embed_weight|embed_bias|decoder_weight|decoder_bias|"
    r"lstm_([lr]\d+_(?:i2h|h2h)_(?:weight|bias)))$")


def word_lm_params_from_jax(params):
    """The JAX package's word-LM `RNNModel` parameters -> the port's
    `RNNModel` state dict.

    ``params``: name -> numpy array, as ``{k: p.data().asnumpy() for k, p
    in net.collect_params().items()}`` (``rnnmodel0_embed_weight``,
    ``rnnmodel0_lstm_l0_i2h_weight``, ..., ``rnnmodel0_decoder_weight``).
    A model built with ``tie_weights`` has no decoder weight: its decoder
    shares ``embed_weight`` and its bias is ``embed_bias``. The shared
    weight is one name there and fills both of the port's keys
    (``embedding.weight`` and ``decoder.weight``, one `Parameter`). Raises
    `MXNetError` on a name it cannot place, or on a missing one."""
    state, prefixes = {}, set()
    for key, value in params.items():
        m = _WORD_LM_KEY.match(key)
        if m is None:
            raise MXNetError("cannot place word-LM parameter %r" % key)
        prefixes.add(m.group(1))
        name, lstm = m.group(2), m.group(3)
        if lstm is not None:
            state["rnn." + lstm] = _t(value)
        elif name == "embed_weight":
            state["embedding.weight"] = _t(value)
        else:   # embed_bias is the tied decoder's bias
            state["decoder." + name.split("_")[1]] = _t(value)
    if len(prefixes) != 1:
        raise MXNetError("not one word-LM model's parameters: prefixes %s"
                         % sorted(prefixes))
    tied = not any(k.endswith("decoder_weight") for k in params)
    if tied:
        if "embedding.weight" in state:
            state["decoder.weight"] = state["embedding.weight"]
    elif any(k.endswith("embed_bias") for k in params):
        raise MXNetError("embed_bias beside a decoder weight: not one word-LM "
                         "model's parameters")
    missing = sorted({"embedding.weight", "decoder.weight", "decoder.bias"}
                     - set(state))
    if missing or not any(k.startswith("rnn.") for k in state):
        raise MXNetError("word-LM parameters missing: %s"
                         % (missing or ["rnn.*"]))
    return state


# ---------------------------------------------------------------------------
# Symbolic Module
# ---------------------------------------------------------------------------

def module_params_from_jax(arg_params, aux_params, device):
    """The JAX package's `Module` parameters -> the port's: ``(arg_params,
    aux_params)`` of NDArrays on ``device``, for `Module.init_params` /
    `set_params`. ``arg_params`` / ``aux_params``: name -> numpy array (or
    anything with ``asnumpy``), as ``{k: v.asnumpy() for k, v in
    mod.get_params()[0].items()}``. Symbolic parameters keep their graph
    names in both packages (``fc1_weight``, ``lstm_parameters``,
    ``bn0_moving_mean``), so nothing is renamed; the dtype is kept."""
    from .ndarray import array

    def move(params):
        out = {}
        for k, v in (params or {}).items():
            a = _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
            out[k] = array(a, ctx=device, dtype=a.dtype)
        return out

    return move(arg_params), move(aux_params)

