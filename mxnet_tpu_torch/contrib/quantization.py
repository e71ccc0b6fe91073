"""Model quantization (counterpart of
`mxnet_tpu/contrib/quantization.py`).

The reference's `python/mxnet/contrib/quantization.py` (`quantize_model`
:422 — graph pass src/operator/quantization/quantize_graph_pass.cc +
calibration). The pass rewrites FullyConnected / Convolution nodes into
quantize_v2 -> quantized_* (the int8 GEMM of `ops/quantization.py`) ->
dequantize chains. The graph pass, the BatchNorm fold, the KL search and
`quantize_params` are the JAX package's numpy code as it is, so the two
packages give the same graph and the same int8 weights bit for bit.
Calibration runs the float graph's internals on the device of the
calibration batches (the parameters are moved there), under no_grad.
Calibration modes:

- 'none'   — runtime min/max per batch (quantize_v2 without calib ranges)
- 'naive'  — exact min/max of each quantized input collected over the
             calibration set (reference: collect_layer_output_min_max)
- 'entropy'— KL-divergence threshold search over layer-output histograms
             (reference: contrib/quantization.py _get_optimal_threshold —
             minimize KL(P||Q) between the clipped fp32 distribution P and
             its 255-bin int8 quantization Q over candidate thresholds)
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from ..base import MXNetError
from ..symbol.symbol import Symbol, _Node

__all__ = ["quantize_model", "quantize_graph", "quantize_params",
           "fold_batch_norm"]


def fold_batch_norm(sym, arg_params, aux_params):
    """Fold inference-mode BatchNorm into the preceding Convolution /
    FullyConnected weights and bias (y = s*(Wx+b-mean)+beta with
    s = gamma/sqrt(var+eps) becomes W'=s*W, b'=s*(b-mean)+beta).

    Deployment pre-pass for int8: with BN folded, conv->relu->pool chains
    quantize into one int8 segment (the reference reaches the same effect
    via its MKLDNN subgraph fusion backend before quantize_graph_pass.cc
    runs). Returns (new_sym, new_arg_params, new_aux_params); the folded
    BN's parameters are dropped from the dicts."""
    params = dict(arg_params)
    auxs = dict(aux_params)

    def value(name):
        v = params.get(name, auxs.get(name))
        if v is None:
            return None
        return _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)

    counts = {}
    for node in sym._topo():
        for e in node.inputs:
            counts[id(e[0])] = counts.get(id(e[0]), 0) + 1
    for n, _ in sym._outputs:
        counts[id(n)] = counts.get(id(n), 0) + 1

    def _axis_matches(bn, conv):
        # folding scales weight dim 0 (output channels); only valid when
        # BN normalizes the conv/FC channel axis
        axis = int(bn.attrs.get("axis", 1))
        if conv.op == "FullyConnected":
            # flatten=True (the default) makes the output 2-D so axis 1 is
            # the hidden axis; with flatten=False only axis=-1 is safe
            if str(conv.attrs.get("flatten", True)) in ("True", "1"):
                return axis in (1, -1)
            return axis == -1
        layout = str(conv.attrs.get("layout") or "NCHW")
        return axis % len(layout) == layout.index("C")

    def _try_fold(node):
        """The folded replacement node, or None when folding is invalid —
        every guard funnels to the shared copy path."""
        prod_edge = node.inputs[0] if node.inputs else None
        prod = prod_edge[0] if prod_edge else None
        if not (node.op == "BatchNorm" and prod is not None
                and prod.op in ("Convolution", "FullyConnected")
                and prod_edge[1] == 0 and counts.get(id(prod)) == 1
                and not node.attrs.get("output_mean_var", False)
                and _axis_matches(node, prod)
                and all(e[0].is_var for e in node.inputs[1:])
                and prod.inputs[1][0].is_var):
            return None
        # every folded-into or dropped parameter var must have exactly ONE
        # consumer: scaling a tied weight or popping shared BN stats would
        # corrupt the other consumers
        if any(counts.get(id(e[0])) != 1
               for e in [prod.inputs[1]] + list(node.inputs[1:5])):
            return None
        g_n, b_n, m_n, v_n = (e[0].name for e in node.inputs[1:5])
        w_name = prod.inputs[1][0].name
        gamma, beta = value(g_n), value(b_n)
        mean, var = value(m_n), value(v_n)
        w = value(w_name)
        no_bias = str(prod.attrs.get("no_bias", False)) in ("True", "1")
        b_edge = None if no_bias or len(prod.inputs) < 3 else prod.inputs[2]
        if b_edge is not None and (not b_edge[0].is_var
                                   or counts.get(id(b_edge[0])) != 1):
            return None
        b_name = b_edge[0].name if b_edge is not None else None
        if any(x is None for x in (gamma, beta, mean, var, w)) or \
                (b_name is not None and value(b_name) is None):
            return None
        # attr defaults MUST mirror the op's execution defaults
        # (ops/nn.py batch_norm: eps=1e-3, fix_gamma=True), or a BN built
        # without explicit attrs folds to a different function
        eps = float(node.attrs.get("eps", 1e-3))
        if str(node.attrs.get("fix_gamma", True)) in ("True", "1"):
            gamma = _np.ones_like(gamma)
        s = gamma / _np.sqrt(var + eps)
        bias = value(b_name) if b_name is not None \
            else _np.zeros(w.shape[0], w.dtype)
        params[w_name] = w * s.reshape((-1,) + (1,) * (w.ndim - 1))
        new_b_name = b_name or (prod.name + "_folded_bias")
        params[new_b_name] = (bias - mean) * s + beta
        for p in (g_n, b_n, m_n, v_n):
            params.pop(p, None)
            auxs.pop(p, None)
        attrs = dict(prod.attrs)
        attrs["no_bias"] = False
        bias_var = _Node(None, new_b_name, {})
        return _Node(prod.op, prod.name, attrs,
                     [(mapping[id(prod.inputs[0][0])], prod.inputs[0][1]),
                      (mapping[id(prod.inputs[1][0])], prod.inputs[1][1]),
                      (bias_var, 0)])

    mapping = {}
    for node in sym._topo():
        if node.is_var:
            n = _Node(None, node.name, dict(node.attrs))
            n._shape, n._dtype = node._shape, node._dtype
            mapping[id(node)] = n
            continue
        folded = _try_fold(node)
        mapping[id(node)] = folded if folded is not None else _Node(
            node.op, node.name, dict(node.attrs),
            [(mapping[id(e[0])], e[1]) for e in node.inputs],
            node.aux_slots)
    new_sym = Symbol([(mapping[id(n)], i) for n, i in sym._outputs])
    return new_sym, params, auxs

_QUANTIZABLE = {"FullyConnected", "Convolution"}

# ops that run IN the int8 domain when fed by a quantized producer
# (reference: FQuantizedOp registrations in quantized_activation.cc,
# quantized_flatten.cc, quantized_pooling.cc, quantized_concat.cc). The
# pass consumes the producer's (int8, min, max) directly, so the graph
# stops dequantizing around relu/flatten/pool/concat nodes.
_INT8_PASSTHROUGH = {
    "Activation": "_contrib_quantized_act",
    "relu": "_contrib_quantized_act",
    "Flatten": "_contrib_quantized_flatten",
    "flatten": "_contrib_quantized_flatten",
    "Pooling": "_contrib_quantized_pooling",
    "Concat": "_contrib_quantized_concat",
    "concat": "_contrib_quantized_concat",
}

# the attrs each quantized passthrough kernel understands
_PASSTHROUGH_KEEP = {
    "_contrib_quantized_act": ("act_type",),
    "_contrib_quantized_flatten": (),
    "_contrib_quantized_pooling": ("kernel", "pool_type", "global_pool",
                                   "stride", "pad", "pooling_convention",
                                   "count_include_pad"),
    "_contrib_quantized_concat": ("dim", "num_args"),
}


def _can_passthrough(node, qop):
    if qop == "_contrib_quantized_act":
        return node.op == "relu" or node.attrs.get("act_type") == "relu"
    if qop == "_contrib_quantized_pooling":
        return node.attrs.get("pool_type", "max") in ("max", "avg")
    return True


def _can_quantize(node):
    """Conv variants the int8 kernel doesn't cover stay fp32 (reference
    skips them in quantize_graph_pass.cc the same way)."""
    if node.op == "Convolution":
        dil = tuple(node.attrs.get("dilate") or (1, 1))
        ng = int(node.attrs.get("num_group") or 1)
        if dil not in ((), (1, 1)) or ng != 1:
            return False
    return True


def _kl_divergence(p, q):
    """KL(P||Q), both unnormalized counts. Each is normalized by its FULL
    mass (not just P's support) so mass Q fails to place where P has it is
    charged — masking+renormalizing Q over P's support would score a
    single-spike P as a perfect match for any Q."""
    p = p.astype(_np.float64)
    q = q.astype(_np.float64)
    psum, qsum = p.sum(), q.sum()
    if psum == 0.0:
        return 0.0
    if qsum == 0.0:
        return _np.inf
    p = p / psum
    q = q / qsum
    mask = p > 0
    return float(_np.sum(p[mask] * _np.log(p[mask] /
                                           _np.maximum(q[mask], 1e-12))))


def _optimal_threshold(hist, amax, num_quantized_bins=255):
    """KL-minimizing symmetric clip threshold from an |value| histogram
    (reference: contrib/quantization.py _get_optimal_threshold — the
    TensorRT-style search: for each candidate bin count i, fold outliers
    into the edge bin to form P, quantize P's support into
    num_quantized_bins to form Q, keep the threshold with least KL)."""
    num_bins = hist.size
    if amax == 0.0 or hist.sum() == 0:
        return amax
    best_div, best_i = _np.inf, num_bins
    hist = hist.astype(_np.float64)
    tail = _np.concatenate([_np.cumsum(hist[::-1])[::-1][1:], [0.0]])
    for i in range(num_quantized_bins, num_bins + 1, 2):
        sliced = hist[:i]
        p = sliced.copy()
        p[i - 1] += tail[i - 1]          # clipped outliers -> edge bin
        idx = _np.arange(i) * num_quantized_bins // i
        # Q is built from the UNFOLDED slice (reference quantization.py
        # _get_optimal_threshold): P carries the clipped-outlier mass in its
        # edge bin but Q cannot represent it, so KL(P||Q) charges each
        # candidate threshold for what it clips. Folding the tail into Q too
        # would make Q==P at i==num_quantized_bins (identity bin map) and the
        # search would degenerate to always picking the smallest threshold.
        counts = _np.bincount(idx, weights=sliced, minlength=num_quantized_bins)
        nz = (p > 0).astype(_np.float64)
        denom = _np.bincount(idx, weights=nz, minlength=num_quantized_bins)
        # expand Q back over P's support: each nonzero source bin gets its
        # quantized bin's mass split evenly over that bin's nonzero sources
        q = _np.where(nz > 0, counts[idx] / _np.maximum(denom[idx], 1.0), 0.0)
        div = _kl_divergence(p, q)
        if div < best_div:
            best_div, best_i = div, i
    return (best_i + 0.5) * amax / num_bins


def _tensor(v):
    v = v._data if hasattr(v, "_data") else v
    return v if torch.is_tensor(v) else torch.as_tensor(_np.asarray(v))


def _host(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _iter_calib(sym, arg_params, aux_params, calib_data, num_calib_examples):
    """Yield lists of per-internal-output numpy arrays per batch. The graph
    runs on the device of the batch's first data array, the parameters
    moved there once."""
    internals = sym.get_internals()
    seen = 0
    params = None
    for batch in calib_data:
        values = {}
        for name, arr in zip(calib_data.provide_data, batch.data):
            values[name.name if hasattr(name, "name") else name[0]] = arr
        for name, arr in zip(getattr(calib_data, "provide_label", []) or [],
                             batch.label or []):
            values[name.name if hasattr(name, "name") else name[0]] = arr
        values = {k: _tensor(v) for k, v in values.items()}
        dev = next(iter(values.values())).device
        if params is None:
            params = {k: _tensor(v).to(dev)
                      for d in (arg_params, aux_params) for k, v in d.items()}
        values = {k: v.to(dev) for k, v in values.items()}
        values.update(params)
        with torch.no_grad():
            outs = internals._interpret(values, device=dev)
        yield [((node, idx), _host(out))
               for (node, idx), out in zip(internals._outputs, outs)]
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    calib_data.reset()


def _collect_ranges(sym, arg_params, aux_params, calib_data,
                    num_calib_examples, mode, data_names=("data",),
                    label_names=("softmax_label",), num_bins=8001):
    """Run calibration batches through every internal output, returning
    {(node_id, out_idx): (min, max)} (reference:
    _LayerOutputMinMaxCollector / _LayerHistogramCollector)."""
    samples = {}
    if mode != "entropy":
        for batch_outs in _iter_calib(sym, arg_params, aux_params,
                                      calib_data, num_calib_examples):
            for (node, idx), a in batch_outs:
                key = (id(node), idx)
                mn, mx = float(a.min()), float(a.max())
                if key in samples:
                    omn, omx = samples[key]
                    samples[key] = (min(omn, mn), max(omx, mx))
                else:
                    samples[key] = (mn, mx)
        return samples
    # entropy: pass 1 finds each tensor's |max| (fixing its histogram
    # range), pass 2 accumulates histograms, then the KL search picks the
    # clip threshold per tensor
    amax = {}
    for batch_outs in _iter_calib(sym, arg_params, aux_params, calib_data,
                                  num_calib_examples):
        for (node, idx), a in batch_outs:
            key = (id(node), idx)
            m = float(_np.abs(a).max()) if a.size else 0.0
            amax[key] = max(amax.get(key, 0.0), m)
    hists = {k: _np.zeros(num_bins, _np.int64) for k in amax}
    for batch_outs in _iter_calib(sym, arg_params, aux_params, calib_data,
                                  num_calib_examples):
        for (node, idx), a in batch_outs:
            key = (id(node), idx)
            if amax[key] > 0 and a.size:
                h, _ = _np.histogram(_np.abs(a.reshape(-1)), bins=num_bins,
                                     range=(0.0, amax[key]))
                hists[key] += h
    for key in amax:
        thr = _optimal_threshold(hists[key], amax[key])
        samples[key] = (-thr, thr)
    return samples


def quantize_graph(sym, excluded_sym_names=(), calib_ranges=None,
                   weight_ranges=None, quantized_dtype="int8"):
    """Rewrite the graph, returning the quantized Symbol (reference:
    quantize_graph_pass.cc QuantizeGraph)."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported (reference "
                         "uint8 path is MKLDNN-specific)")
    excluded = set(excluded_sym_names)
    calib_ranges = calib_ranges or {}
    mapping = {}  # id(old node) -> new node
    offline_vars = {}  # weight name -> (qwv, mnv, mxv) var nodes, shared by
    #                    every quantized consumer of that weight (duplicate
    #                    same-named vars would corrupt list_arguments())

    def new_edge(old_node, idx):
        return (mapping[id(old_node)], idx)

    _INT32_PRODUCERS = {"_contrib_quantized_conv",
                        "_contrib_quantized_fully_connected"}

    def int8_sources(deq, name, cal=None):
        """(q, min, max) edges in int8 from a pass-inserted dequantize
        producer. Quantized conv/FC emit an int32 ACCUMULATOR — feeding it
        onward as int8 would wrap — so a requantize (int32 -> int8,
        reference requantize-inl.h) is inserted, calibrated when the
        original edge has a collected range."""
        q_e, mn_e, mx_e = deq.inputs
        if q_e[0].op in _INT32_PRODUCERS:
            attrs = {}
            if cal is not None:
                attrs = {"min_calib_range": cal[0], "max_calib_range": cal[1]}
            rq = _Node("_contrib_requantize", name + "_requantize", attrs,
                       [q_e, mn_e, mx_e])
            return ((rq, 0), (rq, 1), (rq, 2))
        return (q_e, mn_e, mx_e)

    for node in sym._topo():
        if node.is_var:
            n = _Node(None, node.name, dict(node.attrs))
            n._shape, n._dtype = node._shape, node._dtype
            mapping[id(node)] = n
            continue
        if node.op in _QUANTIZABLE and node.name not in excluded \
                and _can_quantize(node):
            data_edge = node.inputs[0]
            w_edge = node.inputs[1]
            no_bias = bool(node.attrs.get("no_bias", False))
            b_edge = None if (no_bias or len(node.inputs) < 3) else node.inputs[2]

            src = new_edge(*data_edge)
            if src[0].op == "_contrib_dequantize" and src[1] == 0:
                # the producer is a dequantize this pass inserted: consume
                # its int8 sources directly instead of paying a
                # dequantize->quantize_v2 round trip (reference: the
                # requantize/dequantize fusion in quantize_graph_pass.cc)
                d_edges = int8_sources(
                    src[0], node.name,
                    calib_ranges.get((id(data_edge[0]), data_edge[1])))
            else:
                cal = calib_ranges.get((id(data_edge[0]), data_edge[1]))
                qattrs = {}
                if cal is not None:
                    qattrs = {"min_calib_range": cal[0],
                              "max_calib_range": cal[1]}
                qdata = _Node("_contrib_quantize_v2",
                              node.name + "_quantize", qattrs, [src])
                d_edges = ((qdata, 0), (qdata, 1), (qdata, 2))
            if w_edge[0].is_var and w_edge[1] == 0:
                # weight is a parameter: quantize OFFLINE. The graph gets
                # `<name>_quantize{,_min,_max}` vars which quantize_params
                # fills from the fp32 weight once, so the compiled step
                # never re-reads fp32 weights or recomputes their ranges
                # (reference: quantize_graph_pass.cc renames the weight
                # entry and _quantize_params materializes it).
                base = w_edge[0].name + "_quantize"
                if base in offline_vars:
                    # weight shared by multiple quantized consumers: reuse
                    # the var triple created for the first one (reference
                    # renames a single shared entry; fresh same-named vars
                    # here would yield duplicate argument names)
                    qwv, mnv, mxv = offline_vars[base]
                else:
                    qwv = _Node(None, base, {})
                    if w_edge[0]._shape is not None:
                        qwv._shape = w_edge[0]._shape
                    qwv._dtype = _np.int8
                    mnv = _Node(None, base + "_min", {})
                    mxv = _Node(None, base + "_max", {})
                    mnv._shape = mxv._shape = (1,)
                    mnv._dtype = mxv._dtype = _np.float32
                    offline_vars[base] = (qwv, mnv, mxv)
                w_edges = ((qwv, 0), (mnv, 0), (mxv, 0))
            else:
                # computed weight (rare): quantize at runtime
                qweight = _Node("_contrib_quantize_v2",
                                node.name + "_qweight", {},
                                [new_edge(*w_edge)])
                w_edges = ((qweight, 0), (qweight, 1), (qweight, 2))
            qop = "_contrib_quantized_fully_connected" \
                if node.op == "FullyConnected" else "_contrib_quantized_conv"
            qin = [d_edges[0], w_edges[0]]
            # bias (fp32; quantized inside the op) or a zero placeholder
            if b_edge is not None:
                qin.append(new_edge(*b_edge))
            # only the attrs the quantized kernels understand survive
            # (reference filters the same way in quantize_graph_pass.cc)
            keep = ("num_hidden", "no_bias", "flatten") \
                if node.op == "FullyConnected" \
                else ("kernel", "stride", "pad", "num_filter", "no_bias")
            attrs = {k: v for k, v in node.attrs.items() if k in keep}
            attrs["no_bias"] = b_edge is None
            if b_edge is None:
                # quantized op signature has a bias slot; reuse weight as a
                # dummy — no_bias=True means it is never read
                qin.append(w_edges[0])
            qin += [d_edges[1], d_edges[2], w_edges[1], w_edges[2]]
            qnode = _Node(qop, node.name + "_quantized", attrs, qin)
            deq = _Node("_contrib_dequantize", node.name + "_dequantize", {},
                        [(qnode, 0), (qnode, 1), (qnode, 2)])
            mapping[id(node)] = deq
        elif (node.op in _INT8_PASSTHROUGH and node.name not in excluded
              and _can_passthrough(node, _INT8_PASSTHROUGH[node.op])
              and all(mapping[id(e[0])].op == "_contrib_dequantize"
                      and e[1] == 0 for e in node.inputs)):
            qop = _INT8_PASSTHROUGH[node.op]
            # every producer is a dequantize the pass itself inserted:
            # consume its int8 sources directly and re-wrap the result,
            # keeping the whole segment in the quantized domain (the
            # intermediate dequantize drops out at graph rebuild)
            srcs = [int8_sources(mapping[id(e[0])],
                                 "%s_in%d" % (node.name, i),
                                 calib_ranges.get((id(e[0]), e[1])))
                    for i, e in enumerate(node.inputs)]
            attrs = {k: v for k, v in node.attrs.items()
                     if k in _PASSTHROUGH_KEEP[qop]}
            if qop == "_contrib_quantized_act":
                attrs.setdefault("act_type", "relu")
            if qop == "_contrib_quantized_concat":
                attrs["num_args"] = len(srcs)
                qin = [s[0] for s in srcs]
                for s in srcs:
                    qin += [s[1], s[2]]
            else:
                qin = list(srcs[0])
            qnode = _Node(qop, node.name + "_quantized", attrs, qin)
            deq = _Node("_contrib_dequantize", node.name + "_dequantize", {},
                        [(qnode, 0), (qnode, 1), (qnode, 2)])
            mapping[id(node)] = deq
        else:
            n = _Node(node.op, node.name, dict(node.attrs),
                      [new_edge(*e) for e in node.inputs], node.aux_slots)
            mapping[id(node)] = n
    outs = [(mapping[id(n)], i) for n, i in sym._outputs]
    return Symbol(outs)


def quantize_params(qsym, arg_params):
    """Materialize the offline-quantized weight params a quantize_graph
    symbol expects: for every `<w>_quantize` var, the int8 tensor plus its
    `_min`/`_max` range scalars computed from the fp32 param `<w>`
    (reference: contrib/quantization.py _quantize_params). Params still
    consumed in fp32 (biases, excluded layers) pass through; fp32 weights
    whose only consumer was the quantized op are dropped."""
    from ..ndarray import array as _nd_array

    out = {}
    var_names = [n.name for n in qsym._topo() if n.is_var]
    for name in var_names:
        if name.endswith("_quantize"):
            orig = name[:-len("_quantize")]
            if orig not in arg_params:
                raise MXNetError(
                    "quantize_params: no fp32 source param %r for %r"
                    % (orig, name))
            v = arg_params[orig]
            w = _np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v,
                            _np.float32)
            mn, mx = float(w.min()), float(w.max())
            scale = 127.0 / max(abs(mn), abs(mx), 1e-20)
            qw = _np.clip(_np.round(w * scale), -127, 127).astype(_np.int8)
            out[name] = _nd_array(qw, dtype="int8")
            out[name + "_min"] = _nd_array(_np.array([mn], _np.float32))
            out[name + "_max"] = _nd_array(_np.array([mx], _np.float32))
        elif not name.endswith(("_quantize_min", "_quantize_max")) \
                and name in arg_params:
            out[name] = arg_params[name]
    return out


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=(), calib_mode="none", calib_data=None,
                   num_calib_examples=None, quantized_dtype="int8",
                   logger=logging):
    """reference: contrib/quantization.py:422 quantize_model. Returns
    (quantized_sym, quantized_arg_params, aux_params) — weights are
    quantized OFFLINE into int8 `_quantize` params (+ range scalars) like
    the reference's _quantize_params, so the compiled step reads int8
    weights directly instead of re-quantizing fp32 weights every batch."""
    if calib_mode not in ("none", "naive", "entropy"):
        raise MXNetError("calib_mode must be none/naive/entropy")
    calib_ranges = {}
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("calib_data required for calib_mode=%s" % calib_mode)
        arg_j = {k: (v._data if hasattr(v, "_data") else v)
                 for k, v in arg_params.items()}
        aux_j = {k: (v._data if hasattr(v, "_data") else v)
                 for k, v in aux_params.items()}
        calib_ranges = _collect_ranges(sym, arg_j, aux_j, calib_data,
                                       num_calib_examples, calib_mode,
                                       data_names, label_names)
        logger.info("calibrated %d tensors (%s mode)", len(calib_ranges),
                    calib_mode)
    qsym = quantize_graph(sym, excluded_sym_names, calib_ranges,
                          quantized_dtype=quantized_dtype)
    qargs = quantize_params(qsym, arg_params)
    return qsym, qargs, aux_params
