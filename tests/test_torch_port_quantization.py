"""The port's int8 quantization (`ops/quantization.py`,
`contrib/quantization.py`) against the JAX package's, on the CPU.

Tolerances:

- every op on the same seeded numpy inputs: int8 / int32 outputs equal
  exactly, f32 outputs (ranges, dequantized values) bit for bit;
- `fold_batch_norm`'s parameters within 1e-6 (the same numpy code);
- `quantize_graph`: the ops, node names and arguments equal, on LeNet and
  on `resnet18_v1`; `quantize_params`' int8 weights bit for bit;
- `_optimal_threshold` equal on one histogram;
- naive calibration ranges within 1e-5 relative (the float convolutions
  sum in other orders);
- `resnet18_v1` at 8 x 3 x 32^2, BatchNorm folded, quantized with the JAX
  package's calibrated ranges fed to both packages: the int8 logits equal
  bit for bit (the int32 products are exact, the rest elementwise IEEE
  arithmetic, and the global average pool sees 1 x 1 maps);
- the f32 global average pool (the f32 node before the int8 FC's
  ``quantize_v2``): equal bit for bit to the exact window sum divided once
  and rounded to f32 (`math.fsum`), and within 1e-6 of the largest mean
  of the JAX pool (which reduces in f32);
- a ``-quant-0000.params`` file carried both ways: int8 and f32 arrays
  keep their dtypes and bits, each package reads the other's graph, and
  the port's `Predictor` (over either package's files) and `Module` give
  the JAX logits bit for bit.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.predict import Predictor

R18_SHAPE = (8, 3, 32, 32)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).reshape(-1), a.dtype, a.shape


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    if not np.array_equal(_bits(got)[0], _bits(want)[0]):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        raise AssertionError("%s: %d of %d elements differ, largest %g"
                             % (what, int((diff > 0).sum()), diff.size,
                                diff.max()))


# -- the ops ------------------------------------------------------------------

def _op_cases():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 9, 9).astype(np.float32)
    q = rng.randint(-127, 128, (4, 3, 9, 9)).astype(np.int8)
    q2 = rng.randint(-127, 128, (4, 5, 9, 9)).astype(np.int8)
    mn, mx_ = np.array([-1.3], np.float32), np.array([2.1], np.float32)
    wmn, wmx = np.array([-0.5], np.float32), np.array([0.4], np.float32)
    w = rng.randint(-127, 128, (12, 3, 3, 3)).astype(np.int8)
    w7 = rng.randint(-127, 128, (16, 3, 7, 7)).astype(np.int8)
    b = rng.randn(12).astype(np.float32)
    b7 = rng.randn(16).astype(np.float32)
    acc = rng.randint(-100000, 100000, (4, 16, 5, 5)).astype(np.int32)
    wf = rng.randint(-127, 128, (10, 243)).astype(np.int8)
    bf = rng.randn(10).astype(np.float32)
    return {
        "quantize_v2": ("quantize_v2", [x], {}),
        "quantize_v2_calibrated": ("quantize_v2", [x],
                                   {"min_calib_range": -1.7,
                                    "max_calib_range": 2.3}),
        "dequantize_int32": ("dequantize", [acc, mn, mx_], {}),
        "dequantize_int8": ("dequantize", [q, mn, mx_], {}),
        "requantize": ("requantize", [acc, mn, mx_], {}),
        "requantize_calibrated": ("requantize", [acc, mn, mx_],
                                  {"min_calib_range": -3.0,
                                   "max_calib_range": 2.5}),
        # K = 27 and N = 12 padded to 8s, M = 4 x 5 x 5
        "quantized_conv_3x3_s2": ("quantized_conv",
                                  [q, w, b, mn, mx_, wmn, wmx],
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "num_filter": 12}),
        "quantized_conv_no_bias": ("quantized_conv",
                                   [q, w, b, mn, mx_, wmn, wmx],
                                   {"kernel": (3, 3), "num_filter": 12,
                                    "no_bias": True}),
        # the stem's geometry: K = 147, stride 2, pad 3; M = 1 x 2 x 2 < 17
        "quantized_conv_7x7_one_image": ("quantized_conv",
                                         [q[:1], w7, b7, mn, mx_, wmn, wmx],
                                         {"kernel": (7, 7), "stride": (2, 2),
                                          "pad": (3, 3), "num_filter": 16}),
        "quantized_fully_connected": ("quantized_fully_connected",
                                      [q, wf, bf, mn, mx_, wmn, wmx],
                                      {"num_hidden": 10}),
        "quantized_fully_connected_one_row": (
            "quantized_fully_connected", [q[:1], wf, bf, mn, mx_, wmn, wmx],
            {"num_hidden": 10}),
        "quantized_pooling_max": ("quantized_pooling", [q, mn, mx_],
                                  {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "max"}),
        "quantized_pooling_avg": ("quantized_pooling", [q, mn, mx_],
                                  {"kernel": (2, 2), "stride": (2, 2),
                                   "pool_type": "avg"}),
        "quantized_pooling_global_avg": ("quantized_pooling", [q, mn, mx_],
                                         {"global_pool": True,
                                          "pool_type": "avg"}),
        "quantized_act": ("quantized_act", [q, mn, mx_], {}),
        "quantized_flatten": ("quantized_flatten", [q, mn, mx_], {}),
        "quantized_concat": ("quantized_concat", [q, q2, mn, mx_, wmn, wmx],
                             {"num_args": 2, "dim": 1}),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_op_matches_jax(case):
    name, arrays, attrs = _op_cases()[case]
    want = getattr(jmx.nd.contrib, name)(
        *[jmx.nd.array(a, dtype=a.dtype) for a in arrays], **attrs)
    with mx.cpu():
        got = getattr(mx.nd.contrib, name)(
            *[mx.nd.array(a, dtype=a.dtype) for a in arrays], **attrs)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g.asnumpy(), np.asarray(w.asnumpy()), "%s output %d" % (case, i))


def test_global_avg_pool_is_the_rounded_exact_mean():
    """ResNet's global average pool in f32 sums in f64 and divides once by
    a tensor, so it is the exact mean rounded to f32, the same bits on the
    card (PyTorch's CUDA divide by a Python number multiplies by the
    reciprocal, which the card check caught) and on the CPU."""
    rng = np.random.RandomState(5)
    # 8,192 means: enough that a reciprocal product misses (7 of them)
    x = (np.maximum(rng.randn(16, 512, 7, 7), 0)
         * rng.uniform(0, 3, (16, 512, 1, 1))).astype(np.float32)
    want = np.array([[math.fsum(w) / 49.0 for w in row]
                     for row in x.astype(np.float64).reshape(16, 512, 49)])
    with mx.cpu():
        got = mx.nd.Pooling(mx.nd.array(x), kernel=(1, 1), global_pool=True,
                            pool_type="avg").asnumpy()
    _same(got.reshape(16, 512), want.astype(np.float32), "pool")
    jax_pool = np.asarray(jmx.nd.Pooling(
        jmx.nd.array(x), kernel=(1, 1), global_pool=True,
        pool_type="avg").asnumpy())
    np.testing.assert_allclose(got, jax_pool, rtol=0,
                               atol=1e-6 * np.abs(jax_pool).max())


def test_every_registration_and_alias_is_ported():
    from mxnet_tpu import ops as jops
    from mxnet_tpu_torch import ops as tops

    names = [n for n in jops.list_ops()
             if jops.get(n).fn.__module__ == "mxnet_tpu.ops.quantization"]
    assert len({jops.get(n).name for n in names}) == 9
    for n in names:
        assert tops.get(n).name == jops.get(n).name, n
        assert tops.get(n).num_outputs == jops.get(n).num_outputs, n


def test_int8_matmul_pads_small_shapes_exactly():
    from mxnet_tpu_torch.ops.quantization import int8_matmul

    import torch

    rng = np.random.RandomState(1)
    for m, k, n in ((1, 147, 1000), (16, 8, 8), (33, 2048, 10)):
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        w = rng.randint(-127, 128, (n, k)).astype(np.int8)
        got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w)).numpy()
        want = a.astype(np.int64) @ w.astype(np.int64).T
        assert got.dtype == np.int32 and np.array_equal(got, want), (m, k, n)


# -- the graph pass -----------------------------------------------------------

def _lenet(m):
    nn = m.gluon.nn
    net = nn.HybridSequential(prefix="lenet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, activation="relu"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Conv2D(16, kernel_size=3, activation="relu"),
                nn.MaxPool2D(pool_size=2, strides=2),
                nn.Flatten(),
                nn.Dense(64, activation="relu"),
                nn.Dense(10))
    return net


def _graph(sym):
    return [(n.op, n.name, sorted(k for k in n.attrs
                                  if not k.startswith("__")))
            for n in sym._topo()]


def test_quantize_graph_lenet_equals_jax():
    jsym = _lenet(jmx)(jmx.sym.var("data"))
    tsym = mx.sym.load_json(jsym.tojson())
    jq_sym, tq_sym = jq.quantize_graph(jsym), tq.quantize_graph(tsym)
    assert _graph(tq_sym) == _graph(jq_sym)
    assert tq_sym.list_arguments() == jq_sym.list_arguments()
    assert tq_sym.list_outputs() == jq_sym.list_outputs()
    ops = [n.op for n in tq_sym._topo() if not n.is_var]
    assert ops.count("_contrib_quantized_conv") == 2
    assert ops.count("_contrib_quantized_fully_connected") == 2
    assert "_contrib_quantized_pooling" in ops


def test_optimal_threshold_equals_jax():
    rng = np.random.RandomState(3)
    a = np.abs(np.concatenate([rng.randn(20000), 9.0 * rng.randn(40)]))
    amax = float(a.max())
    hist, _ = np.histogram(a, bins=1001, range=(0.0, amax))
    got = tq._optimal_threshold(hist, amax)
    assert got == jq._optimal_threshold(hist, amax)
    assert 0 < got < amax


def _calib(m, x, batch):
    return m.io.NDArrayIter(x, batch_size=batch)


def _r18_values(sym, rng):
    """Every argument and aux state of ``sym`` from ``rng``: weights
    uniform within sqrt(3 / fan-in), gamma in [0.5, 1.5], betas and biases
    within 0.1, running means within 0.2 and variances in [0.5, 1.5]."""
    arg_shapes, _, aux_shapes = sym.infer_shape(data=R18_SHAPE)
    values = {}
    for name, shape in zip(sym.list_arguments() + sym.list_auxiliary_states(),
                           arg_shapes + aux_shapes):
        if name == "data":
            continue
        if name.endswith("weight"):
            lim = np.sqrt(3.0 / np.prod(shape[1:]))
            v = rng.uniform(-lim, lim, shape)
        elif name.endswith(("gamma", "running_var")):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean"):
            v = rng.uniform(-0.2, 0.2, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        values[name] = v.astype(np.float32)
    return values


@pytest.fixture(scope="module")
def r18(tmp_path_factory):
    """resnet18_v1 at 8 x 3 x 32^2 in the JAX package: weights and running
    statistics from a seed (`_r18_values`), BatchNorm folded, naive
    calibration over the batch, the quantized graph and its logits; and
    the port's fold and quantization of the same graph and values with the
    JAX ranges."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, R18_SHAPE).astype(np.float32)
    sym = jvision.resnet18_v1()(jmx.sym.var("data"))
    values = _r18_values(sym, rng)
    aux_names = set(sym.list_auxiliary_states())
    jargs = {k: jmx.nd.array(v) for k, v in values.items()
             if k not in aux_names}
    jauxs = {k: jmx.nd.array(v) for k, v in values.items() if k in aux_names}
    fsym, fargs, fauxs = jq.fold_batch_norm(sym, jargs, jauxs)
    fargs = {k: jmx.nd.array(np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                        else v)) for k, v in fargs.items()}
    jranges = jq._collect_ranges(
        fsym, {k: v._data for k, v in fargs.items()}, {},
        _calib(jmx, x, 8), None, "naive")
    by_name = {(n.name, i): jranges[(id(n), i)] for n in fsym._topo()
               for i in range(n.num_outputs()) if (id(n), i) in jranges}
    qsym = jq.quantize_graph(fsym, calib_ranges=jranges)
    qargs = jq.quantize_params(qsym, fargs)
    exe = qsym.bind(jmx.cpu(), args={"data": jmx.nd.array(x), **qargs},
                    grad_req="null")
    logits = np.asarray(exe.forward()[0].asnumpy())

    with mx.context.scope(mx.cpu()):
        tsym = mx.sym.load_json(sym.tojson())
        targs = {k: mx.nd.array(v) for k, v in values.items()
                 if k not in aux_names}
        tauxs = {k: mx.nd.array(v) for k, v in values.items()
                 if k in aux_names}
        tfsym, tfargs, tfauxs = tq.fold_batch_norm(tsym, targs, tauxs)
        tfargs = {k: mx.nd.array(np.asarray(v.asnumpy() if hasattr(
            v, "asnumpy") else v)) for k, v in tfargs.items()}
        tranges = tq._collect_ranges(tfsym, tfargs, {}, _calib(mx, x, 8),
                                     None, "naive")
        fed = {(id(n), i): by_name[(n.name, i)] for n in tfsym._topo()
               for i in range(n.num_outputs()) if (n.name, i) in by_name}
        tqsym = tq.quantize_graph(tfsym, calib_ranges=fed)
        tqargs = tq.quantize_params(tqsym, tfargs)
    return {"x": x, "fsym": fsym, "fargs": fargs, "fauxs": fauxs,
            "by_name": by_name, "qsym": qsym, "qargs": qargs,
            "logits": logits, "tfsym": tfsym, "tfargs": tfargs,
            "tfauxs": tfauxs, "tranges": tranges, "tqsym": tqsym,
            "tqargs": tqargs, "dir": tmp_path_factory.mktemp("q")}


def test_fold_batch_norm_equals_jax(r18):
    assert _graph(r18["tfsym"]) == _graph(r18["fsym"])
    ops = [n.op for n in r18["tfsym"]._topo() if not n.is_var]
    assert "BatchNorm" not in ops
    assert sorted(r18["tfargs"]) == sorted(r18["fargs"])
    assert r18["tfauxs"] == {} and r18["fauxs"] == {}
    for k, v in r18["fargs"].items():
        np.testing.assert_allclose(r18["tfargs"][k].asnumpy(), v.asnumpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_naive_ranges_within_1e5_of_jax(r18):
    tranges = {(n.name, i): r18["tranges"][(id(n), i)]
               for n in r18["tfsym"]._topo() for i in range(n.num_outputs())
               if (id(n), i) in r18["tranges"]}
    assert sorted(tranges) == sorted(r18["by_name"])
    for key, (mn, mx_) in r18["by_name"].items():
        got = tranges[key]
        scale = max(abs(mn), abs(mx_), 1e-30)
        assert abs(got[0] - mn) <= 1e-5 * scale, (key, got, (mn, mx_))
        assert abs(got[1] - mx_) <= 1e-5 * scale, (key, got, (mn, mx_))


def test_quantize_graph_resnet18_equals_jax(r18):
    assert _graph(r18["tqsym"]) == _graph(r18["qsym"])
    assert r18["tqsym"].list_arguments() == r18["qsym"].list_arguments()
    ops = [n.op for n in r18["tqsym"]._topo() if not n.is_var]
    assert ops.count("_contrib_quantized_conv") == 20
    assert ops.count("_contrib_quantized_fully_connected") == 1
    assert sorted(r18["tqargs"]) == sorted(r18["qargs"])
    for k, v in r18["qargs"].items():
        _same(r18["tqargs"][k].asnumpy(), np.asarray(v.asnumpy()), k)


def test_resnet18_int8_logits_equal_jax(r18):
    with mx.cpu():
        got = r18["tqsym"].eval(data=mx.nd.array(r18["x"]),
                                **r18["tqargs"])[0].asnumpy()
    assert np.isfinite(got).all()
    _same(got, r18["logits"], "int8 logits")


def test_quant_params_file_both_ways(r18):
    d, x = r18["dir"], r18["x"]
    stem = next(n for n in r18["tqsym"].list_arguments()
                if n.endswith("_weight_quantize"))
    jprefix, tprefix = str(d / "jax-quant"), str(d / "port-quant")
    jmx.model.save_checkpoint(jprefix, 0, r18["qsym"], r18["qargs"], {})
    with mx.context.scope(mx.cpu()):
        mx.model.save_checkpoint(tprefix, 0, r18["tqsym"], r18["tqargs"], {})
        _, targs, _ = mx.model.load_checkpoint(jprefix, 0)
        for k, v in r18["qargs"].items():
            _same(targs[k].asnumpy(), np.asarray(v.asnumpy()), k)
        for prefix in (jprefix, tprefix):
            pred = Predictor(prefix + "-symbol.json",
                             prefix + "-0000.params", ctx=mx.cpu(),
                             input_shapes={"data": R18_SHAPE})
            _same(pred.forward(data=x).get_output(0).asnumpy(),
                  r18["logits"], "port Predictor over " + prefix)
            assert pred._args[stem].dtype == np.int8
        # Module binds the int8 weights as they are
        mod = mx.mod.Module(r18["tqsym"], label_names=None,
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", R18_SHAPE)], for_training=False)
        mod.set_params(targs, {}, allow_missing=True)
        assert mod._exec.arg_dict[stem].dtype == np.int8
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], None), is_train=False)
        _same(mod.get_outputs()[0].asnumpy(), r18["logits"], "port Module")
    jsym, jargs, _ = jmx.model.load_checkpoint(tprefix, 0)
    assert sorted(jargs) == sorted(r18["tqargs"])
    for k, v in r18["tqargs"].items():
        _same(np.asarray(jargs[k].asnumpy()), v.asnumpy(), k)
    assert _graph(jsym) == _graph(r18["qsym"])


def test_top1_agrees_with_the_folded_float_graph(r18):
    with mx.cpu():
        fp = r18["tfsym"].eval(data=mx.nd.array(r18["x"]),
                               **r18["tfargs"])[0].asnumpy()
    agree = (fp.argmax(1) == r18["logits"].argmax(1)).mean()
    assert agree >= 0.75, agree
