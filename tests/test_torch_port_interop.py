"""Custom operators, subgraph partitioning and ONNX interchange of the PyTorch
port against the JAX package's, on the CPU, at small sizes.

- Custom ops: the same user `CustomOp` classes (registered in each
  package under the same names) run through ``nd.Custom`` under the tape,
  ``sym.Custom`` in an executor and ``F.Custom`` in a hybridized
  `HybridBlock`; outputs and gradients agree within 1e-6, and the calls a
  user op sees (``is_train``, ``req``, shapes, the backward's recompute)
  are the same sequence in both packages.
- Subgraph: the partitioned graphs' op lists (the fused ops' numbering
  aside) and input order are the JAX package's, and their outputs and
  gradients agree within 1e-6.
- ONNX: the JAX test file's cases through the port (tolerances as there:
  rtol 1e-4 / atol 1e-4 for zoo nets, 1e-4 / 1e-5 for the BERT subset,
  1e-5 / 1e-6 for the trained BatchNorm), the two slow families behind
  ``MXTPU_TEST_EXAMPLES_FULL``; and both directions across packages: a
  file the JAX package exports is imported by the port and the reverse,
  outputs within 1e-4, and the two files decode to the same op sequence,
  attributes and initializers (bit for bit).

The JAX results that several cases read are computed once (module cache).
"""
import functools
import os
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.subgraph  # noqa: F401  (not among the JAX package's imports)
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.contrib import onnx as jonnx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, subgraph as sg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import onnx as onnx_mx
from mxnet_tpu_torch.contrib import onnx_proto
from mxnet_tpu_torch.gluon.model_zoo import vision

EXACT = 1e-6


@pytest.fixture(autouse=True)
def cpu():
    with mx.context.scope(mx.cpu()):
        yield


@pytest.fixture(autouse=True)
def op_registries(monkeypatch):
    """The fused ops a partition registers leave both packages' op
    registries with the test (other files enumerate them)."""
    from mxnet_tpu import ops as jops
    from mxnet_tpu_torch import ops as tops

    for m in (jops, tops):
        monkeypatch.setattr(m, "_REGISTRY", dict(m._REGISTRY))


# ---------------------------------------------------------------------------
# custom ops: one set of user classes a package
# ---------------------------------------------------------------------------

CALLS = {}  # package name -> [call records] of the protocol op


def _user_ops(m):
    """Register the test's user ops in package ``m`` (the classes of
    tests/test_custom_op.py, under names of their own, plus a protocol
    recorder and a prop with an aux state)."""
    key = m.__name__

    class Sigmoid(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0],
                        m.nd.array(1.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy() * y * (1 - y)
            self.assign(in_grad[0], req[0], m.nd.array(g))

    @m.operator.register("interop_sigmoid")
    class SigmoidProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class ScaledAdd(m.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] + in_data[1] * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])
            self.assign(in_grad[1], req[1], out_grad[0] * self.scale)

    @m.operator.register("interop_scaled_add")
    class ScaledAddProp(m.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            return ScaledAdd(self.scale)

    class Recorder(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS[key].append(("forward", bool(is_train), list(req),
                               [tuple(a.shape) for a in in_data],
                               m.autograd.is_recording()))
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            CALLS[key].append(("backward", list(req),
                               [tuple(a.shape) for a in out_grad],
                               m.autograd.is_recording()))
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @m.operator.register("interop_recorder")
    class RecorderProp(m.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            CALLS[key].append(("create", [list(s) for s in shapes]))
            return Recorder()

    @m.operator.register("interop_with_aux")
    class AuxProp(m.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]


for _m in (jmx, mx):
    _user_ops(_m)


def _sig(x):
    return 1 / (1 + np.exp(-x))


def _close(got, want, tol=EXACT):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def test_custom_forward():
    xv = np.array([-1.0, 0.0, 2.0], np.float32)
    outs = [m.nd.Custom(m.nd.array(xv), op_type="interop_sigmoid").asnumpy()
            for m in (jmx, mx)]
    _close(outs[1], outs[0])
    _close(outs[1], _sig(xv))


def test_custom_backward():
    xv = np.random.RandomState(0).uniform(-2, 2, (3, 4)).astype(np.float32)
    grads = []
    for m in (jmx, mx):
        x = m.nd.array(xv)
        x.attach_grad()
        with m.autograd.record():
            loss = m.nd.Custom(x, op_type="interop_sigmoid").sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    _close(grads[1], grads[0])
    _close(grads[1], _sig(xv) * (1 - _sig(xv)))


def test_custom_attrs_and_two_inputs():
    res = []
    for m in (jmx, mx):
        a, b = m.nd.array([1.0, 2.0]), m.nd.array([10.0, 20.0])
        a.attach_grad()
        b.attach_grad()
        with m.autograd.record():
            out = m.nd.Custom(a, b, op_type="interop_scaled_add", scale="3.0")
            out.sum().backward()
        res.append([out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()])
    for got, want in zip(res[1], res[0]):
        _close(got, want)
    _close(res[1][0], [31.0, 62.0])
    _close(res[1][2], [3.0, 3.0])


def test_custom_in_symbol():
    xv = np.array([[0.5, -0.5]], np.float32)
    res = []
    for m in (jmx, mx):
        out = m.sym.Custom(m.sym.var("data"), op_type="interop_sigmoid",
                           name="sig")
        fwd = out.eval_with({"data": xv}).asnumpy()
        exe = out.bind(m.cpu(), args={"data": m.nd.array(xv)})
        exe.forward(is_train=True)
        exe.backward()
        res.append([fwd, exe.grad_dict["data"].asnumpy(),
                    out.list_arguments(), out.list_outputs(),
                    out.infer_shape(data=(4, 2))])
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])
    assert res[1][2:] == res[0][2:]


def test_custom_in_hybridized_block():
    """The JAX test runs ``nd.Custom`` under ``jax.jit``; the port's
    counterpart is a hybridized `HybridBlock` calling ``F.Custom`` (the
    JAX block hybridized too), forward and gradient."""
    xv = np.random.RandomState(1).uniform(-2, 2, (2, 5)).astype(np.float32)
    res = []
    for m in (jmx, mx):
        class Net(m.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return F.Custom(x, x, op_type="interop_scaled_add",
                                scale="0.5") * F.Custom(
                                    x, op_type="interop_sigmoid")

        net = Net()
        net.hybridize()
        x = m.nd.array(xv)
        x.attach_grad()
        with m.autograd.record():
            y = net(x)
        y.backward()
        res.append([y.asnumpy(), x.grad.asnumpy()])
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])


def test_custom_sees_the_same_calls():
    """The user op's calls under the tape: the prop's `create_operator`,
    ``forward`` with ``is_train``, every req ``write``, no outer recording,
    and the backward's recompute of the forward in training mode."""
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    for m in (jmx, mx):
        CALLS[m.__name__] = []
        x = m.nd.array(xv)
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.Custom(x, op_type="interop_recorder")
        y.backward(m.nd.ones((2, 3)))
        _close(x.grad.asnumpy(), np.full((2, 3), 2.0))
        with m.autograd.predict_mode():
            m.nd.Custom(x, op_type="interop_recorder")
    assert CALLS["mxnet_tpu_torch"] == CALLS["mxnet_tpu"]
    assert [c[0] for c in CALLS["mxnet_tpu_torch"]] == [
        "create", "forward", "create", "forward", "backward", "create",
        "forward"]


def test_custom_out_grad_is_contiguous():
    """``sum().backward()`` gives the op an expanded gradient (stride 0):
    the user's array is contiguous and of its own memory."""
    seen = []

    class Probe(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            t = out_grad[0]._data
            seen.append((t.is_contiguous(), t.stride()))
            out_grad[0][:] = 5.0   # the user may write it
            self.assign(in_grad[0], req[0], out_grad[0])

    @mx.operator.register("interop_probe")
    class ProbeProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Probe()

    x = mx.nd.array(np.ones((3, 4), np.float32))
    x.attach_grad()
    with autograd.record():
        loss = mx.nd.Custom(x, op_type="interop_probe").sum()
    loss.backward()
    assert seen == [(True, (4, 1))]
    _close(x.grad.asnumpy(), np.full((3, 4), 5.0))


def test_custom_runs_on_the_inputs_device_and_assign_copies():
    """`create_operator` gets the inputs' context, every array handed to
    the user lies there, and `assign` copies a source made elsewhere into
    the destination's device (``dst[:] = src``), for every req."""
    seen = []

    class Where(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append([a._data.device.type for a in in_data + out_data])
            self.assign(out_data[0], "write", in_data[0])
            self.assign(out_data[0], "add", in_data[0])
            self.assign(out_data[0], "null", in_data[0] * 100)

    @mx.operator.register("interop_where")
    class WhereProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            seen.append(str(ctx))
            return Where()

    y = mx.nd.Custom(mx.nd.array([1.0, 2.0]), op_type="interop_where")
    _close(y.asnumpy(), [2.0, 4.0])
    assert seen == ["cpu(0)", ["cpu", "cpu"]]
    dst = mx.nd.zeros((2,), ctx=mx.cpu(0))
    mx.operator.CustomOp().assign(dst, "write",
                                  mx.nd.array([3.0, 4.0], ctx=mx.cpu(1)))
    assert dst.context == mx.cpu(0)
    _close(dst.asnumpy(), [3.0, 4.0])
    with pytest.raises(MXNetError, match="unknown req"):
        mx.operator.CustomOp().assign(dst, "bogus", dst)


def test_custom_refusals_match_jax():
    msgs = []
    for m, err in ((jmx, JMXNetError), (mx, MXNetError)):
        with pytest.raises(err) as e1:
            m.nd.Custom(m.nd.array([1.0]), op_type="interop_with_aux")
        with pytest.raises(err) as e2:
            m.nd.Custom(m.nd.array([1.0]), op_type="interop_unknown_op")
        with pytest.raises(err) as e3:
            m.nd.Custom(m.nd.array([1.0]))
        with pytest.raises(err) as e4:
            m.operator.register("interop_bad")(int)
        msgs.append([str(e.value) for e in (e1, e2, e3, e4)])
    assert msgs[1][0] == msgs[0][0]
    assert msgs[1][2:] == msgs[0][2:]
    assert "interop_unknown_op" in msgs[1][1]


def test_custom_shape_inference_runs_no_user_code():
    out = mx.sym.Custom(mx.sym.var("a"), mx.sym.var("b"),
                        op_type="interop_scaled_add", scale="2")
    jout = jmx.sym.Custom(jmx.sym.var("a"), jmx.sym.var("b"),
                          op_type="interop_scaled_add", scale="2")
    CALLS["mxnet_tpu_torch"] = []
    assert out.infer_shape(a=(3, 7), b=(3, 7)) == \
        jout.infer_shape(a=(3, 7), b=(3, 7))
    rec = mx.sym.Custom(mx.sym.var("x"), op_type="interop_recorder")
    assert rec.infer_shape(x=(5, 2))[1] == [(5, 2)]
    assert CALLS["mxnet_tpu_torch"] == []


def test_custom_registry_listing():
    names = mx.operator.get_all_registered_operators()
    assert {"interop_sigmoid", "interop_scaled_add"} <= set(names)
    assert names == sorted(names)
    assert mx.nd.Custom is mx.nd.op.Custom and mx.sym.Custom is \
        mx.sym.op.Custom


def test_custom_re_registration_replaces_the_prop():
    for scale in (2.0, 3.0):
        class Mul(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux,
                        _s=scale):
                self.assign(out_data[0], req[0], in_data[0] * _s)

        @mx.operator.register("interop_rereg")
        class MulProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes, _op=Mul):
                return _op()

        y = mx.nd.Custom(mx.nd.array([1.0]), op_type="interop_rereg")
        _close(y.asnumpy(), [scale])


# ---------------------------------------------------------------------------
# subgraph partitioning
# ---------------------------------------------------------------------------

def _mlp_sym(m):
    with m.name.NameManager():
        data = m.sym.var("data")
        h = m.sym.relu(m.sym.FullyConnected(data=data, num_hidden=8,
                                            name="fc1"))
        return m.sym.FullyConnected(data=h, num_hidden=3, name="fc2")


def _vals():
    rng = np.random.RandomState(0)
    return {
        "data": rng.uniform(-1, 1, (4, 6)).astype(np.float32),
        "fc1_weight": rng.uniform(-0.5, 0.5, (8, 6)).astype(np.float32),
        "fc1_bias": rng.uniform(-0.1, 0.1, 8).astype(np.float32),
        "fc2_weight": rng.uniform(-0.5, 0.5, (3, 8)).astype(np.float32),
        "fc2_bias": np.zeros(3, np.float32),
    }


def _op_list(sym):
    return [re.sub(r"_\d+$", "", n.op) for n in sym._topo() if not n.is_var]


def _fwd_bwd(m, sym, vals):
    args = {k: m.nd.array(v) for k, v in vals.items()
            if k in sym.list_arguments()}
    exe = sym.bind(m.cpu(), args=args)
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward([m.nd.ones(out.shape)])
    return out, {k: exe.grad_dict[k].asnumpy() for k in sorted(args)}


def _fc_relu_property(m):
    class FCReluSelector(m.subgraph.SubgraphSelector):
        def select(self, node):
            return node.op == "relu"

        def select_input(self, node, input_node):
            return node.op == "relu" and input_node.op == "FullyConnected"

    class FCReluProperty(m.subgraph.SubgraphProperty):
        def create_subgraph_selector(self):
            return FCReluSelector()

    return FCReluProperty()


@pytest.mark.parametrize("prop", ["default", "fc_relu"])
def test_partition_matches_jax(prop):
    res = []
    for m in (jmx, mx):
        sym = _mlp_sym(m)
        p = "default" if prop == "default" else _fc_relu_property(m)
        part = m.subgraph.partition(sym, p)
        fused = [n for n in part._topo() if not n.is_var
                 and n.op.startswith("_subgraph_")][0]
        ref_out, ref_grads = _fwd_bwd(m, sym, _vals())
        out, grads = _fwd_bwd(m, part, _vals())
        _close(out, ref_out)
        for k in ref_grads:
            _close(grads[k], ref_grads[k])
        res.append([_op_list(part), [s.name for s, _ in fused.inputs],
                    part.list_arguments(), out, grads])
    assert res[1][:3] == res[0][:3]
    if prop == "default":
        assert res[1][0] == ["_subgraph_defaultsubgraphproperty"]
    else:
        assert res[1][0] == ["_subgraph_fcreluproperty", "FullyConnected"]
    _close(res[1][3], res[0][3])
    for k in res[0][4]:
        _close(res[1][4][k], res[0][4][k])


def test_partition_keeps_batchnorm_and_custom_ops_unfused():
    res = []
    for m in (jmx, mx):
        with m.name.NameManager():
            data = m.sym.var("data")
            bn = m.sym.BatchNorm(data=data, name="bn")
            h = m.sym.Custom(m.sym.relu(bn), op_type="interop_sigmoid")
            out = m.sym.Dropout(m.sym.exp(h), p=0.5)
        res.append(_op_list(m.subgraph.partition(out, "default")))
    assert res[1] == res[0]
    assert res[1][:1] == ["BatchNorm"] and "Custom" in res[1] \
        and "Dropout" in res[1]


def test_registered_properties():
    assert "default" in sg.list_subgraph_properties()
    assert sg.list_subgraph_properties() == \
        jmx.subgraph.list_subgraph_properties()
    with pytest.raises(MXNetError, match="unknown subgraph property"):
        sg.partition(_mlp_sym(mx), "nope")


def test_partition_with_no_match_returns_the_graph():
    sym = _mlp_sym(mx)
    assert sg.partition(sym, sg.SubgraphProperty()) is sym


def test_partitioned_training_is_the_unpartitioned_one():
    """The smoke's part (c) at a small size on the CPU: ResNet-18 exported
    to ONNX, imported, with a custom softmax head, one SGD step through
    `Module`, partitioned and not: the same ops in the same order give the
    same outputs, gradients and updated weights bit for bit. BatchNorms
    and the head stay outside the fused regions."""
    path, _, _ = _port_resnet_file()
    sym, args, auxs = onnx_mx.import_model(path)
    sym = mx.sym.Custom(sym, mx.sym.var("softmax_label"),
                        op_type="interop_softmax", name="softmax")
    part = sg.partition(sym, "default")
    ops = _op_list(part)
    assert ops.count("BatchNorm") == 20 and ops[-1] == "Custom"
    assert "Convolution" not in ops
    x = np.random.RandomState(3).uniform(-1, 1, (4, 3, 32, 32)).astype(
        np.float32)
    y = np.array([1, 5, 7, 9], np.float32)
    runs = []
    for s in (sym, part):
        mod = mx.mod.Module(s, data_names=["data"],
                            label_names=["softmax_label"], context=mx.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.set_params({k: v.copy() for k, v in args.items()},
                       {k: v.copy() for k, v in auxs.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        mod.backward()
        grads = {k: mod._exec.grad_dict[k].asnumpy() for k in args}
        out = mod.get_outputs()[0].asnumpy()
        mod.update()
        runs.append((out, grads, {k: v.asnumpy() for k, v in
                                  mod.get_params()[0].items()}))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    for k in args:
        np.testing.assert_array_equal(runs[1][1][k], runs[0][1][k])
        np.testing.assert_array_equal(runs[1][2][k], runs[0][2][k])
    assert np.abs(runs[0][1]["resnetv10_conv2d0_weight"]).max() > 0


def test_partitioned_graph_infers_its_shapes():
    """A fused node's variables take their shapes from the captured ops'
    rules, so a partitioned graph binds through `simple_bind` / `Module`
    (the JAX package's shape inference stops at a fused node)."""
    with mx.name.NameManager():
        d = mx.sym.var("data")
        h = mx.sym.Activation(mx.sym.Convolution(d, num_filter=4,
                                                 kernel=(3, 3), name="c1"),
                              act_type="relu")
        out = mx.sym.FullyConnected(mx.sym.BatchNorm(h, name="bn"),
                                    num_hidden=3, name="fc")
    part = sg.partition(out, "default")
    assert _op_list(part) == ["_subgraph_defaultsubgraphproperty",
                              "BatchNorm", "_subgraph_defaultsubgraphproperty"]
    assert part.infer_shape(data=(2, 3, 8, 8)) == \
        out.infer_shape(data=(2, 3, 8, 8))


# the partition test's custom head: SoftmaxOutput's forward and gradient
class _SoftmaxCE(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], mx.nd.softmax(in_data[0], axis=-1))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0].asnumpy()
        label = in_data[1].asnumpy().astype(np.int64)
        y[np.arange(y.shape[0]), label] -= 1.0
        self.assign(in_grad[0], req[0], mx.nd.array(y))


@mx.operator.register("interop_softmax")
class _SoftmaxCEProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _SoftmaxCE()


# ---------------------------------------------------------------------------
# ONNX
# ---------------------------------------------------------------------------

def _roundtrip_net(net, x, tmp_path, rtol=1e-4, atol=1e-4):
    """Trace -> export_model -> import_model -> bind -> compare (the JAX
    test's helper)."""
    net(x)
    ref = net(x)
    ref = (ref[0] if isinstance(ref, (list, tuple)) else ref).asnumpy()
    sym = net(mx.sym.var("data"))
    if isinstance(sym, (list, tuple)):
        sym = sym[0]
    params = {k: v.data() for k, v in net.collect_params().items()}
    path = str(tmp_path / "model.onnx")
    onnx_mx.export_model(sym, params, tuple(x.shape), onnx_file_path=path)
    sym2, args, auxs = onnx_mx.import_model(path)
    exe = sym2.bind(mx.cpu(), args={**args, "data": x}, grad_req="null",
                    aux_states=auxs)
    out = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    return path


_FAMILIES = [
    ("resnet18_v1", (1, 3, 32, 32)),
    ("mobilenet0_25", (1, 3, 32, 32)),
    ("densenet121", (1, 3, 224, 224)),
    ("inception_v3", (1, 3, 299, 299)),
]
_SLOW_FAMILIES = {"densenet121", "inception_v3"}


@pytest.mark.parametrize("name,shape", _FAMILIES,
                         ids=[f[0] for f in _FAMILIES])
def test_model_zoo_roundtrip(name, shape, tmp_path):
    if name in _SLOW_FAMILIES and \
            not os.environ.get("MXTPU_TEST_EXAMPLES_FULL"):
        pytest.skip("slow zoo family - set MXTPU_TEST_EXAMPLES_FULL=1")
    mx.random.seed(11)
    net = getattr(vision, name)()
    net.initialize(mx.init.Xavier())
    x = mx.nd.array(np.random.RandomState(0)
                    .uniform(-1, 1, shape).astype(np.float32))
    _roundtrip_net(net, x, tmp_path)


def test_bert_op_subset_roundtrip(tmp_path):
    S = mx.sym
    rs = np.random.RandomState(1)
    B, L, C, H = 2, 6, 8, 2
    x = S.var("data")
    ln = S.LayerNorm(x, S.var("ln_gamma"), S.var("ln_beta"), axis=-1,
                     eps=1e-5)
    q = S.linalg_gemm2(ln, S.var("wq"))
    qh = S.transpose(S.Reshape(q, shape=(B, L, H, C // H)),
                     axes=(0, 2, 1, 3))
    scores = S.batch_dot(S.Reshape(qh, shape=(-1, L, C // H)),
                         S.Reshape(qh, shape=(-1, L, C // H)),
                         transpose_b=True)
    scores = S._div_scalar(scores, scalar=float(np.sqrt(C // H)))
    neg = S._mul_scalar(S.ones_like(scores), scalar=-1e9)
    scores = S.where(S.broadcast_to(S.expand_dims(S.var("mask"), axis=0),
                                    shape=(B * H, L, L)), scores, neg)
    att = S.softmax(scores, axis=-1)
    out = S.LeakyReLU(S.mean(att, axis=-1, keepdims=False),
                      act_type="gelu")
    out = S.slice_axis(out, axis=1, begin=0, end=4)
    args = {
        "data": mx.nd.array(rs.uniform(-1, 1, (B, L, C)).astype(np.float32)),
        "ln_gamma": mx.nd.array(np.ones(C, np.float32)),
        "ln_beta": mx.nd.array(np.zeros(C, np.float32)),
        "wq": mx.nd.array(rs.uniform(-0.5, 0.5, (C, C)).astype(np.float32)),
        "mask": mx.nd.array(np.tril(np.ones((L, L), np.float32))),
    }
    ref = out.bind(mx.cpu(), args=dict(args), grad_req="null").forward(
        is_train=False)[0].asnumpy()
    path = str(tmp_path / "bertops.onnx")
    params = {k: v for k, v in args.items() if k not in ("data", "mask")}
    onnx_mx.export_model(out, params, {"data": (B, L, C), "mask": (L, L)},
                         onnx_file_path=path)
    sym2, arg_params, auxs = onnx_mx.import_model(path)
    got = sym2.bind(mx.cpu(), args={**arg_params, "data": args["data"],
                                    "mask": args["mask"]},
                    grad_req="null", aux_states=auxs).forward(
        is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_embedding_gather_roundtrip(tmp_path):
    rs = np.random.RandomState(2)
    out = mx.sym.sum(mx.sym.Embedding(mx.sym.var("data"),
                                      mx.sym.var("embed_weight"),
                                      input_dim=11, output_dim=5),
                     axis=-1, keepdims=False)
    args = {"data": mx.nd.array(np.array([[1, 4, 9], [0, 2, 7]], np.int32),
                                dtype=np.int32),
            "embed_weight": mx.nd.array(
                rs.uniform(-1, 1, (11, 5)).astype(np.float32))}
    ref = out.bind(mx.cpu(), args=dict(args), grad_req="null").forward(
        is_train=False)[0].asnumpy()
    path = str(tmp_path / "embed.onnx")
    onnx_mx.export_model(out, {"embed_weight": args["embed_weight"]},
                         {"data": (2, 3)}, input_type=np.int32,
                         onnx_file_path=path)
    sym2, arg_params, _ = onnx_mx.import_model(path)
    got = sym2.bind(mx.cpu(), args={**arg_params, "data": args["data"]},
                    grad_req="null").forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_documented_unsupported_ops_raise_clearly(tmp_path):
    anchors = mx.sym.contrib.MultiBoxPrior(mx.sym.var("data"), sizes=(0.5,),
                                           ratios=(1.0,))
    with pytest.raises(MXNetError, match="export_compiled"):
        onnx_mx.export_model(anchors, {}, (1, 3, 8, 8),
                             onnx_file_path=str(tmp_path / "x.onnx"))


@pytest.mark.parametrize("op", ["BatchNormRelu", "BatchNormAddRelu"])
def test_fused_batchnorm_nodes_are_refused_by_name(op, tmp_path):
    """The channels-last zoo's fused epilogue nodes have no row in the
    table (nor in the JAX package's): export names the op and points at
    the AOT path, as for MultiBox."""
    with mx.gluon.nn.layout_scope():
        net = vision.resnet18_v1(fuse_epilogue=True)
    net.initialize()
    sym = net(mx.sym.var("data"))
    assert op in _op_list(sym)
    data = [mx.sym.var("data")] + ([mx.sym.var("addend")]
                                   if op == "BatchNormAddRelu" else [])
    with pytest.raises(MXNetError, match=r"op '%s' not supported.*"
                       r"export_compiled" % op):
        onnx_mx.export_model(getattr(mx.sym, op)(*data), {},
                             {"data": (1, 64, 8, 8), "addend": (1, 64, 8, 8)},
                             onnx_file_path=str(tmp_path / "x.onnx"))


def test_channels_last_layout_is_refused(tmp_path):
    with mx.gluon.nn.layout_scope():
        net = vision.resnet18_v1()
    net.initialize()
    with pytest.raises(MXNetError, match="layout NHWC"):
        onnx_mx.export_model(net(mx.sym.var("data")), {}, (1, 32, 32, 3),
                             onnx_file_path=str(tmp_path / "x.onnx"))
    bn = mx.sym.BatchNorm(mx.sym.var("data"), axis=3, name="bn")
    with pytest.raises(MXNetError, match="axis 3"):
        onnx_mx.export_model(bn, {}, (1, 4, 4, 2),
                             onnx_file_path=str(tmp_path / "y.onnx"))


def test_get_model_metadata(tmp_path):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(4))
    net.initialize()
    path = _roundtrip_net(net, mx.nd.zeros((2, 8)), tmp_path)
    meta = onnx_mx.get_model_metadata(path)
    assert meta == jonnx.get_model_metadata(path)
    assert meta["input_tensor_data"] == [("data", (2, 8))]


def _shim_model(proto):
    h, nh, TP = proto.helper, proto.numpy_helper, proto.TensorProto
    w = nh.from_array(np.arange(6, dtype=np.float32).reshape(2, 3), "w")
    n1 = h.make_node("Gemm", ["x", "w"], ["y"], transB=1, alpha=2.0)
    g = h.make_graph([n1], "g",
                     [h.make_tensor_value_info("x", TP.FLOAT, (1, 3))],
                     [h.make_tensor_value_info("y", TP.FLOAT, (1, 2))], [w])
    return h.make_model(g, producer_name="test")


def test_shim_roundtrip_and_the_jax_shim_agree():
    """The shim encodes the message byte for byte as the JAX package's
    shim does, and decodes it back (the JAX test's golden decode by
    protoc is the JAX shim's)."""
    from mxnet_tpu.contrib import onnx_proto as jproto

    blob = _shim_model(onnx_proto).SerializeToString()
    assert blob == _shim_model(jproto).SerializeToString()
    h = onnx_proto.helper
    m2 = onnx_proto.ModelProto.FromString(blob)
    node = m2.graph.node[0]
    assert node.op_type == "Gemm" and list(node.input) == ["x", "w"]
    attrs = {a.name: h.get_attribute_value(a) for a in node.attribute}
    assert attrs["transB"] == 1 and attrs["alpha"] == 2.0
    np.testing.assert_array_equal(
        onnx_proto.numpy_helper.to_array(m2.graph.initializer[0]),
        np.arange(6, dtype=np.float32).reshape(2, 3))
    assert m2.opset_import[0].version == 13
    assert onnx_mx._is_shim(onnx_mx._onnx_impl()[0])


def test_shim_packed_and_unpacked_scalars():
    t = onnx_proto.TensorProto(dims=[2, 3], data_type=1, name="t")
    blob = t.SerializeToString()
    unpacked = (b"\x08\x02\x08\x03"         # field 1 varint 2, varint 3
                b"\x10\x01"                  # field 2 = 1
                b"\x42\x01t")                # field 8 = "t"
    t2 = onnx_proto.TensorProto.FromString(unpacked)
    assert list(t2.dims) == [2, 3] and t2.data_type == 1 and t2.name == "t"
    assert list(onnx_proto.TensorProto.FromString(blob).dims) == [2, 3]


def test_trained_batchnorm_roundtrip(tmp_path):
    mx.random.seed(5)
    net = mx.gluon.nn.HybridSequential(prefix="tbn_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(3))
    net.initialize(mx.init.Xavier())
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-2})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(4)
    X = mx.nd.array(rs.uniform(-1, 1, (16, 3, 6, 6)).astype(np.float32))
    Y = mx.nd.array(rs.uniform(0, 3, (16,)).astype(np.int32))
    for _ in range(10):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(16)
    gamma = [v for k, v in net.collect_params().items()
             if k.endswith("gamma")][0].data().asnumpy()
    assert not np.allclose(gamma, 1.0), "training left gamma at 1; test moot"
    path = _roundtrip_net(net, X, tmp_path, rtol=1e-5, atol=1e-6)
    # the moving statistics come back as aux states, and training mode
    # updates them in place as the BatchNorm op does
    sym, args, auxs = onnx_mx.import_model(path)
    assert sorted(auxs) == sorted(sym.list_auxiliary_states()) and \
        len(auxs) == 2
    before = {k: v.asnumpy().copy() for k, v in auxs.items()}
    exe = sym.bind(mx.cpu(), args={**args, "data": X}, aux_states=auxs)
    exe.forward(is_train=True)
    assert all(not np.array_equal(auxs[k].asnumpy(), before[k])
               for k in auxs)


def _write_graph(tmp_path, name, nodes, inputs, outputs, inits=()):
    h = onnx_proto.helper
    path = str(tmp_path / name)
    onnx_proto.save(h.make_model(h.make_graph(nodes, "g", inputs, outputs,
                                              list(inits))), path)
    return path


def test_omitted_optional_inputs_keep_positions(tmp_path):
    h, TP = onnx_proto.helper, onnx_proto.TensorProto
    path = _write_graph(
        tmp_path, "clip.onnx", [h.make_node("Clip", ["x", "", "mx_val"],
                                            ["y"])],
        [h.make_tensor_value_info("x", TP.FLOAT, (4,))],
        [h.make_tensor_value_info("y", TP.FLOAT, (4,))],
        [onnx_proto.numpy_helper.from_array(np.float32(0.5), "mx_val")])
    sym, args, _ = onnx_mx.import_model(path)
    x = mx.nd.array(np.array([-2.0, 0.0, 0.4, 2.0], np.float32))
    out = sym.bind(mx.cpu(), args={**args, "x": x}, grad_req="null") \
        .forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, [-2.0, 0.0, 0.4, 0.5])


def test_split_equal_parts_without_attr(tmp_path):
    h, TP = onnx_proto.helper, onnx_proto.TensorProto
    path = _write_graph(
        tmp_path, "split.onnx", [h.make_node("Split", ["x"], ["a", "b"],
                                             axis=1)],
        [h.make_tensor_value_info("x", TP.FLOAT, (2, 6))],
        [h.make_tensor_value_info("a", TP.FLOAT, (2, 3)),
         h.make_tensor_value_info("b", TP.FLOAT, (2, 3))])
    sym, _, _ = onnx_mx.import_model(path)
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(2, 6))
    outs = sym.bind(mx.cpu(), args={"x": x}, grad_req="null").forward(
        is_train=False)
    np.testing.assert_array_equal(outs[0].asnumpy(), x.asnumpy()[:, :3])
    np.testing.assert_array_equal(outs[1].asnumpy(), x.asnumpy()[:, 3:])


def test_import_refuses_unknown_ops_as_jax(tmp_path):
    h, TP = onnx_proto.helper, onnx_proto.TensorProto
    path = _write_graph(
        tmp_path, "u.onnx", [h.make_node("NonMaxSuppression", ["x"], ["y"])],
        [h.make_tensor_value_info("x", TP.FLOAT, (4,))],
        [h.make_tensor_value_info("y", TP.FLOAT, (4,))])
    msgs = []
    for mod, err in ((jonnx, JMXNetError), (onnx_mx, MXNetError)):
        with pytest.raises(err) as e:
            mod.import_model(path)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_import_and_export_tables_match_jax():
    assert sorted(onnx_mx._IMPORT_OPS) == sorted(jonnx._IMPORT_OPS)
    assert sorted(onnx_mx._EXPORT_OPS) == sorted(jonnx._EXPORT_OPS)


def test_contrib_onnx_is_exposed():
    assert mx.contrib.onnx is onnx_mx
    assert set(jonnx.__all__) == set(onnx_mx.__all__)
    import mxnet_tpu_torch.contrib as contrib

    assert "not ported" not in contrib.__doc__


# -- both directions across packages ----------------------------------------

_SHAPE = (1, 3, 32, 32)


def _x():
    return np.random.RandomState(0).uniform(-1, 1, _SHAPE).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_resnet_file():
    """A JAX resnet18_v1 (seeded Xavier), its ``.params`` file, its ONNX
    export and its eval output; made once."""
    import tempfile

    d = tempfile.mkdtemp(prefix="interop-onnx-")
    jmx.random.seed(11)
    net = jmx.gluon.model_zoo.vision.resnet18_v1()
    net.initialize(jmx.init.Xavier())
    x = jmx.nd.array(_x())
    ref = net(x).asnumpy()
    net.save_parameters(os.path.join(d, "r18.params"))
    sym = net(jmx.sym.var("data"))
    params = {k: v.data() for k, v in net.collect_params().items()}
    path = os.path.join(d, "jax.onnx")
    jonnx.export_model(sym, params, _SHAPE, onnx_file_path=path)
    return d, path, ref


@functools.lru_cache(maxsize=None)
def _port_resnet_file():
    """The port's resnet18_v1 on the JAX net's weights, exported; made
    once. Returns (path, eval output, the JAX package's output of the
    port's file)."""
    d, _, _ = _jax_resnet_file()
    with mx.context.scope(mx.cpu()):
        net = vision.resnet18_v1()
        net.load_parameters(os.path.join(d, "r18.params"))
        ref = net(mx.nd.array(_x())).asnumpy()
        sym = net(mx.sym.var("data"))
        params = {k: v.data() for k, v in net.collect_params().items()}
        path = os.path.join(d, "port.onnx")
        onnx_mx.export_model(sym, params, _SHAPE, onnx_file_path=path)
    jsym, jargs, jauxs = jonnx.import_model(path)
    jout = jsym.bind(jmx.cpu(), args={**jargs, "data": jmx.nd.array(_x())},
                     grad_req="null", aux_states=jauxs).forward(
        is_train=False)[0].asnumpy()
    return path, ref, jout


def _decode(path):
    m = onnx_proto.load(path)
    g = m.graph
    h = onnx_proto.helper
    nodes = [(n.op_type, len(n.input), len(n.output),
              {a.name: h.get_attribute_value(a) for a in n.attribute})
             for n in g.node]
    inits = [(i.name, onnx_proto.numpy_helper.to_array(i)) for i in
             g.initializer]
    return nodes, inits, [(i.name, [d.dim_value for d in
                                    i.type.tensor_type.shape.dim])
                          for i in g.input]


def test_jax_file_imports_into_the_port():
    _, path, jref = _jax_resnet_file()
    sym, args, auxs = onnx_mx.import_model(path)
    out = sym.bind(mx.cpu(), args={**args, "data": mx.nd.array(_x())},
                   grad_req="null", aux_states=auxs).forward(
        is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, jref, rtol=1e-4, atol=1e-4)


def test_port_file_imports_into_jax():
    path, ref, jout = _port_resnet_file()
    np.testing.assert_allclose(jout, ref, rtol=1e-4, atol=1e-4)
    _, _, jref = _jax_resnet_file()
    np.testing.assert_allclose(ref, jref, rtol=1e-4, atol=1e-4)


def test_both_files_decode_to_the_same_graph():
    _, jpath, _ = _jax_resnet_file()
    ppath, _, _ = _port_resnet_file()
    jn, ji, jin = _decode(jpath)
    pn, pi, pin = _decode(ppath)
    assert pn == jn and pin == jin
    assert [n for n, _ in pi] == [n for n, _ in ji]
    for (name, a), (_, b) in zip(pi, ji):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
