"""The blocks of the vision families whose whole nets are too costly to run
through the JAX package on the CPU, held block by block against it:
Inception V3's A to E at 35 x 35, 17 x 17 and 8 x 8 (their full widths),
MobileNet v1's depthwise pair and v2's linear bottleneck at multiplier
0.25, and ResNet v2's BasicBlockV2 and BottleneckV2 with and without the
projection, fused and not; ResNet v2's input BatchNorm (no gamma, no beta,
3 channels); and the channel axis each concatenating block fixes at
construction, in both layouts. The whole nets of these families run on
the port alone in tests/test_torch_port_vision_nets.py.

Each block is built channels-last inside a `HybridSequential` of prefix
"blk_" in both packages, so the parameter names agree; the JAX block takes
the port block's weights (Xavier from a seed), by name. One training-mode
forward under ``autograd.record`` and a backward of a random cotangent:
the output, the input's gradient, every parameter's gradient and every
running statistic after it agree. A ReLU's gradient jumps at 0, and the
two packages' f32 forwards differ by about 1e-6 there, so a BatchNorm
output within that of 0 may take the ReLU's other branch on one side (seen
in Inception C: one such element moved a conv weight's gradient by 11 %,
while the port matched an f64 computation): the input is the first drawn
from the seed on whose forward every BatchNorm output a ReLU follows lies
at least `KINK` = 2e-6 from 0. The JAX BatchNorms run its jnp path
(MXTPU_PALLAS_CONV_EPILOGUE=0), the function its Pallas conv-epilogue
kernels compute, except in ResNet v2's input BatchNorm, which runs those
kernels in interpret mode
(MXTPU_PALLAS_CONV_EPILOGUE=1, as tests/test_torch_port_resnet.py runs
them): interpret mode costs about 0.9 s a BatchNorm forward and backward
on this CPU, and the Inception blocks alone hold 36.

Tolerances as tests/test_torch_port_resnet.py states them: f32 rtol 1e-4
with an absolute floor of 1e-4 x the largest magnitude of the compared
tensor; a parameter gradient's floor is its layer's (1e-4 x the largest
gradient among a conv's weight and bias or a BatchNorm's gamma and beta,
which come from one cotangent).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception
from mxnet_tpu.gluon.model_zoo.vision import mobilenet as jmobilenet
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinception
from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet as tmobilenet
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs: the suite runs its files in
    parallel worker processes, where more threads a worker only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _wrapped(nn_mod, make):
    net = nn_mod.HybridSequential(prefix="blk_")
    with net.name_scope():
        net.add(make(nn_mod))
    return net


# the margin kept between every BatchNorm output that a ReLU follows and the
# ReLU's kink: the two packages' f32 forwards differ by about 1e-6 there,
# and an output closer to 0 may take the other branch on one side, where
# the gradient jumps by the whole cotangent
KINK = 2e-6


def _port_block(make):
    with tnn.layout_scope():
        net = _wrapped(tnn, make)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu(), seed=0)
    return net


def _kink_free_input(net, shape, seed):
    """The first input drawn from ``seed``, ``seed + 1``, ... whose
    training-mode forward through the port's ``net`` leaves every
    BatchNorm output that a ReLU follows at least `KINK` from 0 (the
    running statistics are restored after each try)."""
    bns = [m for m in net.modules() if isinstance(m, tnn.BatchNorm)
           and m._act_type is None]
    closest = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: closest.append(float(out.abs().min())))
        for m in bns]
    try:
        for s in range(seed, seed + 100):
            x = np.random.RandomState(s).uniform(-1, 1, shape).astype(
                np.float32)
            state = {k: v.clone() for k, v in net.state_dict().items()}
            closest.clear()
            net.train()
            with torch.no_grad():
                net(torch.from_numpy(x))
            net.load_state_dict(state)
            if not closest or min(closest) >= KINK:
                return x, s
    finally:
        for h in hooks:
            h.remove()
    raise AssertionError("no input of seeds %d.. keeps the BatchNorm "
                         "outputs %g from the ReLU kink" % (seed, KINK))


def _jax_run(make, x, ct, params):
    """The JAX block on the port block's weights ``params`` (by name) in
    one recorded training forward and the backward of ``ct``: the output,
    the input's and the parameters' gradients and the parameters
    after."""
    with jgluon.nn.layout_scope():
        net = _wrapped(jgluon.nn, make)
    net.initialize(jmx.init.Xavier())
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(params[k]))
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jautograd.record():
        out = net(jx)
    out.backward(jmx.nd.array(ct))
    params = net.collect_params()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    after = {k: p.data().asnumpy() for k, p in params.items()}
    return out.asnumpy(), jx.grad.asnumpy(), grads, after


def _port_run(net, x, ct):
    tx = mx.nd.array(x, ctx=mx.cpu())
    tx.attach_grad()
    with tautograd.record():
        out = net(tx)
    out.backward(mx.nd.array(ct, ctx=mx.cpu()))
    params = net.collect_params()
    grads = {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"}
    after = {k: p.data().asnumpy() for k, p in params.items()}
    return out.asnumpy(), tx.grad.asnumpy(), grads, after


def _check_block(make_j, make_t, shape, what, seed=0):
    net = _port_block(make_t)
    net.eval()
    with torch.no_grad():   # the deferred shapes
        out = net(torch.zeros(shape))
    params = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    x, s = _kink_free_input(net, shape, seed)
    ct = np.random.RandomState(s + 1000).standard_normal(
        tuple(out.shape)).astype(np.float32)
    jout, jdx, jgrads, jafter = _jax_run(make_j, x, ct, params)
    tout, tdx, tgrads, tafter = _port_run(net, x, ct)
    _close(tout, jout, F32_TOL, what + " out")
    _close(tdx, jdx, F32_TOL, what + " dx")
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        layer = k.rsplit("_", 1)[0]
        scale = max(float(np.max(np.abs(v))) for n, v in jgrads.items()
                    if n.rsplit("_", 1)[0] == layer)
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=F32_TOL,
                                   atol=F32_TOL * scale,
                                   err_msg="%s d%s" % (what, k))
    for k in jafter:
        if k.endswith(("running_mean", "running_var")):
            _close(tafter[k], jafter[k], F32_TOL, "%s %s" % (what, k))


# (name, JAX block, port block, input shape (N, H, W, C))
_INCEPTION = [
    ("A", lambda nn: jinception._make_A(32, "A1_"),
     lambda nn: tinception._make_A(32, "A1_"), (1, 35, 35, 192)),
    ("B", lambda nn: jinception._make_B("B_"),
     lambda nn: tinception._make_B("B_"), (1, 35, 35, 288)),
    ("C", lambda nn: jinception._make_C(128, "C1_"),
     lambda nn: tinception._make_C(128, "C1_"), (1, 17, 17, 768)),
    ("D", lambda nn: jinception._make_D("D_"),
     lambda nn: tinception._make_D("D_"), (1, 17, 17, 768)),
    ("E", lambda nn: jinception._InceptionE("E1_"),
     lambda nn: tinception._InceptionE("E1_"), (1, 8, 8, 1280)),
]


@pytest.mark.parametrize("name,make_j,make_t,shape", _INCEPTION,
                         ids=[c[0] for c in _INCEPTION])
def test_inception_blocks_match_jax(monkeypatch, name, make_j, make_t,
                                    shape):
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "0")
    _check_block(make_j, make_t, shape, "inception " + name)


def test_mobilenet_v1_depthwise_pair_matches_jax(monkeypatch):
    """The 3x3 depthwise conv (groups = channels) with BN and ReLU, then
    the 1x1 conv, at multiplier 0.25 (8 -> 16 channels, stride 2)."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "0")

    def make(mod):
        def build(nn):
            seq = nn.HybridSequential(prefix="")
            mod._add_conv_dw(seq, dw_channels=8, channels=16, stride=2)
            return seq
        return build

    _check_block(make(jmobilenet), make(tmobilenet), (2, 14, 14, 8),
                 "mobilenet v1 pair")


def test_mobilenet_v2_bottleneck_matches_jax(monkeypatch):
    """A linear bottleneck at multiplier 0.25 (6 channels, expansion 6,
    the shortcut), its RELU6 a clip whose gradient at the bounds is the
    JAX package's."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "0")
    _check_block(lambda nn: jmobilenet._LinearBottleneck(6, 6, 6, 1),
                 lambda nn: tmobilenet._LinearBottleneck(6, 6, 6, 1),
                 (2, 10, 10, 6), "mobilenet v2 bottleneck")


# (block, channels, stride, downsample, in_channels, fused, input shape)
_RESNET_V2 = [
    ("BasicBlockV2", 8, 1, False, 8, False, (2, 8, 8, 8)),
    ("BasicBlockV2", 16, 2, True, 8, True, (2, 8, 8, 8)),
    ("BottleneckV2", 16, 1, False, 16, True, (2, 8, 8, 16)),
    ("BottleneckV2", 32, 2, True, 16, False, (2, 8, 8, 16)),
]


@pytest.mark.parametrize("block,channels,stride,downsample,in_c,fused,shape",
                         _RESNET_V2)
def test_resnet_v2_blocks_match_jax(monkeypatch, block, channels, stride,
                                    downsample, in_c, fused, shape):
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "0")

    def make(mod):
        return lambda nn: getattr(mod, block)(
            channels, stride, downsample, in_channels=in_c,
            fuse_epilogue=fused, prefix="")

    _check_block(make(jresnet), make(tresnet), shape,
                 "%s ds=%s fused=%s" % (block, downsample, fused))


def test_resnet_v2_input_batchnorm_matches_jax(monkeypatch):
    """ResNet v2's first layer: BatchNorm(scale=False, center=False) over
    the 3 channels of an NHWC image, trained through the JAX package's
    Pallas kernels (interpret mode) and the port's epilogue (its plain
    version here; the kernels' scalar path on the card). No gamma or beta
    takes a gradient; the input's gradient and the running statistics
    agree."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    _check_block(lambda nn: nn.BatchNorm(scale=False, center=False),
                 lambda nn: nn.BatchNorm(scale=False, center=False),
                 (2, 12, 12, 3), "resnet v2 input BN", seed=1)


def _to_nchw_state(state):
    """A channels-last net's state dict for the channels-first build: each
    conv weight (O, kh, kw, I) -> (O, I, kh, kw)."""
    return {k: v.permute(0, 3, 1, 2).contiguous() if v.dim() == 4 else v
            for k, v in state.items()}


@pytest.mark.parametrize("block", ["inception_A", "densenet_layer",
                                   "squeezenet_fire"])
def test_concat_axis_is_fixed_at_construction(block):
    """A concatenating block built in either layout concatenates that
    layout's channel axis: the NHWC build and the NCHW build, on the same
    weights, compute the same function (transposed), and the NHWC one
    built outside the scope but fed NHWC data does not."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import densenet, squeezenet

    makers = {
        "inception_A": (lambda: tinception._make_A(8, "A1_"), 16),
        "densenet_layer": (lambda: densenet._DenseLayer(4, 2, 0), 6),
        "squeezenet_fire": (lambda: squeezenet._Fire(4, 6, 6), 5)}
    make, c = makers[block]
    x = np.random.RandomState(2).uniform(-1, 1, (2, 9, 9, c)).astype(
        np.float32)
    nets = {}
    for layout in ("NHWC", "NCHW"):
        with tnn.layout_scope(layout == "NHWC"):
            net = _wrapped(tnn, lambda nn: make())
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net.eval()
        nets[layout] = net
    with torch.no_grad():
        nets["NHWC"](torch.from_numpy(x))
        nets["NCHW"](torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        nets["NCHW"].load_state_dict(_to_nchw_state(
            nets["NHWC"].state_dict()))
        want = nets["NHWC"](torch.from_numpy(x)).numpy()
        got = nets["NCHW"](torch.from_numpy(x).permute(0, 3, 1, 2)
                           .contiguous()).permute(0, 2, 3, 1).numpy()
    _close(got, want, F32_TOL, block)
    assert want.shape[-1] > c
