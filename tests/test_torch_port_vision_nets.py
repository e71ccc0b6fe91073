"""The vision families of the PyTorch port as whole nets against the JAX
package, on the CPU, where one run of the JAX net is cheap: VGG with
BatchNorm at narrow widths, AlexNet and SqueezeNet 1.1 at batch 1, and
DenseNet(8, 4, (1, 1, 1, 1)); the weights crossing both ways
(`convert.vision_params_from_jax`, ``.params`` files); and `get_model`
against the JAX package's table; and every family at full width against
the JAX package's symbol shape inference, with Inception V3 at 299 x 299
and a `train_imagenet` step on the port alone.

The nets are built channels-last (`layout_scope`), the slice's training
layout. The JAX side trains its BatchNorms through its jnp path
(MXTPU_PALLAS_CONV_EPILOGUE=0, by monkeypatch), the function its Pallas
conv-epilogue kernels compute: tests/test_torch_port_resnet.py holds the
port's epilogue against those kernels in interpret mode, and
tests/test_torch_port_vision_blocks.py does at ResNet v2's input
BatchNorm, but interpret mode costs about 0.9 s a BatchNorm forward and
backward on this CPU, too much for whole nets in the tests' time. The
JAX net takes the port net's weights (Xavier from a seed), by name. The
input is the first drawn from the seed on whose forward every
BatchNorm output a ReLU follows lies at least `KINK` from 0 (see
tests/test_torch_port_vision_blocks.py: there a rounding apart can put
the two packages on the two sides of the kink). One training step
each: a forward in training mode under ``autograd.record``, the softmax
cross-entropy's backward, and a ``gluon.Trainer`` SGD step (lr 0.1) on
the port side; the output, the loss, every gradient, every running
statistic and every parameter's change (against the JAX package's SGD
rule on the JAX gradients) agree. Dropout is set to rate 0 on both sides
(threefry and Philox masks cannot match), so the parts around it are
compared; its own draw is tested in tests/test_torch_port_vision_ops.py.

Tolerances as tests/test_torch_port_resnet.py states them: f32 rtol 1e-4
with an absolute floor of 1e-4 x the largest magnitude of the compared
tensor (sums in other orders). A weight gradient's floor is that of its
layer: 1e-4 x the largest gradient magnitude among the layer's parameters.
A BatchNorm's gamma and beta gradients and a convolution's bias gradient
are sums over every row of the layer's output (up to 12,544 here), which
can cancel far below their terms (a conv bias a BatchNorm follows has a
gradient of 0 but for rounding; DenseNet's stem gamma too, by the scale
symmetry of the BatchNorms after it); their floor is 1e-4 x the sum of
their terms' magnitudes, channel by channel (`_term_sums`, from the
port's forward and backward). A parameter's change in the step is the
difference of two f32 values of the parameter's size, so its floor is at
least one f32 rounding step of the parameter's largest magnitude (2^-23 x
max|param|): a batch-1 step moves some weights by less than that.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import train_imagenet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

F32_TOL = 1e-4
LR = 0.1


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


def _no_dropout(net):
    for blk in _blocks(net):
        if type(blk).__name__ == "Dropout":
            blk._rate = 0.0


def _blocks(net):
    yield net
    for child in net._children.values():
        yield from _blocks(child)


# the margin kept between every BatchNorm output that a ReLU follows and the
# ReLU's kink: the two packages' f32 forwards differ by about 1e-6 there,
# and an output closer to 0 may take the other branch on one side, where
# the gradient jumps by the whole cotangent
KINK = 2e-6


def _port_net(make, shape, seed):
    """The port's net with Xavier weights from a seed (its deferred shapes
    from one inference forward), Dropout at rate 0, and the first input
    drawn from ``seed``, ``seed + 1``, ... on whose training-mode forward
    every BatchNorm output a ReLU follows lies at least `KINK` from 0 (the
    running statistics restored after each try)."""
    with tnn.layout_scope():
        net = make()
    net.initialize(mx.init.Xavier(), seed=seed)
    _no_dropout(net)
    net.eval()
    with torch.no_grad():
        net(torch.zeros(shape))
    bns = [m for m in net.modules() if isinstance(m, tnn.BatchNorm)]
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
                return net, x
    finally:
        for h in hooks:
            h.remove()
    raise AssertionError("no input keeps the BatchNorms %g from the ReLU "
                         "kink" % KINK)


def _jax_step(make, params, x, y):
    """The JAX net on the port net's weights ``params`` (by structural
    name) in one training forward and backward: the output, the loss, the
    gradients and the parameters after, by structural name (the name past
    the top prefix)."""
    with jgluon.nn.layout_scope():
        jnet = make()
    jnet.initialize(jmx.init.Xavier())
    _no_dropout(jnet)
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(params[k.split("_", 1)[1]]))
    with jautograd.record():
        out = jnet(jmx.nd.array(x))
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(out, jmx.nd.array(y))
    loss.backward()
    params = jnet.collect_params()
    grads = {k.split("_", 1)[1]: p.grad().asnumpy() for k, p in
             params.items() if p.grad_req != "null"}
    after = {k.split("_", 1)[1]: p.data().asnumpy() for k, p in
             params.items()}
    return out.asnumpy(), loss.asnumpy(), grads, after


def _term_sums(net, sums):
    """Hooks that record, for each BatchNorm's gamma and beta and each
    convolution's bias, the per-channel sum of the magnitudes of the terms
    its gradient sums over the rows: sum|g * xhat| for gamma, sum|g| for a
    beta or a bias, g the cotangent of the layer's output. A gradient that
    cancels far below its terms is as exact as those sums allow."""
    hooks = []

    def bn_hook(mod, inp, out):
        c = out.shape[mod._axis]
        x = inp[0].detach().float().movedim(mod._axis, -1).reshape(-1, c)
        var, mean = torch.var_mean(x, 0, correction=0)
        xhat = (x - mean) * torch.rsqrt(var + mod._kwargs["eps"])
        names = [mod._reg_params[n].name.split("_", 1)[1]
                 for n in ("gamma", "beta")]

        def grad_hook(g):
            g = g.detach().float().movedim(mod._axis, -1).reshape(-1, c)
            sums[names[0]] = (g * xhat).abs().sum(0).numpy()
            sums[names[1]] = g.abs().sum(0).numpy()

        out.register_hook(grad_hook)

    def conv_hook(mod, inp, out):
        name = mod._reg_params["bias"].name.split("_", 1)[1]
        axis = -1 if mod._ch_last else 1

        def grad_hook(g):
            g = g.detach().float().movedim(axis, -1)
            sums[name] = g.reshape(-1, g.shape[-1]).abs().sum(0).numpy()

        out.register_hook(grad_hook)

    for m in net.modules():
        if isinstance(m, tnn.BatchNorm) and m._act_type is None:
            hooks.append(m.register_forward_hook(bn_hook))
        elif isinstance(m, tnn.Conv2D) and m.bias is not None:
            hooks.append(m.register_forward_hook(conv_hook))
    return hooks


def _port_step(net, x, y):
    """One training step through the port's façade: out, loss, the
    gradients, and the parameters before and after a `gluon.Trainer` SGD
    step, by structural name."""
    params = net.collect_params()
    trainer = tgluon.Trainer(params, "sgd", {"learning_rate": LR})
    sums = {}
    hooks = _term_sums(net, sums)
    with tautograd.record():
        out = net(mx.nd.array(x, ctx=mx.cpu()))
        loss = tgluon.loss.SoftmaxCrossEntropyLoss()(
            out, mx.nd.array(y, ctx=mx.cpu()))
    loss.backward()
    for h in hooks:
        h.remove()
    grads = {k.split("_", 1)[1]: p.grad().asnumpy() for k, p in
             params.items() if p.grad_req != "null"}
    before = {k.split("_", 1)[1]: p.data().asnumpy().copy() for k, p in
              params.items()}
    trainer.step(x.shape[0])
    after = {k.split("_", 1)[1]: p.data().asnumpy() for k, p in
             params.items()}
    return out.asnumpy(), loss.asnumpy(), grads, before, after, sums


def _within(got, want, floor, what):
    """|got - want| <= 1e-4 |want| + floor, elementwise; ``floor`` a scalar
    or one value a channel (the last axis)."""
    err = np.abs(got - want) - F32_TOL * np.abs(want) - floor
    assert err.max() <= 0, "%s: off by %g beyond the tolerance" % (
        what, float(err.max()))


def _layer_floor(values, k):
    layer = k.rsplit("_", 1)[0]
    return F32_TOL * max(float(np.max(np.abs(v))) for n, v in values.items()
                         if n.rsplit("_", 1)[0] == layer)


# the port's constructors also take the device (the CPU here)
_FAMILIES = {
    "vgg_bn": (lambda m, **kw: m.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                     classes=10, batch_norm=True, **kw),
               (2, 32, 32, 3)),
    "alexnet": (lambda m, **kw: m.AlexNet(classes=10, **kw), (1, 67, 67, 3)),
    "squeezenet1_1": (lambda m, **kw: m.squeezenet1_1(classes=10, **kw),
                      (1, 224, 224, 3)),
    "densenet": (lambda m, **kw: m.DenseNet(8, 4, (1, 1, 1, 1), classes=10,
                                            **kw), (1, 224, 224, 3)),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_family_training_step_matches_jax(monkeypatch, family):
    """Output, loss and every gradient of a training-mode step; every
    running statistic after it; every parameter's change in an SGD step,
    against the JAX step's ``-lr * grad / batch`` (the JAX package's SGD
    without momentum or wd)."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "0")
    make, shape = _FAMILIES[family]
    tnet, x = _port_net(lambda: make(tvision, device="cpu"), shape, 1)
    y = np.random.RandomState(2).randint(0, 10, shape[0]).astype(np.float32)
    params = {p.name.split("_", 1)[1]: p.data().asnumpy() for p in
              tnet.collect_params().values()}
    jout, jloss, jgrads, jafter = _jax_step(lambda: make(jvision), params,
                                            x, y)
    tout, tloss, tgrads, tbefore, tafter, sums = _port_step(tnet, x, y)
    _close(tout, jout, F32_TOL, family + " out")
    _close(tloss, jloss, F32_TOL, family + " loss")
    assert sorted(tgrads) == sorted(jgrads)
    floors = {k: F32_TOL * sums[k] if k in sums else _layer_floor(jgrads, k)
              for k in jgrads}
    for k in jgrads:
        _within(tgrads[k], jgrads[k], floors[k], "%s d%s" % (family, k))
    assert sorted(tafter) == sorted(jafter)
    for k in jafter:
        if k.endswith(("running_mean", "running_var")):
            _close(tafter[k], jafter[k], F32_TOL, "%s %s" % (family, k))
        elif k in jgrads:
            # the JAX package's SGD step: -lr * grad / batch
            scale = LR / x.shape[0]
            floor = np.maximum(floors[k] * scale,
                               2.0 ** -23 * float(np.max(np.abs(tbefore[k]))))
            _within(tafter[k] - tbefore[k], -scale * jgrads[k], floor,
                    "%s %s change" % (family, k))


def test_params_files_cross_both_ways(tmp_path):
    """``save_parameters`` / ``load_parameters`` of DenseNet(8, 4, (1, 1, 1,
    1)) between the packages: the port reads the JAX net's file and
    computes its outputs, and the JAX net reads the port's."""
    x = np.random.RandomState(2).uniform(-1, 1, (1, 224, 224, 3)).astype(
        np.float32)
    np.random.seed(3)
    with jgluon.nn.layout_scope():
        jnet = jvision.DenseNet(8, 4, (1, 1, 1, 1), classes=10)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(tmp_path / "j.params"))
    with tnn.layout_scope():
        tnet = tvision.DenseNet(8, 4, (1, 1, 1, 1), classes=10, device="cpu")
    tnet.load_parameters(str(tmp_path / "j.params"), ctx=mx.cpu())
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    _close(got, want, F32_TOL, "JAX file into the port")
    with tautograd.train_mode():
        tnet(mx.nd.array(x, ctx=mx.cpu()))   # moves the running statistics
    tnet.eval()
    with torch.no_grad():
        want = tnet(torch.from_numpy(x)).numpy()
    tnet.save_parameters(str(tmp_path / "t.params"))
    jnet.load_parameters(str(tmp_path / "t.params"))
    _close(jnet(jmx.nd.array(x)).asnumpy(), want, F32_TOL,
           "port file into JAX")


def test_vision_params_from_jax_raises_on_what_it_cannot_place():
    """Arrays named as the JAX package names a VGG's (``vgg0_...``) are
    placed by name; a wrong shape, an extra or a missing name, or two
    nets' names raise."""
    with tnn.layout_scope():
        tnet = tvision.VGG([1] * 5, [4] * 5, classes=3, device="cpu")
    tnet.initialize(mx.init.Xavier())
    tnet(torch.zeros(1, 32, 32, 3))
    params = {"vgg0_" + p.name.split("_", 1)[1]: p.data().asnumpy() + 1
              for p in tnet.collect_params().values()}
    state = convert.vision_params_from_jax(params, tnet)
    assert sorted(state) == sorted(tnet.state_dict())
    tnet.load_state_dict(state)
    for path, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), params["vgg0_" + p.name.split("_", 1)[1]])
    bad = dict(params)
    bad[next(k for k in bad if k.endswith("dense2_weight"))] = \
        np.zeros((3, 5), np.float32)
    with pytest.raises(MXNetError, match="shape"):
        convert.vision_params_from_jax(bad, tnet)
    extra = dict(params, vgg0_conv2d9_weight=np.zeros((1,), np.float32))
    with pytest.raises(MXNetError, match="not in the port net"):
        convert.vision_params_from_jax(extra, tnet)
    missing = {k: v for k, v in params.items() if "conv2d0" not in k}
    with pytest.raises(MXNetError, match="missing"):
        convert.vision_params_from_jax(missing, tnet)
    with pytest.raises(MXNetError, match="not one network"):
        convert.vision_params_from_jax(dict(params, other0_w=np.zeros(1)),
                                       tnet)


def test_get_model_resolves_every_name_of_the_jax_table():
    """Every name of the JAX package's table, and the reference's dotted
    spellings, resolves to the port's factory of that name, except the
    SSD family and the space-to-depth stem helpers, which raise naming
    the roadmap item; an unknown name raises naming the available
    models, as in the JAX package."""
    names = sorted(jvision._models)
    assert len(names) == 43
    not_ported = set(tvision._NOT_PORTED)
    assert not_ported <= set(names)
    assert sorted(set(tvision._models) | not_ported) == names
    for n in names:
        if n in not_ported:
            with pytest.raises(MXNetError, match="not ported yet"):
                tvision.get_model(n)
        else:
            assert tvision._models[n].__name__ == n
    for alias, want in [("mobilenet0.25", "mobilenet0_25"),
                        ("squeezenet1.0", "squeezenet1_0"),
                        ("inceptionv3", "inception_v3"),
                        ("MobileNetV2_0.5", "mobilenet_v2_0_5"),
                        ("ResNet50_V2", "resnet50_v2")]:
        net = tvision.get_model(alias, classes=4, device="cpu")
        jnet = jvision.get_model(alias, classes=4)
        assert type(net).__name__ == type(jnet).__name__, alias
        assert tvision.get_model(want, classes=4, device="cpu").prefix[
            :-2] == net.prefix[:-2]
    with pytest.raises(MXNetError, match="Available"):
        tvision.get_model("resnet51_v1")
    with pytest.raises(MXNetError, match="not ported yet"):
        tvision.get_model("ssd_512_resnet50_v1")

# ---------------------------------------------------------------------------
# every family at full width: its parameters' names and shapes against the
# JAX package's symbol shape inference (``net(mx.sym.var("data"))
# .infer_shape``, which computes nothing), both nets built channels-first
# (the layout in which the JAX package's shape rules give a convolution's
# weight shape: they read the channels at axis 1), the port's deferred
# shapes from one inference forward of a zero image; and Inception V3 at
# 299 x 299 with `train_imagenet` on the port alone (the JAX net at that
# size is too slow on this CPU; its blocks are held in
# tests/test_torch_port_vision_blocks.py)
# ---------------------------------------------------------------------------

# name: (image side, BatchNorms, parameter arrays incl. running statistics,
# trainable values) of the JAX package's nets
_FULL_WIDTH = {
    "inception_v3": (299, 94, 472, 23834568),
    "densenet121": (224, 121, 606, 7978856),
    "resnet50_v2": (224, 51, 259, 25549486),
    "mobilenet_v2_1_0": (224, 53, 266, 3504960),
    "mobilenet1_0": (224, 27, 137, 4231976),
    "vgg16_bn": (224, 13, 84, 138365992),
    "squeezenet1_1": (224, 0, 52, 1235496),
    "alexnet": (224, 0, 16, 61100840),
}


def _tail(name):
    return name.split("_", 1)[1]


@pytest.mark.parametrize("name", sorted(_FULL_WIDTH))
def test_full_width_parameters_match_jax_shape_inference(name):
    side, n_bn, n_arrays, n_values = _FULL_WIDTH[name]
    jnet = jvision.get_model(name)
    sym = jnet(jmx.sym.var("data"))
    arg, _, aux = sym.infer_shape(data=(1, 3, side, side))
    want = dict(zip(sym.list_arguments(), arg))
    want.update(zip(sym.list_auxiliary_states(), aux))
    want = {_tail(k): tuple(v) for k, v in want.items() if k != "data"}
    assert len(want) == n_arrays

    net = tvision.get_model(name, device="cpu")
    net.initialize(init="xavier", seed=0)
    net.eval()
    with torch.no_grad():
        out = net(torch.zeros(1, 3, side, side))
    assert tuple(out.shape) == (1, 1000)
    got = {_tail(p.name): tuple(p.shape) for p in
           net.collect_params().values()}
    assert got == want
    assert sum(isinstance(m, tnn.BatchNorm) for m in net.modules()) == n_bn
    assert sum(p.numel() for p in net.parameters()) == n_values


def test_inception_v3_at_299_and_a_train_imagenet_step():
    """Inception V3 made by `train_imagenet.build_network` at 299 x 299,
    NHWC (its deferred shapes from one forward of a zero image), and one
    more f32 forward of a batch on the port alone: finite logits of shape
    (1, 10); 224 x 224 does not fit its final AvgPool2D(8) and raises,
    naming the size. Then the script itself steps a family named the
    reference's dotted way (MobileNet 0.25, bf16 over f32 masters) to a
    finite loss."""
    net = train_imagenet.build_network("inception_v3", 10, (3, 299, 299),
                                       "NHWC", "cpu", 0)
    net.eval()
    x = np.random.RandomState(4).uniform(-1, 1, (1, 299, 299, 3))
    with torch.no_grad():
        out = net(torch.from_numpy(x.astype(np.float32)))
    assert tuple(out.shape) == (1, 10) and bool(torch.isfinite(out).all())
    with pytest.raises(MXNetError, match="built for 299 x 299"):
        train_imagenet.build_network("inception_v3", 10, (3, 224, 224),
                                     "NHWC", "cpu", 0)
    loss = train_imagenet.main(["--device", "cpu", "--network",
                                "mobilenet0.25", "--batch-size", "2",
                                "--num-batches", "1", "--layout", "NHWC",
                                "--num-classes", "10", "--image-shape",
                                "3,64,64"])
    assert np.isfinite(loss)


@pytest.mark.parametrize("name,image", [("resnet18_v2", (3, 32, 32)),
                                        ("mobilenet0_25", (3, 64, 64)),
                                        ("squeezenet1_0", (3, 224, 224))])
def test_build_network_takes_in_channels_and_device(name, image):
    """`train_imagenet.build_network` hands every factory ``in_channels``
    and ``device``: the parameters are on that device with the first
    layer sized for the image's channels, and Xavier fills them from the
    seed (two builds agree bit for bit)."""
    nets = [train_imagenet.build_network(name, 7, image, "NHWC", "cpu", 5)
            for _ in range(2)]
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        assert a.var.device.type == "cpu"
        assert torch.equal(a.var, b.var)
    first = next(iter(nets[0].collect_params().values()))
    assert image[0] in first.shape
    with pytest.raises(MXNetError, match="not supported"):
        train_imagenet.build_network("resnet51_v1", 7, image, "NHWC", "cpu",
                                     0)
