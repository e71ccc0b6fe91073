"""ResNet training path of the PyTorch port against the JAX package, on the
CPU.

The JAX side runs as tests/test_conv_epilogue.py runs it: its Pallas
conv-epilogue kernels in interpret mode, with MXTPU_PALLAS_CONV_EPILOGUE=1
(through monkeypatch) wherever the routing in `ops/nn.py:_bn_act` is
involved. The port runs its plain versions, which its wrappers take for
CPU tensors. Inputs are made with numpy from a seed and handed to both.
The card-only tests of the kernels are in tests/test_torch_port_cuda.py.

Tolerances, and why:

* f32: rtol 1e-4 with an absolute floor of 1e-4 x the largest magnitude of
  the compared tensor. Both sides compute in f32 but sum in different
  orders (batch moments over up to ~2000 rows, the conv and GEMM
  reductions); a BN gradient element near zero comes out of cancellations
  and carries the absolute error of its terms, not a relative one.
* bf16 values: rtol 2^-7 with an absolute floor of 2^-7 x the largest
  magnitude: one bf16 rounding step is 2^-8 relative, and the two sides
  may round an f32 result that lies near a bf16 tie to neighbouring values
  (the kernels' f32 arithmetic is the same, its summation order is not).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_kernels as jpk

from mxnet_tpu_torch import convert, initializer, metric, telemetry
from mxnet_tpu_torch import optimizer as toptim
from mxnet_tpu_torch import train_imagenet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import optimizer_ops as topt
from mxnet_tpu_torch.ops import pallas_kernels as tpk
from mxnet_tpu_torch.parallel import DistributedTrainer

EPS = 1e-3
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _np(t):
    return t.detach().float().cpu().numpy()


def _epi_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 3.0).astype(np.float32)
    res = rng.randn(*shape).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    return x, gamma, beta, res, ct


def _jax_epilogue(x, gamma, beta, res, ct, dtype, fix_gamma, relu):
    """JAX conv_epilogue (Pallas, interpret mode): out, mean, var and the
    gradients of sum(out * ct) in x, gamma, beta (, residual)."""
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta)]
    if res is not None:
        args.append(jnp.asarray(res, jdt))
    cta = jnp.asarray(ct, jdt)

    def f(*a):
        out, mean, var = jpk.conv_epilogue(
            a[0], a[1], a[2], a[3] if res is not None else None, eps=EPS,
            fix_gamma=fix_gamma, relu=relu)
        return jnp.sum(out.astype(jnp.float32) * cta.astype(jnp.float32)), \
            (out, mean, var)

    (_, (out, mean, var)), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return out, mean, var, grads


def _torch_epilogue(fn, x, gamma, beta, res, ct, dtype, fix_gamma, relu):
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    rt = None if res is None else torch.from_numpy(res).to(tdt) \
        .requires_grad_()
    out, mean, var = fn(xt, gt, bt, rt, eps=EPS, fix_gamma=fix_gamma,
                        relu=relu)
    assert out.dtype == tdt and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    cta = torch.from_numpy(ct).to(tdt).float()
    (out.float() * cta).sum().backward()
    grads = [xt.grad, gt.grad, bt.grad] + ([] if rt is None else [rt.grad])
    return out, mean, var, grads


# (shape, relu, has_res, fix_gamma): C = 3, 64, 200; R = 70, 2001 and 462
# rows, none a multiple of the JAX kernels' row blocks (32..512)
_EPI_CASES = [
    ((2, 5, 7, 3), True, False, False),
    ((2, 5, 7, 3), False, False, True),
    ((3, 23, 29, 64), True, True, False),
    ((3, 23, 29, 64), False, False, False),
    ((2, 11, 21, 200), True, False, True),
    ((2, 11, 21, 200), False, True, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,relu,has_res,fix_gamma", _EPI_CASES)
def test_conv_epilogue_matches_jax(monkeypatch, dtype, shape, relu, has_res,
                                   fix_gamma):
    """Values and gradients of the port's `conv_epilogue` (the autograd
    Function over the four kernels' plain versions, as the wrapper runs
    on the CPU) and of `conv_epilogue_reference` (autograd through the
    plain forward) against the JAX package's `conv_epilogue`."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    x, gamma, beta, res, ct = _epi_inputs(shape, seed=len(shape) + shape[-1])
    if dtype == "bfloat16":   # the same bf16 values on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    res = res if has_res else None
    ref = _jax_epilogue(x, gamma, beta, res, ct, dtype, fix_gamma, relu)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for fn in (tpk.conv_epilogue, tpk.conv_epilogue_reference):
        out, mean, var, grads = _torch_epilogue(fn, x, gamma, beta, res, ct,
                                                dtype, fix_gamma, relu)
        _close(_np(out), np.asarray(ref[0], np.float32), tol, "out")
        # the moments are f32 on both sides whatever the input dtype
        _close(_np(mean), ref[1], F32_TOL, "mean")
        _close(_np(var), ref[2], F32_TOL, "var")
        names = ["x", "gamma", "beta", "residual"]
        for name, g, want in zip(names, grads, ref[3]):
            want = np.asarray(want, np.float32)
            if g is None:   # fix_gamma: the reference never reads gamma
                assert name == "gamma" and fix_gamma
                assert not want.any()
                continue
            # dgamma / dbeta are f32 sums on both sides
            gtol = tol if name in ("x", "residual") else F32_TOL
            if dtype == "bfloat16" and name in ("gamma", "beta"):
                # summed over products of bf16-rounded terms: each side
                # rounds its masked cotangent and xhat in another order
                gtol = BF16_TOL
            _close(_np(g), want, gtol, "d" + name)
            if name == "gamma" and fix_gamma:
                assert not _np(g).any()


def test_conv_epilogue_cpu_counts_no_launch_and_keeps_shape():
    x, gamma, beta, res, _ = _epi_inputs((2, 3, 4, 8), 0)
    before = [getattr(tpk, n).launches for n in
              ("epi_stats", "epi_apply", "epi_bwd_reduce", "epi_bwd_dx")]
    xt = torch.from_numpy(x).requires_grad_()
    out, mean, var = tpk.conv_epilogue(xt, torch.from_numpy(gamma),
                                       torch.from_numpy(beta),
                                       torch.from_numpy(res))
    out.sum().backward()
    assert out.shape == xt.shape and mean.shape == var.shape == (8,)
    assert [getattr(tpk, n).launches for n in
            ("epi_stats", "epi_apply", "epi_bwd_reduce",
             "epi_bwd_dx")] == before


def test_bn_stats_large_mean_small_spread():
    """The proxy shift keeps E[d^2] - E[d]^2 from cancelling: a channel at
    mean 1e4 with spread 1e-2 keeps its variance in f32."""
    rng = np.random.RandomState(3)
    x = (1e4 + 1e-2 * rng.randn(4096, 2)).astype(np.float32)
    mean, var = tops._bn_stats(torch.from_numpy(x))
    _close(mean.numpy(), x.astype(np.float64).mean(0), 1e-6, "mean")
    _close(var.numpy(), x.astype(np.float64).var(0), 2e-2, "var")


def _bn_inputs(shape, axis, seed):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    return ((rng.randn(*shape) * 1.5 + 0.7).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


# (op, axis, is_train, use_global_stats): the channels-last training path,
# the channels-first one, inference, and use_global_stats in training
_BN_CASES = [
    ("batch_norm", -1, True, False),
    ("batch_norm_relu", -1, True, False),
    ("batch_norm_add_relu", -1, True, False),
    ("batch_norm_add_relu", 1, True, False),
    ("batch_norm_relu", -1, False, False),
    ("batch_norm", 1, True, True),
]


@pytest.mark.parametrize("op,axis,is_train,use_global", _BN_CASES)
def test_bn_ops_match_jax(monkeypatch, op, axis, is_train, use_global):
    """The BN ops at op level: output, the moving-statistics update (in
    place in the port) and the gradients of data, gamma, beta, addend."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    shape = (3, 6, 5, 16)
    x, add, g, b, mm, mv, ct = _bn_inputs(shape, axis, seed=11)
    has_add = op == "batch_norm_add_relu"
    kw = dict(eps=EPS, momentum=0.9, fix_gamma=False,
              use_global_stats=use_global, axis=axis, is_train=is_train)

    def jf(x_, g_, b_, a_):
        fn = getattr(jnn, op)
        args = (x_, a_) if has_add else (x_,)
        out, nmm, nmv = fn(*args, g_, b_, jnp.asarray(mm), jnp.asarray(mv),
                           **kw)
        return jnp.sum(out * jnp.asarray(ct)), (out, nmm, nmv)

    (_, (jout, jmm, jmv)), jgrads = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(add))

    xt, gt, bt, at = (torch.from_numpy(a).requires_grad_()
                      for a in (x, g, b, add))
    tmm, tmv = torch.from_numpy(mm.copy()), torch.from_numpy(mv.copy())
    args = (xt, at) if has_add else (xt,)
    out, omm, omv = getattr(tops, op)(*args, gt, bt, tmm, tmv, **kw)
    assert omm is tmm and omv is tmv   # updated in place
    (out * torch.from_numpy(ct)).sum().backward()
    _close(_np(out), jout, F32_TOL, "out")
    _close(tmm.numpy(), jmm, F32_TOL, "moving_mean")
    _close(tmv.numpy(), jmv, F32_TOL, "moving_var")
    for name, t, want in zip(["x", "gamma", "beta", "addend"],
                             [xt, gt, bt, at], jgrads):
        if name == "addend" and not has_add:
            continue
        _close(_np(t.grad), want, F32_TOL, "d" + name)


def _small_nets(seed):
    """The JAX test net and the port's, the port's weights converted from
    the JAX net's."""
    np.random.seed(seed)   # the JAX Xavier draws from numpy's global state
    with jgluon.nn.layout_scope():
        jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [8, 16, 32],
                                classes=10, thumbnail=True,
                                fuse_epilogue=True)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((2, 8, 8, 3)))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    with tnn.layout_scope():
        tnet = tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1], [8, 16, 32],
                                classes=10, thumbnail=True,
                                fuse_epilogue=True, device="cpu")
    tnet.load_state_dict(convert.resnet_params_from_jax(params), strict=True)
    return jnet, tnet


def _batch(seed, n=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, (n,)).astype(np.int64)
    return x, y


def test_small_resnet_forward_matches_jax(monkeypatch):
    """Forward in inference mode (running statistics) and in training mode
    (batch statistics, through the conv epilogue)."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    jnet, tnet = _small_nets(seed=1)
    x, _ = _batch(2)
    want = jnet(mx.nd.array(x)).asnumpy()
    tnet.eval()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    _close(got.numpy(), want, F32_TOL, "predict")
    with jautograd.record():
        want_train = jnet(mx.nd.array(x)).asnumpy()
    tnet.train()
    with torch.no_grad():
        got_train = tnet(torch.from_numpy(x))
    _close(got_train.numpy(), want_train, F32_TOL, "train-mode forward")


def test_small_resnet_two_trainer_steps_match_jax(monkeypatch):
    """Two DistributedTrainer steps in f32 (SGD, momentum 0.9, wd 1e-4) on
    one device each: every loss, every parameter and every running
    statistic agree."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    from mxnet_tpu.parallel import DistributedTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh

    jnet, tnet = _small_nets(seed=2)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    mesh = make_mesh([("dp", 1)], devices=jax.devices()[:1])
    jtr = JTrainer(jnet, "sgd", dict(opt),
                   loss=jgluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh)
    ttr = DistributedTrainer(tnet, "sgd", dict(opt),
                             loss=tloss.SoftmaxCrossEntropyLoss())
    for step in range(2):
        x, y = _batch(10 + step)
        jl = float(jtr.step(mx.nd.array(x),
                            mx.nd.array(y.astype(np.float32))).asnumpy())
        tl = ttr.step(torch.from_numpy(x), torch.from_numpy(y))
        assert tl.dtype == np.float32 and tl.shape == ()
        _close(float(tl), jl, F32_TOL, "loss step %d" % step)
    jtr.sync_params()
    want = convert.resnet_params_from_jax(
        {k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
    state = tnet.state_dict()
    assert sorted(state) == sorted(want)
    for k in want:
        _close(state[k].numpy(), want[k].numpy(), F32_TOL, k)


def test_resnet50_structure_matches_jax():
    """The port's resnet50_v1 has the JAX net's parameters, one to one by
    name through the converter, with the same shapes: 267 arrays (running
    statistics included), 25,610,152 values."""
    np.random.seed(0)
    with jgluon.nn.layout_scope():
        jnet = jresnet.resnet50_v1(classes=1000, fuse_epilogue=True)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 32, 32, 3)))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    with tnn.layout_scope():
        tnet = tresnet.resnet50_v1(classes=1000, fuse_epilogue=True,
                                   device="cpu")
    state = tnet.state_dict()
    conv = convert.resnet_params_from_jax(params, fuse_epilogue=True)
    assert sorted(conv) == sorted(state)
    for k, v in conv.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
    assert len(state) == len(params) == 267
    assert sum(v.numel() for v in state.values()) == sum(
        int(np.prod(v.shape)) for v in params.values()) == 25610152
    bns = [m for m in tnet.modules() if isinstance(m, tnn.BatchNorm)]
    assert len(bns) == 53
    # the reference graph: the same names, and the JAX reference graph's
    # paths (its ReLUs are Activation children)
    with tnn.layout_scope():
        plain = tresnet.resnet50_v1(fuse_epilogue=False, device="cpu")
    assert sorted(p.split("_", 1)[1] for p in plain.collect_params()) == \
        sorted(k.split("_", 1)[1] for k in params)
    assert sorted(plain.state_dict()) == sorted(
        convert.resnet_params_from_jax(params, fuse_epilogue=False))


@pytest.mark.parametrize("value", [None, "", "0", "1", "auto"])
def test_fuse_epilogue_env_picks_the_graph_as_jax(monkeypatch, value):
    """MXTPU_PALLAS_CONV_EPILOGUE picks the same zoo graph in both
    packages: set and not "0" builds the fused graph."""
    if value is None:
        monkeypatch.delenv("MXTPU_PALLAS_CONV_EPILOGUE", raising=False)
    else:
        monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", value)
    want = jresnet._fuse_epilogue_default(None)
    assert tresnet._fuse_epilogue_default(None) == want
    assert want == (value not in (None, "", "0"))
    with tnn.layout_scope():
        net = tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1], [8, 16, 32],
                               classes=10, thumbnail=True, device="cpu")
    fused = [m for m in net.modules()
             if isinstance(m, tnn.BatchNorm) and m._act_type == "relu"]
    assert bool(fused) == want


def test_resnet_params_from_jax_raises_on_what_it_cannot_place():
    good = {"resnetv10_" + k: v for k, v in {
        "conv2d0_weight": np.zeros((8, 3, 3, 3), np.float32),
        "dense0_weight": np.zeros((10, 32), np.float32),
        "dense0_bias": np.zeros(10, np.float32)}.items()}
    with pytest.raises(MXNetError):
        convert.resnet_params_from_jax(good)   # no stages
    np.random.seed(3)
    with jgluon.nn.layout_scope():
        jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [8, 16, 32],
                                classes=10, thumbnail=True,
                                fuse_epilogue=True)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 8, 8, 3)))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    bad = dict(params)
    prefix = next(iter(params)).split("_", 1)[0]
    bad[prefix + "_stage1_extra0_weight"] = np.zeros(3, np.float32)
    with pytest.raises(MXNetError, match="cannot place"):
        convert.resnet_params_from_jax(bad)
    bad = dict(params)
    k = [n for n in params if n.endswith("stage2_batchnorm1_gamma")][0]
    bad[k] = np.zeros(5, np.float32)
    with pytest.raises(MXNetError, match="channels"):
        convert.resnet_params_from_jax(bad)
    bad = dict(params)
    del bad[[n for n in params if n.endswith("stage1_batchnorm3_beta")][0]]
    with pytest.raises(MXNetError):
        convert.resnet_params_from_jax(bad)


@pytest.mark.parametrize("shape", [(64, 7, 7, 3), (256, 1, 1, 64),
                                   (128, 3, 3, 128), (1000, 2048)])
def test_xavier_scale_matches_jax(monkeypatch, shape):
    """The JAX Xavier's uniform half-width for a weight of this (O, kh, kw,
    I) shape equals the port's, and the port's draws lie within it."""
    seen = []
    real = np.random.uniform

    def spy(low, high, size):
        seen.append(high)
        return real(low, high, size)

    monkeypatch.setattr(np.random, "uniform", spy)
    arr = mx.nd.zeros(shape)
    mx.init.Xavier()(mx.init.InitDesc("conv_weight"), arr)
    monkeypatch.undo()
    assert len(seen) == 1
    s = initializer.xavier_scale(shape)
    assert s == pytest.approx(float(seen[0]), rel=1e-12)
    w = torch.zeros(shape)
    initializer.Xavier()("w_weight", w, torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= s
    assert float(w.std()) == pytest.approx(s / np.sqrt(3.0), rel=0.1)


def test_initialize_fills_by_name_and_seed():
    with tnn.layout_scope():
        a = tresnet.resnet18_v1(classes=7, device="cpu").initialize(
            seed=5)
        b = tresnet.resnet18_v1(classes=7, device="cpu").initialize(
            seed=5)
    for (k, v), (_, w) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(v, w), k
        if k.endswith(("gamma", "running_var")):
            assert torch.equal(v, torch.ones_like(v))
        elif k.endswith(("beta", "bias", "running_mean")):
            assert not v.any()
        else:
            assert v.abs().max() > 0


def test_sgd_mom_update_matches_jax():
    from mxnet_tpu.ops import optimizer_ops as jopt

    rng = np.random.RandomState(4)
    w, g, m = (rng.randn(5, 7).astype(np.float32) for _ in range(3))
    kw = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5,
              clip_gradient=0.8)
    jw, jm = jopt.sgd_mom_update(jnp.asarray(w), jnp.asarray(g),
                                 jnp.asarray(m), **kw)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    out = topt.sgd_mom_update(tw, torch.from_numpy(g), tm, **kw)
    assert out[0] is tw and out[1] is tm   # in place
    _close(tw.numpy(), jw, 1e-6, "weight")
    _close(tm.numpy(), jm, 1e-6, "mom")
    jw2 = jopt.sgd_update(jnp.asarray(w), jnp.asarray(g), lr=0.1, wd=1e-4)
    tw2 = torch.from_numpy(w.copy())
    topt.sgd_update(tw2, torch.from_numpy(g), lr=0.1, wd=1e-4)
    _close(tw2.numpy(), jw2, 1e-6, "sgd weight")


def test_sgd_per_parameter_multipliers_match_jax():
    """lr_mult / wd_mult of a parameter scale its update as in the JAX
    optimizer, and the update count advances once per update."""
    from mxnet_tpu import optimizer as jopt_mod

    rng = np.random.RandomState(8)
    w, g = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01)
    jo = jopt_mod.create("sgd", **kw)
    jo.param_dict = {0: type("P", (), {"lr_mult": 2.0, "wd_mult": 0.5})()}
    jw = mx.nd.array(w)
    js = jo.create_state(0, jw)
    to = toptim.create("sgd", **kw)
    tp = torch.nn.Parameter(torch.from_numpy(w.copy()))
    tp.lr_mult, tp.wd_mult = 2.0, 0.5
    to.param_dict = {0: tp}
    ts = to.create_state(0, tp)
    for _ in range(2):
        jo.update(0, jw, mx.nd.array(g), js)
        to.update(0, tp, torch.from_numpy(g), ts)
    _close(tp.detach().numpy(), jw.asnumpy(), 1e-6, "weight")
    assert to.num_update == jo.num_update == 2


def test_loss_and_metrics_match_jax():
    rng = np.random.RandomState(6)
    pred = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, 6)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(
        mx.nd.array(pred), mx.nd.array(label)).asnumpy()
    got = tloss.SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                          torch.from_numpy(label))
    _close(got.numpy(), want, 1e-6, "loss")
    _close(float(tops.softmax_cross_entropy(torch.from_numpy(pred),
                                            torch.from_numpy(label))),
           float(jnn.softmax_cross_entropy(jnp.asarray(pred),
                                           jnp.asarray(label))), 1e-6,
           "softmax_cross_entropy")
    for jm, tm in ((mx.metric.Accuracy(), metric.Accuracy()),
                   (mx.metric.TopKAccuracy(3), metric.TopKAccuracy(3))):
        jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
        tm.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        assert tm.get() == pytest.approx(jm.get())


def test_trainer_bf16_amp_keeps_f32_master_weights():
    with tnn.layout_scope():
        net = tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1], [8, 16, 32],
                               classes=10, thumbnail=True,
                               fuse_epilogue=True, device="cpu")
    net.initialize(seed=0)
    tr = DistributedTrainer(net, "sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9},
                            loss=tloss.SoftmaxCrossEntropyLoss(),
                            amp_dtype="bfloat16")
    x, y = _batch(7, n=8)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    steps = telemetry.counter("mxtpu_steps_total", {"kind": "dist"})
    examples = telemetry.counter("mxtpu_examples_total", {"kind": "dist"})
    n0, e0 = steps.value, examples.value
    losses = [float(tr.step(x, y)) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert steps.value == n0 + 3 and examples.value == e0 + 24
    assert telemetry.histogram("mxtpu_step_seconds",
                               {"kind": "dist"}).snapshot()["count"] >= 3
    for k, v in net.state_dict().items():
        assert v.dtype == torch.float32, k
        assert not torch.equal(v, before[k]), k   # every tensor moved
    with pytest.raises(MXNetError, match="mesh"):
        DistributedTrainer(net, "sgd", mesh=["cpu", "cpu"])


def test_train_imagenet_cpu_rehearsal(capsys):
    loss = train_imagenet.main(["--device", "cpu", "--network",
                                "resnet18_v1", "--batch-size", "2",
                                "--image-shape", "3,32,32", "--layout",
                                "NHWC", "--num-batches", "2",
                                "--num-classes", "10"])
    assert np.isfinite(loss)
    assert "done: trained resnet18_v1 bfloat16 NHWC on cpu" in \
        capsys.readouterr().out
    # RecordIO input is ported (tests/test_torch_port_train_imagenet_rec.py)
    with pytest.raises(MXNetError, match="x.rec not found"):
        train_imagenet.main(["--device", "cpu", "--data-train", "x.rec"])


def test_training_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import mxnet_tpu_torch.train_imagenet, mxnet_tpu_torch.metric\n"
            "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
            "import mxnet_tpu_torch.gluon.model_zoo.transformer\n"
            "import mxnet_tpu_torch.ops.contrib, mxnet_tpu_torch.optimizer\n"
            "import mxnet_tpu_torch.parallel, mxnet_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
