"""The port's Gluon façade against the JAX package's, on the CPU.

Covers `gluon.Parameter` / `ParameterDict` / `Block` / `HybridBlock`
(deferred `Dense` / `Conv2D` / `BatchNorm` shapes, structural names,
``.params`` files crossing between the packages both ways, a user
``hybrid_forward`` block with ``hybridize()`` leaving its outputs as they
were), `gluon.Trainer` with every optimizer over 5 steps under a learning-
rate schedule (SGLD by its distribution), the 5 schedulers, the 17
``nd`` optimizer update ops, every loss but CTC (held in
test_torch_port_ctc.py) with ``weight`` and ``sample_weight``, every
metric, every deterministic initializer (the random ones by
distribution), `gluon.utils.clip_global_norm`, and `Trainer.save_states` /
`load_states`.

The same numpy inputs (from a seed) go through both packages; weights are
carried from the JAX model to the port's by `Parameter.set_data`, by
structural name. Tolerances: f32 rtol 1e-4 with an absolute floor of 1e-4
x max|want| for forwards, gradients and trained weights (products summed
in other orders); 1e-5 (same floor rule) for the element-wise update
ops; schedulers and metrics exactly or to 1e-6 (host float64 arithmetic).
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel

TOL = 1e-4
UPDATE_TOL = 1e-5
PKGS = {"jax": jmx, "torch": mx}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor, err_msg=what)


def _copy(jnet, tnet):
    """Carry the JAX block's values onto the port's, by structural name."""
    jp = jnet._collect_params_with_prefix()
    tp = tnet._collect_params_with_prefix()
    assert sorted(jp) == sorted(tp)
    for k, p in jp.items():
        tp[k].set_data(p.data().asnumpy())


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# blocks: deferred shapes, names, .params files, hybrid_forward
# ---------------------------------------------------------------------------

_DEFERRED = [
    ("dense-flatten", lambda g: g.nn.Dense(5), (2, 3, 4), (5, 12)),
    ("dense", lambda g: g.nn.Dense(5, flatten=False), (2, 3, 4), (5, 4)),
    ("conv-nchw", lambda g: g.nn.Conv2D(4, 3, padding=1), (2, 3, 6, 6),
     (4, 3, 3, 3)),
    ("conv-nhwc", lambda g: g.nn.Conv2D(4, 3, strides=2, layout="NHWC"),
     (2, 7, 7, 3), (4, 3, 3, 3)),
    ("batchnorm", lambda g: g.nn.BatchNorm(), (4, 3, 5), (3,)),
]


@pytest.mark.parametrize("name,make,xshape,wshape", _DEFERRED,
                         ids=[d[0] for d in _DEFERRED])
def test_deferred_shapes_match_jax(name, make, xshape, wshape):
    x = _rand(1, *xshape)
    jl, tl = make(jmx.gluon), make(gluon)
    jl.initialize(jmx.init.Xavier())
    tl.initialize(mx.init.Xavier())
    first = next(iter(tl.collect_params().values()))
    assert 0 in first.shape
    with pytest.raises(gluon.DeferredInitializationError):
        first.data()
    jout = jl(jmx.nd.array(x))
    tl(nd.array(x))
    tshapes = [p.shape for p in tl.collect_params().values()]
    assert tshapes == [p.shape for p in jl.collect_params().values()]
    assert tshapes[0] == wshape
    _copy(jl, tl)
    with autograd.record():     # BatchNorm in training mode both sides
        tout = tl(nd.array(x))
    with jmx.autograd.record():
        jout = jl(jmx.nd.array(x))
    _close(tout.asnumpy(), jout.asnumpy(), name)


def _mlp(g, bn=True):
    """Dense -> BatchNorm -> Dense; without ``bn`` (the optimizer cases)
    the first layer's bias has a gradient that is not zero in exact
    arithmetic, which a normalising optimizer would turn from rounding
    noise into a step."""
    net = g.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(g.nn.Dense(5, in_units=4, activation="relu"))
        if bn:
            net.add(g.nn.BatchNorm(in_channels=5))
        net.add(g.nn.Dense(3, in_units=5))
    return net


def test_names_and_structure_match_jax():
    jnet, tnet = _mlp(jmx.gluon), _mlp(gluon)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())
    assert list(tnet.collect_params(".*weight")) == \
        list(jnet.collect_params(".*weight"))
    assert tnet.prefix == jnet.prefix == "net_"
    assert tnet[0].name == jnet[0].name == "net_dense0"
    # the attribute is the Parameter, and the module tree holds its tensor
    assert tnet[0].weight is tnet.collect_params()["net_dense0_weight"]
    assert tnet[0]._held("weight") is tnet[0].weight.var
    assert sorted(tnet.state_dict()) == sorted(
        k for k in tnet._collect_params_with_prefix())


def _lm(pkg, **kw):
    return (jmx.gluon.model_zoo.word_lm.RNNModel if pkg == "jax"
            else RNNModel)(20, 8, 8, 2, dropout=0.0, prefix="lm_", **kw)


@pytest.mark.parametrize("build", ["mlp", "word_lm"])
def test_params_file_from_jax_loads_in_the_port(tmp_path, build):
    import mxnet_tpu.gluon.model_zoo.word_lm  # noqa: F401

    jnet = _mlp(jmx.gluon) if build == "mlp" else _lm("jax")
    jnet.initialize(jmx.init.Xavier())
    # BatchNorm's running statistics move off their defaults first
    with jmx.autograd.record():
        jnet(jmx.nd.array(_rand(2, 6, 4)) if build == "mlp"
             else jmx.nd.array(np.arange(12).reshape(4, 3), dtype="int32"))
    path = str(tmp_path / "j.params")
    jnet.save_parameters(path)
    tnet = _mlp(gluon) if build == "mlp" else _lm("torch")
    tnet.load_parameters(path)
    want = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    got = tnet._collect_params_with_prefix()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].data().asnumpy(), w, err_msg=k)


@pytest.mark.parametrize("build", ["mlp", "word_lm"])
def test_params_file_from_the_port_loads_in_jax(tmp_path, build):
    tnet = _mlp(gluon) if build == "mlp" else _lm("torch")
    tnet.initialize(mx.init.Xavier(), seed=3)
    path = str(tmp_path / "t.params")
    tnet.save_parameters(path)
    jnet = _mlp(jmx.gluon) if build == "mlp" else _lm("jax")
    jnet.load_parameters(path)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            tnet._collect_params_with_prefix()[k].data().asnumpy(),
            err_msg=k)
    # ParameterDict.save / load by full name, the same container
    tnet.collect_params().save(str(tmp_path / "d.params"))
    jnet.collect_params().load(str(tmp_path / "d.params"))


def _user_block(g):
    class Scaled(g.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = self.params.get("w", shape=(4, 3))
                self.dense = g.nn.Dense(2, in_units=4)

        def hybrid_forward(self, F, x, w):
            return self.dense(F.relu(F.dot(x, w, transpose_b=True))) * 0.5

    return Scaled(prefix="user_")


def _user_run(pkg, net, x):
    ag = pkg.autograd
    with ag.record():
        out = net(pkg.nd.array(x))
    out.backward()
    return out.asnumpy(), {k: p.grad().asnumpy()
                           for k, p in net.collect_params().items()}


def test_user_hybrid_forward_block_matches_jax_and_hybridize_keeps_it():
    x = _rand(4, 5, 3)
    jnet, tnet = _user_block(jmx.gluon), _user_block(gluon)
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize()
    _copy(jnet, tnet)
    assert isinstance(tnet.w, gluon.Parameter)
    want = _user_run(jmx, jnet, x)
    got = _user_run(mx, tnet, x)
    tnet.hybridize(static_alloc=True)
    again = _user_run(mx, tnet, x)
    assert tnet._active and tnet._flags["static_alloc"]
    assert tnet.dense._active
    _close(got[0], want[0], "out")
    np.testing.assert_array_equal(again[0], got[0])
    for k in want[1]:
        _close(got[1][k], want[1][k], k)
        np.testing.assert_array_equal(again[1][k], got[1][k])


def test_facade_modes_follow_autograd():
    """Dropout drops and BatchNorm uses batch statistics only while
    autograd is training; the tensor path keeps train() / eval()."""
    drop = gluon.nn.Dropout(0.5)
    x = nd.ones((64, 64))
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with autograd.record():
        y = drop(x)
    assert (y.asnumpy() == 0).mean() > 0.3
    with autograd.record(train_mode=False):
        np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    drop.train()
    assert (drop(torch.ones(64, 64)) == 0).float().mean() > 0.3


# ---------------------------------------------------------------------------
# Trainer and optimizers
# ---------------------------------------------------------------------------

_OPTIMIZERS = [
    ("sgd", {"momentum": 0.9, "wd": 1e-3, "clip_gradient": 0.5}),
    ("sgd", {}),
    ("nag", {"momentum": 0.9, "wd": 1e-3}),
    ("adam", {"wd": 1e-3}),
    ("adamw", {"wd": 1e-2}),
    ("adagrad", {"wd": 1e-3}),
    ("adadelta", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.6}),
    ("ftrl", {}),
    ("ftml", {}),
    ("signum", {"momentum": 0.9, "wd_lh": 1e-3}),
    ("signum", {"momentum": 0.0}),
    ("dcasgd", {"momentum": 0.9}),
    ("adamax", {}),
    ("nadam", {}),
    ("lbsgd", {"momentum": 0.9}),
    ("ccsgd", {"momentum": 0.5}),
]


def _trainer_run(pkg, jnet, name, kw, x, y, steps=5):
    """5 Trainer steps of an L2 loss on the MLP; returns every step's
    weights."""
    g = pkg.gluon
    sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    params = dict(kw, learning_rate=0.1, lr_scheduler=sched)
    trainer = g.Trainer(jnet.collect_params(), name, params)
    loss = g.loss.L2Loss()
    out = []
    for _ in range(steps):
        with pkg.autograd.record():
            lval = loss(jnet(pkg.nd.array(x)), pkg.nd.array(y))
        lval.backward()
        trainer.step(x.shape[0])
        out.append({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    return out, trainer


@pytest.mark.parametrize("name,kw", _OPTIMIZERS,
                         ids=["%s-%d" % (o[0], i)
                              for i, o in enumerate(_OPTIMIZERS)])
def test_trainer_with_every_optimizer_matches_jax(name, kw):
    x, y = _rand(5, 6, 4), _rand(6, 6, 3)
    jnet, tnet = _mlp(jmx.gluon, bn=False), _mlp(gluon, bn=False)
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize()
    _copy(jnet, tnet)
    want, jtr = _trainer_run(jmx, jnet, name, kw, x, y)
    got, ttr = _trainer_run(mx, tnet, name, kw, x, y)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            _close(g[k], w[k], "%s step %d %s" % (name, step, k))
    assert ttr.learning_rate == jtr.learning_rate
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 5


def _sgld_moments(pkg):
    g = pkg.gluon
    p = g.Parameter("p", shape=(200, 100))
    p.initialize(init="zeros")
    c = np.full((200, 100), 2.0, np.float32)
    sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    trainer = g.Trainer([p], "sgld", {"learning_rate": 0.01,
                                      "lr_scheduler": sched})
    lrs = []
    for _ in range(5):
        with pkg.autograd.record():
            lval = (p.data() * pkg.nd.array(c)).sum()
        lval.backward()
        trainer.step(4)
        lrs.append(trainer.learning_rate)
    w = p.data().asnumpy().astype(np.float64)
    return w.mean(), w.std(), lrs


def test_sgld_matches_jax_in_distribution():
    """w after 5 steps from 0 with gradient c / 4: mean -sum(lr_t) / 2 *
    c / 4, variance sum(lr_t) (each step adds N(0, lr_t) noise)."""
    want = _sgld_moments(jmx)
    got = _sgld_moments(mx)
    assert got[2] == want[2]
    lrs = np.array(got[2])
    # the schedule as the optimizer saw it at each step's update count
    seen = np.array([0.01, 0.01, 0.005, 0.005, 0.0025])
    mean, std = -seen.sum() / 2 * 2.0 / 4, np.sqrt(seen.sum())
    for m, s, _ in (got, want):
        assert abs(m - mean) < 4 * std / np.sqrt(20000), (m, mean)
        assert abs(s - std) < 0.02 * std, (s, std)
    assert lrs[-1] == 0.0025


def test_trainer_stale_gradients_and_one_device():
    net = _mlp(gluon)
    net.initialize()
    trainer = gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(MXNetError, match="has not been updated"):
        trainer.step(1)
    with autograd.record():
        lval = net[0](nd.ones((2, 4))).sum()   # reaches the first layer only
    lval.backward()
    with pytest.raises(MXNetError, match="net_batchnorm0_gamma"):
        trainer.step(2)
    trainer.step(2, ignore_stale_grad=True)
    with pytest.raises(MXNetError, match="queue 1 item 2"):
        gluon.Trainer(net.collect_params(), "sgd", sharded=True)
    with pytest.raises(MXNetError, match="queue 1 item 2"):
        trainer.step_batch(None)
    # one process: a dist_sync store is rank 0 of 1 and the step is the
    # plain one; a context named twice holds one copy (as in the JAX
    # package)
    gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync").step(
        2, ignore_stale_grad=True)
    net.initialize(ctx=[mx.cpu(), mx.cpu()], force_reinit=True)
    assert net[0].weight.list_ctx() == [mx.cpu()]


def test_save_and_load_states_round_trip(tmp_path):
    x, y = _rand(7, 6, 4), _rand(8, 6, 3)
    nets = [_mlp(gluon) for _ in range(2)]
    nets[0].initialize(seed=1)
    for k, p in nets[0]._collect_params_with_prefix().items():
        nets[1]._collect_params_with_prefix()[k].set_data(p.data())
    loss = gluon.loss.L2Loss()

    def step(net, trainer):
        with autograd.record():
            lval = loss(net(nd.array(x)), nd.array(y))
        lval.backward()
        trainer.step(6)

    trainers = [gluon.Trainer(n.collect_params(), "adam",
                              {"learning_rate": 0.05}) for n in nets]
    for _ in range(2):
        step(nets[0], trainers[0])
    path = str(tmp_path / "adam.states")
    trainers[0].save_states(path)
    with open(path, "rb") as f:
        assert pickle.load(f)["step_count"] == 2
    for k, p in nets[0]._collect_params_with_prefix().items():
        nets[1]._collect_params_with_prefix()[k].set_data(p.data())
    trainers[1].load_states(path)
    assert trainers[1].step_count == 2
    assert trainers[1].optimizer.param_dict
    for net, trainer in zip(nets, trainers):
        step(net, trainer)
    for k, p in nets[0].collect_params().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), nets[1].collect_params()[k].data().asnumpy())


# ---------------------------------------------------------------------------
# schedulers and the nd update ops
# ---------------------------------------------------------------------------

_SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=2, factor=0.5, base_lr=0.1,
                             stop_factor_lr=0.02, warmup_steps=3,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3, base_lr=1.0)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.2, pwr=2,
                           final_lr=0.01, warmup_steps=2)),
    ("CosineScheduler", dict(max_update=12, base_lr=0.2, final_lr=0.01,
                             warmup_steps=3, warmup_mode="constant")),
    ("CosineScheduler", dict(max_update=10, base_lr=0.5)),
]


@pytest.mark.parametrize("cls,kw", _SCHEDULERS,
                         ids=["%s-%d" % (s[0], i)
                              for i, s in enumerate(_SCHEDULERS)])
def test_schedulers_match_jax(cls, kw):
    j = getattr(jmx.lr_scheduler, cls)(**kw)
    t = getattr(mx.lr_scheduler, cls)(**kw)
    assert [t(n) for n in range(16)] == [j(n) for n in range(16)]


_UPDATE_OPS = [
    ("sgd_update", 0, dict(lr=0.1, wd=1e-3, clip_gradient=0.3)),
    ("sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=1e-3)),
    ("mp_sgd_update", 1, dict(lr=0.1, wd=1e-3)),
    ("mp_sgd_mom_update", 2, dict(lr=0.1, momentum=0.9)),
    ("nag_mom_update", 1, dict(lr=0.1, momentum=0.9, rescale_grad=0.5)),
    ("adam_update", 2, dict(lr=0.01, wd=1e-3)),
    ("adamw_update", 2, dict(lr=0.01, wd=1e-2, eta=0.5)),
    ("rmsprop_update", 1, dict(lr=0.01, clip_weights=0.5)),
    ("rmspropalex_update", 3, dict(lr=0.01)),
    ("ftrl_update", 2, dict(lr=0.1, lamda1=0.05)),
    ("ftml_update", 3, dict(lr=0.01, t=3)),
    ("signsgd_update", 0, dict(lr=0.1, wd=1e-2)),
    ("signum_update", 1, dict(lr=0.1, wd_lh=1e-2)),
    ("adagrad_update", 1, dict(lr=0.1)),
    ("adadelta_update", 2, dict(rho=0.8)),
]


@pytest.mark.parametrize("op,nstate,kw", _UPDATE_OPS,
                         ids=[o[0] for o in _UPDATE_OPS])
def test_update_ops_match_jax(op, nstate, kw):
    rng = np.random.RandomState(len(op))
    arrays = [rng.uniform(-1, 1, (5, 4)).astype(np.float32)
              for _ in range(2 + nstate)]
    # states positive (accumulated squares among them); the centered
    # RMSProp's mean gradient small enough that n - g^2 stays positive
    arrays[2:] = [np.abs(a) + 0.1 for a in arrays[2:]]
    if op == "rmspropalex_update":
        arrays[3] *= 0.1
    results = []
    for pkg in (jmx, mx):
        ins = [pkg.nd.array(a) for a in arrays]
        outs = [ins[0]] + ins[2:]
        getattr(pkg.nd, op)(*ins, out=outs if len(outs) > 1 else outs[0],
                            **kw)
        results.append([o.asnumpy() for o in outs])
    for i, (g, w) in enumerate(zip(results[1], results[0])):
        _close(g, w, "%s output %d" % (op, i), tol=UPDATE_TOL)


@pytest.mark.parametrize("op", ["multi_sgd_update", "multi_sgd_mom_update"])
def test_multi_update_ops_match_jax(op):
    rng = np.random.RandomState(3)
    per = 2 if op == "multi_sgd_update" else 3
    arrays = [rng.uniform(-1, 1, (3, 2)).astype(np.float32)
              for _ in range(2 * per)]
    kw = dict(lrs=(0.1, 0.2), wds=(0.0, 1e-2), num_weights=2)
    if per == 3:
        kw["momentum"] = 0.9
    results = []
    for pkg in (jmx, mx):
        ins = [pkg.nd.array(a) for a in arrays]
        outs = ins[0::per] + (ins[2::per] if per == 3 else [])
        getattr(pkg.nd, op)(*ins, out=outs, **kw)
        results.append([o.asnumpy() for o in outs])
    for g, w in zip(results[1], results[0]):
        _close(g, w, op, tol=UPDATE_TOL)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_cases():
    rng = np.random.RandomState(9)
    p = rng.normal(size=(4, 5)).astype(np.float32)
    pos = rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
    lab = rng.normal(size=(4, 5)).astype(np.float32)
    sign = np.sign(rng.normal(size=(4, 5))).astype(np.float32)
    bits = (rng.uniform(size=(4, 5)) > 0.5).astype(np.float32)
    cls = np.array([0, 3, 4, 1], np.float32)
    dist = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    sw = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    cnt = rng.poisson(2.0, (4, 5)).astype(np.float32)
    return [
        ("L2Loss", dict(weight=0.7), [p, lab], sw),
        ("L1Loss", dict(weight=0.7), [p, lab], sw),
        ("SigmoidBinaryCrossEntropyLoss", dict(weight=0.7), [p, bits], sw),
        ("SigmoidBCELoss", dict(from_sigmoid=True), [pos, bits], sw),
        ("SoftmaxCrossEntropyLoss", dict(weight=0.7), [p, cls], sw),
        ("SoftmaxCELoss", dict(sparse_label=False), [p, dist], sw),
        ("SoftmaxCrossEntropyLoss", dict(from_logits=True, axis=1),
         [np.log(dist), cls], None),
        ("KLDivLoss", dict(weight=0.7), [np.log(dist[::-1].copy()), dist],
         sw),
        ("KLDivLoss", dict(from_logits=False), [p, dist], sw),
        ("HuberLoss", dict(rho=0.5, weight=0.7), [p, lab], sw),
        ("HingeLoss", dict(margin=0.5, weight=0.7), [p, sign], sw),
        ("SquaredHingeLoss", dict(weight=0.7), [p, sign], sw),
        ("LogisticLoss", dict(weight=0.7), [p, sign], sw),
        ("LogisticLoss", dict(label_format="binary"), [p, bits], sw),
        ("TripletLoss", dict(margin=0.5, weight=0.7), [p, lab, p * 0.5],
         sw[:, 0]),
        ("PoissonNLLLoss", dict(weight=0.7), [p * 0.3, cnt], sw),
        ("PoissonNLLLoss", dict(from_logits=False, compute_full=True),
         [pos * 3, cnt], None),
        ("CosineEmbeddingLoss", dict(weight=0.7, margin=0.1),
         [p, lab, np.array([1, -1, 1, -1], np.float32)], sw[:, 0]),
    ]


_LOSSES = _loss_cases()


def _loss_run(pkg, cls, kw, args, sw):
    loss = getattr(pkg.gluon.loss, cls)(**kw)
    arrays = [pkg.nd.array(a) for a in args]
    arrays[0].attach_grad()
    with pkg.autograd.record():
        out = loss(*arrays) if sw is None \
            else loss(*arrays, pkg.nd.array(sw))
    out.backward()
    return out.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("cls,kw,args,sw", _LOSSES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_LOSSES)])
def test_losses_match_jax(cls, kw, args, sw):
    want = _loss_run(jmx, cls, kw, args, sw)
    got = _loss_run(mx, cls, kw, args, sw)
    _close(got[0], want[0], cls + " value")
    _close(got[1], want[1], cls + " gradient")


def test_ctc_loss_waits_for_the_ctc_op():
    """The CTC op it waited for is ported: the block is that op on (T, N,
    C) pred with the blank last and the lengths' flags from their
    presence (held to the JAX block in test_torch_port_ctc.py)."""
    from mxnet_tpu_torch.ops import rnn as rnn_ops

    pred = torch.from_numpy(_rand(17, 2, 5, 4))
    label = torch.tensor([[0.0, 1.0], [2.0, 0.0]])
    lengths = torch.tensor([2.0, 1.0])
    got = gluon.loss.CTCLoss()(pred, label, None, lengths)
    want = rnn_ops.ctc_loss(pred.transpose(0, 1), label, None, lengths,
                            use_label_lengths=True, blank_label="last")
    assert torch.equal(got, want) and got.shape == (2,)


def test_losses_take_tensors_on_the_tensor_path():
    pred = torch.from_numpy(_rand(3, 4, 5))
    label = torch.tensor([0.0, 1.0, 4.0, 7.0])
    out = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label)
    assert isinstance(out, torch.Tensor) and out.shape == (4,)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_cases():
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(6), 10).astype(np.float32)
    cls = rng.randint(0, 6, 10).astype(np.float32)
    bin_p = rng.dirichlet(np.ones(2), 10).astype(np.float32)
    bin_l = rng.randint(0, 2, 10).astype(np.float32)
    reg_p = rng.normal(size=(10,)).astype(np.float32)
    reg_l = (reg_p + rng.normal(scale=0.3, size=(10,))).astype(np.float32)
    return [
        ("acc", (), [cls], [probs]),
        ("top_k_acc", (3,), [cls], [probs]),
        ("f1", (), [bin_l], [bin_p]),
        ("mcc", (), [bin_l], [bin_p]),
        ("pcc", (), [bin_l], [bin_p]),
        ("perplexity", (), [cls], [probs]),
        ("mae", (), [reg_l], [reg_p]),
        ("mse", (), [reg_l], [reg_p]),
        ("rmse", (), [reg_l], [reg_p]),
        ("ce", (), [cls], [probs]),
        ("nll_loss", (), [cls], [probs]),
        ("pearsoncorrelation", (), [reg_l], [reg_p]),
        ("loss", (), [], [reg_p]),
        ("torch", (), [], [reg_p]),
        ("caffe", (), [], [reg_p]),
        (["acc", "mse"], (), [cls], [probs]),
    ]


_METRICS = _metric_cases()


@pytest.mark.parametrize("name,args,labels,preds", _METRICS,
                         ids=[str(m[0]) for m in _METRICS])
def test_metrics_match_jax(name, args, labels, preds):
    values = []
    for pkg in (jmx, mx):
        m = pkg.metric.create(name, *args)
        for _ in range(2):
            m.update([pkg.nd.array(a) for a in labels],
                     [pkg.nd.array(a) for a in preds])
        values.append(m.get())
    assert values[1][0] == values[0][0]
    np.testing.assert_allclose(np.asarray(values[1][1], np.float64),
                               np.asarray(values[0][1], np.float64),
                               rtol=1e-6, atol=1e-9)


def test_custom_metrics_match_jax():
    def frac_pos(label, pred):
        return float((pred > 0).mean())

    reg = _rand(2, 8)
    for make in (lambda p: p.metric.np(frac_pos),
                 lambda p: p.metric.create(frac_pos),
                 lambda p: p.metric.CustomMetric(frac_pos, name="fp")):
        got = []
        for pkg in (jmx, mx):
            m = make(pkg)
            m.update([pkg.nd.array(reg)], [pkg.nd.array(reg)])
            got.append(m.get())
        assert got[0] == got[1]
    m = mx.metric.Perplexity()
    m.update([torch.tensor([1.0])], [torch.tensor([[0.5, 0.5]])])
    assert m.get() == ("perplexity", 2.0)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

_DET_INITS = [
    ("Zero", lambda i: i.Zero(), "fc_weight", (3, 4)),
    ("One", lambda i: i.One(), "fc_weight", (3, 4)),
    ("Constant", lambda i: i.Constant(0.3), "fc_weight", (3, 4)),
    ("Constant-bias", lambda i: i.Constant(0.3), "fc_bias", (3,)),
    ("Bilinear", lambda i: i.Bilinear(), "up_weight", (2, 1, 4, 4)),
    ("Bilinear-odd", lambda i: i.Bilinear(), "up_weight", (1, 1, 5, 3)),
    ("LSTMBias", lambda i: i.LSTMBias(1.5), "lstm_i2h_bias", (16,)),
    ("Load", lambda i: i.Load({"arg:fc_weight": np.arange(12.0).reshape(
        3, 4)}, default_init=i.One()), "fc_weight", (3, 4)),
    ("Load-default", lambda i: i.Load({}, default_init=i.Constant(2.0)),
     "fc_weight", (3, 4)),
    ("Mixed", lambda i: i.Mixed([".*bias", ".*"],
                                [i.Constant(-1.0), i.One()]),
     "fc_bias", (3,)),
    ("gamma", lambda i: i.Uniform(), "bn_gamma", (5,)),
    ("running_var", lambda i: i.Normal(), "bn_running_var", (5,)),
    ("created", lambda i: i.create('["constant", {"value": 0.25}]'),
     "fc_weight", (2, 2)),
]


@pytest.mark.parametrize("name,make,param,shape", _DET_INITS,
                         ids=[d[0] for d in _DET_INITS])
def test_deterministic_initializers_match_jax(name, make, param, shape):
    out = []
    for pkg in (jmx, mx):
        arr = pkg.nd.zeros(shape)
        make(pkg.init)(pkg.init.InitDesc(param), arr)
        out.append(arr.asnumpy())
    np.testing.assert_array_equal(out[1], out[0])


def test_random_initializers_by_distribution():
    gen = torch.Generator().manual_seed(0)
    shape = (200, 300)
    fan = (200 + 300) / 2.0

    def draw(init):
        arr = nd.zeros(shape)
        init(mx.init.InitDesc("w_weight"), arr, gen)
        return arr.asnumpy().astype(np.float64)

    u = draw(mx.init.Uniform(0.2))
    assert np.abs(u).max() <= 0.2 and abs(u.std() - 0.2 / np.sqrt(3)) < 2e-3
    n = draw(mx.init.Normal(0.5))
    assert abs(n.std() - 0.5) < 5e-3 and abs(n.mean()) < 5e-3
    xg = draw(mx.init.Xavier("gaussian", "in", 2))
    assert abs(xg.std() - np.sqrt(2 / 300.0)) < 1e-3
    he = draw(mx.init.MSRAPrelu(slope=0.25))
    assert abs(he.std() - np.sqrt(2 / 1.0625 / fan)) < 1e-3
    q = draw(mx.init.Orthogonal(scale=1.5))
    np.testing.assert_allclose(q @ q.T, 2.25 * np.eye(200), atol=1e-4)
    # the JAX package's draws of the same rules have the same moments
    ju = jmx.nd.zeros(shape)
    jmx.init.Uniform(0.2)(jmx.init.InitDesc("w_weight"), ju)
    assert abs(ju.asnumpy().std() - u.std()) < 3e-3
    # a seed gives the same weights again
    a = mx.init.Xavier()
    x1, x2 = nd.zeros((3, 4)), nd.zeros((3, 4))
    a("w_weight", x1, torch.Generator().manual_seed(5))
    a("w_weight", x2, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(x1.asnumpy(), x2.asnumpy())


# ---------------------------------------------------------------------------
# gluon.utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [_rand(i, *s) for i, s in enumerate([(3, 4), (5,), (2, 2, 2)])]
    results = []
    for pkg in (jmx, mx):
        nds = [pkg.nd.array(a) for a in arrays]
        norm = pkg.gluon.utils.clip_global_norm(nds, max_norm)
        results.append((norm, [a.asnumpy() for a in nds]))
    _close(results[1][0], results[0][0], "norm")
    for g, w in zip(results[1][1], results[0][1]):
        _close(g, w, "clipped")


def test_split_and_check_sha1(tmp_path):
    x = _rand(1, 6, 2)
    for even in (True, False):
        n = 3 if even else 4
        got = gluon.utils.split_data(nd.array(x), n, even_split=even)
        want = jmx.gluon.utils.split_data(jmx.nd.array(x), n,
                                          even_split=even)
        assert [g.shape for g in got] == [w.shape for w in want]
    with pytest.raises(MXNetError):
        gluon.utils.split_data(nd.array(x), 4)
    (loaded,) = gluon.utils.split_and_load(x, [mx.cpu()])
    np.testing.assert_array_equal(loaded.asnumpy(), x)
    path = tmp_path / "f.bin"
    path.write_bytes(b"abc")
    assert gluon.utils.check_sha1(
        str(path), "a9993e364706816aba3e25717850c26c9cd0d89d")
    assert jmx.gluon.utils.check_sha1(
        str(path), "a9993e364706816aba3e25717850c26c9cd0d89d")


# ---------------------------------------------------------------------------
# Parameter and ParameterDict
# ---------------------------------------------------------------------------

def _param_api(pkg):
    g = pkg.gluon
    pd = g.ParameterDict("pd_")
    w = pd.get("w", shape=(2, 0), init=pkg.init.One(), lr_mult=0.5,
               allow_deferred_init=True)
    assert pd.get("w") is w and "pd_w" in pd
    c = pd.get_constant("c", np.array([[1.0, 2.0]], np.float32))
    pd.initialize()
    with pytest.raises(g.DeferredInitializationError):
        w.data()
    w.shape = (2, 3)
    w._finish_deferred_init()
    out = {"w": w.data().asnumpy(), "c": c.data().asnumpy(),
           "lr_mult": w.lr_mult, "c_req": c.grad_req,
           "ctx": len(w.list_ctx()), "data": len(w.list_data())}
    x = pkg.nd.array([[1.0, -1.0, 2.0]])
    with pkg.autograd.record():
        y = (pkg.nd.dot(x, w.data(), transpose_b=True) * 3).sum()
    y.backward()
    out["grad"] = w.grad().asnumpy()
    w.grad_req = "add"
    with pkg.autograd.record():
        y = (pkg.nd.dot(x, w.data(), transpose_b=True) * 3).sum()
    y.backward()
    out["grad_add"] = w.list_grad()[0].asnumpy()
    w.zero_grad()
    out["zeroed"] = w.grad().asnumpy()
    w.set_data(pkg.nd.array(np.full((2, 3), 0.25, np.float32)))
    out["set"] = w.data().asnumpy()
    w.grad_req = "null"
    with pytest.raises(Exception):
        w.grad()
    return out


def test_parameter_api_matches_jax():
    want, got = _param_api(jmx), _param_api(mx)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_cast_apply_and_summary(capsys):
    net = _mlp(gluon)
    net.initialize()
    net.cast("float64")
    assert net[0].weight.data().dtype == np.float64
    assert net.collect_params()["net_dense0_weight"].data().dtype == \
        np.float64
    assert net[1].running_mean.data().dtype == np.float64
    out = net(nd.array(_rand(1, 2, 4), dtype="float64"))
    assert out.dtype == np.float64
    seen = []
    assert net.apply(lambda b: seen.append(type(b).__name__)) is net
    assert seen[-1] == "HybridSequential" and "Dense" in seen
    net.summary()
    assert "Total" in capsys.readouterr().out
