"""BERT pretraining path of the PyTorch port against the JAX package, on the
CPU.

The JAX side runs as its own tests run it: unmasked attention through its
Pallas flash kernels in interpret mode, the masked path in plain jnp. The
port runs the plain versions its kernel wrappers take for CPU tensors.
Inputs and weights are made with numpy from a seed and handed to both
(the JAX Xavier draws from numpy's global state; its weights are carried
to the port by `convert.bert_params_from_jax`). The card-only tests are in
tests/test_torch_port_cuda.py.

Tolerances: f32 rtol 1e-4 with an absolute floor of 1e-4 x the largest
magnitude of the compared tensor (both sides compute in f32 and sum in
other orders); bf16 2e-2 the same way (one bf16 rounding step is 2^-8
relative, and the two frameworks round intermediate bf16 results at
places that differ by a step or two).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.gluon.model_zoo import transformer as jtransformer
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import optimizer_ops as jopt
from mxnet_tpu.ops import tensor as jtensor

from mxnet_tpu_torch import convert
from mxnet_tpu_torch import optimizer as toptim
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import transformer as ttransformer
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import optimizer_ops as topt
from mxnet_tpu_torch.ops import pallas_kernels as tpk
from mxnet_tpu_torch.parallel import DistributedTrainer

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VOCAB, BATCH, SEQ = 50, 2, 12


def _close(got, want, tol, what="", scale=0.0):
    """|got - want| <= tol * |want| + tol * max(max|want|, scale)."""
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = tol * max(float(np.max(np.abs(want))), scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _jparams(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


class _JPretrain(HybridBlock):
    """bench.py's BERT pretraining block at bert_mini's size."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = jtransformer.bert_mini(vocab_size=VOCAB, dropout=0.0)
            self.mlm = jgluon.nn.Dense(VOCAB, flatten=False, prefix="mlm_")

    def hybrid_forward(self, F, tokens):
        seq, _ = self.bert(tokens)
        return self.mlm(seq)


class _TPretrain(torch.nn.Module):
    """The same block in the port: children ``bert`` and ``mlm``."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.bert = ttransformer.bert_mini(vocab_size=VOCAB, dropout=0.0,
                                           device=device)
        self.mlm = tnn.Dense(VOCAB, flatten=False, in_units=64,
                             device=device)

    def forward(self, tokens):
        return self.mlm(self.bert(tokens)[0])


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32),
            rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_grad_matches_jax(dtype):
    """The forward and the hand-written backward (`_ln_core_bwd`) against
    jax.vjp of the JAX LayerNorm, on rows with a large mean."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 48) * 0.5 + 4.0).astype(np.float32)
    gamma = (rng.rand(48) + 0.5).astype(np.float32)
    beta = rng.randn(48).astype(np.float32)
    ct = rng.randn(3, 5, 48).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jin = [jnp.asarray(a, jdt) for a in (x, gamma, beta, ct)]
    out, pull = jax.vjp(lambda a, g, b: jnn.layer_norm(a, g, b), *jin[:3])
    want = [out] + list(pull(jin[3]))
    tin = [torch.from_numpy(np.array(a.astype(jnp.float32)))
           .to(getattr(torch, dtype)) for a in jin]
    leaves = [t.clone().requires_grad_() for t in tin[:3]]
    got = tops.layer_norm(*leaves)
    assert got.grad_fn.name() == "_LayerNormBackward"
    grads = torch.autograd.grad(got, leaves, tin[3])
    for name, a, b in zip(("out", "dx", "dgamma", "dbeta"),
                          [got] + list(grads), want):
        assert a.dtype == getattr(torch, dtype), name
        _close(a, b, TOL[dtype], name)


def test_embedding_clips_indices_like_jax():
    w = np.arange(21, dtype=np.float32).reshape(7, 3)
    idx = np.array([[-3, 0, 6], [9, 2, 7]], np.int32)
    want = jtensor.embedding(jnp.asarray(idx), jnp.asarray(w))
    got = tops.embedding(torch.from_numpy(idx), torch.from_numpy(w))
    _close(got, want, 0.0, "embedding")
    layer = tnn.Embedding(7, 3, device="cpu")
    layer.weight.set_data(w)
    _close(layer(torch.from_numpy(idx)), want, 0.0, "Embedding")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_keep_rate_and_scaling(dtype):
    """The JAX package's dropout by its distribution (threefry and Philox
    give other bits): about 1 - p of the elements kept, each scaled by
    1 / (1 - p), in the input dtype; the identity when p <= 0 or not
    training."""
    x = torch.ones(400, 500, dtype=getattr(torch, dtype))
    gen = torch.Generator().manual_seed(3)
    y = tops.dropout(x, 0.3, is_train=True, generator=gen)
    assert y.dtype == x.dtype
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert tops.dropout(x, 0.3) is x
    assert tops.dropout(x, 0.0, is_train=True) is x
    layer = tnn.Dropout(0.5)
    assert layer.eval()(x) is x
    assert (layer.train()(x) == 0).any()


def test_adam_update_matches_jax():
    rng = np.random.RandomState(4)
    w, g = (rng.randn(5, 7).astype(np.float32) for _ in range(2))
    m, v = rng.randn(5, 7).astype(np.float32), rng.rand(5, 7).astype(
        np.float32)
    kw = dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6, wd=1e-3,
              rescale_grad=0.5, clip_gradient=0.8)
    want = jopt.adam_update(*map(jnp.asarray, (w, g, m, v)), **kw)
    got = [torch.from_numpy(a.copy()) for a in (w, m, v)]
    out = topt.adam_update(got[0], torch.from_numpy(g), got[1], got[2], **kw)
    assert all(a is b for a, b in zip(out, got))   # in place
    for name, a, b in zip(("weight", "mean", "var"), got, want):
        _close(a, b, 1e-6, name)


def test_adam_optimizer_three_steps_match_jax():
    """Bias-corrected lr with the per-parameter update count, lr and wd
    multipliers, f32 moments; a torch sparse tensor as the gradient raises,
    and ``lazy_update`` (the row_sparse update) is taken."""
    from mxnet_tpu import optimizer as jopt_mod

    rng = np.random.RandomState(8)
    w = rng.randn(4, 3).astype(np.float32)
    kw = dict(learning_rate=0.01, wd=0.01)
    jo = jopt_mod.create("adam", **kw)
    jo.param_dict = {0: type("P", (), {"lr_mult": 2.0, "wd_mult": 0.5})()}
    jw = mx.nd.array(w)
    js = jo.create_state(0, jw)
    to = toptim.create("adam", **kw)
    tp = torch.nn.Parameter(torch.from_numpy(w.copy()))
    tp.lr_mult, tp.wd_mult = 2.0, 0.5
    to.param_dict = {0: tp}
    ts = to.create_state(0, tp)
    assert all(s.dtype == torch.float32 for s in ts)
    for step in range(3):
        g = rng.randn(4, 3).astype(np.float32)
        jo.update(0, jw, mx.nd.array(g), js)
        to.update(0, tp, torch.from_numpy(g), ts)
        _close(tp, jw.asnumpy(), 1e-6, "weight step %d" % step)
    _close(ts[0], js[0].asnumpy(), 1e-6, "mean")
    _close(ts[1], js[1].asnumpy(), 1e-6, "var")
    assert to.num_update == jo.num_update == 3
    with pytest.raises(MXNetError, match="sparse"):
        to.update(0, tp, torch.eye(4, 3).to_sparse(), ts)
    assert toptim.create("adam", lazy_update=False).lazy_update is False


def _bert_pair(seed):
    np.random.seed(seed)
    jnet = jtransformer.bert_mini(vocab_size=VOCAB, dropout=0.0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 4), dtype="int32"))
    tnet = ttransformer.bert_mini(vocab_size=VOCAB, dropout=0.0,
                                  device="cpu")
    tnet.load_state_dict(convert.bert_params_from_jax(_jparams(jnet)),
                         strict=True)
    return jnet, tnet


@pytest.mark.parametrize("token_types,valid", [(False, False), (True, False),
                                               (True, True)])
def test_bert_mini_forward_matches_jax(token_types, valid):
    """Sequence output and pooled output: unmasked (the flash path), with
    segment ids, and with per-sample valid lengths (the masked path)."""
    jnet, tnet = _bert_pair(seed=3)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    args_j, args_t = [mx.nd.array(tokens, dtype="int32")], [
        torch.from_numpy(tokens)]
    if token_types or valid:
        types = rng.randint(0, 2, (BATCH, SEQ)).astype(np.int32)
        args_j.append(mx.nd.array(types, dtype="int32") if token_types
                      else None)
        args_t.append(torch.from_numpy(types) if token_types else None)
    if valid:
        lens = np.array([SEQ, 5], np.float32)
        args_j.append(mx.nd.array(lens))
        args_t.append(torch.from_numpy(lens))
    seq, pooled = jnet(*args_j)
    before = tpk.flash_fwd.launches
    with torch.no_grad():
        tseq, tpooled = tnet(*args_t)
    assert tpk.flash_fwd.launches == before   # CPU: plain versions
    _close(tseq, seq.asnumpy(), TOL["float32"], "sequence")
    _close(tpooled, pooled.asnumpy(), TOL["float32"], "pooled")


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_bert_pretrain_trainer_step_matches_jax(amp):
    """One Adam step of BERT mini + an MLM head through each package's
    DistributedTrainer, on (B, L) tokens with (B, L) labels: in f32 the
    loss, every parameter after the step and the change the step made;
    under bf16 AMP the loss, and the f32 master weights. Adam's epsilon is
    1e-2: at the default 1e-8 a first step moves each weight by lr x the
    sign of its gradient, which hides the gradient's value, and a gradient
    that cancels to rounding noise (the key projection's) may flip. The lr
    of 0.1 keeps the change far above one f32 rounding step of the
    weight. A gradient that is zero in exact arithmetic (the key bias's:
    softmax ignores a shift of a row's scores) is rounding noise on both
    sides, so every tensor's floor is also tol x the step's largest
    change."""
    from mxnet_tpu.parallel import DistributedTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh

    np.random.seed(6)
    jnet = _JPretrain()
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 4), dtype="int32"))
    tnet = _TPretrain()
    before = convert.bert_params_from_jax(_jparams(jnet))
    tnet.load_state_dict(before, strict=True)
    opt = {"learning_rate": 0.1, "epsilon": 1e-2}
    mesh = make_mesh([("dp", 1)], devices=jax.devices()[:1])
    jtr = JTrainer(jnet, "adam", dict(opt),
                   loss=jgluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                   amp_dtype=amp)
    ttr = DistributedTrainer(tnet, "adam", dict(opt),
                             loss=tloss.SoftmaxCrossEntropyLoss(),
                             amp_dtype=amp)
    tokens, labels = _tokens(7)
    jl = float(jtr.step(mx.nd.array(tokens, dtype="int32"),
                        mx.nd.array(labels)).asnumpy())
    tl = ttr.step(torch.from_numpy(tokens), torch.from_numpy(labels))
    assert tl.dtype == np.float32 and tl.shape == ()
    _close(float(tl), jl, TOL[amp or "float32"], "loss")
    state = tnet.state_dict()
    assert all(v.dtype == torch.float32 for v in state.values())
    if amp is not None:
        return
    jtr.sync_params()
    want = convert.bert_params_from_jax(_jparams(jnet))
    assert sorted(state) == sorted(want)
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    for k in want:
        _close(state[k], want[k], TOL["float32"], k, big)
        _close(state[k] - before[k], want[k] - before[k], TOL["float32"],
               "change of " + k, big)


def test_bert_params_from_jax_raises_on_what_it_cannot_place():
    np.random.seed(0)
    jnet = jtransformer.bert_mini(vocab_size=VOCAB, dropout=0.0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 4), dtype="int32"))
    params = _jparams(jnet)
    state = convert.bert_params_from_jax(params)
    assert len(state) == len(params) == 5 + 2 * 16 + 2
    key = next(k for k in params if k.endswith("layer1_layernorm1_beta"))
    for bad in ({**params, key.replace("layernorm1", "layernorm7"): 0},
                {k: v for k, v in params.items() if k != key},
                {**params, "x_mlm_weight": 0, "y_head_weight": 0}):
        with pytest.raises(MXNetError):
            convert.bert_params_from_jax(bad)


def test_bert_12_768_12_with_mlm_head_counts_as_the_jax_model():
    """BERT-base's parameter count: 109,482,240, and 132,953,658 with the
    MLM head, as the JAX model's."""
    net = ttransformer.bert_12_768_12(dropout=0.0, device="cpu")
    n = sum(p.numel() for p in net.parameters())
    assert n == 109482240
    assert n + 30522 * 768 + 30522 == 132953658
    assert len(net.encoder.cells) == 12
