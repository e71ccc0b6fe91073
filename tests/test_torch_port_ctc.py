"""CTC in the port against the JAX package, on the CPU.

1. The ``CTCLoss`` op (`mxnet_tpu_torch/ops/rnn.py`) against the JAX op
   (`mxnet_tpu/ops/rnn.py:ctc_loss`) on the same numpy inputs: the loss and
   the input gradient (autograd through the alpha recursion against
   ``jax.vjp`` of the JAX op) for both blank conventions, with and
   without ``use_data_lengths`` / ``use_label_lengths``, an empty label,
   and labels that cannot fit in T (every path at the -1e30 floor, both
   ends of the closing log-sum-exp equal). All four registered names.
2. ``gluon.loss.CTCLoss`` against the JAX block: both layouts of pred and
   label, lengths given or not, a weight and a sample weight.
3. The OCR net of ``examples/ctc/lstm_ocr.py`` (two-layer ``rnn.LSTM(64)``
   in NTC + ``Dense(11)``), the JAX net's weights carried into the port
   through ``save_parameters`` / ``load_parameters``: one Adam step's loss
   and every parameter's change. `chip_smoke.ocr_generator` (the card's
   copy of the example's data, whose module imports the JAX package's
   name) gives the example's batches.

Tolerances: the loss and gradients at rtol 1e-5 / atol 1e-5 at T <= 12.
The two sides do not run the same arithmetic: the JAX op runs its alpha
recursion in f32, the port's in float64 and rounds the loss and gradient
to f32, so the JAX side's rounding grows with T. At T <= 12 it stays
near 1e-6. At T 60 (`test_ctc_op_long_input_matches_jax`) the gradients
were measured up to 2.4e-5 apart (loss rel 4e-7), so that case holds the
gradient at atol LONG_GRAD_ATOL = 1e-4, four times the measured spread,
and the loss at rtol 1e-5. The OCR step at 1e-4 (two LSTM stacks in f32
whose products sum in other orders, then Adam's normalized first step).
"""
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx_j
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import ops as tops

CPU = mx.cpu()
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labels(rng, b, l, c, blank_label, lengths):
    """(B, L) labels with padding past ``lengths``: 1-based with 0 pads for
    "first", 0-based with -1 pads for "last"."""
    if blank_label == "first":
        lab = rng.randint(1, c, (b, l)).astype(np.float32)
        pad = 0.0
    else:
        lab = rng.randint(0, c - 1, (b, l)).astype(np.float32)
        pad = -1.0
    for i, n in enumerate(lengths):
        lab[i, n:] = pad
    return lab


# (T, B, C, L, label lengths, pred lengths or None): a mixed batch with an
# empty label; labels that cannot fit in T
CASES = {
    "mixed": (12, 4, 6, 4, [4, 2, 0, 3], [12, 9, 7, 12]),
    "too long": (3, 2, 5, 4, [4, 4], [3, 2]),
}


def _case(name, blank_label, seed=0):
    t, b, c, l, lab_len, pred_len = CASES[name]
    rng = np.random.RandomState(seed)
    pred = rng.randn(t, b, c).astype(np.float32)
    lab = _labels(rng, b, l, c, blank_label, lab_len)
    cot = rng.randn(b).astype(np.float32)
    return (pred, lab, np.asarray(pred_len, np.float32),
            np.asarray(lab_len, np.float32), cot)


def _jax_ctc(pred, lab, pl, ll, cot, **attrs):
    fn = jops.get("CTCLoss").fn

    def f(p):
        return fn(p, jnp.asarray(lab), jnp.asarray(pl), jnp.asarray(ll),
                  **attrs)

    loss, vjp = jax.vjp(f, jnp.asarray(pred))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(cot))[0])


@functools.lru_cache(maxsize=None)
def _jax_case(case, blank_label, flags):
    """The JAX op's loss and gradient at `_case`, made once a module."""
    pred, lab, pl, ll, cot = _case(case, blank_label)
    return _jax_ctc(pred, lab, pl, ll, cot, use_data_lengths=flags[0],
                    use_label_lengths=flags[1], blank_label=blank_label)


def _port_ctc(name, pred, lab, pl, ll, cot, **attrs):
    p = torch.tensor(pred, requires_grad=True)
    loss = tops.get(name).fn(p, torch.tensor(lab), torch.tensor(pl),
                             torch.tensor(ll), **attrs)
    loss.backward(torch.tensor(cot))
    return loss.detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("blank_label", ["first", "last"])
@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_ctc_op_loss_and_grad_match_jax(case, blank_label, flags):
    pred, lab, pl, ll, cot = _case(case, blank_label)
    attrs = dict(use_data_lengths=flags[0], use_label_lengths=flags[1],
                 blank_label=blank_label)
    want_loss, want_grad = _jax_case(case, blank_label, flags)
    got_loss, got_grad = _port_ctc("CTCLoss", pred, lab, pl, ll, cot,
                                   **attrs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=TOL, atol=TOL)
    assert np.isfinite(got_grad).all()
    if case == "too long":
        # no alignment exists: the loss sits at the floor, as in JAX
        assert (got_loss > 1e29).all()


LONG_GRAD_ATOL = 1e-4


@pytest.mark.parametrize("blank_label", ["first", "last"])
def test_ctc_op_long_input_matches_jax(blank_label):
    """T 60, B 8, C 30, L 20: the port's float64 recursion against the
    JAX op's f32 one, the gradient within LONG_GRAD_ATOL."""
    t, b, c, l = 60, 8, 30, 20
    rng = np.random.RandomState(6)
    pred = (3 * rng.randn(t, b, c)).astype(np.float32)
    lab_len = rng.randint(0, l + 1, b)
    lab = _labels(rng, b, l, c, blank_label, lab_len)
    pl = rng.randint(2 * l + 1, t + 1, b).astype(np.float32)
    ll = lab_len.astype(np.float32)
    cot = rng.randn(b).astype(np.float32)
    attrs = dict(use_data_lengths=True, use_label_lengths=True,
                 blank_label=blank_label)
    want_loss, want_grad = _jax_ctc(pred, lab, pl, ll, cot, **attrs)
    got_loss, got_grad = _port_ctc("CTCLoss", pred, lab, pl, ll, cot,
                                   **attrs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=TOL,
                               atol=LONG_GRAD_ATOL)


@pytest.mark.parametrize("name", ["CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                                  "_contrib_ctc_loss"])
def test_ctc_registered_names(name):
    assert tops.get(name).fn is tops.get("CTCLoss").fn
    pred, lab, pl, ll, cot = _case("mixed", "first")
    want = _jax_case("mixed", "first", (False, False))[0]
    got = _port_ctc(name, pred, lab, pl, ll, cot)[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ctc_through_nd_contrib_matches_jax():
    pred, lab, pl, ll, _ = _case("mixed", "last", seed=2)
    want = mx_j.nd.contrib.CTCLoss(
        mx_j.nd.array(pred), mx_j.nd.array(lab), None, mx_j.nd.array(ll),
        use_label_lengths=True, blank_label="last").asnumpy()
    got = mx.nd.contrib.CTCLoss(
        mx.nd.array(pred, ctx=CPU), mx.nd.array(lab, ctx=CPU), None,
        mx.nd.array(ll, ctx=CPU), use_label_lengths=True,
        blank_label="last").asnumpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
@pytest.mark.parametrize("lengths", ["none", "label", "both"])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths):
    pred, lab, pl, ll, cot = _case("mixed", "last", seed=3)
    lab[lab < 0] = 0.0      # gluon's callers pad with 0 and pass lengths
    if lengths == "none":
        lab = _labels(np.random.RandomState(4), 4, 4, 6, "last",
                      [4, 2, 0, 3])
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        lab = lab.T.copy()
    sw = np.random.RandomState(5).rand(4).astype(np.float32)
    args_j = [mx_j.nd.array(pred), mx_j.nd.array(lab),
              mx_j.nd.array(pl) if lengths == "both" else None,
              mx_j.nd.array(ll) if lengths != "none" else None,
              mx_j.nd.array(sw)]
    args_t = [mx.nd.array(a.asnumpy(), ctx=CPU) if a is not None else None
              for a in args_j]
    jloss = mx_j.gluon.loss.CTCLoss(layout, label_layout, weight=0.5)
    tloss = mx.gluon.loss.CTCLoss(layout, label_layout, weight=0.5)
    args_j[0].attach_grad()
    with mx_j.autograd.record():
        want = jloss(*args_j)
    want.backward(mx_j.nd.array(cot))
    args_t[0].attach_grad()
    with mx.autograd.record():
        got = tloss(*args_t)
    got.backward(mx.nd.array(cot, ctx=CPU))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(args_t[0].grad.asnumpy(),
                               args_j[0].grad.asnumpy(), rtol=TOL, atol=TOL)


def _example_module():
    spec = importlib.util.spec_from_file_location(
        "lstm_ocr_example", os.path.join(ROOT, "examples", "ctc",
                                         "lstm_ocr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class OCRNet(mx.gluon.HybridBlock):
    """The example's OCRNet, in the port."""

    def __init__(self, hidden=64, classes=11, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.lstm = mx.gluon.rnn.LSTM(hidden, num_layers=2, layout="NTC")
            self.fc = mx.gluon.nn.Dense(classes, flatten=False)

    def hybrid_forward(self, F, x):
        return self.fc(self.lstm(x))


def _adam_step(mxp, net, ctx, xb, yb, yl):
    trainer = mxp.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 5e-3})
    ctc = mxp.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    # keyed without the net's own prefix (its per-package name counter)
    params = {k.split("_", 1)[1]: p for k, p in
              net.collect_params().items()}
    before = {k: p.data().asnumpy().copy() for k, p in params.items()}
    x = mxp.nd.array(xb, ctx=ctx)
    with mxp.autograd.record():
        loss = ctc(net(x), mxp.nd.array(yb, ctx=ctx), None,
                   mxp.nd.array(yl, ctx=ctx))
    loss.backward()
    trainer.step(xb.shape[0])
    change = {k: p.data().asnumpy() - before[k] for k, p in params.items()}
    return loss.asnumpy(), before, change


def test_ocr_net_adam_step_matches_jax(tmp_path):
    ex = _example_module()
    xb, yb, yl = ex.make_generator()(8)
    jnet = ex.OCRNet()
    jnet.initialize(mx_j.init.Xavier(), ctx=mx_j.cpu())
    jnet(mx_j.nd.array(xb))           # deferred shapes
    path = str(tmp_path / "ocr.params")
    jnet.save_parameters(path)
    tnet = OCRNet()
    tnet.load_parameters(path, ctx=CPU)
    want_loss, want_before, want_change = _adam_step(mx_j, jnet, mx_j.cpu(),
                                                     xb, yb, yl)
    got_loss, got_before, got_change = _adam_step(mx, tnet, CPU, xb, yb, yl)
    assert sorted(got_change) == sorted(want_change)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4, atol=1e-4)
    for k in want_change:
        np.testing.assert_array_equal(got_before[k], want_before[k])
        np.testing.assert_allclose(got_change[k], want_change[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_smoke_generator_is_the_examples():
    sys.path.insert(0, ROOT)
    import chip_smoke

    ex, ours = _example_module().make_generator(), chip_smoke.ocr_generator()
    for batch in (4, 32):
        for a, b in zip(ex(batch), ours(batch)):
            np.testing.assert_array_equal(a, b)
