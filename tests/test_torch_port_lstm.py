"""The fused LSTM layer of the PyTorch port against the JAX package, on the
CPU.

The JAX side runs its Pallas LSTM kernels (`mxnet_tpu.ops.pallas_kernels.
lstm_layer`: `_lstm_infer_kernel`, `_lstm_fwd_kernel`, `_lstm_bwd_kernel`)
in interpret mode, as tests/test_pallas.py does; the port runs the plain
versions its kernel wrappers take for CPU tensors. Inputs are made with
numpy from a seed and handed to both. The card-only tests of the CUDA
kernels are in tests/test_torch_port_cuda.py.

Tolerances: f32 2e-5 for the outputs and 5e-5 for the gradients, the JAX
package's own tests' tolerances (both sides compute in f32 and sum the
products in other orders). bf16 outputs 2^-7 relative with a floor of
2^-7 x the largest magnitude: both sides round ys, the gates and the
carried h to bf16 at the same places, so they differ only where an f32
sum taken in another order rounds to the neighbouring bf16 value (one
step is 2^-8 relative), and that difference is carried into the later
steps.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pallas_kernels as tpk

NAMES = ("x", "wx", "wh", "bx", "bh", "h0", "c0")


def _inputs(T=7, B=5, I=6, H=9, seed=0):
    """tests/test_pallas.py's `_lstm_inputs`."""
    rng = np.random.RandomState(seed)
    return (rng.randn(T, B, I).astype(np.float32),
            (rng.randn(4 * H, I) * 0.3).astype(np.float32),
            (rng.randn(4 * H, H) * 0.3).astype(np.float32),
            (rng.randn(4 * H) * 0.1).astype(np.float32),
            (rng.randn(4 * H) * 0.1).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32))


def _jax_layer(x, wx, wh, bx, bh, h0, c0, reverse=False):
    """The JAX package's kernel route (`ops/rnn.py:_run_layer`)."""
    gx = jnp.dot(x, wx.T) + (bx + bh)
    if reverse:
        gx = jnp.flip(gx, axis=0)
    ys, h_t, c_t = jpk.lstm_layer(gx, wh, h0, c0)
    if reverse:
        ys = jnp.flip(ys, axis=0)
    return ys, h_t, c_t


def _torch_layer(x, wx, wh, bx, bh, h0, c0, reverse=False, fn=None):
    gx = torch.matmul(x, wx.t()) + (bx + bh)
    if reverse:
        gx = gx.flip(0)
    ys, h_t, c_t = (fn or tpk.lstm_layer)(gx, wh, h0, c0)
    if reverse:
        ys = ys.flip(0)
    return ys, h_t, c_t


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).detach().float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(7, 5, 6, 9), (1, 3, 4, 5)])
def test_lstm_layer_matches_jax_kernel(dtype, reverse, shape):
    """ys, hT and cT of `lstm_layer` against the JAX Pallas layer, at a
    ragged shape (B = 5, H = 9: neither padded to the TPU's 16 or 128) and
    at T = 1, forwards and reversed; in the working dtype."""
    args = _inputs(*shape, seed=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _jax_layer(*[jnp.asarray(a, jdt) for a in args], reverse=reverse)
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    launched = tpk.lstm_infer.launches
    got = _torch_layer(*targs, reverse=reverse)
    assert tpk.lstm_infer.launches == launched   # CPU: plain versions
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    for name, a, b in zip(("ys", "hT", "cT"), got, want):
        assert a.dtype == getattr(torch, dtype), name
        _close(a, b, tol, name)


def test_lstm_layer_gradients_match_jax_kernel():
    """All seven gradients under tests/test_pallas.py's loss, through the
    `_LSTMLayer` route (forward and backward plain versions) against
    jax.grad of the JAX Pallas layer (its forward and backward kernels)."""
    args = _inputs()

    def jloss(*a):
        ys, h_t, c_t = _jax_layer(*a)
        return jnp.sum(ys ** 2) + jnp.sum(h_t * 0.7) + jnp.sum(jnp.tanh(c_t))

    want = jax.grad(jloss, argnums=tuple(range(7)))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    ys, h_t, c_t = _torch_layer(*leaves)
    assert ys.grad_fn.name() == "_LSTMLayerBackward"
    loss = (ys ** 2).sum() + (h_t * 0.7).sum() + torch.tanh(c_t).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5,
                                   atol=5e-5, err_msg=name)


def test_lstm_layer_gradients_match_autograd_of_the_step_loop():
    """The `_LSTMLayer` route's gradients (bwd plain version, dW_hh as one
    product) against autograd through `lstm_layer_reference`, reversed,
    with cotangents on ys, hT and cT."""
    args = _inputs(seed=5)
    rng = np.random.RandomState(6)
    cts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
           for s in ((7, 5, 9), (5, 9), (5, 9))]
    grads = []
    for fn in (tpk.lstm_layer, tpk.lstm_layer_reference):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        outs = _torch_layer(*leaves, reverse=True, fn=fn)
        grads.append(torch.autograd.grad(outs, leaves, cts))
    for name, a, b in zip(NAMES, *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_infer_route_equals_training_route(dtype):
    """Without a gradient `lstm_layer` takes `lstm_infer`; with one, the
    `_LSTMLayer` route (`lstm_fwd`). Both give the same ys, hT and cT."""
    tdt = getattr(torch, dtype)
    gx, wh, h0, c0 = (torch.from_numpy(a).to(tdt) for a in (
        np.random.RandomState(3).randn(6, 4, 32).astype(np.float32),
        np.random.RandomState(4).randn(32, 8).astype(np.float32) * 0.3,
        np.random.RandomState(5).randn(4, 8).astype(np.float32),
        np.random.RandomState(6).randn(4, 8).astype(np.float32)))
    with torch.no_grad():
        infer = tpk.lstm_layer(gx, wh, h0, c0)
    assert infer[0].grad_fn is None
    train = tpk.lstm_layer(gx, wh.clone().requires_grad_(), h0, c0)
    assert train[0].grad_fn.name() == "_LSTMLayerBackward"
    for a, b in zip(infer, train):
        assert a.dtype == tdt and torch.equal(a, b.detach())
    ys, c_all, gates = tpk.lstm_fwd(gx, wh, h0, c0)
    assert c_all.dtype == torch.float32 and gates.shape == gx.shape
    assert torch.equal(c_all[-1].to(tdt), infer[2])


def test_lstm_layer_fits_the_card():
    """The H100's resource check: the word LM's (B 32, H 650) fits in f32
    and bf16, as does a one-unit layer; a layer whose w_hh slice alone
    exceeds a block's 227 KB of shared memory (H 20000: 152 units of
    4 x 20000 weights a block) does not, nor does a dtype the kernels do not
    take."""
    for dtype in (torch.float32, torch.bfloat16):
        assert tpk.lstm_layer_fits(32, 650, dtype)
        assert tpk.lstm_layer_fits(1, 1, dtype)
        assert tpk.lstm_layer_fits(32, 200, dtype)
        assert not tpk.lstm_layer_fits(32, 20000, dtype)
    assert not tpk.lstm_layer_fits(32, 650, torch.float64)
    # the block's smem at the word LM's shape (csrc/lstm.cu: 5 units a
    # block; in f32 both stream their left operand in chunks of 512
    # columns)
    assert tpk._lstm_smem(32, 650, 4) == (3200 + 4 * (13000 + 32 * 512),
                                          1280 + 4 * (13000 + 32 * 512))


def test_wrappers_on_cpu_take_plain_versions_and_count_nothing():
    rng = np.random.RandomState(1)
    t, b, h = 3, 2, 4
    gx = torch.from_numpy(rng.randn(t, b, 4 * h).astype(np.float32))
    wh = torch.from_numpy(rng.randn(4 * h, h).astype(np.float32))
    h0, c0 = torch.zeros(b, h), torch.zeros(b, h)
    counts = [f.launches for f in (tpk.lstm_infer, tpk.lstm_fwd,
                                   tpk.lstm_bwd)]
    ys, ct = tpk.lstm_infer(gx, wh, h0, c0)
    ys2, c_all, gates = tpk.lstm_fwd(gx, wh, h0, c0)
    dgx, dh0, dc0 = tpk.lstm_bwd(torch.ones_like(ys), gates, c_all, c0,
                                 torch.zeros_like(ct), wh)
    assert [f.launches for f in (tpk.lstm_infer, tpk.lstm_fwd,
                                 tpk.lstm_bwd)] == counts
    assert dgx.shape == gx.shape and dh0.shape == dc0.shape == (b, h)
    with pytest.raises(MXNetError, match="unsupported device"):
        tpk._lstm_check("lstm_infer", gx.to("meta"), wh, lambda *a: [])


def test_lstm_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.gluon.rnn\n"
            "import mxnet_tpu_torch.gluon.model_zoo.word_lm\n"
            "import mxnet_tpu_torch.convert\n"
            "import mxnet_tpu_torch, mxnet_tpu_torch.ndarray\n"
            "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.ops.tensor\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
