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
# (T, B, H) of the card tests (tests/test_torch_port_cuda.py:_LSTM_SHAPES)
_CARD_SHAPES = [(35, 32, 650), (7, 5, 9), (1, 3, 5), (35, 1, 200),
                (5, 17, 650), (5, 64, 650), (5, 8, 1500), (6, 24, 333),
                (5, 128, 650), (5, 32, 1500), (4, 20, 130)]


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


def _forward_model(gx, wh, h0, c0):
    """Test-only model of csrc/lstm.cu's forward (`lstm_fwd` and
    `lstm_infer` on the card) in gx's dtype: h_{t-1} and w_hh in the dtype,
    zero-padded as the kernel pads them (bf16: to its k16 steps; f32: to
    hx's 16-byte pitch); the product's f32 partial sums over each K slice
    of `_lstm_fwd_layout` (one warp's range of k16 steps; f32 has one
    slice), added in the kernel's fixed order (0 + slice 0 + slice 1 +
    ...), then to the f32 gate inputs; the carries f32, h rounded to the
    dtype where the kernel stores it. The slices depend on B and H alone.
    Returns ys (T, B, H) and cT (B, H) in the dtype."""
    nt, b, g4 = gx.shape
    h, dt = g4 // 4, gx.dtype
    lay = tpk._lstm_fwd_layout(b, h, 1, gx.element_size())
    slices = lay["kslices"]
    if dt == torch.bfloat16:
        unit, n = 16, lay["steps"]
    else:
        unit, n = 4, lay["hp"] // 4
    kp = unit * n
    w = torch.zeros(4 * h, kp)
    w[:, :h] = wh.float()
    h_pad = torch.zeros(b, kp, dtype=dt)
    h_pad[:, :h] = h0
    c = c0.float()
    ys = []
    for t in range(nt):
        acc = torch.zeros(b, 4 * h)
        for ks in range(slices):
            lo, hi = ks * n // slices * unit, (ks + 1) * n // slices * unit
            acc = acc + torch.matmul(h_pad[:, lo:hi].float(), w[:, lo:hi].t())
        g = gx[t].float() + acc
        i, f, gg, o = g.split(h, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_new = (torch.sigmoid(o) * torch.tanh(c)).to(dt)
        h_pad[:, :h] = h_new
        ys.append(h_new)
    return torch.stack(ys), c.to(dt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(7, 5, 6, 9), (1, 3, 4, 5),
                                   (6, 20, 6, 13)])
def test_forward_summation_order_matches_jax_kernel(shape, dtype):
    """The card's forward, rehearsed on the CPU: `_forward_model` (K split
    into the kernel's slices over zero-padded columns, f32 partials added
    in a fixed order) against the JAX Pallas layer in interpret mode, ys
    and cT in the dtype within the file's tolerance (bf16 2^-7, f32 2e-5);
    at the file's shapes and at B = 20 (two m16 tiles, the second
    partial), H = 13 (not a multiple of 8: K padded past the 16-byte pitch
    of hx)."""
    x, wx, wh, bx, bh, h0, c0 = _inputs(*shape, seed=7)
    gx = (np.einsum("tbi,gi->tbg", x, wx) + (bx + bh)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want_ys, _, want_ct = jpk.lstm_layer(
        *[jnp.asarray(a, jdt) for a in (gx, wh, h0, c0)])
    ys, ct = _forward_model(*[torch.from_numpy(a).to(getattr(torch, dtype))
                              for a in (gx, wh, h0, c0)])
    tol = 2.0 ** -7 if dtype == "bfloat16" else 2e-5
    _close(ys, want_ys, tol, "ys")
    _close(ct, want_ct, tol, "cT")
    lay = tpk._lstm_fwd_layout(shape[1], shape[3], 1, ys.element_size())
    if dtype == "bfloat16":
        assert lay["mpad"] == (32 if shape[1] > 16 else 16)
        assert lay["hp"] % 8 == 0 and lay["pitch"] * 2 % 32 == 16
    else:
        assert lay["hp"] % 4 == 0 and lay["kslices"] == 1


def test_lstm_fwd_smem_mirror_at_the_edge():
    """`_lstm_fwd_layout` as csrc/lstm.cu lays out a forward block at the
    word LM's shape (5 units a block): bf16 K slices of 41 k16 steps over
    two m16 tiles, f32 unpadded. The largest batch at H = 650 whose block
    holds all of h in 227 KB, in each dtype, and one past it, which takes
    the streamed forward (`_lstm_smem` then mirrors that kernel) and still
    fits; the word LM's large width (H 1500) at B 32 in bf16 likewise."""
    bf = tpk._lstm_fwd_layout(32, 650, 5, 2)
    assert (bf["hp"], bf["steps"], bf["pitch"], bf["mpad"], bf["w_rows"],
            bf["np"], bf["kslices"]) == (656, 41, 664, 32, 32, 24, 8)
    f32 = tpk._lstm_fwd_layout(32, 650, 5, 4)
    assert (f32["hp"], f32["pitch"], f32["mpad"], f32["w_rows"],
            f32["kslices"]) == (652, 652, 32, 20, 1)
    for dtype, edge in ((torch.bfloat16, 112), (torch.float32, 66)):
        elem = torch.empty((), dtype=dtype).element_size()
        held = tpk._lstm_fwd_layout(edge, 650, 5, elem)["bytes"]
        past = tpk._lstm_fwd_layout(edge + 1, 650, 5, elem)["bytes"]
        assert held <= tpk._SMEM_MAX_BYTES < past
        assert tpk._lstm_smem(edge, 650, elem)[0] == held
        streamed = tpk._lstm_smem(edge + 1, 650, elem)[0]
        assert streamed == 4 * 5 * (edge + 1) * 5 + elem * (
            4 * 5 * 650 + (edge + 1) * tpk._lstm_chunk_cols(edge + 1, 650,
                                                            elem))
        assert tpk.lstm_layer_fits(edge + 1, 650, dtype)
    assert tpk._lstm_fwd_layout(32, 1500, 12, 2)["bytes"] > \
        tpk._SMEM_MAX_BYTES
    assert tpk.lstm_layer_fits(32, 1500, torch.bfloat16)
    # H = 1500 at batch 8 holds h in bf16; f32's w_hh slice alone does not
    # fit a block in either forward
    assert tpk._lstm_fwd_layout(8, 1500, 12, 2)["bytes"] <= \
        tpk._SMEM_MAX_BYTES
    assert not tpk.lstm_layer_fits(8, 1500, torch.float32)


def _bwd_shares(h, q, elem):
    """The contraction's columns [lo, hi) of 4H that each block of a
    backward cluster of ``q`` blocks takes, as csrc/lstm.cu cuts them
    (`_lstm_bwd_layout`'s 16-byte chunks of a row; hi may pass 4H into the
    zero padding of an odd-H bf16 row)."""
    nch = tpk._lstm_bwd_layout(1, h, q, 1, elem)["nch"]
    per = 16 // elem
    return [(r * nch // q * per, (r + 1) * nch // q * per) for r in range(q)]


def _backward_model(dy, gates, c_all, c0, dct, wh, q):
    """Test-only model of csrc/lstm.cu's backward (`lstm_bwd` on the card,
    clusters of ``q`` blocks) in dy's dtype: dgates rounded to the dtype
    where the kernel stores them, and multiplied back through w_hh in the
    dtype: each block's share of the 4H columns (`_bwd_shares`: 16-byte
    chunks; an odd-H bf16 row padded with zero columns) as f32 partial sums
    over the kernel's K slices (`_lstm_bwd_layout`: ranges of k16 steps;
    f32 has one slice), added in slice order (0 + slice 0 + slice 1 ...),
    the blocks' sums added in block order q = 0 .. Q - 1, then dh = dy +
    that carry; dh and dc f32. The slices and shares depend on B, H and Q
    alone. Returns dgx (T, B, 4H), dh0 and dc0 (B, H) in the dtype."""
    nt, b, h = dy.shape
    dt, elem = dy.dtype, dy.element_size()
    lay = tpk._lstm_bwd_layout(b, h, q, 1, elem)
    steps, slices = lay["steps"], lay["kslices"]
    w = torch.zeros(lay["gp"], h)
    w[:4 * h] = wh.float()
    x = torch.zeros(b, lay["gp"], dtype=dt)
    dgx = torch.empty_like(gates)
    dc = dct.float()
    carry = torch.zeros(b, h)
    for t in range(nt - 1, -1, -1):
        i, f, gg, o = gates[t].float().split(h, dim=-1)
        c_prev = c_all[t - 1] if t > 0 else c0.float()
        dh = dy[t].float() + carry
        tc = torch.tanh(c_all[t])
        dc = dc + dh * o * (1.0 - tc * tc)
        dgx[t] = torch.cat([(dc * gg) * i * (1.0 - i),
                            (dc * c_prev) * f * (1.0 - f),
                            (dc * i) * (1.0 - gg * gg),
                            (dh * tc) * o * (1.0 - o)], dim=-1).to(dt)
        dc = dc * f
        x[:, :4 * h] = dgx[t]
        carry = torch.zeros(b, h)
        for lo, hi in _bwd_shares(h, q, elem):
            cuts = ([lo + ks * steps // slices * 16 for ks in range(slices)]
                    + [hi] if dt == torch.bfloat16 else [lo, hi])
            part = torch.zeros(b, h)
            for a, z in zip(cuts[:-1], cuts[1:]):
                z = min(z, hi)
                part = part + torch.matmul(x[:, a:z].float(), w[a:z])
            carry = carry + part
    return dgx, carry.to(dt), dc.to(dt)


@pytest.mark.parametrize("q", [2, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(7, 5, 6, 9), (1, 3, 4, 5),
                                   (6, 20, 6, 13), (5, 1, 4, 8)])
def test_backward_summation_order_matches_jax_kernel(shape, dtype, q):
    """The card's backward, rehearsed on the CPU: `_backward_model` (the
    contraction cut into clusters' shares and K slices over zero-padded
    columns, f32 partials added slice by slice, then block by block)
    against jax.vjp of the JAX Pallas layer in interpret mode
    (`_lstm_bwd_kernel`): dgx, dh0 and dc0 under cotangents on ys and cT,
    in the dtype within the file's tolerance (bf16 2^-7, f32 5e-5); at the
    file's shapes, at B = 20 (the second m16 tile partial) with H = 13 (odd:
    the bf16 exchange row is padded, and so is the last share), and at
    B = 1; clusters of 2 and of 8 blocks."""
    nt, b, _, h = shape
    x, wx, wh, bx, bh, h0, c0 = _inputs(*shape, seed=11)
    gx = (np.einsum("tbi,gi->tbg", x, wx) + (bx + bh)).astype(np.float32)
    rng = np.random.RandomState(12)
    dy = rng.randn(nt, b, h).astype(np.float32)
    dct = rng.randn(b, h).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j_in = [jnp.asarray(a, jdt) for a in (gx, h0, c0)]
    jwh = jnp.asarray(wh, jdt)
    outs, vjp = jax.vjp(lambda g, hh, cc: jpk.lstm_layer(g, jwh, hh, cc),
                        *j_in)
    want = vjp((jnp.asarray(dy, jdt), jnp.zeros_like(outs[1]),
                jnp.asarray(dct, jdt)))
    tdt = getattr(torch, dtype)
    t_gx, t_wh, t_h0, t_c0, t_dy, t_dct = (
        torch.from_numpy(a).to(tdt) for a in (gx, wh, h0, c0, dy, dct))
    _, c_all, gates = tpk.lstm_fwd_reference(t_gx, t_wh, t_h0, t_c0)
    got = _backward_model(t_dy, gates, c_all, t_c0, t_dct, t_wh, q)
    tol = 2.0 ** -7 if dtype == "bfloat16" else 5e-5
    for name, a, w in zip(("dgx", "dh0", "dc0"), got, want):
        assert a.dtype == tdt
        _close(a, w, tol, name)


def test_lstm_bwd_smem_mirror_at_the_edge():
    """`_lstm_bwd_layout` as csrc/lstm.cu lays out a backward block at the
    word LM's shape (15 clusters of 8 blocks on an H100: 6 units a block,
    48 a cluster, shares of 41 chunks, 328 columns): in bf16 two K slices
    of the 21 k16 steps, for two m16 tiles by three pairs of n8 tiles (12
    warps), f32 unpadded. The largest batch at
    H = 650 whose block holds the clustered layout in each dtype, and one
    past it, which takes the streamed backward; `lstm_layer_fits` still
    admits B 1,258 (bf16) and 791 (f32) at H 650 and H 1500 at B 32 in
    bf16, as before the clustered kernel; and the route each card-test
    shape takes."""
    bf = tpk._lstm_bwd_layout(32, 650, 8, 6, 2)
    assert (bf["gp"], bf["nch"], bf["kmax"], bf["steps"], bf["pitch"],
            bf["mpad"], bf["qu"], bf["up"], bf["w_rows"], bf["np"],
            bf["npairs"], bf["kslices"], bf["bytes"]) == (
                2600, 325, 328, 21, 344, 32, 48, 8, 48, 49, 3, 2, 76560)
    f32 = tpk._lstm_bwd_layout(32, 650, 8, 6, 4)
    assert (f32["gp"], f32["kmax"], f32["pitch"], f32["mpad"],
            f32["kslices"], f32["bytes"]) == (2600, 328, 328, 32, 1, 120208)
    # odd H in bf16: a row of 4H = 52 elements is padded to 56
    assert tpk._lstm_bwd_layout(4, 13, 8, 1, 2)["gp"] == 56
    assert _bwd_shares(13, 2, 2) == [(0, 24), (24, 56)]
    assert _bwd_shares(650, 8, 2)[0] == (0, 320)
    assert _bwd_shares(650, 8, 2)[-1] == (2272, 2600)
    for dtype, edge in ((torch.bfloat16, 160), (torch.float32, 94)):
        elem = torch.empty((), dtype=dtype).element_size()
        route, u, held = tpk._lstm_bwd_route(edge, 650, elem)
        assert route == "clusters" and u == 6
        assert held == tpk._lstm_bwd_layout(edge, 650, 8, 6, elem)["bytes"]
        assert held <= tpk._SMEM_MAX_BYTES
        assert tpk._lstm_bwd_layout(edge + 1, 650, 8, 6, elem)["bytes"] > \
            tpk._SMEM_MAX_BYTES
        route, u, past = tpk._lstm_bwd_route(edge + 1, 650, elem)
        assert route == "streamed" and u == 5
        assert past == 4 * 2 * (edge + 1) * 5 + elem * (
            4 * 5 * 650 + (edge + 1) * tpk._lstm_chunk_cols(edge + 1, 2600,
                                                            elem))
        assert tpk._lstm_smem(edge, 650, elem)[1] == held
    for b, dtype in ((1258, torch.bfloat16), (791, torch.float32)):
        assert tpk.lstm_layer_fits(b, 650, dtype)
        assert not tpk.lstm_layer_fits(b + 1, 650, dtype)
    assert tpk.lstm_layer_fits(32, 1500, torch.bfloat16)
    routes = {(b, h, elem): tpk._lstm_bwd_route(b, h, elem)[0]
              for _, b, h in _CARD_SHAPES for elem in (2, 4)}
    streamed = sorted(k for k, r in routes.items() if r == "streamed")
    assert streamed == [(8, 1500, 4), (32, 1500, 2), (32, 1500, 4),
                        (128, 650, 4)]
    assert tpk._lstm_bwd_route(8, 1500, 2)[:2] == ("clusters", 13)


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
    # forward block; in f32 the forward's c carry, one slice of partial
    # products, 20 gate rows and all of h at a pitch of 652; the backward,
    # 6 units a block in clusters of 8, holds its mbarrier, its peers'
    # partial sums in rows of 8, its dc carry, one slice of partial
    # products, w_hh's 48 units over a share of 328 columns, and that share
    # of dgx[t])
    assert tpk._lstm_smem(32, 650, 4) == (
        4 * (32 * 5 + 32 * 24 + 20 * 652 + 32 * 652),
        16 + 4 * (8 * 32 * 8 + 32 * 6 + 32 * 49 + 48 * 328 + 32 * 328))


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
