"""Flash attention of the PyTorch port against the JAX package, on the CPU.

The JAX side runs as tests/test_pallas.py runs it: its Pallas kernels in
interpret mode (`_flash_fwd` for O and lse, `_bwd_compiled` for dQ, dK
and dV: the two halves of `flash_attention`'s custom vjp). The port runs
the plain versions its wrappers take for CPU tensors, through the same
autograd Function that carries the kernels on the card. Inputs are made
with numpy from a seed and handed to both. The card-only tests of the
kernels are in tests/test_torch_port_cuda.py.

Tolerances: |port - jax| <= tol * |jax| + tol, with tol 5e-4 in f32 (the
JAX test's own, test_pallas.py) and 2e-2 in bf16 (both sides compute in
f32 from the same bf16 inputs and round the result once; one bf16
rounding step is 2^-8 relative, and the two may round a value near a tie
to neighbouring bf16 numbers).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import pallas_kernels as tpk

TOL = {"float32": 5e-4, "bfloat16": 2e-2}
_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _close(got, want, tol, what):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _inputs(shape, dtype, seed=5):
    b, lq, lk, d = shape
    rng = np.random.RandomState(seed)
    arrays = [rng.normal(size=(b, n, d)).astype(np.float32)
              for n in (lq, lk, lk, lq)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    # bf16 inputs rounded once, by JAX, and handed to both sides
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
         for x in j]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 64, 32), (1, 200, 260, 16),
                                   (2, 300, 300, 64)])
def test_flash_matches_jax_kernels(dtype, causal, shape):
    """The port's flash attention (forward, and dQ/dK/dV through its
    autograd Function) and its three plain per-kernel versions against the
    JAX package's Pallas kernels: O, lse, dQ, dK, dV. Causal
    cross-attention (Lq != Lk) keeps the top-left diagonal on both
    sides."""
    tol = TOL[dtype]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, dtype)
    b, lq, lk, d = shape
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = jpk._flash_fwd(jq, jk, jv, causal, scale)
    run = jpk._bwd_compiled((b, lq, lk, d, str(jq.dtype), causal, scale,
                             jpk._use_interpret()))
    j_dq, j_dk, j_dv = run(jq, jk, jv, j_out, j_lse, jg)

    # the plain per-kernel versions, fed the JAX forward's lse
    out, lse = tpk.flash_fwd_reference(tq, tk, tv, causal, scale)
    _close(out, j_out, tol, "out")
    _close(lse, j_lse, TOL["float32"], "lse")
    t_lse = torch.from_numpy(np.asarray(j_lse))
    delta = (tg.float() * out.float()).sum(-1)
    _close(tpk.flash_bwd_dq_reference(tq, tk, tv, tg, t_lse, delta, causal,
                                      scale), j_dq, tol, "dq kernel")
    dk, dv = tpk.flash_bwd_dkv_reference(tq, tk, tv, tg, t_lse, delta,
                                         causal, scale)
    _close(dk, j_dk, tol, "dk kernel")
    _close(dv, j_dv, tol, "dv kernel")

    # the whole function through its autograd Function
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = [getattr(tpk, n).launches for n in _NAMES]
    o = tcontrib.flash_attention(*leaves, causal=causal, sm_scale=scale)
    grads = torch.autograd.grad(o, leaves, tg)
    assert [getattr(tpk, n).launches for n in _NAMES] == before
    _close(o.detach(), j_out, tol, "flash_attention")
    for name, got, want in zip(("dq", "dk", "dv"), grads, (j_dq, j_dk, j_dv)):
        assert got.dtype == tq.dtype, name
        _close(got, want, tol, "flash_attention " + name)


def test_flash_attention_over_heads_matches_jax():
    """(B, H, L, D) inputs, leading dims batched, the default scale; and
    `flash_attention_reference` against `_attention_reference`."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.normal(size=(2, 3, 40, 16)).astype(np.float32)
               for _ in range(3))
    want = jpk.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    got = tpk.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert got.shape == (2, 3, 40, 16)
    _close(got, want, TOL["float32"], "flash_attention")
    ref = jpk._attention_reference(*(jnp.asarray(a.reshape(6, 40, 16))
                                     for a in (q, k, v)), True, 0.25)
    _close(tpk.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=True).reshape(6, 40, 16),
        ref, TOL["float32"], "reference")


def test_flash_single_row_and_masked_causal_rows_are_finite():
    """Lq = 1, and causal rows past Lk (Lq > Lk), give finite values that
    equal the plain attention's, in the forward and the gradients."""
    for shape, causal in (((2, 1, 7, 8), False), ((2, 1, 7, 8), True),
                          ((1, 9, 4, 8), True)):
        _, (q, k, v, g) = _inputs(shape, "float32", seed=9)
        results = []
        for fn in (tpk.flash_attention, tpk.flash_attention_reference):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, causal=causal)
            results.append([out] + list(torch.autograd.grad(out, leaves, g)))
        for a, b in zip(*results):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_flash_wrappers_cpu_take_plain_versions_and_reject_other_devices():
    """CPU tensors run the plain versions and count no launch; a tensor on
    a device that is neither CPU nor CUDA raises."""
    _, (q, k, v, g) = _inputs((1, 5, 6, 8), "float32")
    before = [getattr(tpk, n).launches for n in _NAMES]
    out, lse = tpk.flash_fwd(q, k, v)
    delta = (g * out).sum(-1)
    tpk.flash_bwd_dq(q, k, v, g, lse, delta)
    tpk.flash_bwd_dkv(q, k, v, g, lse, delta)
    assert [getattr(tpk, n).launches for n in _NAMES] == before
    meta = q.to("meta")
    with pytest.raises(MXNetError, match="device"):
        tpk.flash_fwd(meta, meta, meta)


def _mma_fwd(q, k, v, causal, scale):
    """The plain forward with the bf16 tensor-core kernel's rounding point:
    P rounded to bf16 before P v (the row sum l stays the unrounded f32
    sum)."""
    s = tpk._flash_scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p.bfloat16().float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _mma_dkv(q, k, v, dout, lse, delta, causal, scale):
    """The plain dK/dV with the bf16 tensor-core kernel's rounding points:
    P rounded to bf16 before P^T dO, and dS = P (dO v^T - delta) before
    dS^T q (sm_scale applied to the f32 sum)."""
    p = torch.exp(tpk._flash_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.bfloat16().float(), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _mma_dq(q, k, v, dout, lse, delta, causal, scale):
    """The plain dQ with the bf16 tensor-core kernel's rounding point: P in
    f32, dS = P (dO v^T - delta) rounded to bf16 before dS k, the sum in f32
    and sm_scale applied to it."""
    p = torch.exp(tpk._flash_scores(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    return (torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale).to(q.dtype)


_MMA_CASES = [(2, 64, 64, 32), (1, 200, 260, 16), (2, 300, 300, 64),
              (1, 130, 70, 40), (1, 130, 70, 20)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _MMA_CASES)
def test_flash_bf16_rounding_points_match_jax_kernels(causal, shape):
    """CPU rehearsal of the bf16 tensor-core kernels' numerics: the plain
    forward and dK/dV with P (and dS) rounded to bf16 where the kernels
    round them hold the JAX package's Pallas kernels at the unchanged bf16
    tolerance, causal and not, at the head dims the kernels pad (40, 20)
    too."""
    tol = TOL["bfloat16"]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, "bfloat16")
    b, lq, lk, d = shape
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = jpk._flash_fwd(jq, jk, jv, causal, scale)
    run = jpk._bwd_compiled((b, lq, lk, d, str(jq.dtype), causal, scale,
                             jpk._use_interpret()))
    _, j_dk, j_dv = run(jq, jk, jv, j_out, j_lse, jg)

    out, lse = _mma_fwd(tq, tk, tv, causal, scale)
    _close(out, j_out, tol, "out")
    _close(lse, j_lse, TOL["float32"], "lse")
    t_lse = torch.from_numpy(np.asarray(j_lse))
    delta = (tg.float() * out.float()).sum(-1)
    dk, dv = _mma_dkv(tq, tk, tv, tg, t_lse, delta, causal, scale)
    _close(dk, j_dk, tol, "dk")
    _close(dv, j_dv, tol, "dv")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _MMA_CASES)
def test_flash_bf16_dq_rounding_point_matches_jax_kernel(causal, shape):
    """CPU rehearsal of the bf16 tensor-core dQ kernel's numerics: dS
    rounded to bf16 before dS k, where the JAX kernel keeps it in f32, holds
    the JAX package's dQ at the unchanged bf16 tolerance, causal and not,
    at the padded head dims (40, 20) too."""
    tol = TOL["bfloat16"]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, "bfloat16")
    b, lq, lk, d = shape
    scale = 1.0 / np.sqrt(d)
    j_out, j_lse = jpk._flash_fwd(jq, jk, jv, causal, scale)
    run = jpk._bwd_compiled((b, lq, lk, d, str(jq.dtype), causal, scale,
                             jpk._use_interpret()))
    j_dq, _, _ = run(jq, jk, jv, j_out, j_lse, jg)

    t_out = torch.from_numpy(np.array(j_out.astype(jnp.float32)))
    t_lse = torch.from_numpy(np.asarray(j_lse))
    delta = (tg.float() * t_out).sum(-1)
    dq = _mma_dq(tq, tk, tv, tg, t_lse, delta, causal, scale)
    assert dq.dtype == torch.bfloat16
    _close(dq, j_dq, tol, "dq")
