"""Hand-written kernels of the port: the counterpart of the JAX package's
`ops/pallas_kernels.py`.

The module keeps the JAX module's name so a reader finds the counterpart;
it holds no Pallas. Ported so far:

* paged decode attention (:1141-1299 of the JAX module):
  `paged_attention` launches ``csrc/paged_attention.cu``;
* the conv epilogue (:725-1112): `conv_epilogue` (training-mode
  BatchNorm (+ residual) (+ ReLU) over a channels-last activation, with a
  kernel backward) runs the four kernels of ``csrc/conv_epilogue.cu``
  through the wrappers `epi_stats`, `epi_apply`, `epi_bwd_reduce` and
  `epi_bwd_dx`;
* flash attention (:40-373): `flash_attention` (differentiable, over
  (..., L, D)) runs the three kernels of ``csrc/flash_attention.cu``
  through the wrappers `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv`.

Every wrapper launches its hand-written CUDA kernel (sm_90a) for CUDA
tensors, and adds one to its ``launches`` count where it does; it runs its
plain PyTorch version (``*_reference``) only for tensors on the CPU.
Nothing sends a CUDA tensor to a plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "conv_epilogue",
           "conv_epilogue_reference", "epi_stats", "epi_stats_reference",
           "epi_apply", "epi_apply_reference", "epi_bwd_reduce",
           "epi_bwd_reduce_reference", "epi_bwd_dx", "epi_bwd_dx_reference",
           "flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_fwd_reference", "flash_bwd_dq", "flash_bwd_dq_reference",
           "flash_bwd_dkv", "flash_bwd_dkv_reference"]

# finite mask value: a fully masked row stays NaN-free
_NEG_INF = -1e30

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _call(source, argtypes, symbol, dev, *args):
    """Launch entry ``symbol`` of ``csrc/<source>.cu`` (C argument types
    ``argtypes[symbol]``, then the stream) on the current stream of
    ``dev``; raises when the launch reports a CUDA error."""
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes[symbol] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise MXNetError("%s kernel launch failed: CUDA error %d"
                         % (symbol, rc))


_KERNEL_DTYPES = {torch.float32: "paged_attention_f32",
                  torch.bfloat16: "paged_attention_bf16"}
_PAGED_ARGTYPES = dict.fromkeys(_KERNEL_DTYPES.values(),
                                [_P] * 6 + [_I] * 6 + [_F])
_KERNEL_MAX_HEAD_DIM = 128


def paged_attention_reference(q, k_pages, v_pages, page_tables, lengths,
                              sm_scale):
    """Dense-gather version: q (B, H, D); k_pages / v_pages
    (P, H, page_size, D); page_tables (B, max_pages) int; lengths (B,) int.
    Tokens [0, lengths[b]) of sequence b are live, laid out
    ``page_tables[b, t // page_size]`` slot ``t % page_size``. Accumulates
    in f32. A row with length 0 comes out as zeros, as from the kernel."""
    b, h, d = q.shape
    ps = k_pages.shape[2]
    maxp = page_tables.shape[1]
    tbl = page_tables.long()
    k = k_pages[tbl].movedim(2, 1).reshape(b, h, maxp * ps, d)
    v = v_pages[tbl].movedim(2, 1).reshape(b, h, maxp * ps, d)
    s = torch.einsum("bhd,bhld->bhl", q.float(), k.float()) * sm_scale
    ids = torch.arange(maxp * ps, device=q.device)[None, None, :]
    lens = lengths.long()
    s = torch.where(ids < lens[:, None, None], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhl,bhld->bhd", p, v.float())
    o = torch.where((lens > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def _check_kernel_args(q, k_pages, v_pages, page_tables, lengths):
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("lengths", lengths)):
        if t.device != dev:
            raise MXNetError("paged_attention: %s is on %s, q on %s"
                             % (name, t.device, dev))
        if not t.is_contiguous():
            raise MXNetError("paged_attention: %s must be contiguous" % name)
    if q.dtype != torch.float32 or q.dim() != 3:
        raise MXNetError("paged_attention: q must be float32 (B, H, D), got "
                         "%s %s" % (q.dtype, tuple(q.shape)))
    b, h, d = q.shape
    if not 1 <= d <= _KERNEL_MAX_HEAD_DIM:
        raise MXNetError("paged_attention: head dim %d not in 1..%d"
                         % (d, _KERNEL_MAX_HEAD_DIM))
    if k_pages.dtype not in _KERNEL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise MXNetError("paged_attention: K/V pages must both be float32 "
                         "or bfloat16, got %s / %s"
                         % (k_pages.dtype, v_pages.dtype))
    if k_pages.dim() != 4 or k_pages.shape[1] != h or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape:
        raise MXNetError("paged_attention: pages must be (P, %d, ps, %d), got "
                         "%s / %s" % (h, d, tuple(k_pages.shape),
                                      tuple(v_pages.shape)))
    if page_tables.dtype != torch.int32 or page_tables.dim() != 2 \
            or page_tables.shape[0] != b:
        raise MXNetError("paged_attention: page_tables must be int32 "
                         "(%d, max_pages)" % b)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise MXNetError("paged_attention: lengths must be int32 (%d,)" % b)


def paged_attention(q, k_pages, v_pages, page_tables, lengths,
                    sm_scale=None):
    """Decode attention: one query token per sequence against a paged KV
    cache (docs/serving.md §Generation of the JAX package).

    q: (B, H, D) float32. k_pages / v_pages: (P, H, page_size, D) float32
    or bfloat16. page_tables: (B, max_pages) int32, where sequence b's
    token t lives in page ``page_tables[b, t // page_size]``, slot
    ``t % page_size``. lengths: (B,) int32 live-token counts; 0 marks an
    inert padding row, which returns zeros. Returns (B, H, D) float32.

    A CUDA tensor goes through the CUDA kernel (built at first use), and
    each launch adds one to ``paged_attention.launches``; a CPU tensor goes
    through `paged_attention_reference`.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sm_scale = float(sm_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_tables,
                                         lengths, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError("paged_attention: unsupported device %s" % q.device)
    _check_kernel_args(q, k_pages, v_pages, page_tables, lengths)
    b, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    _call("paged_attention", _PAGED_ARGTYPES, _KERNEL_DTYPES[k_pages.dtype],
          q.device, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
          page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
          d, k_pages.shape[0], k_pages.shape[2], page_tables.shape[1],
          sm_scale)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# Conv epilogue: training-mode BatchNorm (+ residual add) (+ ReLU) over a
# channels-last activation seen as rows (R = N*H*W, C). Forward: epi_stats
# (batch moments, then scale and shift) and epi_apply; backward:
# epi_bwd_reduce (the two per-channel sums, then dgamma, dbeta and the dx
# coefficients) and epi_bwd_dx. The per-channel finishing math that the JAX
# package ran between its kernels (`_epi_forward`, `_epi_bwd_impl`) runs
# inside the kernels' second passes here.
# ---------------------------------------------------------------------------

_EPI_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# pass-1 row chunks of the two reductions: one per 128 rows, at most 1024
# (a function of R alone, so a shape always reduces in the same order)
_EPI_CHUNK_ROWS = 128
_EPI_MAX_CHUNKS = 1024

_EPI_ARGTYPES = {
    "epi_stats": [_P, _I, _L, _I, _P, _P, _I, _F, _I, _P, _I] + [_P] * 5,
    "epi_apply": [_P, _P, _I, _L, _I, _P, _P, _I, _P],
    "epi_bwd_reduce": [_P, _P, _P, _I, _L, _I, _P, _P, _P, _I, _I, _P, _I]
                      + [_P] * 5,
    "epi_bwd_dx": [_P, _P, _P, _I, _L, _I] + [_P] * 7,
}


def _epi_chunks(r):
    return max(1, min(_EPI_MAX_CHUNKS, -(-r // _EPI_CHUNK_ROWS)))


def _epi_call(symbol, dev, *args):
    _call("conv_epilogue", _EPI_ARGTYPES, symbol, dev, *args)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _epi_check(name, x2d, rows=(), vecs=(), params=()):
    """Arguments of a kernel wrapper: ``x2d`` a contiguous (R, C) float32
    or bfloat16 CUDA tensor with R >= 1; every other row tensor the same
    shape, dtype and device, contiguous; every per-channel vector f32 (C,);
    gamma / beta (``params``) f32 or bf16 (C,), of one dtype. Raises
    `MXNetError`; nothing is copied or converted."""
    if x2d.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (name, x2d.device))
    if x2d.dim() != 2 or x2d.dtype not in _EPI_DTYPES:
        raise MXNetError("%s: x must be a float32 or bfloat16 (R, C) "
                         "tensor, got %s %s" % (name, x2d.dtype,
                                                tuple(x2d.shape)))
    r, c = x2d.shape
    if r < 1 or c < 1:
        raise MXNetError("%s: empty input %s" % (name, tuple(x2d.shape)))
    named = ([("x", x2d)] + [(n, t) for n, t in rows if t is not None]
             + list(vecs) + list(params))
    for label, t in named:
        if t.device != x2d.device:
            raise MXNetError("%s: %s is on %s, x on %s"
                             % (name, label, t.device, x2d.device))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous (a channels-last "
                             "activation viewed as (R, C) rows)"
                             % (name, label))
    for label, t in rows:
        if t is not None and (t.shape != x2d.shape or t.dtype != x2d.dtype):
            raise MXNetError("%s: %s must be %s %s like x, got %s %s"
                             % (name, label, x2d.dtype, tuple(x2d.shape),
                                t.dtype, tuple(t.shape)))
    for label, t in vecs:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise MXNetError("%s: %s must be float32 (%d,), got %s %s"
                             % (name, label, c, t.dtype, tuple(t.shape)))
    if params:
        dt = params[0][1].dtype
        for label, t in params:
            if t.dtype != dt or dt not in _EPI_DTYPES \
                    or tuple(t.shape) != (c,):
                raise MXNetError("%s: gamma and beta must both be float32 "
                                 "or bfloat16 (%d,), got %s %s"
                                 % (name, c, t.dtype, tuple(t.shape)))


def epi_stats_reference(x2d, gamma, beta, eps, fix_gamma):
    """Plain version of `epi_stats`."""
    from .nn import _bn_stats

    mean, var = _bn_stats(x2d)
    inv = torch.rsqrt(var + eps)
    g1 = torch.ones_like(inv) if fix_gamma else gamma.float()
    scale = g1 * inv
    shift = beta.float() - mean * scale
    return mean, var, inv, scale, shift


def epi_stats(x2d, gamma, beta, eps=1e-3, fix_gamma=False):
    """Batch statistics of rows ``x2d`` (R, C), float32 or bfloat16, and
    the normalize they give: f32 (C,) ``(mean, var, inv, scale, shift)``
    with the biased ``var = max(E[d^2] - E[d]^2, 0)`` of ``d = x - proxy``
    (the proxy: the mean of the first 8 rows), ``inv = 1/sqrt(var + eps)``,
    ``scale = gamma * inv`` (gamma taken as 1 under ``fix_gamma``) and
    ``shift = beta - mean * scale``. CUDA: the kernel pair ``epi_stats`` of
    ``csrc/conv_epilogue.cu`` (deterministic two-pass column sums); CPU:
    `epi_stats_reference`."""
    if x2d.device.type == "cpu":
        return epi_stats_reference(x2d, gamma, beta, eps, fix_gamma)
    _epi_check("epi_stats", x2d, params=(("gamma", gamma), ("beta", beta)))
    r, c = x2d.shape
    n = _epi_chunks(r)
    part = torch.empty((2, n, c), dtype=torch.float32, device=x2d.device)
    vecs = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    _epi_call("epi_stats", x2d.device, x2d.data_ptr(),
              _EPI_DTYPES[x2d.dtype], r, c, gamma.data_ptr(),
              beta.data_ptr(), int(gamma.dtype == torch.bfloat16),
              float(eps), int(bool(fix_gamma)), part.data_ptr(), n,
              *(v.data_ptr() for v in vecs))
    epi_stats.launches += 1
    return tuple(vecs)


epi_stats.launches = 0


def epi_apply_reference(x2d, res2d, scale, shift, relu):
    """Plain version of `epi_apply`."""
    y = x2d.float() * scale + shift
    if res2d is not None:
        y = y + res2d.float()
    if relu:
        y = torch.relu(y)
    return y.to(x2d.dtype)


def epi_apply(x2d, res2d, scale, shift, relu=True):
    """``relu?(x * scale + shift (+ res))`` over rows (R, C), computed in
    f32 and stored in x's dtype; ``res2d`` may be None. CUDA: the
    ``epi_apply`` kernel; CPU: `epi_apply_reference`."""
    if x2d.device.type == "cpu":
        return epi_apply_reference(x2d, res2d, scale, shift, relu)
    _epi_check("epi_apply", x2d, rows=(("residual", res2d),),
               vecs=(("scale", scale), ("shift", shift)))
    r, c = x2d.shape
    out = torch.empty_like(x2d)
    _epi_call("epi_apply", x2d.device, x2d.data_ptr(), _ptr(res2d),
              _EPI_DTYPES[x2d.dtype], r, c, scale.data_ptr(),
              shift.data_ptr(), int(bool(relu)), out.data_ptr())
    epi_apply.launches += 1
    return out


epi_apply.launches = 0


def _masked_ct(ct, out):
    g = ct.float()
    if out is not None:
        g = torch.where(out.float() > 0, g, torch.zeros_like(g))
    return g


def epi_bwd_reduce_reference(ct, x2d, out, mean, inv, gamma, fix_gamma):
    """Plain version of `epi_bwd_reduce`."""
    g = _masked_ct(ct, out)
    xhat = (x2d.float() - mean) * inv
    db = g.sum(dim=0)
    dg = (g * xhat).sum(dim=0)
    r = x2d.shape[0]
    g1 = torch.ones_like(inv) if fix_gamma else gamma.float()
    dgamma = torch.zeros_like(gamma) if fix_gamma else dg.to(gamma.dtype)
    return dgamma, db.to(gamma.dtype), g1 * inv, db / r, dg / r


def epi_bwd_reduce(ct, x2d, out, mean, inv, gamma, fix_gamma=False):
    """The backward's per-channel sums over rows (R, C): with ``g = ct``
    masked by ``out > 0`` (``out`` is the saved forward output when relu
    was on, else None) and ``xhat = (x - mean) * inv``, returns
    ``(dgamma, dbeta, coef, cb, cg)``: dgamma = sum(g * xhat) (zeros under
    ``fix_gamma``) and dbeta = sum(g) in gamma's dtype, and the f32 (C,)
    dx coefficients coef = gamma * inv, cb = sum(g) / R, cg =
    sum(g * xhat) / R. CUDA: the kernel pair ``epi_bwd_reduce``
    (deterministic); CPU: `epi_bwd_reduce_reference`."""
    if x2d.device.type == "cpu":
        return epi_bwd_reduce_reference(ct, x2d, out, mean, inv, gamma,
                                        fix_gamma)
    _epi_check("epi_bwd_reduce", x2d, rows=(("ct", ct), ("out", out)),
               vecs=(("mean", mean), ("inv", inv)),
               params=(("gamma", gamma),))
    r, c = x2d.shape
    n = _epi_chunks(r)
    part = torch.empty((2, n, c), dtype=torch.float32, device=x2d.device)
    grads = torch.empty((2, c), dtype=gamma.dtype, device=x2d.device)
    vecs = torch.empty((3, c), dtype=torch.float32, device=x2d.device)
    _epi_call("epi_bwd_reduce", x2d.device, ct.data_ptr(), x2d.data_ptr(),
              _ptr(out), _EPI_DTYPES[x2d.dtype], r, c, mean.data_ptr(),
              inv.data_ptr(), gamma.data_ptr(),
              int(gamma.dtype == torch.bfloat16), int(bool(fix_gamma)),
              part.data_ptr(), n, grads[0].data_ptr(), grads[1].data_ptr(),
              *(v.data_ptr() for v in vecs))
    epi_bwd_reduce.launches += 1
    return (grads[0], grads[1]) + tuple(vecs)


epi_bwd_reduce.launches = 0


def epi_bwd_dx_reference(ct, x2d, out, mean, inv, coef, cb, cg, has_res):
    """Plain version of `epi_bwd_dx`."""
    g = _masked_ct(ct, out)
    xhat = (x2d.float() - mean) * inv
    dx = (coef * (g - cb - xhat * cg)).to(x2d.dtype)
    return dx, (g.to(x2d.dtype) if has_res else None)


def epi_bwd_dx(ct, x2d, out, mean, inv, coef, cb, cg, has_res=False):
    """``dx = coef * (g - cb - xhat * cg)`` over rows (R, C), with g and
    xhat as in `epi_bwd_reduce`, and ``dres = g`` when ``has_res`` (else
    None), both in x's dtype. CUDA: the ``epi_bwd_dx`` kernel; CPU:
    `epi_bwd_dx_reference`."""
    if x2d.device.type == "cpu":
        return epi_bwd_dx_reference(ct, x2d, out, mean, inv, coef, cb, cg,
                                    has_res)
    _epi_check("epi_bwd_dx", x2d, rows=(("ct", ct), ("out", out)),
               vecs=(("mean", mean), ("inv", inv), ("coef", coef),
                     ("cb", cb), ("cg", cg)))
    r, c = x2d.shape
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(x2d) if has_res else None
    _epi_call("epi_bwd_dx", x2d.device, ct.data_ptr(), x2d.data_ptr(),
              _ptr(out), _EPI_DTYPES[x2d.dtype], r, c, mean.data_ptr(),
              inv.data_ptr(), coef.data_ptr(), cb.data_ptr(), cg.data_ptr(),
              dx.data_ptr(), _ptr(dres))
    epi_bwd_dx.launches += 1
    return dx, dres


epi_bwd_dx.launches = 0


class _ConvEpilogue(torch.autograd.Function):
    """The JAX package's custom_vjp pair `epi3` / `epi4`: forward through
    `epi_stats` + `epi_apply`, backward through `epi_bwd_reduce` +
    `epi_bwd_dx`. The mean / var outputs are not differentiable (their
    cotangents are ignored, as in the JAX package: they feed the moving
    statistics). ``out`` is saved only when relu is on (`_epi_save`)."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, res2d, eps, fix_gamma, relu):
        mean, var, inv, scale, shift = epi_stats(x2d, gamma, beta, eps,
                                                 fix_gamma)
        out = epi_apply(x2d, res2d, scale, shift, relu)
        ctx.save_for_backward(x2d, gamma, mean, inv, out if relu else None)
        ctx.fix_gamma = fix_gamma
        ctx.has_res = res2d is not None
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, ct, _ct_mean, _ct_var):
        x2d, gamma, mean, inv, out = ctx.saved_tensors
        # autograd may hand an expanded cotangent (stride 0 behind a global
        # average pool); the kernels take dense rows, so it is made dense
        # here, once, as the JAX package's cotangent is
        ct = ct.contiguous()
        dgamma, dbeta, coef, cb, cg = epi_bwd_reduce(ct, x2d, out, mean, inv,
                                                     gamma, ctx.fix_gamma)
        dx, dres = epi_bwd_dx(ct, x2d, out, mean, inv, coef, cb, cg,
                              ctx.has_res)
        return dx, dgamma, dbeta, dres, None, None, None


def _epi_rows(x, c, label):
    if x.device.type != "cpu" and not x.is_contiguous():
        raise MXNetError("conv_epilogue: %s must be a contiguous "
                         "channels-last tensor (..., C); got strides %s"
                         % (label, tuple(x.stride())))
    return x.reshape(-1, c)


def conv_epilogue(x, gamma, beta, residual=None, eps=1e-3, fix_gamma=False,
                  relu=True):
    """Fused training-mode BatchNorm (batch statistics) + normalize
    (+ residual add) (+ ReLU) over a channels-last activation ``x`` (..., C).

    Returns ``(out, mean, var)``: ``out`` in x's dtype and shape, the batch
    mean and biased variance f32 (C,) for the moving-statistics update.
    Differentiable in x, gamma, beta and residual (a kernel backward);
    mean and var are not differentiable. CUDA tensors go through the four
    kernels of ``csrc/conv_epilogue.cu``; CPU tensors through their plain
    versions. On the card x (and residual) must be contiguous: the (R, C)
    view is then free, and the wrapper raises rather than copy."""
    shape = x.shape
    c = shape[-1]
    x2d = _epi_rows(x, c, "x")
    res2d = None if residual is None else _epi_rows(residual, c, "residual")
    out, mean, var = _ConvEpilogue.apply(x2d, gamma, beta, res2d, float(eps),
                                         bool(fix_gamma), bool(relu))
    return out.reshape(shape), mean, var


def conv_epilogue_reference(x, gamma, beta, residual=None, eps=1e-3,
                            fix_gamma=False, relu=True):
    """Plain version of `conv_epilogue`: the same function composed of
    PyTorch ops, differentiated by autograd (through the batch statistics).
    Any device."""
    shape = x.shape
    c = shape[-1]
    x2d = x.reshape(-1, c)
    mean, var, _, scale, shift = epi_stats_reference(x2d, gamma, beta, eps,
                                                     fix_gamma)
    out = epi_apply_reference(
        x2d, None if residual is None else residual.reshape(-1, c), scale,
        shift, relu)
    return out.reshape(shape), mean.detach(), var.detach()


# ---------------------------------------------------------------------------
# Flash attention over (BH, L, D): forward (O and the per-row logsumexp),
# and the backward as the JAX package splits it: delta = sum(dO * O) in
# plain torch, then dQ over k tiles and dK/dV over q tiles, each recomputing
# P from lse. Causal keeps the top-left diagonal (key col <= query row).
# ---------------------------------------------------------------------------

_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_MAX_HEAD_DIM = 128
_FLASH_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I],
    "flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _I],
}


def _flash_check(name, q, k, v, dout=None, lse=None, delta=None):
    """Arguments of a flash kernel wrapper: q (BH, Lq, D) and k, v
    (BH, Lk, D), float32 or bfloat16 of one dtype, with BH, Lq, Lk >= 1 and
    D <= 128; dout like q; lse and delta f32 (BH, Lq); all contiguous on one
    CUDA device. Raises `MXNetError`; nothing is copied or converted."""
    if q.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (name, q.device))
    if q.dim() != 3 or q.dtype not in _FLASH_DTYPES:
        raise MXNetError("%s: q must be a float32 or bfloat16 (BH, Lq, D) "
                         "tensor, got %s %s" % (name, q.dtype,
                                                tuple(q.shape)))
    bh, lq, d = q.shape
    if bh < 1 or lq < 1 or not 1 <= d <= _FLASH_MAX_HEAD_DIM:
        raise MXNetError("%s: q shape %s: BH and Lq must be >= 1 and D in "
                         "1..%d" % (name, tuple(q.shape),
                                    _FLASH_MAX_HEAD_DIM))
    named = [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
             ("delta", delta)]
    for label, t in named:
        if t is None:
            continue
        if t.device != q.device:
            raise MXNetError("%s: %s is on %s, q on %s"
                             % (name, label, t.device, q.device))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous (BH, L, D)"
                             % (name, label))
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d or k.shape[1] < 1 \
            or v.shape != k.shape:
        raise MXNetError("%s: k and v must both be (%d, Lk >= 1, %d), got %s "
                         "/ %s" % (name, bh, d, tuple(k.shape),
                                   tuple(v.shape)))
    for label, t in (("k", k), ("v", v), ("dout", dout)):
        if t is not None and t.dtype != q.dtype:
            raise MXNetError("%s: %s is %s, q %s" % (name, label, t.dtype,
                                                     q.dtype))
    if dout is not None and dout.shape != q.shape:
        raise MXNetError("%s: dout must be %s like q, got %s"
                         % (name, tuple(q.shape), tuple(dout.shape)))
    for label, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (bh, lq)):
            raise MXNetError("%s: %s must be float32 (%d, %d), got %s %s"
                             % (name, label, bh, lq, t.dtype,
                                tuple(t.shape)))


def _flash_call(symbol, q, k, tensors, sm_scale, causal):
    """Launch ``symbol`` on the pointers of ``tensors`` (its C argument
    order), then dtype, BH, Lq, Lk, D, scale and causal."""
    bh, lq, d = q.shape
    _call("flash_attention", _FLASH_ARGTYPES, symbol, q.device,
          *(t.data_ptr() for t in tensors), _FLASH_DTYPES[q.dtype], bh, lq,
          k.shape[1], d, sm_scale, int(bool(causal)))


def _flash_scores(q, k, causal, sm_scale):
    """f32 scores ``q k^T * sm_scale`` (BH, Lq, Lk), the entries above a
    causal diagonal set to the finite mask value."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        lq, lk = s.shape[-2:]
        row = torch.arange(lq, device=s.device)[:, None]
        col = torch.arange(lk, device=s.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, _NEG_INF))
    return s


def flash_fwd_reference(q, k, v, causal, sm_scale):
    """Plain version of `flash_fwd`."""
    s = _flash_scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_fwd(q, k, v, causal=False, sm_scale=None):
    """Attention of q (BH, Lq, D) over k, v (BH, Lk, D): ``softmax(q k^T *
    sm_scale) v`` (sm_scale defaults to 1/sqrt(D)), computed in f32 with an
    online softmax. Returns O (BH, Lq, D) in q's dtype and the f32
    logsumexp of each score row, lse (BH, Lq). CUDA: the ``flash_fwd``
    kernel of ``csrc/flash_attention.cu``; CPU: `flash_fwd_reference`."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, sm_scale)
    _flash_check("flash_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _flash_call("flash_fwd", q, k, (q, k, v, out, lse), sm_scale, causal)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _flash_grad_terms(q, k, v, dout, lse, delta, causal, sm_scale):
    """P recomputed from lse, and dS = P * (dO v^T - delta) * sm_scale, both
    f32 (BH, Lq, Lk)."""
    p = torch.exp(_flash_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, sm_scale):
    """Plain version of `flash_bwd_dq`."""
    _, ds = _flash_grad_terms(q, k, v, dout, lse, delta, causal, sm_scale)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=False, sm_scale=None):
    """dQ of flash attention: ``dS k`` with ``P = exp(q k^T * sm_scale -
    lse)`` and ``dS = P * (dout v^T - delta) * sm_scale``; ``lse`` is
    `flash_fwd`'s and ``delta`` = sum(dout * O) over D, both f32 (BH, Lq).
    Returns dQ (BH, Lq, D) in q's dtype. CUDA: the ``flash_bwd_dq`` kernel;
    CPU: `flash_bwd_dq_reference`."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      sm_scale)
    _flash_check("flash_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    _flash_call("flash_bwd_dq", q, k, (q, k, v, dout, lse, delta, dq),
                sm_scale, causal)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, sm_scale):
    """Plain version of `flash_bwd_dkv`."""
    p, ds = _flash_grad_terms(q, k, v, dout, lse, delta, causal, sm_scale)
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=False, sm_scale=None):
    """dK and dV of flash attention: ``dS^T q`` and ``P^T dout``, with P
    and dS as in `flash_bwd_dq`. Returns (dK, dV), each (BH, Lk, D) in k's
    dtype. CUDA: the ``flash_bwd_dkv`` kernel; CPU:
    `flash_bwd_dkv_reference`."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       sm_scale)
    _flash_check("flash_bwd_dkv", q, k, v, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _flash_call("flash_bwd_dkv", q, k, (q, k, v, dout, lse, delta, dk, dv),
                sm_scale, causal)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom_vjp around `_flash_fwd`: the forward saves
    q, k, v, O and lse; the backward takes delta = sum(dO * O) in f32 and
    runs `flash_bwd_dq`, then `flash_bwd_dkv`. The same Function on both
    devices: only the leaf wrappers choose kernel or plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent in the input dtype (the JAX package's g.astype),
        # dense: autograd may hand a strided view
        dout = g.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                          ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (..., L, D) tensors, leading dims batched:
    ``softmax(q k^T * sm_scale) v`` (sm_scale defaults to 1/sqrt(D)),
    causal keeping key col <= query row. Differentiable (the kernels'
    backward). The leading dims are flattened to BH as in the JAX package;
    a view that cannot be flattened in place (as the (B, H, L, D) split of
    attention heads) is copied. CUDA tensors go through the three kernels of
    ``csrc/flash_attention.cu`` (which raise on a non-contiguous input);
    CPU tensors through their plain versions."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    lead = q.shape[:-2]
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    out = _FlashAttention.apply(q.reshape(-1, lq, d), k.reshape(-1, lk, d),
                                v.reshape(-1, lk, d), bool(causal), sm_scale)
    return out.reshape(lead + (lq, d))


def flash_attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain attention over (..., L, D) (the JAX package's
    `_attention_reference`): f32 scores and softmax, the result in q's
    dtype. Differentiable by autograd; any device."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    lead = q.shape[:-2]
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    s = _flash_scores(q.reshape(-1, lq, d), k.reshape(-1, lk, d), causal,
                      sm_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.reshape(-1, lk, d).float())
    return o.to(q.dtype).reshape(lead + (lq, d))
