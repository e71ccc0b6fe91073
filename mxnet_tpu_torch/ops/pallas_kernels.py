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
  `epi_bwd_dx`; over a batch split between ranks the two reductions'
  raw mode and `epi_stats_finish` / `epi_bwd_finish` give the global
  batch's statistics;
* flash attention (:40-373): `flash_attention` (differentiable, over
  (..., L, D)) runs the three kernels of ``csrc/flash_attention.cu``
  through the wrappers `flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv`;
* the fused LSTM layer (:376-718): `lstm_layer` (differentiable) runs the
  three kernels of ``csrc/lstm.cu`` through the wrappers `lstm_infer`
  (no gradient taken), `lstm_fwd` and `lstm_bwd`; `lstm_layer_fits` is
  the card's resource check that routes a shape to them.

Every wrapper launches its hand-written CUDA kernel (sm_90a) for CUDA
tensors, and adds one to its ``launches`` count where it does; it runs its
plain PyTorch version (``*_reference``) only for tensors on the CPU.
Where it launches, a kernel that does products also reports its FLOPs to
`telemetry.flops` (`flash_flops`, `lstm_flops`, the paged formula): the
count `FlopCounterMode` gives its plain version, which on the CPU the
counter sees itself. The
conv-epilogue and LSTM wrappers, which the symbolic path's shape inference
reaches, run it for ``meta`` tensors too (shapes only: nothing is
launched or built). Nothing sends a CUDA tensor to a plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from ..telemetry import flops as _tm_flops
from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "conv_epilogue",
           "conv_epilogue_reference", "epi_stats", "epi_stats_reference",
           "epi_apply", "epi_apply_reference", "epi_bwd_reduce",
           "epi_bwd_reduce_reference", "epi_bwd_dx", "epi_bwd_dx_reference",
           "epi_stats_finish", "epi_stats_finish_reference", "epi_bwd_finish",
           "epi_bwd_finish_reference",
           "flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_fwd_reference", "flash_bwd_dq", "flash_bwd_dq_reference",
           "flash_bwd_dkv", "flash_bwd_dkv_reference", "lstm_layer",
           "lstm_layer_reference", "lstm_layer_fits", "lstm_infer",
           "lstm_infer_reference", "lstm_fwd", "lstm_fwd_reference",
           "lstm_bwd", "lstm_bwd_reference", "flash_flops", "lstm_flops"]

# finite mask value: a fully masked row stays NaN-free
_NEG_INF = -1e30

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _plain(t):
    """Whether a conv-epilogue or LSTM wrapper runs its plain version: for
    a CPU tensor, and for a meta tensor (shape inference)."""
    return t.device.type in ("cpu", "meta")


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
    each launch adds one to ``paged_attention.launches`` and reports
    ``4 * B * H * L * D`` FLOPs to `telemetry.flops` (L = max_pages x
    page_size, the count `FlopCounterMode` gives the plain version); a CPU
    tensor goes through `paged_attention_reference`.
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
    _tm_flops.kernel(4 * b * h * d * page_tables.shape[1] * k_pages.shape[2])
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

# csrc/conv_epilogue.cu's reduction layout constants (`epi_layout`)
_EPI_THREADS = 256
_EPI_CLUSTER_BYTES_PER_BLOCK = 400 * 1024
_EPI_CLUSTER_MIN_K = 8
_EPI_CLUSTER_TILE_PACKS = 8
_EPI_CLUSTER_MIN_TILES = 8
_EPI_FOLD_MAX_BYTES = 512
_EPI_CHUNK_ROWS = 128
_EPI_MAX_CHUNKS = 1024

_EPI_ARGTYPES = {
    "epi_stats": [_P, _I, _L, _I, _P, _P, _I, _F, _I, _P, _I] + [_P] * 5
                 + [_I],
    "epi_apply": [_P, _P, _I, _L, _I, _P, _P, _I, _P],
    "epi_bwd_reduce": [_P, _P, _P, _I, _L, _I, _P, _P, _P, _I, _I, _P, _I]
                      + [_P] * 5 + [_I],
    "epi_bwd_dx": [_P, _P, _P, _I, _L, _I] + [_P] * 7,
    "epi_stats_finish": [_P, _I, _L, _I, _P, _P, _I, _F, _I] + [_P] * 5,
    "epi_bwd_finish": [_P, _I, _L, _I, _P, _P],
}


def _epi_layout(r, c, itemsize, aligned=True):
    """csrc/conv_epilogue.cu's ``epi_layout``: how `epi_stats` and
    `epi_bwd_reduce` reduce (r, c) rows of ``itemsize``-byte elements whose
    row tensors are all 16-byte aligned (``aligned``) or not.

    ``v``: elements a load (16 bytes, or 1 on the scalar path); ``l``: the
    fold, (r // l, w = l * c) rows read instead, column j standing for
    channel j % c, the r % l tail rows added by the finishing thread; ``rf``
    the folded rows. A c of whole 16-byte packs is not folded; another c
    folds the fewest rows that make whole packs, when r has that many and
    the folded row is at most 512 bytes; else the scalar path. ``route``:
    "cluster" (one launch, clusters of K blocks over each of ``tiles``
    tiles of ``tx`` packs: 8, doubled up to 32 while at least 8 tiles are
    left; no workspace) when the tensor's bytes are at most 400 KiB for
    each of 8 blocks a tile, else "streamed" (two
    launches over ``part``, (2, n_chunks, c) floats; ``tx`` packs a tile,
    a power of two up to 32, or the whole folded row). ``ty``: rows in
    flight a block."""
    kv = 16 // itemsize
    v, l = 1, 1
    if aligned and c % kv == 0:
        v = kv
    elif aligned:
        l0 = 16 // math.gcd(c * itemsize % 16, 16)
        if l0 * c * itemsize <= _EPI_FOLD_MAX_BYTES and r >= l0:
            v, l = kv, l0
    w = l * c
    rf = r // l
    packs = w // v
    twc = packs    # the cluster route's tile
    if l == 1 and v == 1:
        twc = min(packs, 32)
    elif l == 1:
        twc = _EPI_CLUSTER_TILE_PACKS
        while twc < 32 and -(-packs // (2 * twc)) >= _EPI_CLUSTER_MIN_TILES:
            twc *= 2
        twc = min(twc, packs)
    tiles_c = -(-packs // twc)
    cluster = rf * w * itemsize <= (_EPI_CLUSTER_BYTES_PER_BLOCK
                                    * _EPI_CLUSTER_MIN_K * tiles_c)
    if cluster:
        tx = twc
    elif l > 1:
        tx = packs
    else:
        tx = 1
        while tx < packs and tx < 32:
            tx *= 2
    ty = 1
    while tx * ty * 2 <= _EPI_THREADS:
        ty *= 2
    lay = {"v": v, "l": l, "w": w, "rf": rf, "tx": tx, "ty": ty,
           "tiles": -(-packs // tx),
           "route": "cluster" if cluster else "streamed", "n_chunks": 0}
    if not cluster:
        lay["n_chunks"] = max(1, min(_EPI_MAX_CHUNKS,
                                     -(-rf // _EPI_CHUNK_ROWS)))
    return lay


def _epi_aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _epi_part(lay, dev):
    """The streamed route's workspace (2, n_chunks, c) floats and its chunk
    count, or (None, 0) on the cluster route."""
    if lay["route"] == "cluster":
        return None, 0
    part = torch.empty((2, lay["n_chunks"], lay["w"] // lay["l"]),
                       dtype=torch.float32, device=dev)
    return part, lay["n_chunks"]


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


def epi_stats_reference(x2d, gamma, beta, eps, fix_gamma, raw=False):
    """Plain version of `epi_stats`."""
    from .nn import _BN_PROXY_ROWS, _bn_stats

    if raw:
        xf = x2d.float()
        proxy = xf[:_BN_PROXY_ROWS].mean(dim=0)
        d = xf - proxy
        return torch.stack([proxy, d.sum(dim=0), d.square().sum(dim=0)])
    mean, var = _bn_stats(x2d)
    return _stats_vectors(mean, var, gamma, beta, eps, fix_gamma)


def _stats_vectors(mean, var, gamma, beta, eps, fix_gamma):
    inv = torch.rsqrt(var + eps)
    g1 = torch.ones_like(inv) if fix_gamma else gamma.float()
    scale = g1 * inv
    shift = beta.float() - mean * scale
    return mean, var, inv, scale, shift


def epi_stats(x2d, gamma, beta, eps=1e-3, fix_gamma=False, raw=False):
    """Batch statistics of rows ``x2d`` (R, C), float32 or bfloat16, and
    the normalize they give: f32 (C,) ``(mean, var, inv, scale, shift)``
    with the biased ``var = max(E[d^2] - E[d]^2, 0)`` of ``d = x - proxy``
    (the proxy: the mean of the first 8 rows), ``inv = 1/sqrt(var + eps)``,
    ``scale = gamma * inv`` (gamma taken as 1 under ``fix_gamma``) and
    ``shift = beta - mean * scale``. With ``raw``, the rank's sums that a
    batch split over ranks combines (`epi_stats_finish`): one f32 (3, C)
    tensor of ``(proxy, sum d, sum d^2)``. CUDA: ``epi_stats`` of
    ``csrc/conv_epilogue.cu`` on the route `_epi_layout` names (one
    cluster launch for small R, else two streamed passes; deterministic
    either way), counted in ``epi_stats.routes`` beside ``launches`` (and
    under "folded" when a narrow C is read as folded rows); CPU:
    `epi_stats_reference`."""
    if _plain(x2d):
        return epi_stats_reference(x2d, gamma, beta, eps, fix_gamma, raw)
    _epi_check("epi_stats", x2d, params=(("gamma", gamma), ("beta", beta)))
    r, c = x2d.shape
    lay = _epi_layout(r, c, x2d.element_size(), _epi_aligned(x2d))
    part, n = _epi_part(lay, x2d.device)
    vecs = torch.empty((3 if raw else 5, c), dtype=torch.float32,
                       device=x2d.device)
    outs = [v.data_ptr() for v in vecs] + [None] * (5 - len(vecs))
    _epi_call("epi_stats", x2d.device, x2d.data_ptr(),
              _EPI_DTYPES[x2d.dtype], r, c, gamma.data_ptr(),
              beta.data_ptr(), int(gamma.dtype == torch.bfloat16),
              float(eps), int(bool(fix_gamma)), _ptr(part), n, *outs,
              int(bool(raw)))
    epi_stats.launches += 1
    epi_stats.routes[lay["route"]] += 1
    if lay["l"] > 1:
        epi_stats.routes["folded"] += 1
    return vecs if raw else tuple(vecs)


epi_stats.launches = 0
epi_stats.routes = dict.fromkeys(("cluster", "streamed", "folded"), 0)


def _finish_check(name, parts, rows, n_vecs):
    if parts.device.type != "cuda" or parts.dtype != torch.float32 \
            or parts.dim() != 3 or parts.shape[1] != n_vecs \
            or not parts.is_contiguous() or rows < 1:
        raise MXNetError("%s: parts must be a contiguous float32 (k, %d, C) "
                         "CUDA tensor and rows >= 1, got %s %s on %s, rows "
                         "%d" % (name, n_vecs, parts.dtype,
                                 tuple(parts.shape), parts.device, rows))


def epi_stats_finish_reference(parts, rows, gamma, beta, eps, fix_gamma):
    """Plain version of `epi_stats_finish`."""
    k = parts.shape[0]
    total = float(rows * k)
    p0 = parts[0, 0]
    u = torch.zeros_like(p0)
    for r in range(k):
        u = u + (float(rows) * (parts[r, 0] - p0) + parts[r, 1])
    u = u / total
    q = torch.zeros_like(p0)
    for r in range(k):
        e = u - (parts[r, 0] - p0)
        q = q + (parts[r, 2] - 2.0 * e * parts[r, 1] + float(rows) * e * e)
    var = torch.clamp(q / total, min=0.0)
    return _stats_vectors(p0 + u, var, gamma, beta, eps, fix_gamma)


def epi_stats_finish(parts, rows, gamma, beta, eps=1e-3, fix_gamma=False):
    """`epi_stats`' five vectors over the rows of k ranks, from their raw
    sums gathered in rank order, ``parts`` f32 (k, 3, C), each rank
    holding ``rows`` rows: the proxies are combined exactly (rank 0's as
    the reference), the ranks added in rank order. CUDA: the
    ``epi_stats_finish`` kernel (a thread a channel); CPU:
    `epi_stats_finish_reference`."""
    if _plain(parts):
        return epi_stats_finish_reference(parts, rows, gamma, beta, eps,
                                          fix_gamma)
    _finish_check("epi_stats_finish", parts, rows, 3)
    k, _, c = parts.shape
    _epi_check("epi_stats_finish", parts[0], params=(("gamma", gamma),
                                                     ("beta", beta)))
    vecs = torch.empty((5, c), dtype=torch.float32, device=parts.device)
    _epi_call("epi_stats_finish", parts.device, parts.data_ptr(), k,
              int(rows), c, gamma.data_ptr(), beta.data_ptr(),
              int(gamma.dtype == torch.bfloat16), float(eps),
              int(bool(fix_gamma)), *(v.data_ptr() for v in vecs))
    epi_stats_finish.launches += 1
    return tuple(vecs)


epi_stats_finish.launches = 0


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
    if _plain(x2d):
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


def epi_bwd_reduce_reference(ct, x2d, out, mean, inv, gamma, fix_gamma,
                             raw=False):
    """Plain version of `epi_bwd_reduce`."""
    g = _masked_ct(ct, out)
    xhat = (x2d.float() - mean) * inv
    db = g.sum(dim=0)
    dg = (g * xhat).sum(dim=0)
    r = x2d.shape[0]
    g1 = torch.ones_like(inv) if fix_gamma else gamma.float()
    dgamma = torch.zeros_like(gamma) if fix_gamma else dg.to(gamma.dtype)
    if raw:
        return dgamma, db.to(gamma.dtype), g1 * inv, torch.stack([db, dg])
    return dgamma, db.to(gamma.dtype), g1 * inv, db / r, dg / r


def epi_bwd_reduce(ct, x2d, out, mean, inv, gamma, fix_gamma=False,
                   raw=False):
    """The backward's per-channel sums over rows (R, C): with ``g = ct``
    masked by ``out > 0`` (``out`` is the saved forward output when relu
    was on, else None) and ``xhat = (x - mean) * inv``, returns
    ``(dgamma, dbeta, coef, cb, cg)``: dgamma = sum(g * xhat) (zeros under
    ``fix_gamma``) and dbeta = sum(g) in gamma's dtype, and the f32 (C,)
    dx coefficients coef = gamma * inv, cb = sum(g) / R, cg =
    sum(g * xhat) / R. With ``raw`` (a batch split over ranks), ``(dgamma,
    dbeta, coef, sums)``: dgamma and dbeta the rank's own, and in place of
    cb and cg the rank's f32 (2, C) ``(sum g, sum g * xhat)`` that
    `epi_bwd_finish` combines. CUDA: ``epi_bwd_reduce`` on the route
    `_epi_layout` names, counted as `epi_stats` counts (deterministic);
    CPU: `epi_bwd_reduce_reference`."""
    if _plain(x2d):
        return epi_bwd_reduce_reference(ct, x2d, out, mean, inv, gamma,
                                        fix_gamma, raw)
    _epi_check("epi_bwd_reduce", x2d, rows=(("ct", ct), ("out", out)),
               vecs=(("mean", mean), ("inv", inv)),
               params=(("gamma", gamma),))
    r, c = x2d.shape
    lay = _epi_layout(r, c, x2d.element_size(), _epi_aligned(ct, x2d, out))
    part, n = _epi_part(lay, x2d.device)
    grads = torch.empty((2, c), dtype=gamma.dtype, device=x2d.device)
    vecs = torch.empty((3, c), dtype=torch.float32, device=x2d.device)
    _epi_call("epi_bwd_reduce", x2d.device, ct.data_ptr(), x2d.data_ptr(),
              _ptr(out), _EPI_DTYPES[x2d.dtype], r, c, mean.data_ptr(),
              inv.data_ptr(), gamma.data_ptr(),
              int(gamma.dtype == torch.bfloat16), int(bool(fix_gamma)),
              _ptr(part), n, grads[0].data_ptr(), grads[1].data_ptr(),
              *(v.data_ptr() for v in vecs), int(bool(raw)))
    epi_bwd_reduce.launches += 1
    epi_bwd_reduce.routes[lay["route"]] += 1
    if lay["l"] > 1:
        epi_bwd_reduce.routes["folded"] += 1
    if raw:
        return grads[0], grads[1], vecs[0], vecs[1:]
    return (grads[0], grads[1]) + tuple(vecs)


epi_bwd_reduce.launches = 0
epi_bwd_reduce.routes = dict.fromkeys(("cluster", "streamed", "folded"), 0)


def epi_bwd_finish_reference(parts, rows):
    """Plain version of `epi_bwd_finish`."""
    total = float(rows * parts.shape[0])
    s1, s2 = parts[0, 0], parts[0, 1]
    for r in range(1, parts.shape[0]):
        s1, s2 = s1 + parts[r, 0], s2 + parts[r, 1]
    return s1 / total, s2 / total


def epi_bwd_finish(parts, rows):
    """``(cb, cg)`` over the rows of k ranks, from their raw backward sums
    gathered in rank order, ``parts`` f32 (k, 2, C), each rank holding
    ``rows`` rows: the sums added in rank order over k rows. CUDA: the
    ``epi_bwd_finish`` kernel (a thread a channel); CPU:
    `epi_bwd_finish_reference`."""
    if _plain(parts):
        return epi_bwd_finish_reference(parts, rows)
    _finish_check("epi_bwd_finish", parts, rows, 2)
    k, _, c = parts.shape
    vecs = torch.empty((2, c), dtype=torch.float32, device=parts.device)
    _epi_call("epi_bwd_finish", parts.device, parts.data_ptr(), k, int(rows),
              c, vecs[0].data_ptr(), vecs[1].data_ptr())
    epi_bwd_finish.launches += 1
    return vecs[0], vecs[1]


epi_bwd_finish.launches = 0


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
    if _plain(x2d):
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


def _gathered(t, sync):
    """Every rank's ``t`` over the mesh axis ``sync``, stacked in rank
    order (one all-gather)."""
    from ..parallel import collectives

    return torch.stack(collectives._gather(t, sync))


class _ConvEpilogue(torch.autograd.Function):
    """The JAX package's custom_vjp pair `epi3` / `epi4`: forward through
    `epi_stats` + `epi_apply`, backward through `epi_bwd_reduce` +
    `epi_bwd_dx`. The mean / var outputs are not differentiable (their
    cotangents are ignored, as in the JAX package: they feed the moving
    statistics). ``out`` is saved only when relu is on (`_epi_save`).

    With ``sync`` (the mesh axis a batch is split over) the statistics and
    the dx coefficients are the global batch's: the two reductions write
    the rank's raw sums, one all-gather each brings every rank's, and
    `epi_stats_finish` / `epi_bwd_finish` finish them. dgamma and dbeta
    stay the rank's own: the trainer sums parameter gradients over the
    ranks itself."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, res2d, eps, fix_gamma, relu, sync):
        if sync is None:
            mean, var, inv, scale, shift = epi_stats(x2d, gamma, beta, eps,
                                                     fix_gamma)
        else:
            raw = epi_stats(x2d, gamma, beta, eps, fix_gamma, raw=True)
            mean, var, inv, scale, shift = epi_stats_finish(
                _gathered(raw, sync), x2d.shape[0], gamma, beta, eps,
                fix_gamma)
        out = epi_apply(x2d, res2d, scale, shift, relu)
        ctx.save_for_backward(x2d, gamma, mean, inv, out if relu else None)
        ctx.fix_gamma = fix_gamma
        ctx.has_res = res2d is not None
        ctx.sync = sync
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, ct, _ct_mean, _ct_var):
        x2d, gamma, mean, inv, out = ctx.saved_tensors
        # autograd may hand an expanded cotangent (stride 0 behind a global
        # average pool); the kernels take dense rows, so it is made dense
        # here, once, as the JAX package's cotangent is
        ct = ct.contiguous()
        if ctx.sync is None:
            dgamma, dbeta, coef, cb, cg = epi_bwd_reduce(
                ct, x2d, out, mean, inv, gamma, ctx.fix_gamma)
        else:
            dgamma, dbeta, coef, sums = epi_bwd_reduce(
                ct, x2d, out, mean, inv, gamma, ctx.fix_gamma, raw=True)
            cb, cg = epi_bwd_finish(_gathered(sums, ctx.sync), x2d.shape[0])
        dx, dres = epi_bwd_dx(ct, x2d, out, mean, inv, coef, cb, cg,
                              ctx.has_res)
        return dx, dgamma, dbeta, dres, None, None, None, None


def _epi_rows(x, c, label):
    if not _plain(x) and not x.is_contiguous():
        raise MXNetError("conv_epilogue: %s must be a contiguous "
                         "channels-last tensor (..., C); got strides %s"
                         % (label, tuple(x.stride())))
    return x.reshape(-1, c)


def conv_epilogue(x, gamma, beta, residual=None, eps=1e-3, fix_gamma=False,
                  relu=True, sync=None):
    """Fused training-mode BatchNorm (batch statistics) + normalize
    (+ residual add) (+ ReLU) over a channels-last activation ``x`` (..., C).

    Returns ``(out, mean, var)``: ``out`` in x's dtype and shape, the batch
    mean and biased variance f32 (C,) for the moving-statistics update.
    Differentiable in x, gamma, beta and residual (a kernel backward);
    mean and var are not differentiable. CUDA tensors go through the four
    kernels of ``csrc/conv_epilogue.cu``; CPU tensors through their plain
    versions. On the card x (and residual) must be contiguous: the (R, C)
    view is then free, and the wrapper raises rather than copy. ``sync``:
    None, or the mesh axis (`parallel.Mesh.axis`) whose ranks each hold R
    rows of the batch, whose statistics are then the global batch's
    (`_ConvEpilogue`)."""
    shape = x.shape
    c = shape[-1]
    x2d = _epi_rows(x, c, "x")
    res2d = None if residual is None else _epi_rows(residual, c, "residual")
    out, mean, var = _ConvEpilogue.apply(x2d, gamma, beta, res2d, float(eps),
                                         bool(fix_gamma), bool(relu), sync)
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


# FLOPs a flash kernel reports (`telemetry.flops.kernel`): what
# `FlopCounterMode` gives its plain version at the same shapes, in units
# of BH * Lq * Lk * D (two products forward; dQ recomputes the scores and
# dP then takes dS k; dK/dV recomputes both and takes dS^T q and P^T dO).
# A causal mask changes neither count.
_FLASH_FLOP_UNITS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def flash_flops(name, q, k):
    """FLOPs of one launch of flash kernel ``name`` on q (BH, Lq, D) and
    k (BH, Lk, D)."""
    bh, lq, d = q.shape
    return _FLASH_FLOP_UNITS[name] * bh * lq * k.shape[1] * d


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
    _tm_flops.kernel(flash_flops("flash_fwd", q, k))
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
    _tm_flops.kernel(flash_flops("flash_bwd_dq", q, k))
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
    _tm_flops.kernel(flash_flops("flash_bwd_dkv", q, k))
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
        ctx.flops_sink = _tm_flops.sink()
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent in the input dtype (the JAX package's g.astype),
        # dense: autograd may hand a strided view
        dout = g.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        with _tm_flops.reporting_to(ctx.flops_sink):
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                              ctx.sm_scale)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                   ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention over (..., L, D) tensors, leading dims batched:
    ``softmax(q k^T * sm_scale) v`` (sm_scale defaults to 1/sqrt(D)),
    causal keeping key col <= query row. Differentiable (the kernels'
    backward). The leading dims are flattened to BH as in the JAX package,
    and made contiguous: the (B, H, L, D) split of attention heads is
    copied, and at B = 1 its flattening is a strided view, which is copied
    too (fault F8). CUDA tensors go through the three kernels of
    ``csrc/flash_attention.cu`` (which raise on a non-contiguous input);
    CPU tensors through their plain versions."""
    sm_scale = float(1.0 / math.sqrt(q.shape[-1]) if sm_scale is None
                     else sm_scale)
    lead = q.shape[:-2]
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    out = _FlashAttention.apply(q.reshape(-1, lq, d).contiguous(),
                                k.reshape(-1, lk, d).contiguous(),
                                v.reshape(-1, lk, d).contiguous(),
                                bool(causal), sm_scale)
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


# ---------------------------------------------------------------------------
# Fused LSTM layer over a precomputed input projection gx (T, B, 4H), gate
# order i, f, g, o. Inference: lstm_infer (ys and cT, no residuals).
# Training: lstm_fwd (ys, the f32 c_t of every step and the post-activation
# gates) and lstm_bwd (the pre-activation gate gradients dgx, dh0, dc0);
# dW_hh is one matrix product outside the kernels, as in the JAX package.
# ---------------------------------------------------------------------------

_LSTM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LSTM_ARGTYPES = {"lstm_infer": [_P] * 7 + [_I] * 4,
                  "lstm_fwd": [_P] * 8 + [_I] * 4,
                  "lstm_bwd": [_P] * 10 + [_I] * 4}
# the card the resource check is made for (H100 SXM): SMs, the shared
# memory one block may take (227 KB), and the clusters of 8 blocks it holds
# at once at one block an SM (cudaOccupancyMaxActiveClusters); and
# csrc/lstm.cu's constants: its warps a block, the most K slices of a
# tensor-core product, the streamed kernels' chunk budget, and the
# backward's cluster size
_H100_SMS = 132
_SMEM_MAX_BYTES = 232448
_H100_CLUSTERS_OF_8 = 15
_LSTM_WARPS = 16
_LSTM_MAX_KSLICES = 8
_LSTM_CHUNK_BYTES = 64 * 1024
_LSTM_BWD_Q = 8


def _round_up(x, m):
    return -(-x // m) * m


def _lstm_chunk_cols(b, k, elem):
    kc = max(32, _LSTM_CHUNK_BYTES // (b * elem) // 32 * 32)
    return min(kc, k)


def _lstm_fwd_layout(b, h, u, elem):
    """csrc/lstm.cu's ``fwd_layout``: the forward kernel's shared memory
    for batch ``b``, hidden size ``h``, ``u`` units a block and ``elem``
    bytes an element. ``hp``: the pitch of the h exchange buffer ``hx``
    (H rounded up to 16 bytes); ``steps``: k16 steps of the product (H
    rounded up to 16); ``pitch``: of the staged h (``mpad`` rows) and of
    the block's gate rows of w_hh (``w_rows``), in elements; ``np``: 4U
    rounded up to 8, the pitch of the f32 partial products, one (mpad, np)
    slice for each of ``kslices`` K slices. bf16 takes the tensor cores
    (rows, gate rows and K padded to the m16n8k16 tiles, an odd count of
    16 bytes a row); f32 the FMA units, unpadded, one K slice. ``bytes``:
    the total, each region 16-byte aligned."""
    mma = elem == 2
    lay = {"hp": _round_up(h, 16 // elem), "steps": _round_up(h, 16) // 16}
    lay["pitch"] = lay["steps"] * 16 + 8 if mma else lay["hp"]
    lay["mpad"] = _round_up(b, 16) if mma else b
    lay["w_rows"] = _round_up(4 * u, 16) if mma else 4 * u
    lay["np"] = _round_up(4 * u, 8)
    lay["kslices"] = min(max(_LSTM_WARPS // (lay["mpad"] // 16), 1),
                         _LSTM_MAX_KSLICES, lay["steps"]) if mma else 1
    lay["bytes"] = (_round_up(4 * b * u, 16)
                    + _round_up(4 * lay["kslices"] * lay["mpad"] * lay["np"],
                                16)
                    + _round_up(elem * lay["w_rows"] * lay["pitch"], 16)
                    + _round_up(elem * lay["mpad"] * lay["pitch"], 16))
    return lay


def _lstm_bwd_layout(b, h, q, u, elem):
    """csrc/lstm.cu's ``bwd_layout``: the backward kernel's shared memory
    for batch ``b``, hidden size ``h``, clusters of ``q`` blocks, ``u``
    units a block and ``elem`` bytes an element. ``gp``: the pitch of an
    exchange row (4H rounded up to 16 bytes), ``nch`` its 16-byte chunks;
    block r of a cluster takes chunks [r nch / q, (r + 1) nch / q) of every
    row of dgx[t], at most ``kmax`` elements; ``steps``: k16 steps of the
    largest share; ``pitch``: of the staged
    share (``mpad`` rows) and of w_hh[share, the cluster's ``qu`` units]
    (``w_rows`` rows), in elements; ``np``: ``qu`` rounded up to 8, plus
    one (odd), the pitch of the f32 partial products, one (mpad, np) slice
    for each of ``kslices`` K slices (bf16: as many as give each of the 16
    warps one (m16 tile, pair of n8 tiles, K slice), at most 8; f32: one);
    ``up``: U rounded up to 4, the row pitch of the peers' partial sums.
    bf16 pads for the tensor cores as the forward does; f32 pads nothing.
    ``bytes``: the mbarrier (16), the peers' sums (q B up floats), the dc
    carry (B u floats), the partial products, w_hh's block and the share,
    each region 16-byte aligned."""
    mma = elem == 2
    lay = {"gp": _round_up(4 * h, 16 // elem)}
    lay["nch"] = lay["gp"] * elem // 16
    lay["kmax"] = -(-lay["nch"] // q) * (16 // elem)
    lay["steps"] = _round_up(lay["kmax"], 16) // 16
    lay["pitch"] = lay["steps"] * 16 + 8 if mma else lay["kmax"]
    lay["mpad"] = _round_up(b, 16) if mma else b
    lay["qu"] = q * u
    lay["up"] = _round_up(u, 4)
    lay["w_rows"] = _round_up(q * u, 16) if mma else q * u
    lay["np"] = _round_up(q * u, 8) + 1
    lay["npairs"] = (lay["np"] // 8 + 1) // 2
    lay["kslices"] = min(max(_LSTM_WARPS // (lay["mpad"] // 16
                                             * lay["npairs"]), 1),
                         _LSTM_MAX_KSLICES, lay["steps"]) if mma else 1
    lay["bytes"] = (16 + _round_up(4 * q * b * lay["up"], 16)
                    + _round_up(4 * b * u, 16)
                    + _round_up(4 * lay["kslices"] * lay["mpad"] * lay["np"],
                                16)
                    + _round_up(elem * lay["w_rows"] * lay["pitch"], 16)
                    + _round_up(elem * lay["mpad"] * lay["pitch"], 16))
    return lay


def _lstm_bwd_route(b, h, elem, clusters=_H100_CLUSTERS_OF_8,
                    q=_LSTM_BWD_Q, sms=_H100_SMS):
    """The backward kernel the card runs for (b, h): ``("clusters", U,
    layout bytes)`` where `_lstm_bwd_layout` fits a block (clusters of
    ``q``, U = ceil(H / (clusters q)) units a block), else ``("streamed",
    U, bytes)``: csrc/lstm.cu's ``bwd_streamed_smem`` with U = ceil(H /
    SMs), the f32 dh and dc carries (2 B U floats), U columns of w_hh over
    4H and one streamed chunk of dgx, in the dtype."""
    u = -(-h // (clusters * q))
    fused = _lstm_bwd_layout(b, h, q, u, elem)["bytes"]
    if fused <= _SMEM_MAX_BYTES:
        return "clusters", u, fused
    u = -(-h // sms)
    return "streamed", u, 4 * 2 * b * u + elem * (
        4 * u * h + b * _lstm_chunk_cols(b, 4 * h, elem))


def _lstm_smem(b, h, elem, sms=_H100_SMS):
    """Shared memory of one block of the forward and of the backward
    kernel. The forward, with U = ceil(H / SMs) units a block, is
    `_lstm_fwd_layout` (c carry, partial products, w_hh's 4U gate rows and
    all of h_{t-1}) where that fits a block, else the streamed forward's
    (csrc/lstm.cu's ``fwd_streamed_smem``: f32 products and carries, 5 B U
    floats, the 4U H slice of w_hh and one streamed chunk of h); the
    backward is the route `_lstm_bwd_route` takes."""
    u = -(-h // sms)
    fwd = _lstm_fwd_layout(b, h, u, elem)["bytes"]
    if fwd > _SMEM_MAX_BYTES:
        fwd = 4 * 5 * b * u + elem * (4 * u * h
                                      + b * _lstm_chunk_cols(b, h, elem))
    return fwd, _lstm_bwd_route(b, h, elem, sms=sms)[2]


def lstm_layer_fits(b, h, dtype):
    """Whether the LSTM kernels take batch ``b``, hidden size ``h`` and
    ``dtype`` on the card: f32 or bf16, and one block's shared memory (its
    slice of w_hh plus its working set, at one block an SM of an H100) within
    227 KB, so the grid is co-resident. Decided from the shape alone, where
    the JAX package checks its VMEM budget (`ops/rnn.py:_run_layer`); a
    shape that does not fit takes the step loop."""
    if dtype not in _LSTM_DTYPES:
        return False
    elem = torch.empty((), dtype=dtype).element_size()
    return max(_lstm_smem(int(b), int(h), elem)) <= _SMEM_MAX_BYTES


def _lstm_check(name, t3, wh, same, f32=lambda t, b, h: ()):
    """Arguments of an LSTM kernel wrapper: ``t3`` (T, B, *) float32 or
    bfloat16 with T, B >= 1 on a CUDA device; ``wh`` (4H, H) with H >= 1;
    then, for (T, B, H), each (label, tensor, shape) of ``same(T, B, H)`` in
    t3's dtype and of ``f32(T, B, H)`` in float32, all contiguous on t3's
    device. Raises `MXNetError`; nothing is copied or converted. Returns
    (T, B, H)."""
    if t3.device.type != "cuda":
        raise MXNetError("%s: unsupported device %s" % (name, t3.device))
    if t3.dim() != 3 or t3.dtype not in _LSTM_DTYPES:
        raise MXNetError("%s: expected a float32 or bfloat16 (T, B, *) "
                         "tensor, got %s %s" % (name, t3.dtype,
                                                tuple(t3.shape)))
    h = wh.shape[-1] if wh.dim() == 2 else 0
    if h < 1 or tuple(wh.shape) != (4 * h, h) or t3.shape[0] < 1 \
            or t3.shape[1] < 1:
        raise MXNetError("%s: wh must be (4H, H) with H >= 1 and T, B >= 1; "
                         "got wh %s and %s" % (name, tuple(wh.shape),
                                               tuple(t3.shape)))
    t, b = t3.shape[:2]
    checks = [(label, x, shape, t3.dtype)
              for label, x, shape in [("wh", wh, wh.shape)] + list(
                  same(t, b, h))]
    checks += [(label, x, shape, torch.float32)
               for label, x, shape in f32(t, b, h)]
    for label, x, shape, dt in checks:
        if x.device != t3.device:
            raise MXNetError("%s: %s is on %s, not %s"
                             % (name, label, x.device, t3.device))
        if tuple(x.shape) != tuple(shape) or x.dtype != dt:
            raise MXNetError("%s: %s must be %s %s, got %s %s"
                             % (name, label, dt, tuple(shape), x.dtype,
                                tuple(x.shape)))
        if not x.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (name, label))
    return t, b, h


def _lstm_fwd_args(name, gx, wh, h0, c0):
    return _lstm_check(name, gx, wh, lambda t, b, h: [
        ("gx", gx, (t, b, 4 * h)), ("h0", h0, (b, h)), ("c0", c0, (b, h))])


def lstm_flops(t, b, h):
    """FLOPs of one launch of any LSTM kernel at (T, B, H): the
    recurrent product, (B, H) by (H, 4H) (backward: (B, 4H) by (4H, H)) a
    step, as `FlopCounterMode` counts the plain versions. The gate math is
    elementwise and counted by neither."""
    return 8 * t * b * h * h


def _lstm_forward_reference(gx, wh, h0, c0, save):
    """The step loop both forward kernels run, in torch: the product takes
    h in the dtype with f32 sums, the carries are f32, ys (and the gates)
    are rounded to the dtype, c_t stays f32. Differentiable by autograd."""
    nt, _, g4 = gx.shape
    h_units, dt = g4 // 4, gx.dtype
    w_t = wh.float().t()
    h, c = h0, c0.float()
    ys, cs, gates = [], [], []
    for t in range(nt):
        g = gx[t].float() + torch.matmul(h.float(), w_t)
        i, f, gg, o = g.split(h_units, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), \
            torch.sigmoid(o)
        c = f * c + i * gg
        h = (o * torch.tanh(c)).to(dt)
        ys.append(h)
        if save:
            cs.append(c)
            gates.append(torch.cat([i, f, gg, o], dim=-1).to(dt))
    ys = torch.stack(ys)
    if save:
        return ys, torch.stack(cs), torch.stack(gates)
    return ys, c.to(dt)


def lstm_infer_reference(gx, wh, h0, c0):
    """Plain version of `lstm_infer`."""
    return _lstm_forward_reference(gx, wh, h0, c0, save=False)


def _lstm_hx(h0):
    """Scratch for the forward kernels' h exchange: (2, B, HP) in h0's
    dtype, HP = H rounded up to 16 bytes. The kernel fills it (h0 and the
    zero padding) before its first step."""
    b, h = h0.shape
    return torch.empty((2, b, _round_up(h, 16 // h0.element_size())),
                       dtype=h0.dtype, device=h0.device)


def lstm_infer(gx, wh, h0, c0):
    """The LSTM recurrence without training residuals: gx (T, B, 4H) the
    input projection with both biases, wh (4H, H), h0 and c0 (B, H), all
    float32 or all bfloat16. Returns ys (T, B, H) and cT (B, H) in the
    dtype. CUDA: the ``lstm_infer`` kernel of ``csrc/lstm.cu``; CPU:
    `lstm_infer_reference`."""
    if _plain(gx):
        return lstm_infer_reference(gx, wh, h0, c0)
    t, b, h = _lstm_fwd_args("lstm_infer", gx, wh, h0, c0)
    ys = torch.empty((t, b, h), dtype=gx.dtype, device=gx.device)
    ct = torch.empty((b, h), dtype=gx.dtype, device=gx.device)
    hx = _lstm_hx(h0)
    _call("lstm", _LSTM_ARGTYPES, "lstm_infer", gx.device, gx.data_ptr(),
          wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), hx.data_ptr(),
          ys.data_ptr(), ct.data_ptr(), _LSTM_DTYPES[gx.dtype], t, b, h)
    lstm_infer.launches += 1
    _tm_flops.kernel(lstm_flops(t, b, h))
    return ys, ct


lstm_infer.launches = 0


def lstm_fwd_reference(gx, wh, h0, c0):
    """Plain version of `lstm_fwd`."""
    return _lstm_forward_reference(gx, wh, h0, c0, save=True)


def lstm_fwd(gx, wh, h0, c0):
    """The LSTM recurrence for training: as `lstm_infer`, but returns ys
    (T, B, H) in the dtype, c_all (T, B, H) f32 (c_t of every step; cT is
    ``c_all[-1]``) and the post-activation gates (T, B, 4H), i, f, g, o, in
    the dtype. CUDA: the ``lstm_fwd`` kernel; CPU: `lstm_fwd_reference`."""
    if _plain(gx):
        return lstm_fwd_reference(gx, wh, h0, c0)
    t, b, h = _lstm_fwd_args("lstm_fwd", gx, wh, h0, c0)
    ys = torch.empty((t, b, h), dtype=gx.dtype, device=gx.device)
    c_all = torch.empty((t, b, h), dtype=torch.float32, device=gx.device)
    gates = torch.empty_like(gx)
    hx = _lstm_hx(h0)
    _call("lstm", _LSTM_ARGTYPES, "lstm_fwd", gx.device, gx.data_ptr(),
          wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), hx.data_ptr(),
          ys.data_ptr(), c_all.data_ptr(), gates.data_ptr(),
          _LSTM_DTYPES[gx.dtype], t, b, h)
    lstm_fwd.launches += 1
    _tm_flops.kernel(lstm_flops(t, b, h))
    return ys, c_all, gates


lstm_fwd.launches = 0


def lstm_bwd_reference(dy, gates, c_all, c0, dct, wh):
    """Plain version of `lstm_bwd`."""
    nt, _, h_units = dy.shape
    dt = dy.dtype
    w = wh.float()
    dh = torch.zeros_like(c_all[0])
    dc = dct.float()
    dgx = torch.empty_like(gates)
    for t in range(nt - 1, -1, -1):
        i, f, gg, o = gates[t].float().split(h_units, dim=-1)
        c_prev = c_all[t - 1] if t > 0 else c0.float()
        dh = dy[t].float() + dh
        tc = torch.tanh(c_all[t])
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        dgx[t] = torch.cat([(dc * gg) * i * (1.0 - i),
                            (dc * c_prev) * f * (1.0 - f),
                            (dc * i) * (1.0 - gg * gg),
                            do * o * (1.0 - o)], dim=-1).to(dt)
        dh = torch.matmul(dgx[t].float(), w)
        dc = dc * f
    return dgx, dh.to(dt), dc.to(dt)


def _lstm_xb(dy):
    """Scratch for the backward kernel's exchange of dgx rows where a row
    of 4H is not a whole number of 16 bytes (bfloat16 with odd H): (2, B,
    GP) in dy's dtype, GP = 4H rounded up to 16 bytes; else None. The
    kernel zeroes its padding before the first step."""
    _, b, h = dy.shape
    gp = _round_up(4 * h, 16 // dy.element_size())
    return None if gp == 4 * h else torch.empty(
        (2, b, gp), dtype=dy.dtype, device=dy.device)


def lstm_bwd(dy, gates, c_all, c0, dct, wh):
    """The reverse recurrence: from dy (T, B, H) and dcT (B, H), both in
    the dtype, the forward's gates and c_all, c0 and wh, returns the
    pre-activation gate gradients dgx (T, B, 4H) and dh0, dc0 (B, H), all in
    the dtype. dy carries the cotangent of hT in its last step. CUDA: the
    ``lstm_bwd`` kernel; CPU: `lstm_bwd_reference`."""
    if _plain(dy):
        return lstm_bwd_reference(dy, gates, c_all, c0, dct, wh)
    t, b, h = _lstm_check(
        "lstm_bwd", dy, wh,
        lambda t, b, h: [("dy", dy, (t, b, h)),
                         ("gates", gates, (t, b, 4 * h)),
                         ("c0", c0, (b, h)), ("dcT", dct, (b, h))],
        f32=lambda t, b, h: [("c_all", c_all, (t, b, h))])
    dgx = torch.empty_like(gates)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    xb = _lstm_xb(dy)
    _call("lstm", _LSTM_ARGTYPES, "lstm_bwd", dy.device, dy.data_ptr(),
          gates.data_ptr(), c_all.data_ptr(), c0.data_ptr(), dct.data_ptr(),
          wh.data_ptr(), dgx.data_ptr(), None if xb is None else
          xb.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
          _LSTM_DTYPES[dy.dtype], t, b, h)
    lstm_bwd.launches += 1
    _tm_flops.kernel(lstm_flops(t, b, h))
    return dgx, dh0, dc0


lstm_bwd.launches = 0


class _LSTMLayer(torch.autograd.Function):
    """The JAX package's custom_vjp of `lstm_layer` under differentiation:
    the forward runs `lstm_fwd` and saves its residuals; the backward casts
    the cotangents of ys and cT to the dtype, runs `lstm_bwd`, and forms
    dW_hh = dgx^T . h_prev (h_prev = [h0, ys[:-1]]) as one matrix product
    in the dtype (f32 sums), as the JAX package did outside its kernel. The
    same Function on both devices: only the leaf wrappers choose kernel or
    plain version."""

    @staticmethod
    def forward(ctx, gx, wh, h0, c0):
        ys, c_all, gates = lstm_fwd(gx, wh, h0, c0)
        ctx.save_for_backward(wh, gates, c_all, h0, c0, ys)
        ctx.flops_sink = _tm_flops.sink()
        return ys, c_all[-1].to(gx.dtype, copy=True)

    @staticmethod
    def backward(ctx, dys, dct):
        wh, gates, c_all, h0, c0, ys = ctx.saved_tensors
        dt = ys.dtype
        with _tm_flops.reporting_to(ctx.flops_sink):
            dgx, dh0, dc0 = lstm_bwd(dys.to(dt).contiguous(), gates, c_all,
                                     c0, dct.to(dt).contiguous(), wh)
        h_units = ys.shape[-1]
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0).reshape(-1, h_units)
        dwh = torch.matmul(dgx.reshape(-1, 4 * h_units).t(), h_prev)
        return dgx, dwh.to(wh.dtype), dh0, dc0


def lstm_layer(gx, wh, h0, c0):
    """One LSTM layer over a precomputed input projection (the JAX
    package's `lstm_layer`): gx (T, B, 4H) = x . w_ih^T + b_ih + b_hh, gate
    order i, f, g, o; wh (4H, H); h0, c0 (B, H), cast to gx's dtype. Returns
    (ys (T, B, H), hT = ys[-1], cT (B, H)), all in gx's dtype.

    When a gradient is being taken (grad mode on and an input requiring
    one) it runs `lstm_fwd` and, in the backward, `lstm_bwd`; otherwise the
    residual-free `lstm_infer`, as the JAX primal does. CUDA tensors go
    through the kernels of ``csrc/lstm.cu`` (f32 or bf16, contiguous; the
    caller routes by `lstm_layer_fits`), CPU tensors through their plain
    versions."""
    h0 = h0.to(gx.dtype)
    c0 = c0.to(gx.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (gx, wh, h0, c0)):
        ys, ct = _LSTMLayer.apply(gx, wh, h0, c0)
    else:
        ys, ct = lstm_infer(gx, wh, h0, c0)
    return ys, ys[-1], ct


def lstm_layer_reference(gx, wh, h0, c0):
    """Plain version of `lstm_layer`: the step loop in torch, differentiated
    by autograd. Any device."""
    h0 = h0.to(gx.dtype)
    ys, c_all, _ = lstm_fwd_reference(gx, wh, h0, c0.to(gx.dtype))
    return ys, ys[-1], c_all[-1].to(gx.dtype)
