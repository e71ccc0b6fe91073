"""The two routes of the conv epilogue's reductions (`epi_stats`,
`epi_bwd_reduce` in csrc/conv_epilogue.cu), rehearsed on the CPU.

A numpy model follows each route's summation order, in float32, one add at
a time where the kernel adds:

* the fold: a C that does not fill whole 16-byte packs is read as
  (R // L, L * C) rows, column j standing for channel j % C; a block adds
  its channel's L columns in order, and the finishing thread adds the
  R % L tail rows in row order;
* in a block, thread t sums rows r0 + t, r0 + t + ty, ... in order, and the
  block's ty partial sums are added in a tree (halving) in shared memory;
* the streamed route: chunks of folded rows, one block's sums a chunk,
  then 32 lanes over the chunks (lane q takes chunks q, q + 32, ...) added
  in lane order;
* the cluster route: K contiguous row shares, one block each, added in
  rank order.

The model runs against the JAX package's `conv_epilogue` in interpret mode
(MXTPU_PALLAS_CONV_EPILOGUE=1) at shapes that hit each case: R < 8, R % L
!= 0, C = 3, C = 448 with few rows, and a shape the layout streams; and
`_epi_layout` (the wrapper's mirror of the kernel's layout) is checked at
the shapes `chip_smoke.py` runs, so each is known to take its route.
Tolerance: 1e-4 for f32 inputs, 2^-7 for bf16 inputs (one bf16 rounding is
2^-8; the two sides round the same terms in other orders), relative with a
floor of the tolerance x the largest magnitude.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.ops import pallas_kernels as tpk

import chip_smoke

EPS = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
F32 = np.float32


def _close(got, want, tol, what):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    floor = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=floor,
                               err_msg=what)


def _block_sums(terms, ty):
    """One block's column sums of ``terms`` (rows, W): thread t adds rows
    t, t + ty, ... in order, then the ty partial sums in a halving tree."""
    rows, w = terms.shape
    iters = -(-rows // ty)
    pad = np.zeros((iters * ty, w), F32)
    pad[:rows] = terms
    part = np.zeros((ty, w), F32)
    for i in range(iters):
        part += pad[i * ty:(i + 1) * ty]
    s = ty // 2
    while s:
        part[:s] += part[s:2 * s]
        s //= 2
    return part[0]


def _fold(col, l, c):
    """A block's channel sums from its column sums: columns c, C + c, ...
    added in order."""
    out = np.zeros(c, F32)
    for j in range(l):
        out += col[j * c:(j + 1) * c]
    return out


def _rows_in_flight(lay, route):
    """A block's ty on ``route`` (the layout's own, or what the other
    route's tile rule gives: the streamed route's tiles are a power of two
    up to 32 packs, or the folded row)."""
    if route == lay["route"]:
        return lay["ty"]
    packs = lay["w"] // lay["v"]
    if route == "cluster" or lay["l"] > 1:
        tx = min(packs, 8 if lay["v"] > 1 else 32) if lay["l"] == 1 \
            else packs
    else:
        tx = 1
        while tx < packs and tx < 32:
            tx *= 2
    ty = 1
    while tx * ty * 2 <= 256:
        ty *= 2
    return ty


def _route_sums(terms, lay, c, route, k):
    """The two channel sums over the folded rows, in the route's order.
    ``terms``: a pair of (rf, w) float32 arrays."""
    rf, l = lay["rf"], lay["l"]
    ty = _rows_in_flight(lay, route)
    out = []
    for t in terms:
        if route == "cluster":
            share = -(-rf // k)
            total = np.zeros(c, F32)
            for q in range(k):
                rows = t[min(q * share, rf):min((q + 1) * share, rf)]
                total += _fold(_block_sums(rows, ty), l, c)
        else:
            n = max(1, min(1024, -(-rf // 128)))
            per = -(-rf // n)
            chunks = [_fold(_block_sums(t[i * per:min((i + 1) * per, rf)],
                                        ty), l, c) for i in range(n)]
            lanes = np.zeros((32, c), F32)
            for i, s in enumerate(chunks):
                lanes[i % 32] += s
            total = np.zeros(c, F32)
            for q in range(32):
                total += lanes[q]
        out.append(total)
    return out


def _proxy(x):
    n = min(x.shape[0], 8)
    s = np.zeros(x.shape[1], F32)
    for i in range(n):
        s += x[i]
    return s / F32(n)


def model_stats(x, lay, route, k=8):
    """mean, var of rows ``x`` (R, C) float32, as the kernel sums them."""
    r, c = x.shape
    p = _proxy(x)
    main = lay["rf"] * lay["l"]
    d = (x[:main] - p).reshape(lay["rf"], lay["l"] * c)
    s1, s2 = _route_sums((d, d * d), lay, c, route, k)
    for i in range(main, r):   # the tail, in row order
        di = x[i] - p
        s1 += di
        s2 += di * di
    s1 /= F32(r)
    s2 /= F32(r)
    return p + s1, np.maximum(s2 - s1 * s1, F32(0))


def model_bwd(ct, x, out, mean, inv, lay, route, k=8):
    """dbeta = sum(g), dgamma = sum(g * xhat), g = ct masked by out > 0."""
    r, c = x.shape
    g = ct if out is None else np.where(out > 0, ct, F32(0)).astype(F32)
    gx = g * ((x - mean) * inv)
    main = lay["rf"] * lay["l"]
    w = lay["l"] * c
    s1, s2 = _route_sums((g[:main].reshape(-1, w), gx[:main].reshape(-1, w)),
                         lay, c, route, k)
    for i in range(main, r):
        s1 += g[i]
        s2 += gx[i]
    return s1, s2


def _jax_reference(x, gamma, beta, ct, dtype, relu):
    """The JAX package's conv_epilogue (Pallas, interpret mode): mean, var,
    out, and the gradients of sum(out * ct) in gamma and beta."""
    jdt = jnp.dtype(dtype)
    cta = jnp.asarray(ct, jdt).astype(jnp.float32)

    def f(xa, g, b):
        out, mean, var = jpk.conv_epilogue(xa, g, b, None, eps=EPS,
                                           fix_gamma=False, relu=relu)
        return jnp.sum(out.astype(jnp.float32) * cta), (out, mean, var)

    (_, (out, mean, var)), (dgamma, dbeta) = jax.value_and_grad(
        f, argnums=(1, 2), has_aux=True)(jnp.asarray(x, jdt),
                                          jnp.asarray(gamma),
                                          jnp.asarray(beta))
    return (np.asarray(mean), np.asarray(var),
            np.asarray(out.astype(jnp.float32)), np.asarray(dgamma),
            np.asarray(dbeta))


def _inputs(r, c, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(r, c) * 2.0 + 3.0).astype(F32)
    ct = rng.randn(r, c).astype(F32)
    if dtype == "bfloat16":   # the same bf16 values on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), F32)
        ct = np.asarray(jnp.asarray(ct, jnp.bfloat16), F32)
    gamma = (rng.rand(c) + 0.5).astype(F32)
    beta = rng.randn(c).astype(F32)
    return x, ct, gamma, beta


# (R, C, dtype): R < 8 (no fold), R % L != 0 with C = 3 and C = 5 (folded
# in 8 rows in bf16, 4 in f32), C = 448 over a few rows, and (26000, 64)
# bf16, which the layout streams
_CASES = [(5, 3, "bfloat16"), (1003, 3, "bfloat16"), (1003, 3, "float32"),
          (777, 5, "bfloat16"), (40, 448, "bfloat16"), (40, 448, "float32"),
          (26000, 64, "bfloat16")]


@pytest.mark.parametrize("r,c,dtype", _CASES)
def test_route_models_match_jax(monkeypatch, r, c, dtype):
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    x, ct, gamma, beta = _inputs(r, c, dtype, seed=r + c)
    tol = TOL[dtype]
    lay = tpk._epi_layout(r, c, 2 if dtype == "bfloat16" else 4)
    if r < 8:
        assert lay["l"] == 1
    elif c in (3, 5):
        assert lay["l"] == (8 if dtype == "bfloat16" else 4)
        assert r % lay["l"]   # a tail
    assert lay["route"] == ("streamed" if r == 26000 else "cluster")
    jmean, jvar, jout, jdgamma, jdbeta = _jax_reference(x, gamma, beta, ct,
                                                        dtype, relu=True)
    routes = [("streamed", 1), ("cluster", 8), ("cluster", 16)]
    for route, k in routes:
        what = "%s K=%d (%d, %d) %s" % (route, k, r, c, dtype)
        mean, var = model_stats(x, lay, route, k)
        _close(mean, jmean, tol, what + " mean")
        _close(var, jvar, tol, what + " var")
        inv = (F32(1) / np.sqrt(var + F32(EPS))).astype(F32)
        db, dg = model_bwd(ct, x, jout, mean, inv, lay, route, k)
        _close(db, jdbeta, tol, what + " dbeta")
        _close(dg, jdgamma, tol, what + " dgamma")


def test_streamed_model_is_the_plain_sum_order_free_of_the_fold():
    """The fold, the tail and the chunk lanes change only the order: the
    model of either route agrees with a float64 sum to f32 rounding."""
    x, ct, _, _ = _inputs(1003, 3, "float32", seed=7)
    lay = tpk._epi_layout(1003, 3, 4)
    for route in ("streamed", "cluster"):
        mean, var = model_stats(x, lay, route, 16)
        _close(mean, x.astype(np.float64).mean(0), 1e-6, route + " mean")
        _close(var, x.astype(np.float64).var(0), 1e-5, route + " var")


@pytest.mark.parametrize("label,r,c", chip_smoke.EPI_SHAPES)
def test_layout_at_the_smoke_shapes(label, r, c):
    """The route each of the smoke's shapes takes, in both dtypes: the
    cluster route at the small-R shapes (ResNet-50's stage 4 and
    Inception's 8 x 8 maps), the streamed route at the others (Inception's
    17 x 17 maps among them), and the fold at C = 3."""
    cluster = {"stage4-out", "inception-narrowest", "odd", "stage4-mid"}
    for itemsize in (2, 4):
        lay = tpk._epi_layout(r, c, itemsize)
        assert lay["route"] == ("cluster" if label in cluster
                                else "streamed"), (label, itemsize, lay)
        assert (lay["l"] > 1) == (c == 3), (label, lay)
        if lay["route"] == "streamed":
            assert 1 <= lay["n_chunks"] <= 1024
        assert lay["tx"] * lay["ty"] <= 256 and lay["ty"] & (lay["ty"] - 1) \
            == 0


def test_layout_picks_the_routes_the_acceptance_names():
    for r, c in ((8192, 448), (6272, 2048)):
        for itemsize in (2, 4):
            assert tpk._epi_layout(r, c, itemsize)["route"] == "cluster"
    for r, c in ((401408, 256), (2765952, 64)):
        for itemsize in (2, 4):
            assert tpk._epi_layout(r, c, itemsize)["route"] == "streamed"
    lay = tpk._epi_layout(6422528, 3, 2)
    assert (lay["l"], lay["w"], lay["route"]) == (8, 24, "streamed")
    # a tensor that is not 16-byte aligned takes the scalar path unfolded
    lay = tpk._epi_layout(1003, 3, 2, aligned=False)
    assert (lay["v"], lay["l"]) == (1, 1)
