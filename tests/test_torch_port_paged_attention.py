"""Paged decode attention of the PyTorch port against the JAX package.

CPU: the port's plain version (`paged_attention_reference`, which the
wrapper runs for CPU tensors) is held against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs, with the ragged and
zero-length rows of tests/test_generate.py. The CUDA kernel against the
plain version on the card is in tests/test_torch_port_cuda.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_kernels as jpk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pallas_kernels as tpk


def _inputs(seed, b, h, d, pages, ps, maxp, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    kp = rng.randn(pages, h, ps, d).astype(np.float32)
    vp = rng.randn(pages, h, ps, d).astype(np.float32)
    tbl = rng.randint(0, pages, (b, maxp)).astype(np.int32)
    return q, kp, vp, tbl, np.asarray(lens, np.int32)


# ---------------------------------------------------------------------------
# CPU: the port's plain version vs the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 4e-2)])
def test_paged_reference_matches_jax_kernel(monkeypatch, dtype, tol):
    b, h, d, pages, ps, maxp = 4, 2, 32, 16, 4, 5
    # a full row, a page-straddling row, a 1-token row and an inert row
    q, kp, vp, tbl, lens = _inputs(7, b, h, d, pages, ps, maxp,
                                   [maxp * ps, 7, 1, 0])
    monkeypatch.setenv("MXTPU_PALLAS_DECODE", "1")   # the Pallas kernel
    ref = jpk.paged_attention(jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
                              jnp.asarray(vp, dtype), jnp.asarray(tbl),
                              jnp.asarray(lens))
    tdt = getattr(torch, dtype)
    # q rounded to the page dtype, as the JAX side sees it, kept in f32
    tq = torch.from_numpy(q).to(tdt).float()
    out = tpk.paged_attention(tq, torch.from_numpy(kp).to(tdt),
                              torch.from_numpy(vp).to(tdt),
                              torch.from_numpy(tbl), torch.from_numpy(lens))
    assert out.dtype == torch.float32 and out.shape == (b, h, d)
    err = np.max(np.abs(np.asarray(ref, np.float32)[:3] - out[:3].numpy()))
    assert err < tol, err
    assert torch.isfinite(out).all()
    assert torch.equal(out[3], torch.zeros(h, d))   # inert row: zeros


def test_paged_reference_matches_jax_reference_wide():
    """Main-path geometry (H=12, Dh=64, page 16) at a small pool, against
    the JAX package's dense-gather reference."""
    b, h, d, pages, ps, maxp = 3, 12, 64, 20, 16, 6
    q, kp, vp, tbl, lens = _inputs(11, b, h, d, pages, ps, maxp,
                                   [96, 33, 16])
    ref = jpk.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), 1.0 / np.sqrt(d))
    out = tpk.paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.from_numpy(lens), 1.0 / np.sqrt(d))
    assert np.max(np.abs(np.asarray(ref) - out.numpy())) < 2e-6


_LOG2E = 1.4426950408889634
_CHUNK = 16
# (B, H, pool pages, page size, pages a sequence) of the rehearsal: pages
# of 6 tokens straddle the 16-token chunks
_REHEARSAL = (6, 2, 24, 6, 9)


def _split_rehearsal(q, kp, vp, tbl, lens, scale, splits):
    """The CUDA kernel's algorithm, in f32 on the CPU: a (b, h)'s live pages
    cut into ``splits`` shares of ceil(pages / splits); each share walked in
    chunks of 16 tokens with one base-2 online-softmax state (one max and
    one rescale a chunk, masked tokens at -1e30); the shares' (m, l, acc)
    merged in split order with weights exp2(m_s - max m). A row with
    length <= 0 gives zeros."""
    b, h, d = q.shape
    ps = kp.shape[2]
    maxp = tbl.shape[1]
    qs = q.float() * (scale * _LOG2E)
    out = torch.zeros(b, h, d)
    for bi in range(b):
        length = int(lens[bi])
        if length <= 0:
            continue
        end = min(length, maxp * ps)
        n_pages = -(-end // ps)
        per = -(-n_pages // splits)
        states = []
        for sp in range(splits):
            p0 = min(sp * per, n_pages)
            p1 = min(p0 + per, n_pages)
            t0, t1 = p0 * ps, min(p1 * ps, end)
            m = torch.full((h, 1), -1e30)
            l = torch.zeros(h, 1)
            acc = torch.zeros(h, d)
            for c0 in range(t0, t1, _CHUNK):
                toks = np.arange(c0, c0 + _CHUNK)
                live = toks < t1
                pages = tbl[bi, np.minimum(toks, t1 - 1) // ps].long()
                kc = kp[pages, :, torch.from_numpy(toks % ps)].float()
                vc = vp[pages, :, torch.from_numpy(toks % ps)].float()
                kc[~torch.from_numpy(live)] = 0.0
                vc[~torch.from_numpy(live)] = 0.0
                s = torch.einsum("hd,thd->ht", qs[bi], kc)
                s = torch.where(torch.from_numpy(live)[None], s,
                                torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                pr = torch.exp2(s - m_new)
                l = l * alpha + pr.sum(-1, keepdim=True)
                acc = acc * alpha + torch.einsum("ht,thd->hd", pr, vc)
                m = m_new
            states.append((m, l, acc))
        mx = torch.stack([st[0] for st in states]).amax(0)
        total = torch.zeros(h, 1)
        res = torch.zeros(h, d)
        for m, l, acc in states:
            w = torch.exp2(m - mx)
            total = total + l * w
            res = res + acc * w
        out[bi] = res / torch.clamp(total, min=1e-30)
    return out


def _rehearsal_inputs(d):
    b, h, pages, ps, maxp = _REHEARSAL
    rng = np.random.RandomState(d)
    lens = [0, 1, ps + 1, maxp * ps] + list(rng.randint(1, maxp * ps, 2))
    return _inputs(13 + d, b, h, d, pages, ps, maxp, lens)


@functools.lru_cache(maxsize=None)
def _jax_paged_kernel(dtype, d):
    """The JAX Pallas kernel (interpret mode) on the rehearsal's inputs."""
    q, kp, vp, tbl, lens = _rehearsal_inputs(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_PALLAS_DECODE", "1")
        return np.asarray(jpk.paged_attention(
            jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tbl), jnp.asarray(lens)),
            np.float32)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("d", [16, 20, 64, 128])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 4e-2)])
def test_paged_split_merge_rehearsal_matches_jax_kernel(dtype, tol, d,
                                                        splits):
    """CPU rehearsal of the CUDA kernel's split of a sequence's pages over
    the blocks of a cluster and its fixed-order merge of their (m, l, acc):
    held to the JAX package's Pallas kernel (interpret mode) at the
    tolerances of test_paged_reference_matches_jax_kernel, over lengths 0,
    1, ps + 1, full and random, pages that straddle the 16-token chunks."""
    q, kp, vp, tbl, lens = _rehearsal_inputs(d)
    ref = _jax_paged_kernel(dtype, d)
    tdt = getattr(torch, dtype)
    got = _split_rehearsal(torch.from_numpy(q).to(tdt).float(),
                           torch.from_numpy(kp).to(tdt),
                           torch.from_numpy(vp).to(tdt),
                           torch.from_numpy(tbl), lens, 1.0 / np.sqrt(d),
                           splits)
    live = lens > 0
    assert np.max(np.abs(ref[live] - got[live].numpy())) < tol
    assert torch.equal(got[~torch.from_numpy(live)],
                       torch.zeros(int((~live).sum()), kp.shape[1], d))


def test_cpu_tensor_takes_plain_version_without_counting():
    q, kp, vp, tbl, lens = _inputs(3, 2, 2, 32, 8, 4, 3, [5, 9])
    before = tpk.paged_attention.launches
    out = tpk.paged_attention(*(torch.from_numpy(a)
                                for a in (q, kp, vp, tbl, lens)))
    ref = tpk.paged_attention_reference(
        *(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)),
        1.0 / np.sqrt(32))
    assert torch.equal(out, ref)
    assert tpk.paged_attention.launches == before


@pytest.mark.parametrize("case", ["q_dtype", "head_dim", "kv_mismatch",
                                  "table_dtype", "lengths_shape",
                                  "noncontiguous", "pages_shape"])
def test_kernel_argument_checks_raise(case):
    """The wrapper refuses what the kernel does not take (checked before
    any launch; shapes only, so it runs on CPU tensors)."""
    q = torch.zeros(2, 4, 64)
    kp = torch.zeros(8, 4, 16, 64)
    vp = torch.zeros(8, 4, 16, 64)
    tbl = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    tpk._check_kernel_args(q, kp, vp, tbl, lens)     # the valid baseline
    if case == "q_dtype":
        q = q.double()
    elif case == "head_dim":   # the kernel takes 1..128
        q, kp, vp = (torch.zeros(*t.shape[:-1], 160) for t in (q, kp, vp))
    elif case == "kv_mismatch":
        vp = vp.bfloat16()
    elif case == "table_dtype":
        tbl = tbl.long()
    elif case == "lengths_shape":
        lens = torch.zeros(3, dtype=torch.int32)
    elif case == "noncontiguous":
        kp = torch.zeros(8, 16, 4, 64).transpose(1, 2)
    elif case == "pages_shape":
        kp = vp = torch.zeros(8, 2, 16, 64)
    with pytest.raises(MXNetError):
        tpk._check_kernel_args(q, kp, vp, tbl, lens)
