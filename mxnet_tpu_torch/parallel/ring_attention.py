"""Ring attention over the ``sp`` mesh axis (counterpart of
`mxnet_tpu/parallel/ring_attention.py`): sequence parallelism.

Q/K/V are split on the sequence dimension over ``sp``. Each rank keeps its
Q shard, and the K/V shards go around the ring by `collectives.ppermute`
(point to point: one shard a hop), n - 1 hops for n ranks. The softmax is
accumulated online (running max and normalizer), so the result is exact
attention, while no rank holds the whole (L, L) score matrix or the whole
K/V. The JAX package writes the block as einsums outside any Pallas
kernel; here it is the same products in PyTorch. Differentiable: the
gradient goes back around the ring through `ppermute`'s inverse.
"""
from __future__ import annotations

import math

import torch

from . import collectives as _coll
from .mesh import current_mesh

__all__ = ["ring_attention", "ring_attention_sharded", "local_attention_block"]


def local_attention_block(q, k, v, o, m, l, causal, q_off, kv_off, scale):
    """One blockwise-attention accumulation step (online softmax).

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]; o: [B, Lq, H, D] f32
    accumulator; m, l: [B, H, Lq] running max and normalizer. Returns the
    updated (o, m, l). A row whose keys are all masked so far keeps m at
    -inf and adds nothing (the guards keep its terms at 0, never NaN)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(lq, device=q.device)[:, None]
        kpos = kv_off + torch.arange(lk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, -math.inf))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m),
                        torch.exp(m - m_safe))
    l_new = alpha * l + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None):
    """Exact attention with K/V going around the ``axis_name`` ring of the
    current mesh. q/k/v are this rank's sequence shards [B, L_local, H,
    D] (rank i holds positions [i L_local, (i+1) L_local)); returns its
    output shard [B, L_local, H, D] in q's dtype."""
    n = _coll.axis_size(axis_name)
    idx = _coll.axis_index(axis_name)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for step in range(n):
        src = (idx - step) % n          # whose K/V shard this rank holds
        o, m, l = local_attention_block(q, kc, vc, o, m, l, causal, idx * lq,
                                        src * lk, scale)
        if step < n - 1:
            kc = _coll.ppermute(kc, axis_name, perm)
            vc = _coll.ppermute(vc, axis_name, perm)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh=None, axis_name="sp", causal=False,
                           scale=None, batch_axis="dp"):
    """Host-callable form: the global [B, L, H, D] inputs are cut to this
    rank's block (batch over ``batch_axis``, sequence over ``axis_name``),
    `ring_attention` runs over the mesh, and the blocks are gathered back:
    every rank returns the global output."""
    from .mesh import use_mesh
    from .sharding import gather_array, shard_array

    mesh = mesh or current_mesh()
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{axis_name}' axis")
    bat = batch_axis if batch_axis in mesh.axis_names else None
    spec = (bat, axis_name, None, None)
    with use_mesh(mesh):
        out = ring_attention(*(shard_array(t, mesh, spec) for t in (q, k, v)),
                             axis_name=axis_name, causal=causal, scale=scale)
    return gather_array(out, mesh, spec)
