"""Card-only tests of the PyTorch port: each CUDA kernel (paged attention,
the four conv-epilogue kernels, the three flash-attention kernels, the
three LSTM kernels) against its plain PyTorch version on the same card
tensors, the generation engine on the card against the full-sequence
forward, a ResNet, a BERT and a word-LM training step on the card
against the same step on the CPU, the word LM's step through the Gluon
façade (``record()`` / ``backward()`` / ``gluon.Trainer``) on the card
against the CPU, a small FusedRNNCell LM's and a conv + BatchNorm net's
symbolic step (``Module``) on the card against the CPU, ``mx.rtc``
(NVRTC-compiled CUDA C++ launched on ``mx.nd`` arrays) with ``mx.nd`` on
the card against the CPU, and a scoring word LM served by the predict
path (``ModelRepository`` -> ``DynamicBatcher`` -> bucketed
``Predictor``s -> ``lstm_infer``) on the card against a ``Predictor`` on
the CPU, with its launch counts and its buckets' shared weights; and a
2-replica generation pool on the card against the in-process engine, each
replica's paged-kernel launches read from its stats; each serving bucket's
warm-up price on the card (its peak bytes and FLOPs, the paged kernel's
by formula) without a new host sync on a request's path; and a
bound graph's no-input ops on the card; and the CTC op, the random ops
(by distribution), the spatial transformer ops, linalg and control flow
on the card against the CPU; and ``sparse.dot`` with its backward (two
card runs bit for bit), a sparse linear model's steps and the local
kvstore on the card against the CPU; and ``topk_moe`` / ``switch_moe``
with their gradients, and a ``DistributedTrainer`` step of an MoE net
over a dp 1 x ep 1 mesh (no host sync in it), on the card against the
CPU; and the conv epilogue's raw mode and finishing kernels (a batch
split over ranks) against their plain versions, attention at batch 1
(fault F8), and a `PipelineTrainer` step at pp 1 on the card against the
CPU; and a Parameter over ``[cpu(0), gpu(0)]`` trained through
`gluon.Trainer` against the same run over ``[cpu(0), cpu(1)]``; and a
ResNet-50 `DistributedTrainer` checkpoint (`CheckpointManager`) restored
into a fresh trainer, whose next step is bit-equal (``-k resilience``).

Every test is marked ``cuda`` and decides inside itself whether a card is
present; without one it skips. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch (``--noconftest``
skips the suite's conftest, which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

import threading

from chip_smoke import (RTC_CASES, RTC_SOFTMAX, RTC_SOFTMAX_EXPORTS,
                        RTC_TEMPLATED_AXPY, SYMBOLIC_STEPS, facade_lm_step,
                        score_symbol,
                        facade_step_errors, module_step_errors, rtc_close,
                        rtc_kernels, rtc_planted_faults, rtc_scale,
                        rtc_softmax, softmax_bwd_plain, softmax_plain)
from mxnet_tpu_torch import context as mx_context
from mxnet_tpu_torch import initializer
from mxnet_tpu_torch import nd, rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_mini, lm_mini
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.ops import pallas_kernels as tpk
from mxnet_tpu_torch.parallel import DistributedTrainer
from mxnet_tpu_torch.serving import GenerateScheduler, TransformerLMEngine


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode")


def _inputs(seed, b, h, d, pages, ps, maxp, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    kp = rng.randn(pages, h, ps, d).astype(np.float32)
    vp = rng.randn(pages, h, ps, d).astype(np.float32)
    tbl = rng.randint(0, pages, (b, maxp)).astype(np.int32)
    return q, kp, vp, tbl, np.asarray(lens, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-5),
                                          ("bfloat16", 4e-2)])
@pytest.mark.parametrize("b,d", [(1, 64), (32, 64), (32, 16), (32, 80),
                                 (32, 128), (4, 64), (32, 20), (32, 40)])
def test_cuda_kernel_matches_plain_on_card(kv_dtype, tol, b, d):
    """Main-path shapes (H=12, Dh=64, page 16, 256 pages, 12 pages a
    sequence) with ragged lengths: 0, 1, page-straddling, full; one and
    four full-length sequences (B * H too small for the card: the kernel
    splits each over a thread-block cluster); and other head dims the
    kernel takes (any up to 128; 20 in bf16 is not whole 16-byte
    vectors)."""
    _need_card()
    h, pages, ps, maxp = 12, 256, 16, 12
    lens = ([0, 1, 17, maxp * ps] * b)[:b] if b > 4 else [maxp * ps] * b
    q, kp, vp, tbl, lens = _inputs(5, b, h, d, pages, ps, maxp, lens)
    dev = torch.device("cuda")
    tdt = getattr(torch, kv_dtype)
    args = (torch.from_numpy(q).to(dev), torch.from_numpy(kp).to(dev, tdt),
            torch.from_numpy(vp).to(dev, tdt), torch.from_numpy(tbl).to(dev),
            torch.from_numpy(lens).to(dev))
    before = tpk.paged_attention.launches
    out = tpk.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpk.paged_attention.launches == before + 1
    ref = tpk.paged_attention_reference(*args, 1.0 / np.sqrt(d))
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol
    inert = torch.from_numpy(lens).to(dev) == 0
    assert torch.equal(out[inert], torch.zeros_like(out[inert]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_paged_kernel_is_deterministic(kv_dtype):
    """No atomics, and the cluster's splits merged in a fixed order: two
    runs give the same bits, split (B = 1) and not (B = 32)."""
    _need_card()
    h, pages, ps, maxp = 12, 256, 16, 12
    tdt = getattr(torch, kv_dtype)
    for b, lens in ((1, [maxp * ps]), (32, [0, 1, 17, maxp * ps] * 8)):
        q, kp, vp, tbl, lens = _inputs(8, b, h, 64, pages, ps, maxp, lens)
        args = (torch.from_numpy(q).cuda(),
                torch.from_numpy(kp).cuda().to(tdt),
                torch.from_numpy(vp).cuda().to(tdt),
                torch.from_numpy(tbl).cuda(), torch.from_numpy(lens).cuda())
        runs = [tpk.paged_attention(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    _need_card()

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tpk, "paged_attention_reference", boom)
    q, kp, vp, tbl, lens = _inputs(1, 2, 2, 32, 8, 4, 3, [5, 9])
    out = tpk.paged_attention(*(torch.from_numpy(a).cuda()
                                for a in (q, kp, vp, tbl, lens)))
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()


def _greedy(lm, prompt, n):
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            ids = torch.tensor([toks],
                               device=lm._held("word_weight").device)
            t = int(torch.argmax(lm(ids)[0, -1]))
            out.append(t)
            toks.append(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_engine_on_card_greedy_and_kernel_launches(kv_dtype):
    """The engine on the card decodes through the kernel, one launch per
    layer per step; with f32 pages its greedy tokens equal the
    full-sequence forward's."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = lm_mini(vocab_size=96, device="cuda").initialize(0, std=0.3)
    eng = TransformerLMEngine(lm=lm, num_pages=32, page_size=4,
                              max_prompt=8, max_new_tokens=12, max_batch=4,
                              kv_dtype=kv_dtype, device="cuda")
    sched = GenerateScheduler(eng, name="cuda-%s/1" % kv_dtype,
                              queue_depth=16)
    try:
        prompts = [[3, 5, 7], [2], [9, 4, 6, 1, 8], [1, 2, 3, 4]]
        budgets = [5, 9, 3, 7]
        before = tpk.paged_attention.launches
        reqs = [sched.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        outs = [r.wait(120) for r in reqs]
        launches = tpk.paged_attention.launches - before
        assert launches >= (max(budgets) - 1) * eng.num_layers
        assert [len(o) for o in outs] == budgets
        assert all(0 <= t < 96 for o in outs for t in o)
        if kv_dtype == "float32":
            assert outs == [_greedy(lm, p, n)
                            for p, n in zip(prompts, budgets)]
        assert sched.allocator.used_pages == 0
    finally:
        sched.close(drain=False, timeout=0)


@pytest.mark.cuda
def test_replica_pool_on_card_matches_in_process_engine(tmp_path):
    """A 2-replica generation pool on ``cuda:0`` (two worker processes
    sharing the card, each with its own CUDA context and copy of the
    weights) gives the in-process card engine's tokens, and each replica
    launched the paged kernel in its own process while serving them (its
    warm-up's launches apart)."""
    _need_card()
    from mxnet_tpu_torch.serving import ModelRepository, save_lm

    torch.backends.cuda.matmul.allow_tf32 = False
    lm = lm_mini(vocab_size=96, device="cuda").initialize(0, std=0.3)
    prefix = save_lm(lm, str(tmp_path / "lm"))
    geom = dict(num_pages=32, page_size=4, max_prompt=8, max_new_tokens=12,
                max_batch=4)
    prompts = [[3, 5, 7], [2], [9, 4, 6, 1, 8], [1, 2, 3, 4], [8, 8], [5]]
    budgets = [5, 9, 3, 7, 4, 8]
    sched = GenerateScheduler(TransformerLMEngine(lm=lm, device="cuda",
                                                  **geom),
                              name="cuda-inproc/1", queue_depth=16)
    try:
        want = [r.wait(120) for r in [sched.submit(p, max_new_tokens=n)
                                      for p, n in zip(prompts, budgets)]]
    finally:
        sched.close(drain=False, timeout=0)
    repo = ModelRepository()
    model = repo.load("cudapool", prefix, generate=True, replicas=2,
                      generate_opts=geom, heartbeat_ms=2000,
                      teardown_grace=2.0, spawn_timeout_s=300,
                      # two requests in flight a replica: the six spread
                      # over both
                      gen_outstanding=2)
    try:
        assert model.describe()["meta"]["device"] == "cuda:%d" % \
            torch.cuda.current_device()
        got = [None] * len(prompts)

        def one(i):
            got[i] = model.generate(prompts[i], max_new_tokens=budgets[i],
                                    timeout_ms=120000)["tokens"]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not any(t.is_alive() for t in threads)
        assert got == want
        for rid in model.pool.replica_ids():
            st = model.pool.replica_stats(rid, timeout=30)
            assert st is not None, rid
            # launches since the replica reported ready: the requests'
            assert st["launches"] > 0 and st["warm_launches"] > 0, st
            assert st["kv_pages_used"] == 0, st
            assert st["jit_after_warm"] == 0 and st["pending"] == 0, st
            assert st["max_memory_allocated"] > 0, st
    finally:
        assert repo.unload("cudapool", timeout=60)


@pytest.mark.cuda
def test_bucket_prices_on_card_and_no_new_host_sync(tmp_path):
    """Each bucket's warm-up is priced on the card: a predict
    `ServedModel`'s and an in-process LM engine's ``bucket_memory``
    ``temp`` > 0 (the peak above the baseline), the predict buckets'
    ``arguments`` their parameter bytes and ``bucket_flops`` their matrix
    products; the paged kernel's FLOPs come from its formula (the card
    engine's decode buckets count what the CPU engine's `FlopCounterMode`
    counts over the plain version). A decode step whose FLOPs are already
    priced makes exactly the host syncs of the bare step (torch's sync
    debug mode, counted as warnings)."""
    _need_card()
    import warnings

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ModelRepository, load_lm, save_lm
    from mxnet_tpu_torch.telemetry import flops

    torch.backends.cuda.matmul.allow_tf32 = False
    net = tnn.HybridSequential()
    net.add(tnn.Dense(256, activation="relu"), tnn.Dense(64))
    net.initialize(ctx=mx.cpu())
    net(nd.zeros((2, 128), ctx=mx.cpu()))
    prefix = str(tmp_path / "mlp")
    net.export(prefix, epoch=0)
    repo = ModelRepository()
    model = repo.load("mlp", prefix, input_shapes={"data": (128,)},
                      max_batch=8, ctx=mx.gpu(0))
    try:
        params = (128 * 256 + 256 + 256 * 64 + 64) * 4
        assert sorted(model.bucket_memory) == [1, 2, 4, 8]
        for b, fig in model.bucket_memory.items():
            assert fig["temp"] > 0 and fig["arguments"] == params, (b, fig)
            assert model.bucket_flops[b] == 2 * b * (128 * 256 + 256 * 64)
        assert model.memory_bytes > params
    finally:
        repo.unload("mlp", timeout=30)

    lm = lm_mini(vocab_size=64).initialize(0, std=0.3)
    lm_prefix = save_lm(lm, str(tmp_path / "lm"))
    geom = dict(num_pages=16, page_size=4, max_prompt=8, max_new_tokens=8,
                max_batch=4)
    engines = {dev: TransformerLMEngine(lm=load_lm(lm_prefix, device=dev),
                                        device=dev, **geom)
               for dev in ("cuda", "cpu")}
    for e in engines.values():
        e.warm()
    card, host = engines["cuda"], engines["cpu"]
    assert sorted(card.bucket_memory) == [1, 2, 4]
    for b, fig in card.bucket_memory.items():
        assert fig["temp"] > 0, (b, fig)
        assert fig["arguments"] == card.param_bytes() + card.kv_bytes()
    assert card.bucket_flops == host.bucket_flops
    assert all(f > 0 for f in card.bucket_flops.values())
    # the kernel alone: invisible to the counter, counted by formula
    q, kp, vp, tbl, lens = _inputs(3, 4, 2, 16, 16, 4, 3, [5, 12, 0, 9])
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp, tbl, lens)]
    _, f = flops.counted_call(tpk.paged_attention, *args)
    assert f == 4 * 4 * 2 * 16 * (3 * 4)

    b = 4
    step = (np.zeros(b, np.int32), np.arange(b, dtype=np.int32),
            np.full(b, geom["num_pages"], np.int32), np.zeros(b, np.int32),
            np.zeros((b, 4), np.int32), np.zeros(b, np.int32),
            np.zeros(b, np.float32), np.zeros(b, np.int32),
            np.ones(b, np.float32), None)

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(*step)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # (the mode's first use also warns that it is a prototype)
        return [str(w.message) for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]

    card.decode_step(*step)   # this step's first call, e.g. greedy-only
    card._decode_step(*step)
    priced = syncs(card.decode_step)
    bare = syncs(card._decode_step)
    assert len(priced) == len(bare) >= 1, (priced, bare)


# ---------------------------------------------------------------------------
# conv epilogue (csrc/conv_epilogue.cu)
#
# Tolerances: f32 results rtol 1e-4 with an absolute floor of 1e-4 x the
# largest magnitude (the kernel and the plain version sum up to 401,408
# rows in different orders); bf16 tensors 2^-7 the same way (one bf16
# rounding step is 2^-8, and an f32 value near a tie may round either
# way after a different summation order).
# ---------------------------------------------------------------------------

_EPI_NAMES = ("epi_stats", "epi_apply", "epi_bwd_reduce", "epi_bwd_dx")


def _close(got, want, tol, what, scale=0.0):
    """|got - want| <= tol * |want| + tol * max(max|want|, scale)."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    floor = tol * max(float(want.abs().max()), scale, 1e-30)
    err = (got - want).abs() - tol * want.abs()
    assert float(err.max()) <= floor, (what, float(err.max()), floor)


def _epi_case(seed, r, c, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def rows():
        return torch.randn(r, c, generator=g, device=dev).to(dtype)

    x = (torch.randn(r, c, generator=g, device=dev) * 2 + 3).to(dtype)
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev)
    return x, rows(), gamma, beta, rows()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c", [(1000, 3), (70, 200), (401408, 64)])
@pytest.mark.parametrize("relu,has_res", [(True, False), (True, True),
                                          (False, False)])
def test_epilogue_kernels_match_plain_on_card(dtype, r, c, relu, has_res):
    """Each of the four kernels against its plain version on the same card
    tensors: a small and an odd shape, and the ResNet-50 stage-1 shape at
    batch 128 (56 x 56 x 64)."""
    _need_card()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    x, res, gamma, beta, ct = _epi_case(7, r, c, getattr(torch, dtype))
    res = res if has_res else None
    before = {n: getattr(tpk, n).launches for n in _EPI_NAMES}
    got = tpk.epi_stats(x, gamma, beta, 1e-5, False)
    want = tpk.epi_stats_reference(x, gamma, beta, 1e-5, False)
    for name, a, b in zip(("mean", "var", "inv", "scale", "shift"), got,
                          want):
        _close(a, b, 1e-4, name)
    mean, _, inv, scale, shift = want
    out = tpk.epi_apply(x, res, scale, shift, relu)
    _close(out, tpk.epi_apply_reference(x, res, scale, shift, relu), tol,
           "out")
    saved = out if relu else None
    got = tpk.epi_bwd_reduce(ct, x, saved, mean, inv, gamma, False)
    want = tpk.epi_bwd_reduce_reference(ct, x, saved, mean, inv, gamma,
                                        False)
    for name, a, b in zip(("dgamma", "dbeta", "coef", "cb", "cg"), got,
                          want):
        _close(a, b, 1e-4, name)
    _, _, coef, cb, cg = want
    dx, dres = tpk.epi_bwd_dx(ct, x, saved, mean, inv, coef, cb, cg,
                              has_res)
    wdx, wdres = tpk.epi_bwd_dx_reference(ct, x, saved, mean, inv, coef, cb,
                                          cg, has_res)
    _close(dx, wdx, tol, "dx")
    if has_res:
        _close(dres, wdres, tol, "dres")
    else:
        assert dres is None
    torch.cuda.synchronize()
    assert all(getattr(tpk, n).launches == before[n] + 1 for n in _EPI_NAMES)


# (R, C): the cluster route folded with a tail and unfolded over 7 tiles,
# R < 8, and the streamed route folded and unfolded
_ROUTE_SHAPES = [(1003, 3), (777, 5), (5, 3), (8192, 448), (6272, 2048),
                 (26000, 64), (1100000, 3)]


@pytest.mark.cuda
def test_epi_layout_mirrors_the_kernel_layout_on_card():
    """`_epi_layout` against the kernel's own layout (``epi_layout_query``:
    V, L, W, route, tx, ty, tiles, n_chunks) at the route shapes and the
    smoke's, both dtypes, aligned or not; the cluster size the card takes
    is 8 or 16."""
    import ctypes

    from chip_smoke import EPI_SHAPES
    from mxnet_tpu_torch.ops import _build

    _need_card()
    fn = _build.load("conv_epilogue").epi_layout_query
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    shapes = _ROUTE_SHAPES + [(r, c) for _, r, c in EPI_SHAPES]
    for r, c in shapes:
        for code, itemsize in ((0, 4), (1, 2)):
            for aligned in (True, False):
                out = (ctypes.c_int * 9)()
                assert fn(code, r, c, int(aligned), out) == 0
                lay = tpk._epi_layout(r, c, itemsize, aligned)
                want = [lay["v"], lay["l"], lay["w"],
                        int(lay["route"] == "cluster"), lay["tx"], lay["ty"],
                        lay["tiles"], lay["n_chunks"]]
                assert list(out)[:8] == want, (r, c, itemsize, aligned)
                assert out[8] in (8, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c", _ROUTE_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_reductions_on_each_route_match_plain_on_card(dtype, r, c, offset):
    """Both reductions on the route their layout names (counted in
    ``routes``), folded or not, and from rows that start one element past
    16-byte alignment (the scalar path), against the plain versions; two
    runs give the same bits."""
    _need_card()
    tdt = getattr(torch, dtype)
    x, _, gamma, beta, ct = _epi_case(11, r, c, tdt)
    if offset:   # views one element into a buffer: not 16-byte aligned
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(r, c)
        ct = torch.cat([ct.new_zeros(1), ct.flatten()])[1:].view(r, c)
    aligned = offset == 0
    lay = tpk._epi_layout(r, c, x.element_size(), aligned)
    out = torch.relu(x)
    if offset:
        out = torch.cat([out.new_zeros(1), out.flatten()])[1:].view(r, c)
    for fn, args, names, ref in (
            (tpk.epi_stats, (x, gamma, beta, 1e-5, False),
             ("mean", "var", "inv", "scale", "shift"),
             tpk.epi_stats_reference),
            (tpk.epi_bwd_reduce, (ct, x, out, None, None, gamma, False),
             ("dgamma", "dbeta", "coef", "cb", "cg"),
             tpk.epi_bwd_reduce_reference)):
        if fn is tpk.epi_bwd_reduce:
            mean, _, inv, _, _ = tpk.epi_stats_reference(x, gamma, beta,
                                                         1e-5, False)
            args = (ct, x, out, mean, inv, gamma, False)
        before = dict(fn.routes)
        got = fn(*args)
        again = fn(*args)
        want = ref(*args)
        moved = {k: n - before[k] for k, n in fn.routes.items()}
        assert moved[lay["route"]] == 2 and \
            moved["folded"] == (2 if lay["l"] > 1 else 0), (moved, lay)
        for name, a, b, a2 in zip(names, got, want, again):
            _close(a, b, 1e-4, "%s (%d, %d) %s" % (name, r, c, dtype))
            assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_epilogue_matches_reference_on_card(dtype):
    """The autograd Function over the kernels against the plain version
    differentiated by autograd: out, mean, var and the gradients of x,
    gamma, beta and residual, with bf16 parameters as the trainer casts
    them."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    x, res, gamma, beta, ct = _epi_case(3, 8 * 28 * 28, 128, tdt)
    x = x.reshape(8, 28, 28, 128)
    res = res.reshape(x.shape)
    # no cotangent where |out| < 1e-3: an f32 rounding apart can put the
    # two forwards on the two sides of the ReLU's kink there
    with torch.no_grad():
        ref_out = tpk.conv_epilogue_reference(x, gamma.to(tdt), beta.to(tdt),
                                              res, eps=1e-5, relu=True)[0]
    ct = torch.where(ref_out.float().abs() < 1e-3, torch.zeros_like(ref_out),
                     ct.reshape(x.shape))
    results = []
    for fn in (tpk.conv_epilogue, tpk.conv_epilogue_reference):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, gamma.to(tdt), beta.to(tdt), res)]
        out, mean, var = fn(*leaves, eps=1e-5, relu=True)
        (out.float() * ct.float()).sum().backward()
        results.append([out, mean, var] + [t.grad for t in leaves])
    names = ("out", "mean", "var", "dx", "dgamma", "dbeta", "dres")
    for name, a, b in zip(names, *results):
        _close(a, b, 1e-4 if name in ("mean", "var") else tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_reductions_are_deterministic(dtype):
    _need_card()
    x, _, gamma, beta, ct = _epi_case(5, 401408, 64, getattr(torch, dtype))
    a = tpk.epi_stats(x, gamma, beta, 1e-5, False)
    b = tpk.epi_stats(x, gamma, beta, 1e-5, False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    out = tpk.epi_apply(x, None, a[3], a[4], True)
    c = tpk.epi_bwd_reduce(ct, x, out, a[0], a[2], gamma, False)
    d = tpk.epi_bwd_reduce(ct, x, out, a[0], a[2], gamma, False)
    assert all(torch.equal(u, v) for u, v in zip(c, d))


@pytest.mark.cuda
def test_epilogue_wrappers_raise_on_bad_inputs():
    """No silent copy or conversion: a non-contiguous input, a tensor on
    the wrong device or of another dtype raises."""
    _need_card()
    x, res, gamma, beta, _ = _epi_case(1, 64, 16, torch.float32)
    with pytest.raises(MXNetError, match="contiguous"):
        tpk.epi_stats(x.t(), gamma, beta)
    with pytest.raises(MXNetError, match="contiguous"):
        tpk.conv_epilogue(x.reshape(4, 4, 4, 16).transpose(1, 2), gamma,
                          beta)
    with pytest.raises(MXNetError, match="cpu"):
        tpk.epi_stats(x, gamma.cpu(), beta)
    with pytest.raises(MXNetError):
        tpk.epi_apply(x, res.to(torch.bfloat16), gamma, beta)
    with pytest.raises(MXNetError):
        tpk.epi_apply(x, None, gamma.double(), beta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c", [(1003, 3), (8192, 448), (401408, 64)])
def test_raw_mode_and_finish_kernels_match_plain_on_card(dtype, r, c):
    """The reductions' raw mode (a batch split over ranks) against its
    plain version and bit for bit on a second run, and the finishing
    kernels over two ranks' sums against the plain whole-batch statistics
    and dx coefficients: the folded cluster route, the cluster route and
    the streamed route."""
    _need_card()
    tdt = getattr(torch, dtype)
    xs, cts = [], []
    for k in range(2):
        x, _, gamma, beta, ct = _epi_case(11 + k, r, c, tdt)
        xs.append((x.float() + 2 * k).to(tdt))
        cts.append(ct)
    raws = []
    for x in xs:
        raw = tpk.epi_stats(x, gamma, beta, 1e-5, False, raw=True)
        assert torch.equal(raw, tpk.epi_stats(x, gamma, beta, 1e-5, False,
                                              raw=True))
        _close(raw, tpk.epi_stats_reference(x, gamma, beta, 1e-5, False,
                                            raw=True), 1e-4, "raw")
        raws.append(raw)
    before = tpk.epi_stats_finish.launches
    got = tpk.epi_stats_finish(torch.stack(raws), r, gamma, beta, 1e-5)
    assert tpk.epi_stats_finish.launches == before + 1
    whole = torch.cat(xs)
    want = tpk.epi_stats_reference(whole, gamma, beta, 1e-5, False)
    for name, a, b in zip(("mean", "var", "inv", "scale", "shift"), got,
                          want):
        _close(a, b, 1e-4, name)
    mean, _, inv, _, _ = got
    sums = []
    for x, ct in zip(xs, cts):
        d = tpk.epi_bwd_reduce(ct, x, None, mean, inv, gamma, False, raw=True)
        again = tpk.epi_bwd_reduce(ct, x, None, mean, inv, gamma, False,
                                   raw=True)
        assert all(torch.equal(a, b) for a, b in zip(d, again))
        for a, b in zip(d, tpk.epi_bwd_reduce_reference(
                ct, x, None, mean, inv, gamma, False, raw=True)):
            _close(a, b, 1e-4, "bwd raw")
        sums.append(d[3])
    cb, cg = tpk.epi_bwd_finish(torch.stack(sums), r)
    wcb, wcg = tpk.epi_bwd_reduce_reference(torch.cat(cts), whole, None, mean,
                                            inv, gamma, False)[3:]
    _close(cb, wcb, 1e-4, "cb", scale=1e-3)
    _close(cg, wcg, 1e-4, "cg", scale=1e-3)


@pytest.mark.cuda
def test_cuda_epilogue_never_takes_plain_version(monkeypatch):
    _need_card()

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in _EPI_NAMES:
        monkeypatch.setattr(tpk, name + "_reference", boom)
    x, res, gamma, beta, _ = _epi_case(2, 96, 8, torch.float32)
    x.requires_grad_()
    out, _, _ = tpk.conv_epilogue(x, gamma, beta, res)
    out.sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all()


def _small_resnet(device):
    with tnn.layout_scope():
        return tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1], [8, 16, 32],
                                classes=10, thumbnail=True,
                                fuse_epilogue=True, device=device)


@pytest.mark.cuda
def test_trainer_step_on_card_matches_cpu():
    """One f32 DistributedTrainer step of the small ResNet on the card
    (TF32 off) against the same step on the CPU, from the same weights and
    batch: the loss, every parameter and running statistic. 8 BatchNorms,
    so each kernel launches 8 times."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (16, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 16)
    nets = {d: _small_resnet(d) for d in ("cpu", "cuda")}
    nets["cpu"].initialize(seed=4)
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    losses = {}
    before = {n: getattr(tpk, n).launches for n in _EPI_NAMES}
    for d, net in nets.items():
        tr = DistributedTrainer(net, "sgd", dict(opt),
                                loss=tloss.SoftmaxCrossEntropyLoss())
        losses[d] = tr.step(x, y)._data
        assert losses[d].device.type == torch.device(d).type
    torch.cuda.synchronize()
    assert all(getattr(tpk, n).launches == before[n] + 8 for n in _EPI_NAMES)
    _close(losses["cuda"].cpu(), losses["cpu"], 1e-4, "loss")
    want = nets["cpu"].state_dict()
    for k, v in nets["cuda"].state_dict().items():
        _close(v.cpu(), want[k], 1e-4, k)


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu)
#
# Tolerances: the kernels and the plain versions compute in f32 from the
# same inputs and sum in other orders. f32 results rtol 1e-4 with a floor
# of 1e-4 x the largest magnitude; bf16 tensors 2^-7 the same way (one
# bf16 rounding step is 2^-8). lse is f32 in both dtypes. The three
# gradients share one floor, from the largest of them: one can cancel to
# rounding noise (one query row under the causal mask sees one key, so
# dS = P * (dO.v - delta) = 0 and dQ = dK = 0 while dV = dO).
# ---------------------------------------------------------------------------

_FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# (BH, Lq, Lk, D): BERT-base's (batch 8 x 12 heads, 512, 64), ragged
# cross-attention, the other head dims (40: rows of 16-byte multiples but D
# not a multiple of 16; 20: rows not 16-byte aligned, the element-load
# path of the tensor-core kernels), a single query row
_FLASH_SHAPES = [(96, 512, 512, 64), (2, 200, 260, 16), (2, 200, 260, 80),
                 (2, 130, 70, 128), (2, 200, 260, 40), (2, 200, 260, 20),
                 (3, 1, 77, 64)]


def _flash_case(seed, bh, lq, lk, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(rows):
        return torch.randn(bh, rows, d, generator=g, device="cuda").to(dtype)

    return t(lq), t(lk), t(lk), t(lq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(dtype, causal, shape):
    _need_card()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    q, k, v, dout = _flash_case(11, *shape, getattr(torch, dtype))
    scale = 1.0 / np.sqrt(shape[-1])
    before = {n: getattr(tpk, n).launches for n in _FLASH_NAMES}
    out, lse = tpk.flash_fwd(q, k, v, causal, scale)
    want_out, want_lse = tpk.flash_fwd_reference(q, k, v, causal, scale)
    _close(out, want_out, tol, "out")
    _close(lse, want_lse, 1e-4, "lse")
    delta = (dout.float() * want_out.float()).sum(-1)
    got = (tpk.flash_bwd_dq(q, k, v, dout, want_lse, delta, causal, scale),)
    got += tpk.flash_bwd_dkv(q, k, v, dout, want_lse, delta, causal, scale)
    want = (tpk.flash_bwd_dq_reference(q, k, v, dout, want_lse, delta,
                                       causal, scale),)
    want += tpk.flash_bwd_dkv_reference(q, k, v, dout, want_lse, delta,
                                        causal, scale)
    big = max(float(w.float().abs().max()) for w in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, tol, name, scale=big)
    torch.cuda.synchronize()
    assert all(getattr(tpk, n).launches == before[n] + 1
               for n in _FLASH_NAMES)


@pytest.mark.cuda
def test_flash_bf16_kernels_run_on_tensor_cores():
    """The bf16 forward, dQ and dK/dV kernels hold HMMA instructions at
    every padded head dim (chip_smoke's SASS check, through cuobjdump)."""
    _need_card()
    from chip_smoke import check_flash_sass

    check_flash_sass()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_are_deterministic(dtype):
    """No atomics and no cross-block sums: two runs give the same bits."""
    _need_card()
    q, k, v, dout = _flash_case(3, 96, 512, 512, 64, getattr(torch, dtype))
    runs = []
    for _ in range(2):
        out, lse = tpk.flash_fwd(q, k, v)
        delta = (dout.float() * out.float()).sum(-1)
        runs.append((out, lse, tpk.flash_bwd_dq(q, k, v, dout, lse, delta))
                    + tpk.flash_bwd_dkv(q, k, v, dout, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grad_matches_reference_on_card(dtype, causal):
    """The autograd Function over the kernels against autograd through the
    plain attention, on the (B, H, L, Dh) head split of BERT-base at batch
    2 (strided views, as the attention layer hands them)."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    g = torch.Generator(device="cuda").manual_seed(8)
    qkv = torch.randn(2, 512, 3, 12, 64, generator=g, device="cuda").to(tdt)
    ct = torch.randn(2, 12, 512, 64, generator=g, device="cuda").to(tdt)
    results = []
    for fn in (tpk.flash_attention, tpk.flash_attention_reference):
        leaf = qkv.clone().requires_grad_()
        q, k, v = (leaf[:, :, i].transpose(1, 2) for i in range(3))
        out = fn(q, k, v, causal=causal)
        (out.float() * ct.float()).sum().backward()
        results.append((out.detach(), leaf.grad))
    for name, a, b in zip(("out", "dqkv"), *results):
        _close(a, b, tol, name)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_bad_inputs():
    _need_card()
    q, k, v, dout = _flash_case(1, 2, 16, 24, 32, torch.float32)
    with pytest.raises(MXNetError, match="contiguous"):
        tpk.flash_fwd(q.transpose(0, 1), k, v)
    with pytest.raises(MXNetError, match="cpu"):
        tpk.flash_fwd(q, k.cpu(), v)
    with pytest.raises(MXNetError):
        tpk.flash_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(MXNetError):
        tpk.flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(MXNetError, match="1..128"):
        big = torch.zeros(1, 4, 136, device="cuda")
        tpk.flash_fwd(big, big, big)
    lse = torch.zeros(2, 16, device="cuda")
    with pytest.raises(MXNetError, match="lse"):
        tpk.flash_bwd_dq(q, k, v, dout, lse[:, :8], lse)


@pytest.mark.cuda
def test_cuda_flash_never_takes_plain_version(monkeypatch):
    _need_card()

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in _FLASH_NAMES:
        monkeypatch.setattr(tpk, name + "_reference", boom)
    q, k, v, _ = _flash_case(2, 2, 40, 40, 64, torch.float32)
    q.requires_grad_()
    tpk.flash_attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(q.grad).all()


class _BertPretrain(torch.nn.Module):
    """BERT mini with an MLM head (vocab 64), children ``bert`` and
    ``mlm``."""

    def __init__(self, device):
        super().__init__()
        self.bert = bert_mini(vocab_size=64, dropout=0.0, device=device)
        self.mlm = tnn.Dense(64, flatten=False, in_units=64, device=device)

    def forward(self, tokens):
        return self.mlm(self.bert(tokens)[0])


@pytest.mark.cuda
def test_attention_at_batch_one_on_card_matches_cpu_f8():
    """F8: `MultiHeadAttention` at batch 1 (a pipeline's microbatch of one
    sequence) runs the flash kernels on the card (they raised on its
    strided heads) and equals the CPU layer on the same weights."""
    _need_card()
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        MultiHeadAttention

    att = MultiHeadAttention(64, 4, prefix="att_")
    att.initialize(ctx="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=(1, 128, 64)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        want = att(x)
        att.to("cuda")
        before = tpk.flash_fwd.launches
        got = att(x.cuda())
    torch.cuda.synchronize()
    assert tpk.flash_fwd.launches == before + 1
    _close(got.cpu(), want, 1e-4, "attention at batch 1")


@pytest.mark.cuda
def test_pipeline_trainer_step_on_card_matches_cpu():
    """`PipelineTrainer` over bert_mini's stages at pp 1, 2 microbatches of
    2 (f32, SGD, TF32 off): the forward and two steps' losses on the card
    against the CPU from the same weights, the flash kernels launched."""
    _need_card()
    from mxnet_tpu_torch.gluon.loss import L2Loss
    from mxnet_tpu_torch.parallel import PipelineTrainer, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(5)
    tok = rng.randint(0, 1000, (4, 32))
    target = rng.uniform(-1, 1, (4, 64)).astype(np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        model = bert_mini(dropout=0.0, device=dev)
        model.initialize(seed=5)
        tr = PipelineTrainer(model, "sgd", {"learning_rate": 0.1},
                             loss=L2Loss(), mesh=make_mesh([("pp", 1)]),
                             num_microbatches=2)
        before = tpk.flash_bwd_dkv.launches
        fwd = tr.forward(tok).asnumpy()
        losses = [float(tr.step(tok, target).asnumpy()) for _ in range(2)]
        got[dev] = (fwd, losses, tpk.flash_bwd_dkv.launches - before)
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["cuda"][1], got["cpu"][1], rtol=1e-4)
    assert got["cpu"][2] == 0 and got["cuda"][2] == 2 * 2 * 2


@pytest.mark.cuda
def test_bert_mini_step_on_card_matches_cpu():
    """One f32 Adam step of BERT mini + MLM head on the card (the flash
    kernels, TF32 off) against the same step on the CPU, from the same
    weights and batch: the loss, every parameter after the step and the
    change the step made (held to tol x the step's largest change as
    well: the key bias's gradient is zero in exact arithmetic). Adam's
    epsilon 1e-2 keeps the step linear in the gradient. 2 layers, so each
    flash kernel launches twice."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    x = rng.randint(0, 64, (4, 100)).astype(np.int64)
    y = rng.randint(0, 64, (4, 100)).astype(np.float32)
    nets = {d: _BertPretrain(d) for d in ("cpu", "cuda")}
    initializer.initialize(nets["cpu"], seed=5)
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"].load_state_dict(before)
    launches = {n: getattr(tpk, n).launches for n in _FLASH_NAMES}
    losses = {}
    for d, net in nets.items():
        tr = DistributedTrainer(net, "adam", {"learning_rate": 0.1,
                                              "epsilon": 1e-2},
                                loss=tloss.SoftmaxCrossEntropyLoss())
        losses[d] = tr.step(x, y)._data
    torch.cuda.synchronize()
    assert all(getattr(tpk, n).launches == launches[n] + 2
               for n in _FLASH_NAMES)
    _close(losses["cuda"].cpu(), losses["cpu"], 1e-4, "loss")
    want = nets["cpu"].state_dict()
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    for k, v in nets["cuda"].state_dict().items():
        _close(v.cpu(), want[k], 1e-4, k, scale=big)
        _close(v.cpu() - before[k], want[k] - before[k], 1e-4,
               "change of " + k, scale=big)


# ---------------------------------------------------------------------------
# the fused LSTM layer (csrc/lstm.cu)
#
# Tolerances: f32 results rtol 1e-4 with a floor of 1e-4 x the largest
# magnitude (the kernels and the plain versions sum the recurrent products
# in other orders); bf16 tensors 2^-7 the same way (one bf16 rounding step
# is 2^-8, and the recurrence carries a rounding apart into later steps).
# ---------------------------------------------------------------------------

_LSTM_NAMES = ("lstm_infer", "lstm_fwd", "lstm_bwd")
# (T, B, H): the word LM's layer, ragged, one step, the RNNModel default
# width at batch 1; then the forward's tensor-core tiling: B = 17 (the
# second m16 tile partial), B = 64 (four m16 tiles), H = 1500 (12 units a
# block, 48 gate rows; f32 does not fit a block there) and an odd H with
# B > 16; and shapes whose block cannot hold all of h, which take the
# streamed forward: B = 128 at H = 650, and H = 1500 at B = 32 (bf16; f32
# does not fit); and for the backward's clusters, a layer whose units a
# cluster (Q U = 16) do not divide H, with a partial m16 tile. The
# backward streams dgx where its clustered layout does not fit a block:
# f32 at B = 128, H = 650, and bf16 at H = 1500, B = 32
# (test_torch_port_lstm.py:test_lstm_bwd_smem_mirror_at_the_edge)
_LSTM_SHAPES = [(35, 32, 650), (7, 5, 9), (1, 3, 5), (35, 1, 200),
                (5, 17, 650), (5, 64, 650), (5, 8, 1500), (6, 24, 333),
                (5, 128, 650), (5, 32, 1500), (4, 20, 130)]


def _lstm_case(seed, t, b, h, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*size, scale=1.0):
        return (torch.randn(size, generator=g, device="cuda") * scale).to(
            dtype)

    return (rnd(t, b, 4 * h), rnd(4 * h, h, scale=(2.0 / (5 * h)) ** 0.5),
            rnd(b, h, scale=0.5), rnd(b, h, scale=0.5), rnd(t, b, h),
            rnd(b, h))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _LSTM_SHAPES)
def test_lstm_kernels_match_plain_on_card(dtype, shape):
    """Each kernel against its plain version on the same card tensors, with
    nonzero h0 and c0; the backward on the plain forward's residuals."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    gx, wh, h0, c0, dy, dct = _lstm_case(9, *shape, tdt)
    before = {n: getattr(tpk, n).launches for n in _LSTM_NAMES}
    if not tpk.lstm_layer_fits(shape[1], shape[2], tdt):
        # routed to the step loop by ops/rnn.py; the kernels refuse it
        with pytest.raises(MXNetError, match="CUDA error"):
            tpk.lstm_infer(gx, wh, h0, c0)
        with pytest.raises(MXNetError, match="CUDA error"):
            tpk.lstm_fwd(gx, wh, h0, c0)
        assert {n: getattr(tpk, n).launches for n in _LSTM_NAMES} == before
        return
    ys, ct = tpk.lstm_infer(gx, wh, h0, c0)
    want_ys, want_ct = tpk.lstm_infer_reference(gx, wh, h0, c0)
    _close(ys, want_ys, tol, "infer ys")
    _close(ct, want_ct, tol, "infer cT")
    ys2, c_all, gates = tpk.lstm_fwd(gx, wh, h0, c0)
    want = tpk.lstm_fwd_reference(gx, wh, h0, c0)
    assert c_all.dtype == torch.float32 and gates.dtype == tdt
    for name, a, b in zip(("ys", "c_all", "gates"), (ys2, c_all, gates),
                          want):
        _close(a, b, tol, "fwd " + name)
    got = tpk.lstm_bwd(dy, want[2], want[1], c0, dct, wh)
    for name, a, b in zip(("dgx", "dh0", "dc0"), got,
                          tpk.lstm_bwd_reference(dy, want[2], want[1], c0,
                                                 dct, wh)):
        assert a.dtype == tdt
        _close(a, b, tol, "bwd " + name)
    torch.cuda.synchronize()
    assert all(getattr(tpk, n).launches == before[n] + 1
               for n in _LSTM_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _LSTM_SHAPES)
def test_lstm_bwd_on_both_routes_is_deterministic(dtype, shape):
    """The backward at every shape, on the route its layout takes
    (clusters, or the streamed kernel), against its plain version, twice
    and bit for bit. A shape that fits no route raises."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    gx, wh, h0, c0, dy, dct = _lstm_case(13, *shape, tdt)
    _, c_all, gates = tpk.lstm_fwd_reference(gx, wh, h0, c0)
    if tpk._lstm_bwd_route(shape[1], shape[2],
                           gx.element_size())[2] > tpk._SMEM_MAX_BYTES:
        with pytest.raises(MXNetError, match="CUDA error"):
            tpk.lstm_bwd(dy, gates, c_all, c0, dct, wh)
        return
    runs = [tpk.lstm_bwd(dy, gates, c_all, c0, dct, wh) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want = tpk.lstm_bwd_reference(dy, gates, c_all, c0, dct, wh)
    for name, a, b in zip(("dgx", "dh0", "dc0"), runs[0], want):
        _close(a, b, tol, "bwd " + name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_kernels_are_deterministic(dtype):
    """One writer for every output element, no atomics: two runs give the
    same bits."""
    _need_card()
    gx, wh, h0, c0, dy, dct = _lstm_case(4, 35, 32, 650, getattr(torch,
                                                                 dtype))
    runs = []
    for _ in range(2):
        ys, c_all, gates = tpk.lstm_fwd(gx, wh, h0, c0)
        runs.append(tpk.lstm_infer(gx, wh, h0, c0) + (ys, c_all, gates)
                    + tpk.lstm_bwd(dy, gates, c_all, c0, dct, wh))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_layer_grad_matches_reference_on_card(dtype):
    """The `_LSTMLayer` route (forward and backward kernels, dW_hh as one
    product) against autograd through the plain step loop: ys, hT, cT and
    the gradients of gx, wh, h0 and c0."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    gx, wh, h0, c0, dy, dct = _lstm_case(5, 35, 32, 650, tdt)
    dht = torch.randn_like(h0.float()).to(tdt)
    results = []
    before = tpk.lstm_bwd.launches
    for fn in (tpk.lstm_layer, tpk.lstm_layer_reference):
        leaves = [t.clone().requires_grad_() for t in (gx, wh, h0, c0)]
        outs = fn(*leaves)
        grads = torch.autograd.grad(outs, leaves, (dy, dht, dct))
        results.append([o.detach() for o in outs] + list(grads))
    assert tpk.lstm_bwd.launches == before + 1
    for name, a, b in zip(("ys", "hT", "cT", "dgx", "dwh", "dh0", "dc0"),
                          *results):
        _close(a, b, tol, name)


@pytest.mark.cuda
def test_lstm_wrappers_raise_on_bad_inputs():
    _need_card()
    gx, wh, h0, c0, dy, dct = _lstm_case(1, 3, 2, 8, torch.float32)
    with pytest.raises(MXNetError, match="contiguous"):
        tpk.lstm_infer(gx, wh, h0.t().contiguous().t(), c0)
    with pytest.raises(MXNetError, match="cpu"):
        tpk.lstm_infer(gx, wh.cpu(), h0, c0)
    with pytest.raises(MXNetError):
        tpk.lstm_fwd(gx, wh.to(torch.bfloat16), h0, c0)
    with pytest.raises(MXNetError):
        tpk.lstm_infer(gx.double(), wh.double(), h0.double(), c0.double())
    with pytest.raises(MXNetError, match=r"\(4H, H\)"):
        tpk.lstm_infer(gx, wh[:, :4], h0, c0)
    ys, c_all, gates = tpk.lstm_fwd(gx, wh, h0, c0)
    with pytest.raises(MXNetError, match="c_all"):
        tpk.lstm_bwd(dy, gates, c_all[:2], c0, dct, wh)


@pytest.mark.cuda
def test_cuda_lstm_never_takes_plain_version(monkeypatch):
    _need_card()

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in _LSTM_NAMES:
        monkeypatch.setattr(tpk, name + "_reference", boom)
    monkeypatch.setattr(tpk, "_lstm_forward_reference", boom)
    gx, wh, h0, c0, _, _ = _lstm_case(2, 6, 4, 40, torch.float32)
    wh.requires_grad_()
    ys, h_t, c_t = tpk.lstm_layer(gx, wh, h0, c0)
    (ys.sum() + c_t.sum()).backward()
    with torch.no_grad():
        tpk.lstm_layer(gx, wh, h0, c0)
    torch.cuda.synchronize()
    assert torch.isfinite(wh.grad).all()


@pytest.mark.cuda
def test_word_lm_step_on_card_matches_cpu():
    """One f32 SGD step (lr 1.0) of a small word LM (vocab 1000, 2 x 650
    units, so the kernels cut w_hh across the SMs as at full width) on the
    card (TF32 off) against the same step on the CPU, from the same
    weights and batch: the loss, every parameter after the step and the
    change the step made. 2 layers: each training kernel launches twice."""
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel

    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    x = rng.randint(0, 1000, (12, 8)).astype(np.int64)
    y = rng.randint(0, 1000, (12, 8)).astype(np.float32)
    nets = {d: RNNModel(1000, 650, 650, 2, dropout=0.0, device=d)
            for d in ("cpu", "cuda")}
    nets["cpu"].initialize(seed=3)
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"].load_state_dict(before)
    launches = {n: getattr(tpk, n).launches for n in _LSTM_NAMES}
    losses = {}
    for d, net in nets.items():
        ce = tloss.SoftmaxCrossEntropyLoss()
        tr = DistributedTrainer(
            net, "sgd", {"learning_rate": 1.0},
            loss=lambda p, y: ce(p.reshape(-1, 1000), y.reshape(-1)))
        losses[d] = tr.step(x, y)._data
    torch.cuda.synchronize()
    assert {n: getattr(tpk, n).launches - launches[n]
            for n in _LSTM_NAMES} == {"lstm_infer": 0, "lstm_fwd": 2,
                                      "lstm_bwd": 2}
    _close(losses["cuda"].cpu(), losses["cpu"], 1e-4, "loss")
    want = nets["cpu"].state_dict()
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    for k, v in nets["cuda"].state_dict().items():
        _close(v.cpu(), want[k], 1e-4, k, scale=big)
        _close(v.cpu() - before[k], want[k] - before[k], 1e-4,
               "change of " + k, scale=big)


@pytest.mark.cuda
def test_facade_word_lm_step_on_card_matches_cpu():
    """One f32 step of the small word LM (vocab 1000, 2 x 650) through the
    Gluon façade, `chip_smoke.facade_lm_step`: on the card (TF32 off) the
    LSTM layers launch the forward and backward kernels once each a layer
    and never the inference kernel; the loss, every Parameter.grad() and
    every updated parameter equal the CPU step's (`facade_step_errors`,
    the word-LM step's tolerance)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {n: getattr(tpk, n).launches for n in _LSTM_NAMES}
    card = facade_lm_step(torch, 5, torch.device("cuda", 0))
    torch.cuda.synchronize()
    assert {n: getattr(tpk, n).launches - launches[n]
            for n in _LSTM_NAMES} == {"lstm_infer": 0, "lstm_fwd": 2,
                                      "lstm_bwd": 2}
    cpu = facade_lm_step(torch, 5, torch.device("cpu"))
    facade_step_errors(torch, card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1])
def test_symbolic_step_on_card_matches_cpu(which):
    """One f32 symbolic step (`Module.forward_backward`, SGD `update`) on
    the card (TF32 off) against the CPU step, `chip_smoke.SYMBOLIC_STEPS`:
    the small FusedRNNCell LM, whose RNN op launches lstm_fwd and lstm_bwd
    once a layer, and the conv -> BatchNorm -> Pooling -> FC net, whose
    BatchNorm launches the four conv-epilogue kernels once each. Every
    output, gradient, argument and aux state agrees
    (`module_step_errors`, rtol 1e-4)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, step, kernels = SYMBOLIC_STEPS[which]
    launches = {n: getattr(tpk, n).launches for n in kernels}
    card = step(torch, 5, torch.device("cuda", 0))
    torch.cuda.synchronize()
    per_layer = 2 if which == 0 else 1
    assert {n: getattr(tpk, n).launches - launches[n] for n in kernels} == \
        dict.fromkeys(kernels, per_layer)
    cpu = step(torch, 5, torch.device("cpu"))
    module_step_errors(torch, card, cpu, name)


# ---------------------------------------------------------------------------
# predict serving: the scoring word LM (vocab 1000, 2 x 650 units, 35
# tokens) through ModelRepository on the card

_SCORE = dict(vocab=1000, units=650, layers=2, seq=35)


def _score_artifact(tmp_path):
    """`chip_smoke.score_symbol` at `_SCORE`, checkpointed with weights
    from a seed (uniform in +-0.1); returns (prefix, data, label) with 9
    sentences of token ids."""
    import mxnet_tpu_torch as mx

    with mx.context.scope(mx.cpu()):
        sym = score_symbol(mx, **_SCORE)
        n, t = 9, _SCORE["seq"]
        shapes = sym.infer_shape(data=(1, t), label=(1, t))[0]
        rng = np.random.RandomState(3)
        params = {k: mx.nd.array(rng.uniform(-0.1, 0.1, s))
                  for k, s in zip(sym.list_arguments(), shapes)
                  if k not in ("data", "label")}
        prefix = str(tmp_path / "score")
        mx.model.save_checkpoint(prefix, 0, sym, params, {})
    data = rng.randint(0, _SCORE["vocab"], (n, t)).astype(np.int32)
    label = rng.randint(0, _SCORE["vocab"], (n, t)).astype(np.int32)
    return prefix, data, label


@pytest.mark.cuda
def test_scoring_lm_served_on_card_matches_cpu_predictor(tmp_path):
    """Served on the card (max_batch 8: buckets 1, 2, 4, 8, warmed), one
    request of 1, 3 and 5 sentences each: every reply equals a `Predictor`
    on the CPU (plain versions, TF32 off) within atol 1e-3; lstm_infer
    launches 2 a warmed bucket and 2 a dispatched batch, lstm_fwd and
    lstm_bwd never; the buckets bind one copy of the weights."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.serving import ModelRepository

    prefix, data, label = _score_artifact(tmp_path)
    shapes = {"data": (_SCORE["seq"],), "label": (_SCORE["seq"],)}
    dtypes = {"data": "int32", "label": "int32"}
    kernels = ("lstm_infer", "lstm_fwd", "lstm_bwd")
    before = {k: getattr(tpk, k).launches for k in kernels}
    repo = ModelRepository()
    model = repo.load("score", prefix, input_shapes=shapes,
                      input_dtypes=dtypes, max_batch=8, ctx=mx.gpu(0))
    try:
        assert {k: getattr(tpk, k).launches - before[k]
                for k in kernels} == {"lstm_infer": 2 * 4, "lstm_fwd": 0,
                                      "lstm_bwd": 0}
        preds = model._runner.predictors
        for b in (1, 2, 4):
            for k in ("embed_weight", "lstm_parameters", "pred_weight",
                      "pred_bias"):
                assert preds[b]._args[k]._data.data_ptr() == \
                    preds[8]._args[k]._data.data_ptr()
                assert preds[b]._args[k]._data.is_cuda
        cpu = Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                        ctx=mx.cpu(), input_dtypes=dtypes,
                        input_shapes={k: (len(data), _SCORE["seq"])
                                      for k in shapes})
        want = cpu.forward(data=data, label=label).get_output(0).asnumpy()
        start = 0
        for i, n in enumerate((1, 3, 5)):
            mid = {k: getattr(tpk, k).launches for k in kernels}
            (got,) = model.predict({"data": data[start:start + n],
                                    "label": label[start:start + n]})
            assert {k: getattr(tpk, k).launches - mid[k]
                    for k in kernels} == {"lstm_infer": 2, "lstm_fwd": 0,
                                          "lstm_bwd": 0}
            assert got.shape == (n, _SCORE["seq"])
            np.testing.assert_allclose(got, want[start:start + n], rtol=0,
                                       atol=1e-3)
            start += n
    finally:
        repo.unload("score", timeout=30)


@pytest.mark.cuda
def test_bound_graph_no_input_ops_on_card():
    """``_zeros``, ``_ones``, ``_arange`` and ``_full`` in a graph bound on
    the card make their outputs there (they took torch's default device,
    the CPU)."""
    _need_card()
    import mxnet_tpu_torch as mx

    data = mx.sym.var("data")
    graph = mx.sym.Group([
        data + mx.sym.zeros((2, 3)), data * mx.sym.ones((2, 3)),
        mx.sym.broadcast_add(data, mx.sym.arange(3)),
        data + mx.sym._full(shape=(2, 3), value=1.5)])
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    exe = graph.bind(mx.gpu(0), {"data": mx.nd.array(x, ctx=mx.gpu(0))},
                     grad_req="null")
    outs = [o.asnumpy() for o in exe.forward(is_train=False)]
    for got, want in zip(outs, (x, x, x + np.arange(3), x + 1.5)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# mx.rtc: CUDA C++ compiled at run time by NVRTC, launched on mx.nd arrays.
# The kernels, their plain versions and the softmax tolerance are the
# smoke's (`chip_smoke.py`), so the two cannot drift apart.

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RTC_CASES))
def test_rtc_jax_test_kernels_on_card(name):
    """The JAX RTC tests' kernels, as CUDA C++: the same values, the
    outputs written in place and returned as the same objects, and one
    NVRTC compile however often the kernel launches."""
    _need_card()
    case = RTC_CASES[name]
    dev = torch.device("cuda", 0)
    args = [nd.array(v, ctx=dev, dtype=v.dtype) if isinstance(v, np.ndarray)
            else v for v in case["inputs"]()]
    want = case["plain"](*[torch.from_numpy(v) if isinstance(v, np.ndarray)
                           else v for v in case["inputs"]()])
    compiles = rtc._driver().compiles
    module = rtc.CudaModule(case["source"])
    assert rtc._driver().compiles == compiles + 1
    func = module.get_kernel(name, case["signature"])
    before = rtc.CudaKernel.launches
    for _ in range(case["launches"]):
        outs = func.launch(args, dev, case["grid"], case["block"])
    assert rtc._driver().compiles == compiles + 1
    assert rtc.CudaKernel.launches == before + case["launches"]
    out = [a for a in args if isinstance(a, nd.NDArray)][-1]
    assert len(outs) == 1 and outs[0] is out
    np.testing.assert_array_equal(out.wait_to_read().asnumpy(),
                                  want.numpy())


@pytest.mark.cuda
def test_rtc_templated_exports_on_card():
    """The reference's templated example: one source, two instantiations
    fetched by their C++ names (NVRTC's lowered names)."""
    _need_card()
    module = rtc.CudaModule(RTC_TEMPLATED_AXPY,
                            exports=["axpy<float>", "axpy<double>"])
    dev = torch.device("cuda", 0)
    for ct, dt in (("float", "float32"), ("double", "float64")):
        f = module.get_kernel("axpy<%s>" % ct,
                              "const %s *x, %s *y, %s alpha" % (ct, ct, ct))
        x = nd.array(np.arange(8), ctx=dev, dtype=dt)
        y = nd.ones((8,), ctx=dev, dtype=dt)
        f.launch([x, y, 0.5], dev, (2,), (4,))
        assert y.dtype == dt
        np.testing.assert_array_equal(y.asnumpy(), 1 + 0.5 * np.arange(8))
    with pytest.raises(MXNetError, match="not exported"):
        module.get_kernel("axpy<int>", "const int *x, int *y, int alpha")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n", [(5, 3000), (4, 30522)])
def test_rtc_softmax_matches_plain_on_card(dtype, rows, n):
    """Row softmax forward and backward over (rows, n) against the plain
    versions within the smoke's tolerance (`chip_smoke.rtc_close`); a
    30522-wide f32 row stages 122,088 bytes of dynamic shared memory
    (above 48 KB: the function's limit is raised first). Two runs give the
    same bits."""
    _need_card()
    module = rtc.CudaModule(RTC_SOFTMAX, exports=RTC_SOFTMAX_EXPORTS)
    kern = rtc_kernels(module, "float" if dtype == "float32"
                       else "__nv_bfloat16")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(rows)
    x = nd.array(rng.randn(rows, n) * 3, ctx=dev, dtype=dtype)
    dy = nd.array(rng.randn(rows, n), ctx=dev, dtype=dtype)
    runs = []
    for _ in range(2):
        y, dx = nd.zeros((rows, n), dev, dtype), nd.zeros((rows, n), dev,
                                                          dtype)
        for which in ("fwd", "bwd"):
            rtc_softmax(kern, which, x, dy, y, dx)
        runs.append((y._data.clone(), dx._data.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    y, dx = runs[0]
    for which, got, want in (("fwd", y, softmax_plain(torch, x._data)),
                             ("bwd", dx, softmax_bwd_plain(y, dy._data))):
        scale = rtc_scale(which, want, y, dy._data)
        rtc_close(torch, got, want, scale, dtype, which)
        rtc_planted_faults(torch, got, want, scale, dtype, which)


@pytest.mark.cuda
def test_rtc_half_and_bfloat16_kernels_on_card():
    """``cuda_fp16.h`` and ``cuda_bf16.h`` resolve under NVRTC, and 16-bit
    scalars pass as their bits."""
    _need_card()
    module = rtc.CudaModule(r"""
#include <cuda_fp16.h>
#include <cuda_bf16.h>
extern "C" __global__ void hscale(const __half *x, __half *y, __half s) {
    y[threadIdx.x] = __hmul(x[threadIdx.x], s);
}
extern "C" __global__ void bscale(const __nv_bfloat16 *x, __nv_bfloat16 *y,
                                  __nv_bfloat16 s) {
    y[threadIdx.x] = __float2bfloat16(__bfloat162float(x[threadIdx.x])
                                      * __bfloat162float(s));
}""")
    dev = torch.device("cuda", 0)
    for name, ct, dt in (("hscale", "__half", "float16"),
                         ("bscale", "__nv_bfloat16", "bfloat16")):
        f = module.get_kernel(name, "const %s *x, %s *y, %s s" % (ct, ct, ct))
        x = nd.array(np.linspace(-2, 2, 16), ctx=dev, dtype=dt)
        y = nd.zeros((16,), ctx=dev, dtype=dt)
        f.launch([x, y, -1.5], dev, (1,), (16,))
        want = (x._data.float() * -1.5).to(y._data.dtype)
        assert torch.equal(y._data, want), name


@pytest.mark.cuda
def test_rtc_errors_on_card():
    """A syntax error raises with NVRTC's log; an unknown kernel, a CPU
    ctx, an array off the ctx, a numpy array for a pointer and a refused
    launch raise too."""
    _need_card()
    with pytest.raises(MXNetError, match="failed to compile(.|\n)*error"):
        rtc.CudaModule('extern "C" __global__ void broken(float *y) {')
    module = rtc.CudaModule(RTC_CASES["inc"]["source"])
    with pytest.raises(MXNetError, match="not defined"):
        module.get_kernel("missing", "float *y")
    f = module.get_kernel("inc", "float *y")
    dev = torch.device("cuda", 0)
    with pytest.raises(MXNetError, match="no CPU path"):
        f.launch([nd.zeros((4,), ctx="cpu")], "cpu", (1,), (4,))
    with pytest.raises(MXNetError, match="not on the launch's ctx"):
        f.launch([nd.zeros((4,), ctx="cpu")], dev, (1,), (4,))
    with pytest.raises(MXNetError, match="takes an NDArray"):
        f.launch([np.zeros(4, np.float32)], dev, (1,), (4,))
    with pytest.raises(MXNetError, match="cuLaunchKernel"):
        f.launch([nd.zeros((4,), ctx=dev)], dev, (1,), (2048,))


@pytest.mark.cuda
def test_rtc_launch_from_a_fresh_thread():
    """A thread that never touched the card launches: the driver context
    is made current there."""
    _need_card()
    case = RTC_CASES["axpy"]
    func = rtc.CudaModule(case["source"]).get_kernel("axpy",
                                                     case["signature"])
    dev = torch.device("cuda", 0)
    x, y = nd.ones((10,), ctx=dev), nd.zeros((10,), ctx=dev)
    errors = []

    def run():
        try:
            func.launch([x, y, 3.0], dev, (1,), (10,))
            y.wait_to_read()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(y.asnumpy(), np.full(10, 3.0))


@pytest.mark.cuda
def test_rtc_launches_on_the_current_torch_stream():
    """A torch op queued after a launch reads its output without a sync:
    the kernel (which spins about 10 ms before it writes) runs on the
    current stream, here a side stream."""
    _need_card()
    func = rtc.CudaModule(r"""
extern "C" __global__ void slow_fill(float *y, float v, long long cycles) {
    long long t0 = clock64();
    while (clock64() - t0 < cycles) {}
    y[threadIdx.x] = v;
}""").get_kernel("slow_fill", "float *y, float v, int64_t cycles")
    dev = torch.device("cuda", 0)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        y = nd.zeros((32,), ctx=dev)
        func.launch([y, 2.0, 20_000_000], dev, (1,), (32,))
        total = y._data.sum()
    side.synchronize()
    assert total.item() == 64.0


@pytest.mark.cuda
def test_nd_on_card_matches_cpu(tmp_path):
    """mx.nd creation, arithmetic, indexing, reductions and save/load on
    the card give the CPU's values; a file saved from the card loads on
    the CPU."""
    _need_card()
    rng = np.random.RandomState(0)
    a, b = rng.randn(4, 5).astype(np.float32), rng.randn(4, 5)
    res = {}
    for ctx in ("cpu", "cuda"):
        x, y = nd.array(a, ctx=ctx), nd.array(b, ctx=ctx)
        z = (x * 2 + y) / 3 - 1
        z += nd.ones((4, 5), ctx=ctx)
        z[1] = 0.5
        res[ctx] = [z, nd.dot(x, y.T), nd.softmax(x), x.argmax(axis=1),
                    nd.arange(0, 6, ctx=ctx).reshape((2, 3)), x.sum(axis=0),
                    nd.array(np.arange(6), ctx=ctx, dtype="int32") + 0.7]
        assert res[ctx][0].context == mx_context.Context(ctx)
    for c, g in zip(res["cpu"], res["cuda"]):
        assert c.dtype == g.dtype and c.shape == g.shape
        np.testing.assert_allclose(g.asnumpy(), c.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    path = str(tmp_path / "card.params")
    nd.save(path, {"z": res["cuda"][0], "i": res["cuda"][-1]})
    back = nd.load(path, ctx="cpu")
    np.testing.assert_array_equal(back["z"].asnumpy(),
                                  res["cuda"][0].asnumpy())
    assert back["i"].dtype == np.int32


class _OverwritingIter:
    """Yields the same numpy buffer every time, overwritten with batch i's
    values on the i-th ``next()``: a prefetcher that lets a copy read the
    buffer after its producer asked for the next batch delivers the wrong
    values."""

    def __init__(self, n, shape):
        self._n = n
        self._i = 0
        self._buf = np.empty(shape, np.float32)
        self._label = np.empty(shape[:1], np.float32)

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        self._buf[...] = self._i
        self._buf.reshape(-1)[::7] = -self._i   # not one constant
        self._label[...] = self._i
        self._i += 1
        return [self._buf, self._label]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_device_prefetcher_copies_before_the_source_is_overwritten(depth):
    """Every batch arrives on the card with its own values, though its
    source buffer is overwritten as soon as the next one is asked for and
    the consumer's stream is kept busy (a long sleep kernel) while copies
    queue up behind it."""
    _need_card()
    from mxnet_tpu_torch.data import DevicePrefetcher

    before = set(threading.enumerate())
    n, shape = 12, (64, 3, 224, 224)   # 38.5 MB a batch
    want = np.empty(shape, np.float32)
    pf = DevicePrefetcher(_OverwritingIter(n, shape), depth=depth,
                          mesh="cuda")
    got = 0
    try:
        for i, (x, y) in enumerate(pf):
            assert x.is_cuda and y.is_cuda
            torch.cuda._sleep(20_000_000)   # ~10 ms of busy stream
            want[...] = i
            want.reshape(-1)[::7] = -i
            assert torch.equal(x.cpu(), torch.from_numpy(want)), i
            assert torch.equal(y.cpu(), torch.full(shape[:1], float(i))), i
            got += 1
    finally:
        pf.close()
    assert got == n
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("mxtpu-") and t not in before]


@pytest.mark.cuda
def test_image_ops_and_transforms_on_card_match_cpu():
    """`mx.nd.image` ops and the DataLoader's transforms give the CPU's
    bits on the card (to_tensor and normalize divide by tensors, never by
    a Python number, which CUDA turns into a reciprocal multiply); resize
    within one uint8 level, and 1e-4 in float, of the CPU."""
    _need_card()
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    out = {}
    for ctx in ("cpu", "cuda"):
        x = nd.array(img, ctx=ctx, dtype="uint8")
        t = nd.image.to_tensor(x)
        chain = T.Compose([T.CenterCrop(32), T.ToTensor(),
                           T.Normalize(mean, std)])
        out[ctx] = [t, nd.image.normalize(t, mean=mean, std=std), chain(x),
                    nd.image.resize(x, size=(20, 30)),
                    nd.image.resize(t.transpose((1, 2, 0)), size=(80, 60))]
    for k, (c, g) in enumerate(zip(out["cpu"], out["cuda"])):
        if k < 3:
            np.testing.assert_array_equal(g.asnumpy(), c.asnumpy())
        else:
            np.testing.assert_allclose(g.asnumpy().astype(np.float32),
                                       c.asnumpy().astype(np.float32),
                                       atol=1 if k == 3 else 1e-4)


# ---------------------------------------------------------------------------
# the vision slice: its ops, the ResNet v2 input BatchNorm and an Inception
# block through the epilogue kernels, each on the card against the CPU
# ---------------------------------------------------------------------------

_VISION_OPS = [
    ("Pooling", [(2, 9, 9, 5)], dict(kernel=(3, 3), stride=(2, 2),
                                     pool_type="avg",
                                     pooling_convention="full",
                                     layout="NHWC")),
    ("Pooling", [(2, 8, 8, 5)], dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                     pool_type="avg", layout="NHWC")),
    ("Pooling", [(2, 3, 8, 8)], dict(kernel=(2, 2), stride=(2, 2),
                                     pool_type="lp", p_value=2)),
    ("Pooling", [(2, 6, 9)], dict(global_pool=True, pool_type="max")),
    ("Convolution", [(1, 5, 6, 7, 4), (6, 3, 2, 3, 2)],
     dict(kernel=(3, 2, 3), num_group=2, layout="NDHWC")),
    ("Deconvolution", [(2, 5, 6, 4), (4, 3, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), num_group=2, layout="NHWC")),
    ("LeakyReLU", [(2, 3, 4)], dict(act_type="elu", slope=0.7)),
    ("UpSampling", [(2, 3, 4, 5)], dict(scale=3, sample_type="bilinear")),
    ("Correlation", [(1, 2, 9, 9), (1, 2, 9, 9)],
     dict(kernel_size=3, max_displacement=2, stride2=2, pad_size=2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shapes,attrs", _VISION_OPS)
def test_vision_ops_on_card_match_cpu(name, shapes, attrs):
    """The slice's pooling, convolution and transposed-convolution cases
    and a few of its registrations, forward and the gradient of every
    input, on the card (cuDNN, TF32 off) against the CPU: rtol 1e-4 with a
    floor of 1e-4 x max|CPU value|."""
    _need_card()
    from mxnet_tpu_torch import ops as tops

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(len(shapes))
    arrays = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    results = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for a in arrays]
        out = tops.get(name).fn(*leaves, **attrs)
        ct = torch.from_numpy(np.random.RandomState(9).standard_normal(
            tuple(out.shape)).astype(np.float32)).to(dev)
        grads = torch.autograd.grad(out, leaves, ct)
        results[dev] = [out.detach().cpu()] + [g.cpu() for g in grads]
    for got, want in zip(results["cuda"], results["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_v2_input_batchnorm_runs_the_kernels_on_card(dtype):
    """BatchNorm(scale=False, center=False) over an NHWC image's 3
    channels in training mode: the kernels' scalar path, a gamma of 1 and
    a beta of 0 with no parameter behind them; output, moving statistics
    and the input's gradient against the CPU's plain version (f32: rtol
    1e-4; bf16: 2^-7, one rounding step), and each forward kernel
    launched once, the backward pair once."""
    _need_card()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2.0 ** -7
    x = np.random.RandomState(3).uniform(0, 255, (4, 32, 32, 3)).astype(
        np.float32)
    ct = np.random.RandomState(4).standard_normal(x.shape).astype(
        np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        with tnn.layout_scope():
            bn = tnn.BatchNorm(scale=False, center=False, in_channels=3,
                               device=dev)
        bn.train()
        xt = torch.from_numpy(x).to(dev).to(tdt).requires_grad_()
        before = {k: getattr(tpk, k).launches for k in
                  ("epi_stats", "epi_apply", "epi_bwd_reduce", "epi_bwd_dx")}
        out = bn(xt)
        (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(ct).to(dev)
                                    .to(tdt))
        counts = {k: getattr(tpk, k).launches - v for k, v in
                  before.items()}
        assert counts == dict.fromkeys(counts, 1 if dev == "cuda" else 0)
        results[dev] = [out.detach().float().cpu(), dx.float().cpu(),
                        bn._held("running_mean").cpu(),
                        bn._held("running_var").cpu()]
    for i, (got, want) in enumerate(zip(results["cuda"], results["cpu"])):
        t = 1e-4 if i >= 2 else tol
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=t,
                                   atol=t * float(want.abs().max()))


@pytest.mark.cuda
def test_inception_block_trains_through_the_kernels_on_card():
    """Inception's A block (NHWC, f32, batch 2, 35 x 35 x 192) in training
    mode on the card and on the CPU from the same weights: the output and
    the moving statistics agree (rtol 1e-4, floor 1e-4 x max|CPU value|),
    and each epilogue kernel launches once a BatchNorm (7) in the forward
    and the backward."""
    _need_card()
    from mxnet_tpu_torch.gluon.model_zoo.vision import inception

    torch.backends.cudnn.allow_tf32 = False
    x = np.random.RandomState(5).uniform(-1, 1, (2, 35, 35, 192)).astype(
        np.float32)
    nets, outs = {}, {}
    for dev in ("cpu", "cuda"):
        with tnn.layout_scope():
            net = inception._make_A(32, "A1_")
        net.initialize(ctx=dev, seed=0)
        net.eval()
        with torch.no_grad():
            net(torch.zeros(1, 35, 35, 192, device=dev))
        nets[dev] = net
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    for dev, net in nets.items():
        net.train()
        before = {k: getattr(tpk, k).launches for k in
                  ("epi_stats", "epi_apply", "epi_bwd_reduce", "epi_bwd_dx")}
        out = net(torch.from_numpy(x).to(dev))
        out.float().square().mean().backward()
        counts = {k: getattr(tpk, k).launches - v for k, v in
                  before.items()}
        assert counts == dict.fromkeys(counts, 7 if dev == "cuda" else 0)
        outs[dev] = out.detach().cpu()
    np.testing.assert_allclose(outs["cuda"].numpy(), outs["cpu"].numpy(),
                               rtol=1e-4,
                               atol=1e-4 * float(outs["cpu"].abs().max()))
    want = nets["cpu"].state_dict()
    for k, v in nets["cuda"].state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                v.cpu().numpy(), want[k].numpy(), rtol=1e-4,
                atol=1e-4 * float(want[k].abs().max()), err_msg=k)


@pytest.mark.cuda
def test_ctc_op_on_card_matches_cpu():
    _need_card()
    from chip_smoke import check_ctc_op

    assert len(check_ctc_op(torch, 5)) == 2


@pytest.mark.cuda
def test_random_linalg_control_flow_on_card():
    _need_card()
    import mxnet_tpu_torch as mx
    from chip_smoke import (CONTROL_FLOW_TOL, LINALG_RTOL, check_random,
                            compare_runs, control_flow_run, linalg_run,
                            spatial_run)

    report = check_random(mx, mx.gpu(0), 1 << 16, 7)
    assert len(report) == 19
    compare_runs("spatial", spatial_run(torch, "cuda", 1),
                 spatial_run(torch, "cpu", 1), 1e-5)
    compare_runs("linalg", linalg_run(mx, mx.gpu(0), 1),
                 linalg_run(mx, mx.cpu(), 1), LINALG_RTOL)
    compare_runs("control flow", control_flow_run(mx, mx.gpu(0), 1),
                 control_flow_run(mx, mx.cpu(), 1), CONTROL_FLOW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nnz,dim", [(512, 16, 100_000),
                                          (64, 3, 7)])
def test_sparse_dot_and_backward_repeat_bit_for_bit_on_card(rows, nnz, dim):
    """``sparse.dot(csr, w)`` and its backward (the transposed product)
    sum in a fixed order: two card runs are equal bit for bit, and the card
    agrees with the CPU within 1e-5 of the largest magnitude."""
    _need_card()
    from chip_smoke import sparse_batches, sparse_dot_grad

    batch = sparse_batches(3, 1, rows=rows, nnz=nnz, dim=dim)[0]
    runs = [sparse_dot_grad(torch, dev, batch, dim)
            for dev in ("cuda", "cuda", "cpu")]
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.cuda
def test_sparse_linear_model_and_kvstore_on_card():
    """A few steps of the sparse linear model (row_sparse gradient, lazy
    AdaGrad, kv.push) twice on the card, equal bit for bit, and within the
    smoke's limits of the CPU; the local kvstore's calls on the card equal
    the CPU's bit for bit."""
    _need_card()
    from chip_smoke import (SPARSE_LOSS_TOL, SPARSE_W1_TOL, kvstore_run,
                            sparse_batches, sparse_linear_run)

    batches = sparse_batches(4, 6, rows=1024, nnz=16, dim=200_000)
    a, b, c = (sparse_linear_run(torch, dev, batches, dim=200_000)
               for dev in ("cuda", "cuda", "cpu"))
    assert torch.equal(a["losses"], b["losses"])
    assert np.array_equal(a["w"], b["w"])
    np.testing.assert_allclose(a["w1"], c["w1"], rtol=0,
                               atol=SPARSE_W1_TOL * np.abs(c["w1"]).max())
    np.testing.assert_allclose(a["losses"].numpy(), c["losses"].numpy(),
                               rtol=SPARSE_LOSS_TOL)
    card, cpu = kvstore_run(torch, "cuda", 5), kvstore_run(torch, "cpu", 5)
    for k in cpu:
        assert np.array_equal(card[k], cpu[k]), k


@pytest.mark.cuda
def test_scalar_ops_make_no_host_sync_on_card():
    """Queue 3 fault F4: ``x + 1.0`` and the other ``_*_scalar`` ops made
    their Python number a card tensor by a blocking host-to-device copy a
    call. With torch's sync debug mode set to error, none of them may
    synchronize. The correctly rounded ones (add, subtract, multiply,
    divide, mod, maximum, compare) equal the CPU's results bit for bit (a
    divide too: the divisor stays a card tensor, never a reciprocal); the
    two powers, whose CUDA and CPU libraries round differently, within
    1e-6."""
    _need_card()
    x_np = np.random.RandomState(0).uniform(0.5, 2.0, (64, 33)) \
        .astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        x = nd.array(x_np, ctx=dev)
        if dev == "cuda":
            nd.waitall()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = [x + 1.5, x - 0.25, 3.0 - x, x * 0.1, x / 7.0, 2.0 / x,
                   x % 0.3, nd.maximum(x, 1.0), (x > 1.0) * x,
                   x ** 1.7, 1.3 ** x]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs[dev] = [g.asnumpy() for g in got]
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if i < 9:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)


def _moe_case(seed, t=64, d=32, h=48, e=8):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=s).astype(np.float32) / np.sqrt(max(s[-2], 1))
            for s in ((t, d), (e, d), (e, d, h), (e, h, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5), (3, 2.0)])
def test_moe_ops_on_card_match_cpu(k, cf):
    """`topk_moe` (and `switch_moe` at k = 1): outputs, lb, z and every
    input's gradient on card tensors (TF32 off) against the CPU within
    1e-5 of each one's largest magnitude; the routing (a stable sort) is
    the CPU's."""
    _need_card()
    from mxnet_tpu_torch.ops import contrib as tc

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            args = [torch.from_numpy(a).to(dev).requires_grad_(True)
                    for a in _moe_case(k)]
            if k == 1:
                out, lb = tc.switch_moe(*args, capacity_factor=cf)
                z = lb
            else:
                out, lb, z = tc.topk_moe(*args, k=k, capacity_factor=cf)
            (out.square().sum() + lb + z).backward()
            res[dev] = [out, lb, z] + [a.grad for a in args]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for got, want in zip(res["cuda"], res["cpu"]):
        want = want.detach()
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got.detach().cpu() - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_moe_trainer_step_on_card_matches_cpu_without_host_sync():
    """A small MoE LM (`chip_smoke.moe_lm`'s structure) through
    `DistributedTrainer` over ``make_mesh([("dp", 1), ("ep", 1)])`` with a
    plain-callable loss: the step returns an `NDArray`; in f32 (TF32 off)
    its loss and parameters equal the CPU's within 1e-5; and with torch's
    sync debug mode set to error the bf16 step synchronizes nowhere."""
    _need_card()
    import chip_smoke
    import mxnet_tpu_torch as mx

    saved = (chip_smoke.MOE_VOCAB, chip_smoke.MOE_UNITS,
             chip_smoke.MOE_HIDDEN, chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ)
    chip_smoke.MOE_VOCAB, chip_smoke.MOE_UNITS, chip_smoke.MOE_HIDDEN = \
        500, 64, 128
    chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ = 4, 32
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, y = chip_smoke.moe_batches(5, 1)[0]
        nets, losses = {}, {}
        for dev in ("cpu", "cuda"):
            nets[dev] = chip_smoke.moe_lm(mx, torch.device(dev), 5)
            tr = DistributedTrainer(
                nets[dev], "adam", {"learning_rate": 0.1, "epsilon": 1e-2},
                loss=chip_smoke.moe_loss(mx),
                mesh=mx.parallel.make_mesh([("dp", 1), ("ep", 1)]))
            loss = tr.step(x, y)
            assert isinstance(loss, mx.nd.NDArray)
            losses[dev] = float(loss.asnumpy())
        assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * losses["cpu"]
        want = nets["cpu"].state_dict()
        for name, v in nets["cuda"].state_dict().items():
            scale = float(want[name].abs().max())
            assert float((v.cpu() - want[name]).abs().max()) <= 1e-5 * scale
        tr = DistributedTrainer(nets["cuda"], "adam",
                                {"learning_rate": 1e-4},
                                loss=chip_smoke.moe_loss(mx),
                                amp_dtype="bfloat16")
        xc, yc = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        tr.step(xc, yc)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.step(xc, yc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        (chip_smoke.MOE_VOCAB, chip_smoke.MOE_UNITS, chip_smoke.MOE_HIDDEN,
         chip_smoke.MOE_BATCH, chip_smoke.MOE_SEQ) = saved


@pytest.mark.cuda
def test_parameters_over_host_and_card_train_as_over_two_host_contexts():
    """An MLP's parameters over ``[cpu(0), gpu(0)]`` (a copy on the host and
    one on the card) trained through `gluon.Trainer` (split_and_load, a
    forward and backward a context, the gradients summed by the local
    store, SGD with momentum, 3 steps) equal the same run over ``[cpu(0),
    cpu(1)]``: f32 with TF32 off, within 1e-6 of each tensor's largest
    magnitude; each copy on its own device."""
    _need_card()
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(4)
    ws = [rng.uniform(-0.5, 0.5, s).astype(np.float32)
          for s in ((8, 5), (8,), (3, 8), (3,))]
    xs = rng.uniform(-1, 1, (3, 8, 5)).astype(np.float32)
    ys = rng.randint(0, 3, (3, 8)).astype(np.float32)

    def run(ctxs):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=5),
                mx.gluon.nn.Dense(3, in_units=8))
        net.initialize(ctx=ctxs)
        for p, w in zip(net.collect_params().values(), ws):
            p.set_data(mx.nd.array(w, ctx=mx.cpu()))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in zip(xs, ys):
            parts = mx.gluon.utils.split_and_load(
                mx.nd.array(x, ctx=mx.cpu()), ctxs)
            labels = mx.gluon.utils.split_and_load(
                mx.nd.array(y, ctx=mx.cpu()), ctxs)
            with mx.autograd.record():
                losses = [loss_fn(net(a), b) for a, b in zip(parts, labels)]
            mx.autograd.backward(losses)
            trainer.step(x.shape[0])
        return net

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = run([mx.cpu(0), mx.gpu(0)])
        host = run([mx.cpu(0), mx.cpu(1)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for (name, p), q in zip(card.collect_params().items(),
                            host.collect_params().values()):
        assert p.data(mx.gpu(0))._data.is_cuda
        for got, c in ((p.data(mx.cpu(0)), mx.cpu(0)),
                       (p.data(mx.gpu(0)), mx.cpu(1))):
            want = q.data(c).asnumpy()
            scale = max(float(np.abs(want).max()), 1e-6)
            assert float(np.abs(got.asnumpy() - want).max()) \
                <= 1e-6 * scale, name


# ---------------------------------------------------------------------------
# resilience: a DistributedTrainer checkpoint on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_resilience_resnet50_checkpoint_restores_bit_equal(tmp_path):
    """ResNet-50 v1 NHWC bf16 (fused epilogue) at 32 images: two steps,
    a `CheckpointManager` checkpoint of the parameters, buffers and
    momentum, then a third step; a fresh trainer from another seed
    restores the checkpoint and its third step gives the same loss and the
    same parameters, buffers and states bit for bit (cuDNN's deterministic
    algorithms)."""
    _need_card()
    from chip_smoke import deterministic, restore_flags, resilience_trainer
    from chip_smoke import trained_arrays
    from mxnet_tpu_torch.parallel.resilience import CheckpointManager

    prev = deterministic(torch)
    try:
        net, tr, x, y = resilience_trainer(torch, 0, batch=32)
        for _ in range(2):
            tr.step(x, y)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        path = mgr.save(tr.step_count, save_params=tr.save_params,
                        save_states=tr.save_states)
        assert mgr.latest() == (2, path)
        want_loss = tr.step(x, y)._data.clone()
        want = trained_arrays(net, tr, str(tmp_path))
        del net, tr
        net, tr = resilience_trainer(torch, 1, batch=32)[:2]
        header = mgr.restore(load_params=tr.load_params,
                             load_states=tr.load_states)
        assert header["step"] == 2 and tr.step_count == 2
        before = tpk.epi_stats.launches
        loss = tr.step(x, y)._data
        torch.cuda.synchronize()
        assert tpk.epi_stats.launches == before + 53
        assert torch.equal(loss, want_loss)
        got = trained_arrays(net, tr, str(tmp_path))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        restore_flags(torch, prev)


@pytest.mark.cuda
def test_interop_softmax_rtc_custom_op_matches_plain():
    """The interop phase's custom-op head (`chip_smoke.interop_register_head`:
    NVRTC kernels launched on the op's own arrays) against its plain NDArray
    version, forward and gradient, within 1e-5 of the output's scale; its
    forward sees its inputs on the card and launches rtc kernels."""
    _need_card()
    import mxnet_tpu_torch as mx
    from chip_smoke import interop_register_head

    dev = torch.device("cuda", 0)
    seen = interop_register_head(mx, dev)
    rng = np.random.RandomState(0)
    xv = rng.randn(32, 1000).astype(np.float32) * 3
    lv = rng.randint(0, 1000, 32).astype(np.float32)
    x = nd.array(xv, ctx=mx.gpu(0))
    label = nd.array(lv, ctx=mx.gpu(0))
    x.attach_grad()
    before = rtc.CudaKernel.launches
    with mx.autograd.record():
        y = nd.Custom(x, label, op_type="softmax_rtc")
    y.backward()
    torch.cuda.synchronize()
    assert seen["forward_on_card"] == 2          # the call and the recompute
    assert rtc.CudaKernel.launches - before == 3  # fwd, fwd, bwd
    want = nd.softmax(nd.array(xv, ctx=mx.gpu(0)), axis=-1).asnumpy()
    np.testing.assert_allclose(y.asnumpy(), want, rtol=1e-5, atol=1e-5)
    gwant = want.copy()
    gwant[np.arange(32), lv.astype(np.int64)] -= 1.0
    np.testing.assert_allclose(x.grad.asnumpy(), gwant, rtol=1e-5,
                               atol=1e-5)
    assert x.grad.context == mx.gpu(0)


@pytest.mark.cuda
def test_interop_onnx_resnet18_on_card_matches_gluon(tmp_path):
    """A resnet18_v1 on the card, exported to ONNX and imported back, bound
    on ``mx.gpu(0)``: its eval logits are the gluon net's within rtol
    1e-4 / atol 1e-4 (the JAX ONNX test's tolerances), TF32 off."""
    _need_card()
    import mxnet_tpu_torch as mx
    from chip_smoke import deterministic, restore_flags
    from mxnet_tpu_torch.contrib import onnx

    prev = deterministic(torch)
    try:
        mx.random.seed(3)
        net = tresnet.resnet18_v1()
        net.initialize(mx.init.Xavier())
        x = nd.array(np.random.RandomState(1).uniform(
            -1, 1, (4, 3, 64, 64)).astype(np.float32), ctx=mx.gpu(0))
        want = net(x).asnumpy()
        path = str(tmp_path / "r18.onnx")
        onnx.export_model(net(mx.sym.var("data")),
                          {k: v.data() for k, v in
                           net.collect_params().items()},
                          (4, 3, 64, 64), onnx_file_path=path)
        sym, args, auxs = onnx.import_model(path)
        assert all(a.context == mx.gpu(0) for a in args.values())
        got = sym.bind(mx.gpu(0), args={**args, "data": x},
                       grad_req="null", aux_states=auxs).forward(
            is_train=False)[0].asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    finally:
        restore_flags(torch, prev)
