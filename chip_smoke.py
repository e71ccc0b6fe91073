#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`mxnet_tpu_torch`) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
the CUDA toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py [--seed N] [--requests N] [--profile]
                          [--details PATH]

Phases; each raises on failure, and the script then exits non-zero:

1. setup: the card's name and power limit (``nvidia-smi``); every kernel
   the port has, built from ``mxnet_tpu_torch/csrc`` with ``nvcc`` for
   sm_90a, one ``nvcc`` per source, all started together.
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   same card tensors, at the main paths' shapes, with the kernel's time
   (CUDA events, the 50 MB L2 flushed and the card kept busy for about 1 ms
   before every launch, so the host's enqueue latency stays out), the plain
   version's time, the time of one PyTorch call computing the same
   function where there is one, and the least time the card could take
   (bytes over 3.35 TB/s, or FLOPs over 67 TFLOP/s f32 or 989 TFLOP/s
   bf16); first the timing floor, a zero_ of 16 floats timed the same way,
   which every kernel time includes. The paged attention kernel at the decode step's shapes (f32 and
   bf16 pages; B = 32 ragged, B = 1 and 4 full-length, which it splits
   over a thread-block cluster; bf16 at head dims 20 and 40), each run
   twice and compared bit for bit; the
   four conv-epilogue kernels at ResNet-50's BatchNorm shapes at batch
   128, 224 x 224, and at the vision path's extremes (Inception v3's
   (2,765,952, 64) and (8,192, 448), ResNet v2's input BatchNorm (6,422,528,
   3) without gamma or beta), in bf16 and f32, with and without ReLU and
   residual, and two runs of each reduction compared bit for bit. ``--details`` writes every conv-epilogue
   case to a JSON file. The three flash-attention kernels at BERT-base's
   attention at batch 8 ((8 x 12, 512, 64), bf16 and f32), causal and not,
   and at ragged, other-head-dim and one-row shapes, each run twice and
   compared bit for bit; `scaled_dot_product_attention` is their
   yardstick; and the flash autograd Function against autograd through
   the plain attention. The three LSTM kernels (infer, forward, backward)
   at the word LM's layer (T 35, B 32, H 650, nonzero h0 and c0) and at
   ragged, one-step and width-200 shapes and the shapes the forward's
   tensor-core tiling can get wrong (B 17 and 64, H 1500, odd H with B >
   16) and shapes whose block cannot hold all of h (B 128, H 1500 at B
   32: the streamed forward; f32 B 128 and bf16 H 1500 B 32 also take the
   streamed backward, the rest the backward's thread-block clusters) and a
   layer whose cluster units do not divide H, bf16 and f32, each run twice
   and compared bit for bit (a shape too large for a block must be
   refused, by all three); the bf16 forward and clustered backward kernels
   must hold HMMA instructions and no LSTM kernel may spill registers;
   cuDNN's LSTM layer is their yardstick, and one grid barrier
   (``lstm_barrier_probe``; for the backward, its own launch's,
   ``lstm_cluster_probe``, which also times a cluster barrier) times T
   gives each its sequential floor, with each kernel's µs a step beside
   one barrier's; and `lstm_layer` (the autograd Function) against
   autograd through the plain step loop.
   Then ``mx.rtc`` on ``mx.nd`` arrays: every module compiled by NVRTC
   for sm_90a (seconds each); with the RTC launch count set to 0, the
   JAX package's RTC test kernels in CUDA form (axpy, scale, inc launched
   three times with one compile, addk in int32) with their values and
   outputs written in place, the reference's templated axpy fetched by
   its exported names, and a row softmax forward and backward over BERT-
   base's MLM logits (8 x 512 tokens x 30,522 words, one block a row, the
   row in 122,088 bytes of dynamic shared memory) in f32 and bf16, each
   case synchronised and checked; then those kernels against their plain
   versions (f32 within 1e-6, bf16 within one rounding step beyond that,
   two runs bit for bit) with kernel, plain and library (`torch.softmax`
   and its backward) times, and the host time of one launch beside
   `add_`'s.
3. serve: a TransformerLM at BERT-base width (12 x 768, 12 heads, vocab
   30522; random weights from ``--seed``) written as a generation artifact,
   loaded through `ModelRepository` with the default serving geometry, and
   served by `ServingServer`: concurrent ``:generate`` requests over HTTP,
   mostly greedy, a few sampled. The paged-attention launch count is set
   to 0 just before the load and read after the last reply; two greedy
   replies are held against the full-sequence forward on the card.
4. train: ResNet-50 v1 (fused epilogue, NHWC, 1000 classes, Xavier
   weights from ``--seed``) trained by `DistributedTrainer` in bf16 over
   f32 master weights (SGD, momentum 0.9, wd 1e-4, lr 0.02) on one
   synthetic batch of 128 x 224 x 224 x 3, repeated: 3 warm-up steps, then
   the conv-epilogue launch counts set to 0 and 10 timed steps.
   Every loss must be finite and the last below the first, and each
   epilogue kernel must have launched 53 x steps times (53 BatchNorms).
   Prints images/s, MFU against 989 TFLOP/s bf16 and peak allocated
   bytes; ``--profile`` adds the device busy share and device time by
   kernel of two steps.
   Then train_rec: the same model and step fed from records. 1,664
   training and 250 validation images made from ``--seed`` (short side
   256, long side 256 to 341, smooth content plus noise, labels in [0,
   1000)) are written as PNG records by the port's `recordio` into a
   temporary directory. Data gate: `io.ImageRecordIter` over the
   validation records (center crop, no mirror, no shuffle, 8 threads)
   must give exactly the center crops of the images written, labels in
   record order, pad 6 on the last batch. Then `train_imagenet.main` on
   both files (ResNet-50 v1 NHWC bf16, the fused graph, batch 128, lr
   0.02, random crop and mirror, ImageNet mean and std, min(CPUs, 16)
   decode threads, `data.DevicePrefetcher` before the step, --top-k 5):
   every loss finite; with the counts set to 0 after 3 warm-up steps, each
   epilogue kernel launches 53 x 10 times in the 10 timed steps and never
   in the validation pass, which scores exactly 250 samples. Prints
   images/s beside the train phase's synthetic images/s, the share of the
   step time spent waiting in ``next()``, decode-only images/s at 1, 4 and
   min(CPUs, 16) threads, ``os.cpu_count()`` and peak allocated bytes
   (``--profile``: device busy time of the run). Then, with CUDA up,
   `gluon.data.DataLoader` over `ImageRecordDataset` (CenterCrop,
   ToTensor, Normalize) at 0 and 4 forked workers: equal batches, within
   1e-6 of the iterator's normalized crops, no worker process left; prints
   images/s of each.
   Then train_vision: Inception v3 built by `train_imagenet.build_network`
   (NHWC, 1000 classes, Xavier from ``--seed``) and trained by
   `DistributedTrainer` in bf16 over f32 masters (SGD lr 0.02, momentum
   0.9, wd 1e-4) on one synthetic batch of 128 x 299 x 299 x 3: 3 warm-up
   steps, then the epilogue counts set to 0 and 10 timed steps; every
   loss finite and the last below the first, each epilogue kernel 94 x
   10 launches. Prints images/s, ms a step, MFU against 989 TFLOP/s with
   bench.py's 3 x 11.46e9 FLOPs an image and the forward hooks' count,
   peak allocated bytes (``--profile``: the device busy share and its
   groups). Then AlexNet, VGG-16-BN, SqueezeNet 1.1, DenseNet-121,
   MobileNet v1 and v2 and ResNet-50 v2 at full width, batch 32 at 224 x
   224, 2 steps each: losses finite, the forward kernels a BatchNorm x 2
   launches and the backward pair a BatchNorm whose backward runs x 2
   (not ResNet v2's input BatchNorm, whose gamma, beta and input take no
   gradient); ms a step and peak bytes (``--profile``: DenseNet's and
   the MobileNets' busy share and groups, depthwise convolutions apart).
   Then BERT-base pretraining as bench.py's ``bench_bert`` drives it:
   `bert_12_768_12` (no dropout) + an MLM Dense(30522) head, 132,953,658
   parameters, Xavier from ``--seed``, Adam lr 1e-4, bf16 over f32
   masters, one synthetic batch of 8 x 512 tokens repeated: 3 warm-up
   steps, then the flash launch counts set to 0 and 10 timed steps. The
   loss must be finite and fall, and each flash kernel launch 12 x steps
   times. Prints tokens/s, ms a step, MFU by bench.py's FLOP count and
   peak allocated bytes; ``--profile`` adds the device busy share and
   device time by group (flash, GEMM, LayerNorm, optimizer, rest).
   Then the word LM as bench.py's ``bench_lstm`` drives it:
   RNNModel(10000, 650, 650, 2 layers, dropout 0), 19,780,400
   parameters, Xavier from ``--seed``, SGD lr 1.0, bf16 over f32 masters,
   one synthetic batch of 35 x 32 tokens repeated: 3 warm-up steps, then
   the LSTM launch counts set to 0 and 10 timed steps. The loss must be
   finite and fall, lstm_fwd and lstm_bwd launch 2 x steps times and
   lstm_infer never. Prints tokens/s, ms a step, MFU by bench.py's FLOP
   count and peak allocated bytes; ``--profile`` adds the device busy
   share and device time by group (LSTM, GEMM, loss, optimizer, rest).
   Then its evaluation: the trained model under no_grad over 4
   consecutive windows with the state carried; lstm_infer launches 2 x 4
   times and nothing else; the perplexity is finite, and the logits and
   final state equal a CPU run's of the same model and windows.
   Then the same model through the Gluon façade, as the JAX package's
   examples/rnn/word_lm.py loop drives it (`train_word_lm.train_epoch`):
   RNNModel(10000, 650, 650, 2 layers, dropout 0) built and initialised
   (Xavier from ``--seed``, on the card) through `gluon`,
   `gluon.Trainer` SGD lr 1.0, f32, truncated BPTT over a corpus made from
   the seed in which each token has 4 successors, 35 x 32 tokens a window,
   the state detached and carried, a loss a token and the gradients'
   global norm clipped at 0.25 x 35 x 32 as the reference's word_lm
   ``train()``: 2 warm-up windows, then the LSTM launch counts set to 0
   and 10 timed windows of ``record()`` / ``backward()`` /
   ``trainer.step``. Every loss must be finite and the last below the
   first; lstm_fwd and lstm_bwd launch 2 x 10 times and lstm_infer never.
   Then 4 windows of ``net(x, state)`` outside ``record()``: lstm_infer
   launches 2 x 4 times and the training kernels never, and
   `metric.Perplexity` is finite. Prints tokens/s, ms a window and peak
   allocated bytes; ``--profile`` adds the device busy share.
5. parity: one f32 step of a small ResNet (2 bottleneck stages), one f32
   Adam step of bert_mini + an MLM head, and one f32 SGD step of a small
   word LM (vocab 1000, 2 x 650 units, 12 x 8 tokens), on the card
   (kernels, TF32 off) against the same step on the CPU (plain versions)
   from the same weights and batch: loss and every updated parameter and
   running statistic, after the step and as the change the step made.
   Then Inception v3 (batch 2, 299 x 299), DenseNet-121 and MobileNet v2
   (batch 2, 224 x 224), f32: one trainer step's loss on the card and on
   the CPU within rtol 1e-4, then every layer of the card's training
   forward and backward (each Conv2D, BatchNorm, Dense, pool and
   activation) recomputed on the CPU from the inputs, weights and output
   cotangent the card gave it: output, input gradient, parameter
   gradients and moving statistics within rtol 1e-4 over floors of the
   sums of their terms (a whole step cannot be compared element by
   element across devices: ReLUs flip on a rounding apart).
   Then the same small word LM's step through the Gluon façade
   (``record()``, ``backward()``, ``gluon.Trainer`` SGD) on the card and
   on the CPU: the loss, every ``Parameter.grad()`` and every updated
   parameter, at the word-LM step's tolerance. Then one f32 symbolic step
   (``Module`` ``forward_backward`` and SGD ``update``) of a small
   FusedRNNCell LM (the LSTM kernels) and of a conv -> BatchNorm ->
   Pooling -> FC net (BatchNorm's conv-epilogue kernels) on the card
   against the CPU: every output, gradient, argument and aux state within
   rtol 1e-4.
6. symbolic (run before the parity phase): the word LM at the same width
   through ``mx.sym`` / ``mx.mod`` / ``mx.rnn``, as the reference's
   cudnn_lstm_bucketing.py builds it: a ``BucketingModule`` over
   Embedding(10000, 650) -> FusedRNNCell(650, 2 layers) (the ``RNN`` op,
   time-major) -> FullyConnected(10000) -> SoftmaxOutput, 19,780,400 f32
   parameters (Xavier and FusedRNN from ``--seed``), SGD lr 1.0 through
   ``Module.init_optimizer``, ``BucketSentenceIter`` batches of 32
   sentences from a chain where each token has 4 successors, buckets 10,
   20 and 35: ``fit`` over 2 warm-up batches, then the LSTM launch counts
   set to 0 and ``fit`` over 12 timed batches (perplexity finite and
   falling; lstm_fwd and lstm_bwd 2 x 12 launches, lstm_infer none); then
   ``score`` with ``Perplexity`` over 4 batches at bucket 35 (lstm_infer
   2 x 4, nothing else); then ``save_checkpoint`` and ``Module.load`` of
   the default bucket, whose outputs over those batches must equal the
   trained module's bit for bit. Prints tokens/s and ms a batch at bucket
   35 and over the fit, the score's tokens/s, perplexities and peak
   allocated bytes; ``--profile`` adds the device busy share of a bucket-35
   batch and its split (LSTM, GEMM, loss, optimizer, rest).
7. predict_serving (after the symbolic phase, before parity): that
   phase's checkpoint, as it was written, served as a scoring model
   (`score_symbol`: data (N, 35) int32 -> Embedding -> FusedRNNCell
   unrolled batch-major -> FullyConnected(10000, flatten=False) ->
   log_softmax -> pick(label): each token's log-likelihood) through
   ``ModelRepository.load`` on the card (max_batch 32: buckets 1 to 32,
   each a ``Predictor`` binding the prototype's weight tensors, warmed
   before publishing; the default 5 ms coalescing window) and
   ``ServingServer`` on a free port. With the LSTM launch counts set to 0
   just before the load: 32 sequential one-sentence ``:predict`` requests,
   256 from 32 concurrent clients, 64 of 1 to 4 sentences from 16 clients,
   then a SIGTERM with 32 requests in flight. Every request must answer
   200 with a CPU ``Predictor``'s log-likelihoods (plain versions) within
   atol 1e-3; lstm_infer launches 2 x (batches dispatched + buckets
   warmed) and lstm_fwd / lstm_bwd never; the buckets share one copy of
   the weights (``data_ptr``); the drain completes. Prints requests/s and
   p50 / p99 latency of each part, the mean dispatched batch and the
   batches by size, load and warm seconds and peak allocated bytes;
   ``--profile`` adds the device busy share of a bucket-32 batch and its
   split (LSTM, GEMM, log-softmax and pick, rest). The LSTM kernel phase
   holds lstm_infer at the served shapes (35, B, 650), B 1 to 32, too.

``--profile`` also adds a `torch.profiler` breakdown of one decode step.
The last three lines of standard output are the card's name and power
limit, ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``. Without
a CUDA card, or without the package beside it, the script exits non-zero
and prints no result.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the
# tensor cores, dense bf16 in the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# every kernel of the port: wrapper, source, the TPU kernel it replaces
_EPI_SRC = "mxnet_tpu_torch/csrc/conv_epilogue.cu"
_FLASH_SRC = "mxnet_tpu_torch/csrc/flash_attention.cu"
_LSTM_SRC = "mxnet_tpu_torch/csrc/lstm.cu"
KERNELS = [
    {"name": "paged_attention", "route": "cuda",
     "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:1168"},
    {"name": "epi_stats", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:769"},
    {"name": "epi_apply", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:790"},
    {"name": "epi_bwd_reduce", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:807"},
    {"name": "epi_bwd_dx", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:840"},
    {"name": "flash_fwd", "route": "cuda", "source": _FLASH_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:57"},
    {"name": "flash_bwd_dq", "route": "cuda", "source": _FLASH_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:163"},
    {"name": "flash_bwd_dkv", "route": "cuda", "source": _FLASH_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:201"},
    {"name": "lstm_infer", "route": "cuda", "source": _LSTM_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:506"},
    {"name": "lstm_fwd", "route": "cuda", "source": _LSTM_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:429"},
    {"name": "lstm_bwd", "route": "cuda", "source": _LSTM_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:463"},
    {"name": "rtc", "route": "nvrtc", "source": "mxnet_tpu_torch/rtc.py",
     "replaces": "mxnet_tpu/rtc.py:198"},
]
SERVE_KERNELS = ["paged_attention"]
EPI_KERNELS = ["epi_stats", "epi_apply", "epi_bwd_reduce", "epi_bwd_dx"]
FLASH_KERNELS = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"]
LSTM_KERNELS = ["lstm_infer", "lstm_fwd", "lstm_bwd"]

# serving-path geometry of the paged-attention kernel: heads, head dim,
# tokens a page, pages in the pool, pages a sequence (64 + 128 tokens)
H, DH, PS, POOL, MAXP = 12, 64, 16, 256, 12


def log(*parts):
    print(*parts, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# cycles of the card's sleep before each timed call (about 1 ms): the card
# is still busy when the start event is enqueued, and the host enqueues the
# call meanwhile, so the time is the device's and not the host's latency
TIMING_SLEEP_CYCLES = 2_000_000


def time_ms(torch, fn, flush, reps=100):
    """Median ms of ``fn`` on the card, CUDA events around each call, the
    L2 cache overwritten and the card kept busy (`TIMING_SLEEP_CYCLES`)
    before each one."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(TIMING_SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ---------------------------------------------------------------------------
# phase 2: paged attention against its plain version
# ---------------------------------------------------------------------------

# (page dtype, B, head dim, lengths): the serving path's f32 pages at the
# largest decode bucket, ragged (inert, one token, page-straddling, full,
# then random); one and four full-length sequences, which the kernel splits
# over the blocks of a cluster; the same in bf16; and bf16 at head dims
# whose rows are not whole 16-byte vectors (20: element loads) or are (40)
PAGED_CASES = [("float32", 32, DH, "ragged"), ("float32", 1, DH, "full"),
               ("float32", 4, DH, "full"), ("bfloat16", 32, DH, "ragged"),
               ("bfloat16", 1, DH, "full"), ("bfloat16", 4, DH, "full"),
               ("bfloat16", 32, 20, "ragged"), ("bfloat16", 32, 40, "ragged")]
# the f32 sums in another order; bf16 pages against the plain version's
# f32 arithmetic on the same bf16 values
PAGED_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


def paged_inputs(torch, seed, b, d, kv_dtype, lengths):
    rng = np.random.RandomState(seed)
    if lengths == "full":
        lens = np.full(b, MAXP * PS)
    else:   # ragged: inert, one token, page-straddling, full, then random
        lens = rng.randint(1, MAXP * PS + 1, b)
        lens[:4] = [0, 1, PS + 1, MAXP * PS]
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.randn(b, H, d).astype(np.float32)).to(dev)
    kv = [torch.from_numpy(rng.randn(POOL, H, PS, d).astype(np.float32))
          .to(dev, kv_dtype) for _ in range(2)]
    tbl = torch.from_numpy(rng.randint(0, POOL, (b, MAXP))
                           .astype(np.int32)).to(dev)
    return (q, kv[0], kv[1], tbl,
            torch.from_numpy(lens.astype(np.int32)).to(dev))


def paged_bound(q, k, lengths):
    """Least time for one call: the live K/V rows read once, q, the output,
    the live page-table entries and the lengths; or its FLOPs (q.k and
    p.v, 2 each per K/V element) at the f32 peak."""
    lens = lengths.cpu().numpy().astype(np.int64)
    b, h, d = q.shape
    live = int(lens.clip(min=0).sum())
    kv_bytes = 2 * live * h * d * k.element_size()
    other = 2 * q.numel() * 4 + 4 * int(np.ceil(lens.clip(min=0) / PS).sum()) \
        + 4 * b
    flops = 4 * live * h * d
    t_bytes = (kv_bytes + other) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_paged_attention(torch, pk, seed, flush):
    """Kernel vs plain on the card at every case of PAGED_CASES, each run
    twice and compared bit for bit, inert rows exactly zero, with kernel,
    plain and bound times. Returns the numbers of the f32, B = 32 case (the
    engine's default page type at the largest decode bucket) and the
    largest error of all."""
    worst, row = 0.0, None
    for dtype, b, d, lengths in PAGED_CASES:
        tol = PAGED_TOL[dtype]
        args = paged_inputs(torch, seed, b, d, getattr(torch, dtype), lengths)
        scale = 1.0 / np.sqrt(d)
        tag = "paged_attention %s B=%d D=%d %s" % (dtype, b, d, lengths)
        out = pk.paged_attention(*args, sm_scale=scale)
        again = pk.paged_attention(*args, sm_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("%s: two runs differ" % tag)
        ref = pk.paged_attention_reference(*args, scale)
        live = args[4] > 0
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("%s: non-finite output" % tag)
        if not bool((out[~live] == 0).all()):
            raise AssertionError("%s: inert row not zero" % tag)
        err = float((out[live] - ref[live]).abs().max())
        if not err <= tol:
            raise AssertionError("%s: max err %g > %g" % (tag, err, tol))
        worst = max(worst, err)
        ms = time_ms(torch, lambda: pk.paged_attention(
            *args, sm_scale=scale), flush)
        plain_ms = time_ms(torch, lambda: pk.paged_attention_reference(
            *args, scale), flush)
        bound_ms, bound_by = paged_bound(args[0], args[1], args[4])
        log("%s live_tokens=%d: max_abs_err %.3g (tol %g), two runs "
            "bit-identical; kernel %.4f ms plain %.4f ms bound %.4f ms (%s, "
            "%.2fx) library none" % (tag, int(args[4].sum()), err, tol, ms,
                                     plain_ms, bound_ms, bound_by,
                                     ms / bound_ms))
        if (dtype, b, d) == ("float32", 32, DH):
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    row["max_abs_err"] = worst
    return row


# ---------------------------------------------------------------------------
# phase 3: serve the full-width LM over HTTP
# ---------------------------------------------------------------------------

def greedy(torch, lm, prompt, n):
    """Full-sequence greedy oracle: one whole forward per new token."""
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            ids = torch.tensor([toks], device=lm._held("word_weight").device)
            t = int(torch.argmax(lm(ids)[0, -1]))
            out.append(t)
            toks.append(t)
    return out


def make_requests(seed, n, vocab, max_prompt, max_new):
    """Prompts of 5..max_prompt tokens, budgets of 16..64; the first is the
    longest allowed prompt with the largest budget, the second a short
    one; every fourth request samples (temperature, top-k, top-p)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = [max_prompt, 5][i] if i < 2 else rng.randint(5, max_prompt + 1)
        body = {"tokens": rng.randint(0, vocab, plen).tolist(),
                "max_new_tokens": [min(64, max_new), 16][i] if i < 2
                else int(rng.randint(16, min(64, max_new) + 1)),
                "timeout_ms": 600000}
        if i % 4 == 3:
            body.update(temperature=0.8, top_k=40, top_p=0.95)
        reqs.append(body)
    return reqs


def post_all(url, bodies):
    """POST every body at once, one thread each. Returns per request
    (status, reply, t_sent, t_answered)."""
    results = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))

    def one(i):
        data = json.dumps(bodies[i]).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"})
        gate.wait()
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=900) as r:
                results[i] = (r.status, json.loads(r.read()), t0,
                              time.monotonic())
        except Exception as e:
            results[i] = (getattr(e, "code", None), repr(e), t0,
                          time.monotonic())

    threads = [threading.Thread(target=one, args=(i,), name="smoke-%d" % i)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def profile_decode(torch, engine, b):
    """`torch.profiler` over 5 decode steps at batch ``b`` (128 live tokens
    a row): device time by kernel, and the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    ps, maxp = engine.page_size, engine.max_pages_per_seq
    tables = np.arange(b * maxp, dtype=np.int32).reshape(b, maxp)
    tables %= engine.num_pages
    pos = np.full(b, 127, np.int32)
    args = (np.zeros(b, np.int32), pos, tables[:, 127 // ps],
            np.full(b, 127 % ps, np.int32), tables, pos + 1,
            np.zeros(b, np.float32), np.zeros(b, np.int32),
            np.ones(b, np.float32), None)
    for _ in range(3):
        engine.decode_step(*args)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(10):
        engine.decode_step(*args)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            engine.decode_step(*args)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' device time
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us / 5 / 1e3, ev.count // 5, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile decode B=%d: step wall %.3f ms, device busy %.3f ms "
        "(%.1f%%)" % (b, step_ms, busy, 100.0 * busy / step_ms))
    for ms, count, key in rows[:12]:
        log("  %8.4f ms  x%-4d %s" % (ms, count, key[:90]))


def serve(torch, pk, args):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_base_lm
    from mxnet_tpu_torch.serving import ModelRepository, ServingServer, save_lm

    t0 = time.monotonic()
    lm = bert_base_lm(device="cpu").initialize(args.seed)
    n_layers = lm.config["num_layers"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        prefix = save_lm(lm, os.path.join(tmp, "bert_base_lm"))
        log("model: %s, %d parameters, artifact written in %.1f s"
            % (json.dumps(lm.config, sort_keys=True),
               sum(p.numel() for p in lm.parameters()),
               time.monotonic() - t0))
        del lm
        torch.cuda.reset_peak_memory_stats()
        for k in SERVE_KERNELS:   # the serving path's counts start here
            getattr(pk, k).launches = 0
        t0 = time.monotonic()
        repo = ModelRepository()
        model = repo.load("lm", prefix, generate=True)
    geo = model.generate_info
    log("loaded and warmed in %.1f s (warm %.2f s): %s"
        % (time.monotonic() - t0, model.warm_seconds,
           json.dumps(geo, sort_keys=True)))
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    bodies = make_requests(args.seed + 1, args.requests,
                           model.scheduler.engine.vocab_size,
                           geo["max_prompt"], geo["max_new_tokens"])
    results = post_all("http://127.0.0.1:%d/v1/models/lm:generate"
                       % srv.port, bodies)
    srv.shutdown()
    launches = {k: getattr(pk, k).launches for k in SERVE_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    name = "%s/%d" % (model.name, model.version)
    steps = telemetry.counter("mxtpu_serve_decode_steps_total",
                              {"model": name}).value
    itl = telemetry.histogram("mxtpu_serve_intertoken_seconds",
                              {"model": name})
    pre = telemetry.histogram("mxtpu_serve_prefill_seconds",
                              {"model": name}).snapshot()
    pages_used = model.describe()["kv"]["pages_used"]
    for i, (status, reply, _, _) in enumerate(results):
        if status != 200:
            raise AssertionError("request %d answered %s: %s"
                                 % (i, status, reply))
        want = bodies[i]["max_new_tokens"]
        if reply["num_generated"] != want or len(reply["tokens"]) != want:
            raise AssertionError("request %d: %d tokens, asked for %d"
                                 % (i, reply["num_generated"], want))
    if pages_used != 0:
        raise AssertionError("%d KV pages still used after drain"
                             % pages_used)
    if launches["paged_attention"] < steps * n_layers:
        raise AssertionError("paged_attention launched %d times for %d "
                             "decode steps of %d layers"
                             % (launches["paged_attention"], steps, n_layers))
    generated = sum(r[1]["num_generated"] for r in results)
    wall = max(r[3] for r in results) - min(r[2] for r in results)
    log("served %d requests (%d sampled), all 200: %d tokens in %.3f s = "
        "%.1f generated tokens/s; %d decode steps, mean decode batch %.2f; "
        "inter-token p50 %.4f s p99 %.4f s (histogram-interpolated) max "
        "%.4f s; %d prefills, mean %.4f s max %.4f s; peak allocated %d "
        "bytes; paged_attention launches %d (>= %d = steps x layers; "
        "warm-up adds one step per decode bucket)"
        % (len(results), sum("temperature" in b for b in bodies), generated,
           wall, generated / wall, steps, (generated - len(results)) / steps,
           itl.quantile(0.5), itl.quantile(0.99), itl.snapshot()["max"],
           pre["count"], pre["sum"] / pre["count"], pre["max"], peak,
           launches["paged_attention"], steps * n_layers))
    engine = model.scheduler.engine
    if not repo.unload("lm", timeout=30.0):
        raise AssertionError("unload did not drain")
    for i in (0, 1):   # the two greedy oracle requests
        want = greedy(torch, engine.lm, bodies[i]["tokens"],
                      bodies[i]["max_new_tokens"])
        if results[i][1]["tokens"] != want:
            raise AssertionError("greedy request %d differs from the full "
                                 "forward:\n%s\n%s"
                                 % (i, results[i][1]["tokens"], want))
    log("greedy requests 0 and 1 (%d and %d tokens) equal the full-sequence "
        "forward on the card" % (bodies[0]["max_new_tokens"],
                                 bodies[1]["max_new_tokens"]))
    if args.profile:
        profile_decode(torch, engine, 16)
    return launches


# ---------------------------------------------------------------------------
# phase 2: the conv-epilogue kernels against their plain versions
# ---------------------------------------------------------------------------

# ResNet-50's BatchNorm shapes at batch 128, 224 x 224, as (R = N*H*W, C);
# an odd one (C not a multiple of the 16-byte packs); and the extremes of
# the vision families' training path (train_vision): Inception v3's widest
# BatchNorm at batch 128, 299 x 299 (128 x 147 x 147 rows of 64) and its
# narrowest (128 x 8 x 8 rows of 448), and ResNet v2's input BatchNorm at
# batch 128, 224 x 224 (6,422,528 rows of the 3 image channels: the
# scalar path, without gamma or beta: fix_gamma and beta 0)
EPI_SHAPES = [("stem", 1605632, 64), ("stage1-mid", 401408, 64),
              ("stage1-out", 401408, 256), ("stage4-out", 6272, 2048),
              ("odd", 1000, 3), ("inception-widest", 2765952, 64),
              ("inception-narrowest", 8192, 448),
              ("resnet_v2-input", 6422528, 3), ("stage4-mid", 6272, 512),
              ("stage3-out", 25088, 1024), ("inception-17x17", 36992, 192)]
# the shapes whose BatchNorm has no learned gamma or beta
EPI_FIXED_GAMMA = ("resnet_v2-input",)
# the case each kernel's row of the "kernels" line reports: the stage-1
# block output in bf16, in the variant the path runs at that shape, the
# block tail's BN + add + ReLU (the backward reduce sees only the ReLU
# mask). No one PyTorch call computes it, so the row's library_ms is null;
# the plain BatchNorm variant, which has a one-call yardstick, goes beside
# it under "bn_variant".
EPI_ROW = ("stage1-out", "bfloat16")
# the small-R case the two reductions' rows also report ("small_r"), in the
# plain BatchNorm variant: Inception v3's 8 x 8 BatchNorms, the cluster
# route
EPI_SMALL_R = ("inception-narrowest", "bfloat16")
EPI_ROW_VARIANT = {"epi_stats": "-", "epi_apply": "add+relu",
                   "epi_bwd_reduce": "relu", "epi_bwd_dx": "add+relu"}
EPI_EPS = 1e-5
# f32 results: rtol 1e-4 with a floor of 1e-4 x max|plain| (sums over up
# to 1.6 M rows in another order); bf16 tensors 2^-7 the same way (one
# bf16 rounding step is 2^-8)
EPI_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# FLOPs per (R, C) element, for the operations bound
EPI_FLOPS = {"epi_stats": 3, "epi_apply": 4, "epi_bwd_reduce": 6,
             "epi_bwd_dx": 7}

# the ResNet-50 training phase: batch, warm-up steps, timed steps
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 128, 3, 10


def max_err(torch, got, want, tol, what, scale=0.0):
    """Largest |got - want|; raises unless every element is finite and
    within tol * |want| + tol * max(max|want|, scale)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: non-finite kernel output" % what)
    diff = (got - want).abs()
    excess = float((diff - tol * want.abs()).max())
    floor = tol * max(float(want.detach().abs().max()), scale)
    if excess > floor:
        raise AssertionError("%s: error beyond tolerance %g (excess %g > "
                             "floor %g)" % (what, tol, excess, floor))
    return float(diff.max())


def epi_bound(kernel, r, c, elem, rows_in, rows_out, vec_floats):
    """Least time: each (R, C) tensor read or written once and the
    per-channel vectors, over the HBM rate; or the FLOPs over the f32
    peak."""
    t_bytes = ((rows_in + rows_out) * r * c * elem
               + vec_floats * c * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = EPI_FLOPS[kernel] * r * c / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def route_taken(wrapper, before):
    """The route of a reduction wrapper's one launch since ``before`` (a
    copy of its ``routes`` counts): "cluster" or "streamed", "+fold" when
    the rows were folded."""
    moved = {k for k, n in wrapper.routes.items() if n != before[k]}
    return ("cluster" if "cluster" in moved else "streamed") + \
        ("+fold" if "folded" in moved else "")


def check_epilogue_case(torch, pk, label, r, c, dtype, seed, flush,
                        fix_gamma=False):
    """Every variant of the four kernels at one (R, C, dtype) against the
    plain versions; the timed variants' rows; the largest error of each
    kernel. ``fix_gamma``: the BatchNorm has no learned gamma or beta
    (gamma taken as 1, beta 0)."""
    tdt = getattr(torch, dtype)
    tol = EPI_TOL[dtype]
    elem = torch.empty((), dtype=tdt).element_size()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(r, c, generator=g, device="cuda") * 2 + 3).to(tdt)
    res = torch.randn(r, c, generator=g, device="cuda").to(tdt)
    ct = torch.randn(r, c, generator=g, device="cuda").to(tdt)
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda")
    if fix_gamma:
        gamma, beta = torch.ones_like(gamma), torch.zeros_like(beta)
    worst = dict.fromkeys(EPI_KERNELS, 0.0)
    rows = []
    tag = "%s (%d, %d) %s" % (label, r, c, dtype)

    # the route each reduction takes here, as the wrapper's mirror of the
    # kernel's layout names it (the tensors are fresh: 16-byte aligned)
    lay = pk._epi_layout(r, c, elem)
    want_route = lay["route"] + ("+fold" if lay["l"] > 1 else "")
    routes = {}

    def row(kernel, variant, fn, plain, library, rows_in, rows_out,
            vec_floats):
        ms = time_ms(torch, fn, flush, reps=50)
        plain_ms = time_ms(torch, plain, flush, reps=50)
        lib_ms = None if library is None else \
            time_ms(torch, library, flush, reps=50)
        bound_ms, bound_by = epi_bound(kernel, r, c, elem, rows_in, rows_out,
                                       vec_floats)
        rows.append({"kernel": kernel, "variant": variant, "case": label,
                     "r": r, "c": c, "dtype": dtype, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "route": routes.get(kernel)})
        log("  %-14s %-9s %s: kernel %.4f ms plain %.4f ms library %s "
            "bound %.4f ms (%s)" % (kernel, variant, tag, ms, plain_ms,
                                    "none" if lib_ms is None
                                    else "%.4f ms" % lib_ms, bound_ms,
                                    bound_by))

    # stats: two runs give the same bits
    before = dict(pk.epi_stats.routes)
    got = pk.epi_stats(x, gamma, beta, EPI_EPS, fix_gamma)
    routes["epi_stats"] = route_taken(pk.epi_stats, before)
    again = pk.epi_stats(x, gamma, beta, EPI_EPS, fix_gamma)
    want = pk.epi_stats_reference(x, gamma, beta, EPI_EPS,
                                       fix_gamma)
    for name, a, b in zip(("mean", "var", "inv", "scale", "shift"), got,
                          want):
        worst["epi_stats"] = max(worst["epi_stats"], max_err(
            torch, a, b, 1e-4, "epi_stats %s %s" % (name, tag)))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("epi_stats %s: two runs differ" % tag)
    mean, _, inv, scale, shift = want
    row("epi_stats", "-",
        lambda: pk.epi_stats(x, gamma, beta, EPI_EPS, fix_gamma),
        lambda: pk.epi_stats_reference(x, gamma, beta, EPI_EPS,
                                       fix_gamma),
        lambda: torch.var_mean(x, 0, correction=0), 1, 0, 7)

    outs = {}
    for relu, has_res in ((False, False), (True, False), (True, True)):
        rr = res if has_res else None
        out = pk.epi_apply(x, rr, scale, shift, relu)
        worst["epi_apply"] = max(worst["epi_apply"], max_err(
            torch, out, pk.epi_apply_reference(x, rr, scale, shift, relu),
            tol, "epi_apply relu=%s res=%s %s" % (relu, has_res, tag)))
        outs[(relu, has_res)] = out
    sc_t, sh_t = scale.to(tdt), shift.to(tdt)
    row("epi_apply", "bn", lambda: pk.epi_apply(x, None, scale, shift, False),
        lambda: pk.epi_apply_reference(x, None, scale, shift, False),
        lambda: torch.addcmul(sh_t, x, sc_t), 1, 1, 2)
    row("epi_apply", "add+relu",
        lambda: pk.epi_apply(x, res, scale, shift, True),
        lambda: pk.epi_apply_reference(x, res, scale, shift, True), None,
        2, 1, 2)

    coefs = {}
    for relu in (False, True):
        out = outs[(True, False)] if relu else None
        before = dict(pk.epi_bwd_reduce.routes)
        got = pk.epi_bwd_reduce(ct, x, out, mean, inv, gamma, fix_gamma)
        routes["epi_bwd_reduce"] = route_taken(pk.epi_bwd_reduce, before)
        again = pk.epi_bwd_reduce(ct, x, out, mean, inv, gamma, fix_gamma)
        want = pk.epi_bwd_reduce_reference(ct, x, out, mean, inv, gamma,
                                           fix_gamma)
        for name, a, b in zip(("dgamma", "dbeta", "coef", "cb", "cg"), got,
                              want):
            worst["epi_bwd_reduce"] = max(worst["epi_bwd_reduce"], max_err(
                torch, a, b, 1e-4,
                "epi_bwd_reduce relu=%s %s %s" % (relu, name, tag)))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("epi_bwd_reduce %s: two runs differ" % tag)
        coefs[relu] = want[2:]
    # yardstick of the backward pair: one call computes dx, dgamma, dbeta
    def lib_bwd():
        return torch.ops.aten.native_batch_norm_backward(
            ct, x, gamma, None, None, mean, inv, True, EPI_EPS,
            [True, True, True])

    out_relu = outs[(True, False)]
    row("epi_bwd_reduce", "bn",
        lambda: pk.epi_bwd_reduce(ct, x, None, mean, inv, gamma, fix_gamma),
        lambda: pk.epi_bwd_reduce_reference(ct, x, None, mean, inv, gamma,
                                            fix_gamma), lib_bwd, 2, 0, 8)
    row("epi_bwd_reduce", "relu",
        lambda: pk.epi_bwd_reduce(ct, x, out_relu, mean, inv, gamma,
                                  fix_gamma),
        lambda: pk.epi_bwd_reduce_reference(ct, x, out_relu, mean, inv,
                                            gamma, fix_gamma), None, 3, 0, 8)

    for relu, has_res in ((False, False), (True, False), (True, True)):
        out = outs[(True, False)] if relu else None
        coef, cb, cg = coefs[relu]
        dx, dres = pk.epi_bwd_dx(ct, x, out, mean, inv, coef, cb, cg,
                                 has_res)
        wdx, wdres = pk.epi_bwd_dx_reference(ct, x, out, mean, inv, coef, cb,
                                             cg, has_res)
        what = "epi_bwd_dx relu=%s res=%s %s" % (relu, has_res, tag)
        worst["epi_bwd_dx"] = max(worst["epi_bwd_dx"],
                                  max_err(torch, dx, wdx, tol, what))
        if has_res:
            worst["epi_bwd_dx"] = max(worst["epi_bwd_dx"], max_err(
                torch, dres, wdres, tol, what + " dres"))
    coef, cb, cg = coefs[False]
    row("epi_bwd_dx", "bn",
        lambda: pk.epi_bwd_dx(ct, x, None, mean, inv, coef, cb, cg, False),
        lambda: pk.epi_bwd_dx_reference(ct, x, None, mean, inv, coef, cb, cg,
                                        False), lib_bwd, 2, 1, 5)
    coef, cb, cg = coefs[True]
    row("epi_bwd_dx", "add+relu",
        lambda: pk.epi_bwd_dx(ct, x, out_relu, mean, inv, coef, cb, cg,
                              True),
        lambda: pk.epi_bwd_dx_reference(ct, x, out_relu, mean, inv, coef, cb,
                                        cg, True), None, 3, 2, 5)
    for k, got in routes.items():
        if got != want_route:
            raise AssertionError("%s %s: took the %s route, its layout names "
                                 "%s" % (k, tag, got, want_route))
    return rows, worst


def check_conv_epilogue_grad(torch, pk, seed):
    """`conv_epilogue` (the autograd Function over the kernels) against
    `conv_epilogue_reference` (autograd through the plain forward) at the
    stage-1 block tail (BN + add + ReLU, bf16 parameters as the trainer
    casts them): out, mean, var and all four gradients."""
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(seed)
        shape = (128, 56, 56, 256)
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 3).to(tdt)
        res = torch.randn(shape, generator=g, device="cuda").to(tdt)
        ct = torch.randn(shape, generator=g, device="cuda").to(tdt)
        gamma = (torch.rand(256, generator=g, device="cuda") + 0.5).to(tdt)
        beta = torch.randn(256, generator=g, device="cuda").to(tdt)
        # no cotangent where |out| < 1e-3: there an f32 rounding apart can
        # put the two forwards on the two sides of the ReLU's kink, where
        # the gradient jumps from 0 to the whole cotangent
        with torch.no_grad():
            ref_out = pk.conv_epilogue_reference(x, gamma, beta, res,
                                                 eps=EPI_EPS, relu=True)[0]
        ct = torch.where(ref_out.float().abs() < 1e-3, torch.zeros_like(ct),
                         ct)
        del ref_out
        results = []
        for fn in (pk.conv_epilogue, pk.conv_epilogue_reference):
            leaves = [t.clone().requires_grad_() for t in (x, gamma, beta,
                                                           res)]
            out, mean, var = fn(*leaves, eps=EPI_EPS, relu=True)
            (out.float() * ct.float()).sum().backward()
            results.append([out.detach(), mean, var]
                           + [t.grad for t in leaves])
        names = ("out", "mean", "var", "dx", "dgamma", "dbeta", "dres")
        for name, a, b in zip(names, *results):
            tol = 1e-4 if name in ("mean", "var") else EPI_TOL[dtype]
            err = max_err(torch, a, b, tol, "conv_epilogue %s %s"
                          % (name, dtype))
            worst = max(worst, err / float(b.float().abs().max()))
        del results
    log("conv_epilogue (128, 56, 56, 256) BN+add+ReLU, f32 and bf16: out, "
        "mean, var and the gradients of x, gamma, beta, residual agree with "
        "the plain version differentiated by autograd (largest error %.3g "
        "of the compared tensor's largest magnitude)" % worst)


def check_epilogue(torch, pk, seed, flush, details):
    rows, worst = [], dict.fromkeys(EPI_KERNELS, 0.0)
    for i, (label, r, c) in enumerate(EPI_SHAPES):
        for dtype in ("bfloat16", "float32"):
            case_rows, case_worst = check_epilogue_case(
                torch, pk, label, r, c, dtype, seed + i, flush,
                fix_gamma=label in EPI_FIXED_GAMMA)
            rows.extend(case_rows)
            for k, v in case_worst.items():
                worst[k] = max(worst[k], v)
            torch.cuda.empty_cache()
    taken = {(r["case"], r["dtype"], r["kernel"]): r["route"] for r in rows
             if r["route"] is not None}
    seen = set(taken.values())
    for need in ("cluster", "streamed"):
        if not any(t.startswith(need) for t in seen):
            raise AssertionError("no reduction took the %s route: %s"
                                 % (need, sorted(seen)))
    if not any(t.endswith("+fold") for t in seen):
        raise AssertionError("no reduction folded its rows: %s"
                             % sorted(seen))
    log("conv epilogue: every variant of the four kernels agrees with its "
        "plain version at %d shapes x 2 dtypes (|kernel - plain| <= tol x "
        "|plain| + tol x max|plain|, tol 1e-4 for f32 results and 2^-7 for "
        "bf16 tensors); the two reductions give the same bits on a second "
        "run, each on the route its layout names; largest absolute errors "
        "%s; routes %s" % (len(EPI_SHAPES), json.dumps(worst),
                           json.dumps(sorted({"%s %s" % (k[0], k[1]): v
                                              for k, v in taken.items()
                                              if k[2] == "epi_stats"}
                                             .items()))))
    check_conv_epilogue_grad(torch, pk, seed)
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump(rows, f, indent=1)
    out = {}
    for k in EPI_KERNELS:
        case = {r["variant"]: r for r in rows if r["kernel"] == k
                and (r["case"], r["dtype"]) == EPI_ROW}
        pick = case[EPI_ROW_VARIANT[k]]
        out[k] = {key: pick[key] for key in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
        out[k]["max_abs_err"] = worst[k]
        if "bn" in case:
            out[k]["bn_variant"] = {key: case["bn"][key] for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")}
        small = [r for r in rows if r["kernel"] == k and r["variant"] in
                 ("-", "bn") and (r["case"], r["dtype"]) == EPI_SMALL_R]
        if k in ("epi_stats", "epi_bwd_reduce"):
            out[k]["small_r"] = {key: small[0][key] for key in (
                "r", "c", "route", "ms", "plain_ms", "bound_ms",
                "library_ms")}
    return out


# ---------------------------------------------------------------------------
# phase 2: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

# BERT-base's attention at batch 8: (BH = 8 x 12 heads, Lq, Lk, D); the
# path runs it non-causal. The other cases: causal, ragged cross-attention
# at the other head dims (40: D not a multiple of 16, padded with zero
# columns; 20: rows not 16-byte aligned, staged with element loads in the
# tensor-core kernels), and one query row.
FLASH_PATH = (96, 512, 512, 64)
FLASH_CASES = [("path", FLASH_PATH, False), ("path", FLASH_PATH, True),
               ("ragged", (2, 200, 260, 16), False),
               ("ragged", (2, 200, 260, 16), True),
               ("ragged", (2, 200, 260, 80), True),
               ("ragged", (2, 200, 260, 128), False),
               ("ragged", (2, 200, 260, 128), True),
               ("ragged", (2, 200, 260, 40), False),
               ("ragged", (2, 200, 260, 40), True),
               ("ragged", (2, 200, 260, 20), False),
               ("ragged", (2, 200, 260, 20), True),
               ("one row", (96, 1, 512, 64), False),
               ("one row", (96, 1, 512, 64), True)]
# f32 results rtol 1e-4 with a floor of 1e-4 x max|plain|, bf16 tensors
# 2^-7 the same way (sums in other orders; one bf16 step is 2^-8); the
# three gradients share one floor, from the largest of them (one query row
# under the causal mask has dS = 0, so dQ and dK are rounding noise)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# FLOPs per (BH, visible (query, key) pair, D): 2 per multiply-add of each
# product (forward: q.k and p.v; dQ: q.k, dO.v, dS.k; dK/dV: those and
# p.dO)
FLASH_FLOPS = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
# (BH, L, D) tensors each kernel reads or writes once, as (rows of Lq, rows
# of Lk), and the f32 (BH, Lq) vectors (lse; lse and delta)
FLASH_TENSORS = {"flash_fwd": (2, 2, 1), "flash_bwd_dq": (3, 2, 2),
                 "flash_bwd_dkv": (2, 4, 2)}


def flash_bound(kernel, shape, causal, dtype):
    """Least time of one call: its tensors read or written once over the
    HBM rate, or its FLOPs over the dtype's peak (bf16 tensor cores, or f32
    outside them); a causal call counts only the visible pairs."""
    bh, lq, lk, d = shape
    pairs = sum(min(r + 1, lk) for r in range(lq)) if causal else lq * lk
    elem = 2 if dtype == "bfloat16" else 4
    n_q, n_k, n_vec = FLASH_TENSORS[kernel]
    t_bytes = ((n_q * lq + n_k * lk) * bh * d * elem + 4 * n_vec * bh * lq) \
        / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_ops = FLASH_FLOPS[kernel] * bh * pairs * d / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


# the flash kernels on the tensor cores (bf16), by the name in their symbol
FLASH_MMA = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
             "flash_bwd_dkv_mma_kernel")


def _int_template_arg(symbol):
    arg = re.search(r"Li(\d+)E", symbol)
    return int(arg.group(1)) if arg else 0


def sass_hmma(path, names, template_arg=_int_template_arg):
    """HMMA (tensor-core) instruction count of every kernel in the library
    at ``path`` whose symbol holds one of ``names``, from ``cuobjdump
    -sass`` (the toolkit's, beside nvcc): {(name, template_arg(mangled
    symbol)): count}; by default the first integer template argument."""
    from mxnet_tpu_torch.ops import _build

    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((n for n in names if n in m.group(1)), None)
            key = None if name is None else (name, template_arg(m.group(1)))
            if key is not None:
                counts.setdefault(key, 0)
        elif key is not None and "HMMA" in line:
            counts[key] += 1
    return counts


def check_flash_sass():
    """The bf16 forward, dQ and dK/dV kernels at every padded head dim (16
    .. 128) hold HMMA instructions; the f32 FMA dQ kernel none. Logs the
    counts."""
    from mxnet_tpu_torch.ops import _build

    counts = sass_hmma(_build.build("flash_attention")["path"],
                       FLASH_MMA + ("flash_bwd_dq_kernel",))
    log("flash SASS, HMMA instructions by kernel and template argument "
        "(padded D for the tensor-core kernels; output columns a thread for "
        "the f32 FMA dQ kernel): %s"
        % ", ".join("%s<%d> %d" % (n, a, c)
                    for (n, a), c in sorted(counts.items())))
    for name in FLASH_MMA:
        dims = sorted(a for (n, a) in counts if n == name)
        if dims != list(range(16, 129, 16)):
            raise AssertionError("%s: instantiations %s in the SASS, not "
                                 "D = 16 .. 128" % (name, dims))
        if min(counts[(name, a)] for a in dims) < 1:
            raise AssertionError("%s: an instantiation without HMMA: the "
                                 "products are not on the tensor cores"
                                 % name)
    return counts


def flash_inputs(torch, seed, shape, tdt):
    bh, lq, lk, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(bh, n, d, generator=g, device="cuda").to(tdt)
            for n in (lq, lk, lk, lq)]


def time_flash(torch, pk, q, k, v, dout, want_lse, delta, dtype, flush):
    """Kernel, plain and library times and the bound of the three kernels
    at the path's shape. The library yardstick is
    `scaled_dot_product_attention` on the (B, H, L, D) views: its forward
    for the forward, and its backward (dQ, dK and dV in one call) for each
    of the two backward kernels."""
    import torch.nn.functional as F

    scale = 1.0 / np.sqrt(q.shape[-1])
    heads = (8, 12) + tuple(q.shape[1:])
    q4, k4, v4 = (t.view(heads) for t in (q, k, v))
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    lib_out = F.scaled_dot_product_attention(*leaves)
    g4 = dout.view(heads)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4), flush, reps=50)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, g4, retain_graph=True), flush, reps=50)
    calls = {
        "flash_fwd": (lambda: pk.flash_fwd(q, k, v, False, scale),
                      lambda: pk.flash_fwd_reference(q, k, v, False, scale),
                      lib_fwd),
        "flash_bwd_dq": (
            lambda: pk.flash_bwd_dq(q, k, v, dout, want_lse, delta, False,
                                    scale),
            lambda: pk.flash_bwd_dq_reference(q, k, v, dout, want_lse,
                                              delta, False, scale), lib_bwd),
        "flash_bwd_dkv": (
            lambda: pk.flash_bwd_dkv(q, k, v, dout, want_lse, delta, False,
                                     scale),
            lambda: pk.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                               delta, False, scale),
            lib_bwd)}
    rows = {}
    for name, (fn, plain, lib_ms) in calls.items():
        ms = time_ms(torch, fn, flush, reps=50)
        plain_ms = time_ms(torch, plain, flush, reps=50)
        bound_ms, bound_by = flash_bound(name, FLASH_PATH, False, dtype)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms}
        log("  %-13s %s %s: kernel %.4f ms plain %.4f ms library (sdpa %s) "
            "%.4f ms bound %.4f ms (%s)"
            % (name, FLASH_PATH, dtype, ms, plain_ms,
               "forward" if name == "flash_fwd" else "backward", lib_ms,
               bound_ms, bound_by))
    return rows


def check_flash_grad(torch, pk, seed):
    """`flash_attention` (the autograd Function over the kernels) against
    autograd through `flash_attention_reference`, on the (B, H, L, Dh)
    head split of BERT-base at batch 8 (strided views, as the attention
    layer hands them), f32 and bf16, causal and not: the output and the
    gradient of the packed q, k, v."""
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        for causal in (False, True):
            g = torch.Generator(device="cuda").manual_seed(seed)
            qkv = torch.randn(8, 512, 3, 12, 64, generator=g,
                              device="cuda").to(tdt)
            ct = torch.randn(8, 12, 512, 64, generator=g,
                             device="cuda").to(tdt)
            results = []
            for fn in (pk.flash_attention, pk.flash_attention_reference):
                leaf = qkv.clone().requires_grad_()
                q, k, v = (leaf[:, :, i].transpose(1, 2) for i in range(3))
                out = fn(q, k, v, causal=causal)
                (out.float() * ct.float()).sum().backward()
                results.append((out.detach(), leaf.grad))
            for name, a, b in zip(("out", "dqkv"), *results):
                err = max_err(torch, a, b, FLASH_TOL[dtype],
                              "flash_attention %s %s causal=%s"
                              % (name, dtype, causal))
                worst = max(worst, err / float(b.float().abs().max()))
    log("flash_attention (8, 12, 512, 64) head-split views, f32 and bf16, "
        "causal and not: the output and the q, k, v gradients agree with "
        "autograd through the plain attention (largest error %.3g of the "
        "compared tensor's largest magnitude)" % worst)


def check_flash(torch, pk, seed, flush):
    """Each flash kernel against its plain version on the same card
    tensors at every case of FLASH_CASES in bf16 and f32, each run twice
    and compared bit for bit; the timings at the path's shape. Returns the
    `kernels` rows (bf16, the path's dtype) with the largest errors."""
    check_flash_sass()
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    rows = {}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        tol = FLASH_TOL[dtype]
        for i, (label, shape, causal) in enumerate(FLASH_CASES):
            q, k, v, dout = flash_inputs(torch, seed + i, shape, tdt)
            scale = 1.0 / np.sqrt(shape[-1])
            want_out, want_lse = pk.flash_fwd_reference(q, k, v, causal,
                                                        scale)
            delta = (dout.float() * want_out.float()).sum(-1)
            runs = []
            for _ in range(2):
                runs.append(pk.flash_fwd(q, k, v, causal, scale)
                            + (pk.flash_bwd_dq(q, k, v, dout, want_lse,
                                               delta, causal, scale),)
                            + pk.flash_bwd_dkv(q, k, v, dout, want_lse,
                                               delta, causal, scale))
            torch.cuda.synchronize()
            tag = "%s %s %s causal=%s" % (label, shape, dtype, causal)
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("flash kernels %s: two runs differ"
                                     % tag)
            out, lse, dq, dk, dv = runs[0]
            want = ((want_out, "flash_fwd", tol, 0.0),
                    (want_lse, "flash_fwd", 1e-4, 0.0))
            grads = (pk.flash_bwd_dq_reference(q, k, v, dout, want_lse,
                                               delta, causal, scale),)
            grads += pk.flash_bwd_dkv_reference(q, k, v, dout, want_lse,
                                                delta, causal, scale)
            big = max(float(t.float().abs().max()) for t in grads)
            want += tuple((t, kern, tol, big) for t, kern in
                          zip(grads, FLASH_KERNELS[1:] + FLASH_KERNELS[2:]))
            for name, got, (ref, kern, t_tol, floor) in zip(
                    ("out", "lse", "dq", "dk", "dv"),
                    (out, lse, dq, dk, dv), want):
                worst[kern] = max(worst[kern], max_err(
                    torch, got, ref, t_tol, "%s %s" % (name, tag),
                    scale=floor))
            if (label, causal) == ("path", False):
                case_rows = time_flash(torch, pk, q, k, v, dout, want_lse,
                                       delta, dtype, flush)
                if dtype == "bfloat16":
                    rows = case_rows
            del q, k, v, dout, runs, grads, want
            torch.cuda.empty_cache()
    log("flash attention: the three kernels agree with their plain versions "
        "at %d cases x 2 dtypes (|kernel - plain| <= tol x |plain| + tol x "
        "max|plain|, tol 1e-4 for f32 results and lse, 2^-7 for bf16 "
        "tensors, the gradients' floor from the largest of the three); two "
        "runs give the same bits; largest absolute errors %s"
        % (len(FLASH_CASES), json.dumps(worst)))
    check_flash_grad(torch, pk, seed)
    for k in FLASH_KERNELS:
        rows[k]["max_abs_err"] = worst[k]
    return rows


# ---------------------------------------------------------------------------
# phase 2: the LSTM kernels against their plain versions
# ---------------------------------------------------------------------------

# bench_lstm's layer: (T = bptt, B = batch, H = hidden); the other cases:
# ragged (neither B nor H a multiple of anything), one step, and the
# RNNModel default width at batch 1
LSTM_PATH = (35, 32, 650)
LSTM_CASES = [("path", LSTM_PATH), ("ragged", (7, 5, 9)),
              ("one step", (1, 3, 5)), ("width 200", (35, 1, 200)),
              # the forward's tensor-core tiling: a partial second m16
              # tile, four m16 tiles, 12 units a block (48 gate rows; f32
              # does not fit a block there and must be refused), odd H
              ("B 17", (5, 17, 650)), ("B 64", (5, 64, 650)),
              ("H 1500", (5, 8, 1500)), ("odd H", (6, 24, 333)),
              # blocks that cannot hold all of h: the streamed forward
              # (and, f32 at B 128 and bf16 at H 1500 B 32, the streamed
              # backward)
              ("B 128", (5, 128, 650)), ("H 1500 B 32", (5, 32, 1500)),
              # the backward's clusters of Q U = 16 units do not divide H
              ("QU does not divide H", (4, 20, 130)),
              # the predict_serving phase's buckets below 32
              ("served B 1", (35, 1, 650)), ("served B 2", (35, 2, 650)),
              ("served B 4", (35, 4, 650)), ("served B 8", (35, 8, 650)),
              ("served B 16", (35, 16, 650))]
# f32 results rtol 1e-4 with a floor of 1e-4 x max|plain|; bf16 tensors
# 2^-7 the same way (the products' f32 sums in other orders can round a
# bf16 h, gate or dgates to the neighbouring value, one step 2^-8, and the
# recurrence carries it on)
LSTM_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


def lstm_inputs(torch, seed, shape, tdt):
    """gx, wh (scaled as Xavier on (4H, H) would), nonzero h0 and c0, and
    the cotangents dy and dcT, on the card."""
    t, b, h = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*size, scale=1.0):
        return (torch.randn(size, generator=g, device="cuda")
                * scale).to(tdt)

    return (rnd(t, b, 4 * h), rnd(4 * h, h, scale=(2.0 / (5 * h)) ** 0.5),
            rnd(b, h, scale=0.5), rnd(b, h, scale=0.5), rnd(t, b, h),
            rnd(b, h))


def lstm_bound(kernel, shape, dtype):
    """Least time of one call at (T, B, H): its tensors read or written
    once over the HBM rate, or the recurrent products' FLOPs (2 T B 4H H)
    over the dtype's peak (bf16 tensor cores, or f32 outside them)."""
    t, b, h = shape
    e = 2 if dtype == "bfloat16" else 4
    gx, w, bh, ys, c_all = t * b * 4 * h * e, 4 * h * h * e, b * h * e, \
        t * b * h * e, t * b * h * 4
    nbytes = {"lstm_infer": gx + w + 2 * bh + ys + bh,
              "lstm_fwd": gx + w + 2 * bh + ys + c_all + gx,
              "lstm_bwd": ys + gx + c_all + 2 * bh + w + gx + 2 * bh}[kernel]
    peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * t * b * 4 * h * h / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def lstm_runs(pk, args):
    """Each kernel once: infer, fwd, and bwd on the fwd's residuals."""
    gx, wh, h0, c0, dy, dct = args
    ys, ct = pk.lstm_infer(gx, wh, h0, c0)
    ys2, c_all, gates = pk.lstm_fwd(gx, wh, h0, c0)
    return (ys, ct, ys2, c_all, gates) + pk.lstm_bwd(dy, gates, c_all, c0,
                                                     dct, wh)


def barrier_ms(torch, h, iters=2000):
    """One grid barrier of a cooperative launch as wide as the LSTM
    kernels' at hidden size h (one block an SM, 512 threads), by CUDA
    events around `iters` of them (``lstm_barrier_probe``). Returns (ms,
    blocks)."""
    import ctypes

    from mxnet_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-h // -(-h // sms))
    fn = _build.load("lstm").lstm_barrier_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def run(n):
        rc = fn(blocks, n, stream)
        if rc != 0:
            raise AssertionError("lstm_barrier_probe: CUDA error %d" % rc)

    run(10)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    run(iters)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters, blocks


def cluster_barriers_us(torch, h, iters=2000):
    """The barriers of the backward's launch at hidden size h (cooperative,
    its clusters, one block an SM; ``lstm_cluster_probe``), by CUDA events
    around `iters` of each: the grid barrier and the cluster barrier, in
    µs. Returns {"grid_us", "cluster_us", "blocks", "Q", "U"}."""
    import ctypes

    from mxnet_tpu_torch.ops import _build

    fn = _build.load("lstm").lstm_cluster_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    stream = torch.cuda.current_stream().cuda_stream
    grid = (ctypes.c_int * 3)()
    out = {}
    for kind, key in ((0, "grid_us"), (1, "cluster_us")):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        rcs = [fn(kind, h, 10, grid, stream)]
        s.record()
        rcs.append(fn(kind, h, iters, grid, stream))
        e.record()
        torch.cuda.synchronize()
        if any(rcs):
            raise AssertionError("lstm_cluster_probe %d: CUDA error %s"
                                 % (kind, rcs))
        out[key] = s.elapsed_time(e) * 1e3 / iters
    out.update(blocks=grid[0], Q=grid[1], U=grid[2])
    return out


def time_lstm(torch, pk, args, dtype, flush, barrier, cbar):
    """Kernel, plain and library times, bound and sequential floor of the
    three kernels at the path's shape. The library yardstick is cuDNN's
    LSTM layer (`torch.nn.LSTM`, one layer, input size H, the same T, B, H
    and dtype): its forward under no_grad for the infer kernel, its
    training forward for the forward kernel, its backward for the backward
    kernel. cuDNN's time includes the input projection, which the kernels'
    does not: that GEMM's time ((T B, H) x (H, 4H)) goes beside it."""
    t, b, h = LSTM_PATH
    tdt = getattr(torch, dtype)
    gx, wh, h0, c0, dy, dct = args
    _, c_all, gates = pk.lstm_fwd_reference(gx, wh, h0, c0)
    lib = torch.nn.LSTM(h, h, 1).to("cuda", tdt)
    lib.flatten_parameters()   # one weight buffer, as cuDNN wants it
    x = torch.randn(t, b, h, device="cuda").to(tdt)
    state = (h0[None].contiguous(), c0[None].contiguous())
    leaves = [x.clone().requires_grad_()] + list(lib.parameters())
    lib_out, _ = lib(leaves[0], state)

    def lib_infer():
        with torch.no_grad():
            return lib(x, state)

    lib_ms = {
        "lstm_infer": time_ms(torch, lib_infer, flush, reps=50),
        "lstm_fwd": time_ms(torch, lambda: lib(leaves[0], state), flush,
                            reps=50),
        "lstm_bwd": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, dy, retain_graph=True), flush, reps=50)}
    w_ih = lib.weight_ih_l0.detach()
    proj_ms = time_ms(torch, lambda: torch.matmul(x.reshape(-1, h),
                                                  w_ih.t()), flush, reps=50)
    calls = {
        "lstm_infer": (lambda: pk.lstm_infer(gx, wh, h0, c0),
                       lambda: pk.lstm_infer_reference(gx, wh, h0, c0)),
        "lstm_fwd": (lambda: pk.lstm_fwd(gx, wh, h0, c0),
                     lambda: pk.lstm_fwd_reference(gx, wh, h0, c0)),
        "lstm_bwd": (lambda: pk.lstm_bwd(dy, gates, c_all, c0, dct, wh),
                     lambda: pk.lstm_bwd_reference(dy, gates, c_all, c0, dct,
                                                   wh))}
    rows = {}
    for name, (fn, plain) in calls.items():
        ms = time_ms(torch, fn, flush, reps=50)
        plain_ms = time_ms(torch, plain, flush, reps=10)
        bound_ms, bound_by = lstm_bound(name, LSTM_PATH, dtype)
        # the recurrence's sequential floor: one grid barrier a step (the
        # forward kernels skip the one after the last step), the
        # backward's as wide as its clustered launch
        barrier_us = cbar["grid_us"] if name == "lstm_bwd" else \
            barrier * 1e3
        floor_ms = barrier_us * 1e-3 * (t if name == "lstm_bwd" else t - 1)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": lib_ms[name],
                      "floor_ms": floor_ms, "projection_ms": proj_ms,
                      "us_per_step": ms * 1e3 / t,
                      "barrier_us": barrier_us}
        if name == "lstm_bwd":
            rows[name]["cluster_barrier_us"] = cbar["cluster_us"]
        log("  %-10s %s %s: kernel %.4f ms (%.3f us a step; %s) plain "
            "%.4f ms library (cuDNN LSTM %s, with its input projection) "
            "%.4f ms [projection GEMM %.4f ms] bound %.4f ms (%s) "
            "sequential floor %.4f ms (%d steps)"
            % (name, LSTM_PATH, dtype, ms, ms * 1e3 / t,
               "its grid barrier %.3f us; a cluster barrier, which it does "
               "not take a step, %.3f us" % (cbar["grid_us"],
                                             cbar["cluster_us"])
               if name == "lstm_bwd" else "one barrier %.3f us" % barrier_us,
               plain_ms, {"lstm_infer": "forward, no_grad",
                          "lstm_fwd": "training forward",
                          "lstm_bwd": "backward"}[name], lib_ms[name],
               proj_ms, bound_ms, bound_by, floor_ms,
               t if name == "lstm_bwd" else t - 1))
    return rows


# the LSTM kernels whose bf16 instantiations run on the tensor cores (the
# streamed kernels' names do not contain these)
LSTM_MMA = ("lstm_forward_kernel", "lstm_backward_kernel")


def _lstm_template_arg(symbol):
    """'bf16 fwd', 'f32 infer', 'bf16 bwd', ... from the mangled symbol of
    lstm_forward_kernel<T, kSave> or lstm_backward_kernel<T>."""
    return "%s %s" % ("bf16" if "__nv_bfloat16" in symbol else "f32",
                      "bwd" if "backward" in symbol else
                      "fwd" if "Lb1E" in symbol else "infer")


def check_lstm_sass():
    """Every bf16 instantiation of the forward kernel (lstm_fwd and
    lstm_infer) and of the clustered backward holds HMMA instructions;
    logs every instantiation's count (the f32 ones run on the FMA
    units)."""
    from mxnet_tpu_torch.ops import _build

    counts = sass_hmma(_build.build("lstm")["path"], LSTM_MMA,
                       _lstm_template_arg)
    log("lstm SASS, HMMA instructions by kernel and instantiation: %s"
        % ", ".join("%s %s %d" % (n, a, c)
                    for (n, a), c in sorted(counts.items())))
    for name, arg in ((LSTM_MMA[0], "bf16 fwd"), (LSTM_MMA[0], "bf16 infer"),
                      (LSTM_MMA[1], "bf16 bwd")):
        if counts.get((name, arg), 0) < 1:
            raise AssertionError("%s %s: no HMMA: the recurrent product is "
                                 "not on the tensor cores" % (name, arg))
    return counts


def check_lstm_grad(torch, pk, seed):
    """`lstm_layer` (the `_LSTMLayer` route: forward and backward kernels,
    dW_hh as one product) against autograd through
    `lstm_layer_reference` (the plain step loop), at the path's shape in
    f32 and bf16: ys, hT, cT and the gradients of gx, wh, h0 and c0 under
    cotangents on all three outputs."""
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        gx, wh, h0, c0, dy, dct = lstm_inputs(torch, seed, LSTM_PATH, tdt)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        dht = torch.randn(h0.shape, generator=g, device="cuda").to(tdt)
        results = []
        for fn in (pk.lstm_layer, pk.lstm_layer_reference):
            leaves = [t.clone().requires_grad_() for t in (gx, wh, h0, c0)]
            outs = fn(*leaves)
            grads = torch.autograd.grad(outs, leaves, (dy, dht, dct))
            results.append([o.detach() for o in outs] + list(grads))
        names = ("ys", "hT", "cT", "dgx", "dwh", "dh0", "dc0")
        for name, a, b in zip(names, *results):
            err = max_err(torch, a, b, LSTM_TOL[dtype], "lstm_layer %s %s"
                          % (name, dtype))
            worst = max(worst, err / float(b.float().abs().max()))
    log("lstm_layer %s, f32 and bf16: ys, hT, cT and the gradients of gx, "
        "wh, h0, c0 agree with autograd through the plain step loop "
        "(largest error %.3g of the compared tensor's largest magnitude)"
        % (LSTM_PATH, worst))


def check_lstm(torch, pk, seed, flush):
    """Each LSTM kernel against its plain version on the same card tensors
    at every case of LSTM_CASES in bf16 and f32 (the backward on the plain
    forward's residuals, so each kernel is held alone), each run twice and
    compared bit for bit; the autograd Function; the timings at the
    path's shape. Returns the `kernels` rows (bf16, the path's dtype, with
    the f32 numbers beside) with the largest errors."""
    from mxnet_tpu_torch.base import MXNetError

    check_lstm_sass()
    for dtype in (torch.float32, torch.bfloat16):
        if not pk.lstm_layer_fits(LSTM_PATH[1], LSTM_PATH[2], dtype):
            raise AssertionError("lstm_layer_fits(%d, %d, %s) is false"
                                 % (LSTM_PATH[1], LSTM_PATH[2], dtype))
    barrier, blocks = barrier_ms(torch, LSTM_PATH[2])
    cbar = cluster_barriers_us(torch, LSTM_PATH[2])
    log("lstm: one grid barrier of %d blocks takes %.3f us (lstm_barrier_"
        "probe); the backward's launch at H %d: %d blocks in clusters of %d, "
        "%d units a block: its grid barrier %.3f us, a cluster barrier %.3f "
        "us (lstm_cluster_probe); lstm_layer_fits(32, 650) holds in f32 and "
        "bf16" % (blocks, barrier * 1e3, LSTM_PATH[2], cbar["blocks"],
                  cbar["Q"], cbar["U"], cbar["grid_us"], cbar["cluster_us"]))
    worst = dict.fromkeys(LSTM_KERNELS, 0.0)
    rows, f32_rows = {}, {}
    refused, routes = [], []
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        tol = LSTM_TOL[dtype]
        for i, (label, shape) in enumerate(LSTM_CASES):
            args = lstm_inputs(torch, seed + i, shape, tdt)
            gx, wh, h0, c0, dy, dct = args
            tag = "%s %s %s" % (label, shape, dtype)
            if not pk.lstm_layer_fits(shape[1], shape[2], tdt):
                # ops/rnn.py routes such a shape to the step loop; the
                # kernels must refuse it, not run it
                _, c_all, gates = pk.lstm_fwd_reference(gx, wh, h0, c0)
                for fn, fn_args in (
                        (pk.lstm_infer, (gx, wh, h0, c0)),
                        (pk.lstm_fwd, (gx, wh, h0, c0)),
                        (pk.lstm_bwd, (dy, gates, c_all, c0, dct, wh))):
                    try:
                        fn(*fn_args)
                    except MXNetError:
                        continue
                    raise AssertionError("%s %s: a shape that does not fit "
                                         "a block ran" % (fn.__name__, tag))
                refused.append(tag)
                continue
            routes.append("%s: backward %s" % (tag, pk._lstm_bwd_route(
                shape[1], shape[2], gx.element_size())[0]))
            runs = [lstm_runs(pk, args) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("lstm kernels %s: two runs differ" % tag)
            ys, ct, ys2, c_all, gates = runs[0][:5]
            want_ys, want_ct = pk.lstm_infer_reference(gx, wh, h0, c0)
            want_ys2, want_c, want_g = pk.lstm_fwd_reference(gx, wh, h0, c0)
            dgx, dh0, dc0 = pk.lstm_bwd(dy, want_g, want_c, c0, dct, wh)
            want_b = pk.lstm_bwd_reference(dy, want_g, want_c, c0, dct, wh)
            checks = [("lstm_infer", "ys", ys, want_ys, tol),
                      ("lstm_infer", "cT", ct, want_ct, tol),
                      ("lstm_fwd", "ys", ys2, want_ys2, tol),
                      ("lstm_fwd", "c_all", c_all, want_c, LSTM_TOL[
                          "float32"] if dtype == "float32" else tol),
                      ("lstm_fwd", "gates", gates, want_g, tol)]
            checks += [("lstm_bwd", n, a, b, tol) for n, a, b in zip(
                ("dgx", "dh0", "dc0"), (dgx, dh0, dc0), want_b)]
            for kern, name, got, want, t_tol in checks:
                worst[kern] = max(worst[kern], max_err(
                    torch, got, want, t_tol, "%s %s %s" % (kern, name, tag)))
            if label == "path":
                case_rows = time_lstm(torch, pk, args, dtype, flush, barrier,
                                      cbar)
                (rows if dtype == "bfloat16" else f32_rows).update(case_rows)
            del args, runs
            torch.cuda.empty_cache()
    log("lstm: the three kernels agree with their plain versions at %d "
        "cases x 2 dtypes less %d refused as too large for a block (%s) "
        "(|kernel - plain| <= tol x |plain| + tol x max|plain|, tol 1e-4 "
        "for f32 results and c_all, 2^-7 for bf16 tensors); two runs give "
        "the same bits; largest absolute errors %s; %s"
        % (len(LSTM_CASES), len(refused), "; ".join(refused),
           json.dumps(worst), "; ".join(routes)))
    check_lstm_grad(torch, pk, seed)
    for k in LSTM_KERNELS:
        rows[k]["max_abs_err"] = worst[k]
        rows[k]["f32"] = {key: f32_rows[k][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "floor_ms", "us_per_step")}
    return rows


# ---------------------------------------------------------------------------
# phase 2: mx.rtc — CUDA C++ compiled at run time by NVRTC, launched on
# mx.nd arrays on the card
# ---------------------------------------------------------------------------

# The JAX package's RTC test kernels (tests/test_rtc.py) in CUDA form, each
# with its plain version: ``plain(*inputs)`` is the output array's value
# after ``launches`` launches, at the JAX tests' sizes and values.
RTC_CASES = {
    "axpy": dict(
        source=r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}""",
        signature="const float *x, float *y, float alpha",
        inputs=lambda: [np.ones(10, np.float32), np.zeros(10, np.float32),
                        3.0],
        grid=(1, 1, 1), block=(10, 1, 1), launches=1,
        plain=lambda x, y, alpha: y + alpha * x),
    "scale": dict(
        source=r"""
extern "C" __global__ void scale(const float *a, float *o, float s) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    o[i] = a[i] * s;
}""",
        signature="const float *a, float *o, float s",
        inputs=lambda: [np.arange(128, dtype=np.float32).reshape(8, 16),
                        np.zeros((8, 16), np.float32), 0.5],
        grid=(4,), block=(32,), launches=1,
        plain=lambda a, o, s: a * s),
    "inc": dict(
        source=r"""
extern "C" __global__ void inc(float *y) {
    y[threadIdx.x] += 1.0f;
}""",
        signature="float *y",
        inputs=lambda: [np.zeros(4, np.float32)],
        grid=(1,), block=(4,), launches=3,
        plain=lambda y: y + 3.0),
    "addk": dict(
        source=r"""
extern "C" __global__ void addk(const int *x, int *y, int k) {
    y[threadIdx.x] = x[threadIdx.x] + k;
}""",
        signature="const int32_t *x, int32_t *y, int32_t k",
        inputs=lambda: [np.arange(6, dtype=np.int32),
                        np.zeros(6, np.int32), 7],
        grid=(1,), block=(6,), launches=1,
        plain=lambda x, y, k: x + k),
}

RTC_TEMPLATED_AXPY = r"""
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}"""

# row softmax forward and backward: one block of 1024 threads a row, the
# row staged in dynamic shared memory as f32 (f32 math for bf16 rows),
# reductions in a fixed order so the bits repeat
RTC_SOFTMAX = r"""
#include <cuda_bf16.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float *p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16 *p, float v) {
    *p = __float2bfloat16(v);
}

// every thread gets the block's max (MAX) or sum; red holds 32 floats
template <bool MAX>
__device__ float block_reduce(float v, float *red) {
    for (int o = 16; o > 0; o >>= 1) {
        float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = MAX ? fmaxf(v, w) : v + w;
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float id = MAX ? __int_as_float(0xff800000) : 0.0f;
    v = (threadIdx.x & 31) < (blockDim.x >> 5) ? red[threadIdx.x & 31] : id;
    for (int o = 16; o > 0; o >>= 1) {
        float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = MAX ? fmaxf(v, w) : v + w;
    }
    return v;
}

template <typename T>
__global__ void softmax_fwd(const T *x, T *y, int n) {
    extern __shared__ float row[];
    __shared__ float red[32];
    const T *xr = x + (size_t)blockIdx.x * n;
    T *yr = y + (size_t)blockIdx.x * n;
    float m = __int_as_float(0xff800000);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float v = to_f(xr[i]);
        row[i] = v;
        m = fmaxf(m, v);
    }
    m = block_reduce<true>(m, red);
    float s = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float e = expf(row[i] - m);
        row[i] = e;
        s += e;
    }
    float inv = 1.0f / block_reduce<false>(s, red);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) put(yr + i, row[i] * inv);
}

template <typename T>
__global__ void softmax_bwd(const T *y, const T *dy, T *dx, int n) {
    extern __shared__ float row[];
    __shared__ float red[32];
    size_t off = (size_t)blockIdx.x * n;
    float s = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float v = to_f(y[off + i]);
        row[i] = v;
        s += v * to_f(dy[off + i]);
    }
    s = block_reduce<false>(s, red);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        put(dx + off + i, row[i] * (to_f(dy[off + i]) - s));
}
"""
RTC_SOFTMAX_EXPORTS = ["softmax_fwd<float>", "softmax_fwd<__nv_bfloat16>",
                       "softmax_bwd<float>", "softmax_bwd<__nv_bfloat16>"]

# bench_bert's MLM head logits: 8 x 512 tokens over the 30,522-word vocab
RTC_ROWS, RTC_VOCAB = 8 * 512, 30522
RTC_BLOCK = 1024
RTC_LAUNCH_REPS = 1000
# flops an element: forward max, subtract, exp, sum, scale; backward
# product, sum, subtract, product
RTC_FLOPS = {"fwd": 5, "bwd": 4}


def softmax_plain(torch, x):
    """The forward kernel's plain version, f32 math."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_bwd_plain(y, dy):
    """The backward kernel's plain version, f32 math."""
    yf, dyf = y.float(), dy.float()
    return (yf * (dyf - (yf * dyf).sum(-1, keepdim=True))).to(y.dtype)


def rtc_bound(kind, rows, n, elem):
    """Least time: each input read and each output written once over the
    HBM rate (forward x, y; backward y, dy, dx), or the FLOPs over the f32
    peak."""
    tensors = 2 if kind == "fwd" else 3
    t_bytes = tensors * rows * n * elem / HBM_BYTES_PER_S * 1e3
    t_ops = RTC_FLOPS[kind] * rows * n / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


# the full-width kernels against their plain versions: an element may
# differ by RTC_RTOL of its own scale (`rtc_scale`), and in bf16 by one
# rounding step of the larger of the two values beyond that
RTC_RTOL = 1e-5


def rtc_scale(which, want, y=None, dy=None):
    """Each element's scale: |y| forward; y (|dy| + sum|y dy|) backward,
    the size of the terms of dx = y (dy - sum(y dy)) whose rounding and
    summation order the two versions do differently (where dy - sum(y dy)
    cancels, dx is far smaller than its scale)."""
    if which == "fwd":
        return want.float().abs()
    yf, dyf = y.float(), dy.float()
    return yf * (dyf.abs() + (yf * dyf).abs().sum(-1, keepdim=True))


def rtc_close(torch, got, want, scale, dtype, what):
    """Largest |got - want| and largest |got - want| / scale. Raises where
    an element differs by more than RTC_RTOL x scale (f32: the two
    versions round each step and sum a row in different orders, a few
    f32 steps of a 30,522-term sum), plus, in bf16, 2^-7 of the larger of
    |got| and |want| (each version rounds its own f32 result once)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: non-finite kernel output" % what)
    diff = (got - want).abs()
    tol = scale * RTC_RTOL
    if dtype != "float32":
        tol = tol + torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
    bad = int((diff > tol).sum())
    if bad:
        raise AssertionError("%s: %d elements beyond tolerance (largest "
                             "error %g)" % (what, bad, float(diff.max())))
    return float(diff.max()), float((diff / scale).max())


def rtc_planted_faults(torch, got, want, scale, dtype, what):
    """`rtc_close` must refuse a kernel that writes 0 for every output below
    1e-6 in magnitude, and one that rounds coarser than its type: an f32
    result through bf16, a bf16 result two steps off."""
    faults = {"zeroed below 1e-6": torch.where(got.abs() < 1e-6,
                                               torch.zeros_like(got), got)}
    if dtype == "float32":
        faults["rounded to bf16"] = got.to(torch.bfloat16).float()
    else:
        faults["two bf16 steps off"] = (got.float()
                                        * (1 + 2.0 ** -6)).to(got.dtype)
    for name, bad in faults.items():
        try:
            rtc_close(torch, bad, want, scale, dtype, what)
        except AssertionError:
            continue
        raise AssertionError("%s: the check passes a planted fault (%s)"
                             % (what, name))


def rtc_kernels(module, ct):
    """The forward and backward softmax kernels of `RTC_SOFTMAX` for the C
    type ``ct``."""
    sig = {"fwd": "const %s *x, %s *y, int n" % (ct, ct),
           "bwd": "const %s *y, const %s *dy, %s *dx, int n" % (ct, ct, ct)}
    return {k: module.get_kernel("softmax_%s<%s>" % (k, ct), sig[k])
            for k in ("fwd", "bwd")}


def rtc_softmax(kern, which, x, dy, y, dx):
    """Launch the forward (x -> y) or the backward (y, dy -> dx) kernel of
    `rtc_kernels` on (rows, n) NDArrays: one block a row, the row in
    dynamic shared memory (4 n bytes)."""
    rows, n = x.shape
    if which == "fwd":
        return kern["fwd"].launch([x, y, n], x.context, (rows,),
                                  (RTC_BLOCK,), 4 * n)
    return kern["bwd"].launch([y, dy, dx, n], x.context, (rows,),
                              (RTC_BLOCK,), 4 * n)


def rtc_phase(torch, seed, flush):
    """mx.rtc on mx.nd arrays on the card. Compiles every module with
    NVRTC; then, with the RTC launch count set to 0, drives the slice's
    main path once: the JAX RTC tests' kernels (values, in-place outputs,
    one compile for repeated launches), the templated axpy through its
    exported names, and the full-width softmax forward and backward in f32
    and bf16, each case synchronised and checked. Then holds the
    full-width kernels against their plain versions (two runs bit for
    bit; planted faults must fail the same check), times kernel, plain and library (`torch.softmax`,
    `torch._softmax_backward_data`), and the host cost of a launch beside
    `add_`. Returns the `kernels` row and the main path's launch count."""
    from mxnet_tpu_torch import nd, rtc

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    compile_s = {}
    cases = []
    for name, case in RTC_CASES.items():
        module = rtc.CudaModule(case["source"])
        compile_s[name] = module.compile_seconds
        cases.append((name, module.get_kernel(name, case["signature"]),
                      case))
    templ = rtc.CudaModule(RTC_TEMPLATED_AXPY,
                           exports=["axpy<float>", "axpy<double>"])
    compile_s["axpy<T>"] = templ.compile_seconds
    soft = rtc.CudaModule(RTC_SOFTMAX, exports=RTC_SOFTMAX_EXPORTS)
    compile_s["softmax"] = soft.compile_seconds
    kern = {"float32": rtc_kernels(soft, "float"),
            "bfloat16": rtc_kernels(soft, "__nv_bfloat16")}
    log("rtc: NVRTC compiles (s) %s; modules ready in %.2f s"
        % (json.dumps({k: round(v, 3) for k, v in compile_s.items()}),
           time.monotonic() - t0))
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (RTC_ROWS, RTC_VOCAB)
    data = {}
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        x = torch.randn(shape, generator=gen, device=dev) * 3
        dy = torch.randn(shape, generator=gen, device=dev)
        data[dtype] = [nd.from_dlpack(x.to(tdt)), nd.from_dlpack(dy.to(tdt)),
                       nd.zeros(shape, ctx=dev, dtype=dtype),
                       nd.zeros(shape, ctx=dev, dtype=dtype)]
        del x, dy

    # the main path, counted
    rtc.CudaKernel.launches = 0
    compiles = rtc._driver().compiles
    for name, func, case in cases:
        vals = case["inputs"]()
        args = [nd.array(v, ctx=dev, dtype=v.dtype)
                if isinstance(v, np.ndarray) else v for v in vals]
        out = [a for a in args if isinstance(a, nd.NDArray)][-1]
        for _ in range(case["launches"]):
            outs = func.launch(args, dev, case["grid"], case["block"])
        if len(outs) != 1 or outs[0] is not out:
            raise AssertionError("rtc %s: the output is not the same "
                                 "NDArray" % name)
        want = case["plain"](*[torch.from_numpy(v)
                               if isinstance(v, np.ndarray) else v
                               for v in vals]).numpy()
        if not np.array_equal(out.wait_to_read().asnumpy(), want):
            raise AssertionError("rtc %s: %s, want %s"
                                 % (name, out.asnumpy(), want))
    for ct, dt in (("float", "float32"), ("double", "float64")):
        f = templ.get_kernel("axpy<%s>" % ct,
                             "const %s *x, %s *y, %s alpha" % (ct, ct, ct))
        x = nd.array(np.arange(8), ctx=dev, dtype=dt)
        y = nd.ones((8,), ctx=dev, dtype=dt)
        f.launch([x, y, 0.5], dev, (2,), (4,))
        if not np.array_equal(y.wait_to_read().asnumpy(),
                              1 + 0.5 * np.arange(8)):
            raise AssertionError("rtc axpy<%s>: %s" % (ct, y.asnumpy()))
    for dtype in ("float32", "bfloat16"):
        for which in ("fwd", "bwd"):
            rtc_softmax(kern[dtype], which, *data[dtype])
        data[dtype][3].wait_to_read()
    launches = rtc.CudaKernel.launches
    if rtc._driver().compiles != compiles:
        raise AssertionError("rtc: a launch compiled")
    log("rtc: the JAX RTC tests' kernels give their values in place "
        "(axpy, scale, inc x 3, addk), axpy<float> / axpy<double> through "
        "their exported names, and the (%d, %d) softmax forward and "
        "backward ran in f32 and bf16: %d launches, no compile among them"
        % (RTC_ROWS, RTC_VOCAB, launches))

    # the full-width kernels against their plain versions, and timed
    res = {}
    for dtype in ("float32", "bfloat16"):
        x, dy, y, dx = data[dtype]
        runs = []
        for _ in range(2):
            y2 = nd.zeros(shape, ctx=dev, dtype=dtype)
            dx2 = nd.zeros(shape, ctx=dev, dtype=dtype)
            for which in ("fwd", "bwd"):
                rtc_softmax(kern[dtype], which, x, dy, y2, dx2)
            runs.append((y2, dx2))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            if not torch.equal(a._data, b._data):
                raise AssertionError("rtc softmax %s: two runs differ"
                                     % dtype)
        if not (torch.equal(runs[0][0]._data, y._data)
                and torch.equal(runs[0][1]._data, dx._data)):
            raise AssertionError("rtc softmax %s: the main path's run "
                                 "differs" % dtype)
        del runs
        xt, dyt, yt = x._data, dy._data, y._data
        err = {}
        for which, got, want in (
                ("fwd", yt, softmax_plain(torch, xt)),
                ("bwd", dx._data, softmax_bwd_plain(yt, dyt))):
            what = "rtc softmax_%s %s" % (which, dtype)
            scale = rtc_scale(which, want, yt, dyt)
            err[which] = rtc_close(torch, got, want, scale, dtype, what)
            rtc_planted_faults(torch, got, want, scale, dtype, what)
            del want, scale
        elem = 4 if dtype == "float32" else 2
        timing = {
            "fwd": (lambda: rtc_softmax(kern[dtype], "fwd", x, dy, y, dx),
                    lambda: softmax_plain(torch, xt),
                    lambda: torch.softmax(xt, -1)),
            "bwd": (lambda: rtc_softmax(kern[dtype], "bwd", x, dy, y, dx),
                    lambda: softmax_bwd_plain(yt, dyt),
                    lambda: torch._softmax_backward_data(dyt, yt, -1,
                                                         yt.dtype))}
        for which, (fn, plain, lib) in timing.items():
            bound, by = rtc_bound(which, RTC_ROWS, RTC_VOCAB, elem)
            res[(dtype, which)] = {
                "max_abs_err": err[which][0],
                "max_scaled_err": err[which][1],
                "ms": time_ms(torch, fn, flush),
                "plain_ms": time_ms(torch, plain, flush),
                "bound_ms": bound, "bound_by": by,
                "library_ms": time_ms(torch, lib, flush)}
            torch.cuda.empty_cache()
    log("rtc: full-width softmax (%d, %d) against the plain version (an "
        "element within %g of its scale, |y| forward, y (|dy| + sum|y dy|) "
        "backward, and in bf16 one rounding step beyond that; the check "
        "refuses planted faults), two runs bit for bit: %s"
        % (RTC_ROWS, RTC_VOCAB, RTC_RTOL, json.dumps(
            {"%s %s" % k: v for k, v in res.items()})))
    del data
    torch.cuda.empty_cache()

    # the surface's own cost: host time of one launch beside add_
    case = RTC_CASES["axpy"]
    grid, block = case["grid"], case["block"]
    func = rtc.CudaModule(case["source"]).get_kernel("axpy",
                                                     case["signature"])
    x, y = nd.ones((10,), ctx=dev), nd.zeros((10,), ctx=dev)

    def host_us(fn):
        for _ in range(50):
            fn()
        times = []
        for _ in range(RTC_LAUNCH_REPS):
            t = time.perf_counter_ns()
            fn()
            times.append(time.perf_counter_ns() - t)
        torch.cuda.synchronize()
        return float(np.median(times)) / 1e3

    launch_us = host_us(lambda: func.launch([x, y, 3.0], dev, grid, block))
    add_us = host_us(lambda: y._data.add_(x._data, alpha=3.0))
    log("rtc: host time a launch of axpy %.2f us, of Tensor.add_ on the "
        "same arrays %.2f us (median of %d); the phase took %.1f s"
        % (launch_us, add_us, RTC_LAUNCH_REPS, time.monotonic() - t0))

    row = dict(res[("float32", "fwd")])
    row.update({
        "kernel": "softmax_fwd<float> over (%d, %d), one block a row"
                  % (RTC_ROWS, RTC_VOCAB),
        "bwd": res[("float32", "bwd")],
        "bf16": {"fwd": res[("bfloat16", "fwd")],
                 "bwd": res[("bfloat16", "bwd")]},
        "launch_host_us": launch_us, "add_host_us": add_us,
        "compile_s": compile_s})
    return row, launches


# ---------------------------------------------------------------------------
# phase 4: train ResNet-50 through DistributedTrainer
# ---------------------------------------------------------------------------

def count_flops(torch, net, gnn, shape):
    """Forward FLOPs of one image: 2 x multiply-adds of every convolution
    and the dense layer, from their shapes in one forward; and the stem
    conv's share (its input gradient is not computed in training)."""
    flops, stem = [], []

    def conv_hook(mod, inp, out):
        o, kh, kw, i = mod.weight.shape
        flops.append(2 * out.numel() // out.shape[0] * kh * kw * i)
        if not stem:
            stem.append(flops[-1])

    def dense_hook(mod, inp, out):
        flops.append(2 * mod._held("weight").numel())

    hooks = [m.register_forward_hook(conv_hook) for m in net.modules()
             if isinstance(m, gnn.Conv2D)]
    hooks += [m.register_forward_hook(dense_hook) for m in net.modules()
              if isinstance(m, gnn.Dense)]
    was = net.training
    net.eval()
    with torch.no_grad():
        net(torch.zeros((1,) + shape, device="cuda"))
    net.train(was)
    for h in hooks:
        h.remove()
    return sum(flops), stem[0]


# the conv-epilogue kernels' function names in a profile
EPI_FUNCS = ("reduce_partial", "reduce_finish", "reduce_cluster",
             "apply_kernel", "bwd_dx_kernel")


def is_annotation(ev):
    """A `record_function` range (the trainer's ``trainer.optimizer``),
    which the profiler also lists on the device's timeline: a span, not a
    kernel."""
    return getattr(ev, "is_user_annotation", False) or \
        getattr(ev, "key", getattr(ev, "name", "")) == "trainer.optimizer"


def profile_train(torch, trainer, x, y, step_ms, steps=3):
    """`torch.profiler` over ``steps`` training steps: device time by
    kernel, and the device busy share against ``step_ms``, the step time
    measured without the profiler (which slows the host). Also the host
    operators by their own CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(x, y)
        torch.cuda.synchronize()
    rows, host = [], []
    for ev in prof.key_averages():
        if is_annotation(ev):
            continue
        if not str(ev.device_type).endswith("CUDA"):
            host.append((ev.self_cpu_time_total / steps / 1e3,
                         ev.count // steps, ev.key))
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us / steps / 1e3, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"conv epilogue (this port's kernels)":
              lambda k: any("::%s<" % f in k or "::%s(" % f in k
                            for f in EPI_FUNCS),
              "convolution (cuDNN)": lambda k: any(
                  t in k for t in ("xmma", "cudnn", "conv", "implicit_gemm",
                                   "cutlass")),
              "other": lambda k: True}
    shares = dict.fromkeys(groups, 0.0)
    for ms, _, key in rows:
        for name, test in groups.items():
            if test(key):
                shares[name] += ms
                break
    log("profile train step (bf16, batch %d, %d steps): device busy %.3f ms "
        "a step = %.1f%% of the %.2f ms step timed without the profiler; %s"
        % (x.shape[0], steps, busy, 100.0 * busy / step_ms, step_ms,
           "; ".join("%s %.3f ms" % kv for kv in shares.items())))
    for ms, count, key in rows[:15]:
        log("  %8.3f ms  x%-4d %s" % (ms, count, key[:100]))
    log("  host, by own CPU time a step (profiled):")
    for ms, count, key in host[:12]:
        log("  %8.3f ms  x%-4d %s" % (ms, count, key[:100]))


def train(torch, pk, args):
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.parallel import DistributedTrainer

    t0 = time.monotonic()
    batch, shape, steps = TRAIN_BATCH, (224, 224, 3), TRAIN_STEPS
    with gnn.layout_scope():
        net = resnet50_v1(classes=1000, fuse_epilogue=True, device="cuda")
    net.initialize(seed=args.seed)
    n_bn = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
    if n_bn != 53:
        raise AssertionError("resnet50_v1 has %d BatchNorms, not 53" % n_bn)
    fwd_flops, stem_flops = count_flops(torch, net, gnn, shape)
    train_flops = 3 * fwd_flops - stem_flops
    rng = np.random.RandomState(args.seed + 2)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch,) + shape)
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, batch)).cuda()
    # lr 0.02, not the training script's 0.1: from random weights on one
    # repeated batch, 0.1 first drives the loss up (7.66 -> 11.60 before
    # 5.56, seen on the card), and the check below is that it falls
    trainer = DistributedTrainer(
        net, "sgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype="bfloat16")
    log("train: resnet50_v1 NHWC fused epilogue, %d parameters, %d "
        "BatchNorms, built in %.1f s; %.4g forward FLOPs an image, %.4g a "
        "training step's image (3 x forward less the stem's input "
        "gradient)" % (sum(p.numel() for p in net.parameters()), n_bn,
                       time.monotonic() - t0, fwd_flops, train_flops))
    t0 = time.monotonic()
    warm = [float(trainer.step(x, y)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    log("  %d warm-up steps in %.2f s, losses %s"
        % (TRAIN_WARMUP, time.monotonic() - t0, ["%.4f" % v for v in warm]))
    torch.cuda.reset_peak_memory_stats()
    for k in EPI_KERNELS:   # the training path's counts start here
        getattr(pk, k).launches = 0
    for k in ("epi_stats", "epi_bwd_reduce"):
        getattr(pk, k).routes = dict.fromkeys(getattr(pk, k).routes, 0)
    t0 = time.monotonic()
    losses = [trainer.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    routes = {k: dict(getattr(pk, k).routes)
              for k in ("epi_stats", "epi_bwd_reduce")}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall over the timed steps: %s"
                             % losses)
    for k, n in launches.items():
        if n != n_bn * steps:
            raise AssertionError("%s launched %d times in %d steps, not %d"
                                 % (k, n, steps, n_bn * steps))
    ips = batch * steps / wall
    log("  %d timed steps in %.3f s: %.1f images/s, %.2f ms a step; MFU "
        "%.4f (%.4g FLOPs an image at 989 TFLOP/s bf16); peak allocated "
        "%d bytes; losses %s; launches %s (= 53 x %d each); the "
        "reductions' routes %s"
        % (steps, wall, ips, wall / steps * 1e3,
           ips * train_flops / BF16_FLOPS_PER_S, train_flops, peak,
           ["%.4f" % v for v in losses], json.dumps(launches), steps,
           json.dumps(routes)))
    if args.profile:
        profile_train(torch, trainer, x, y, wall / steps * 1e3)
    return launches, ips


# ---------------------------------------------------------------------------
# phase 4, train_rec: the same ResNet-50 trained from RecordIO records
# through train_imagenet (ImageRecordIter -> DecodePool -> DevicePrefetcher
# -> the NHWC transpose on the card -> DistributedTrainer), then validated
# ---------------------------------------------------------------------------

REC_TRAIN = (TRAIN_WARMUP + TRAIN_STEPS) * TRAIN_BATCH   # 1664 images
REC_VAL = 250                                            # 2 batches, pad 6
REC_SHORT, REC_LONG = 256, (256, 341)
IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)


def rec_image(seed, i):
    """Image ``i`` of a record set and its label, from ``seed``: short side
    256, long side 256 to 341 (either orientation), smooth content (a
    per-channel sum of two random plane waves) plus uniform noise, and a
    label in [0, 1000)."""
    rng = np.random.RandomState((seed * 1000003 + i) % (2 ** 32))
    long_side = rng.randint(REC_LONG[0], REC_LONG[1] + 1)
    h, w = (REC_SHORT, long_side) if rng.rand() < 0.5 \
        else (long_side, REC_SHORT)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        fx, fy = rng.uniform(0.005, 0.05, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        img[:, :, ch] = 128 + 60 * np.sin(x * fx + ph[0]) \
            + 50 * np.cos(y * fy + ph[1])
    img += rng.uniform(-12, 12, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), int(rng.randint(0, 1000))


def write_records(prefix, seed, n, threads):
    """``n`` images of `rec_image` as PNG records in ``prefix``.rec/.idx
    through the port's `recordio`, encoded on ``threads`` threads and
    written in order. Returns (bytes written, labels, images)."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import recordio

    def make(i):
        img, label = rec_image(seed, i)
        return img, label, recordio.pack_img(
            recordio.IRHeader(0, float(label), i, 0), img, img_fmt=".png")

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    labels, images = [], []
    with ThreadPoolExecutor(threads) as pool:
        for i, (img, label, buf) in enumerate(pool.map(make, range(n))):
            rec.write_idx(i, buf)
            labels.append(label)
            images.append(img)
    rec.close()
    return os.path.getsize(prefix + ".rec"), labels, images


def center_crop_chw(img, size=224):
    h, w = img.shape[:2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return np.transpose(img[y0:y0 + size, x0:x0 + size].astype(np.float32),
                        (2, 0, 1))


def decode_rate(path, threads, batches, card):
    """Images/s of the training iterator alone (decode, random crop and
    mirror, mean/std) over ``batches`` batches at ``threads`` threads."""
    from mxnet_tpu_torch import io

    it = io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, 224, 224), batch_size=TRAIN_BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True,
        mean_r=IMAGENET_MEAN[0], mean_g=IMAGENET_MEAN[1],
        mean_b=IMAGENET_MEAN[2], std_r=IMAGENET_STD[0],
        std_g=IMAGENET_STD[1], std_b=IMAGENET_STD[2],
        preprocess_threads=threads, rng=np.random.RandomState(threads))
    try:
        it.next()   # the pipeline's start and first batch
        t0 = time.perf_counter()
        for _ in range(batches):
            it.next()
        rate = batches * TRAIN_BATCH / (time.perf_counter() - t0)
    finally:
        it.close()
    log("  decode only: %.1f images/s at %d thread(s) (%d batches of %d "
        "after the first; %s)" % (rate, threads, batches, TRAIN_BATCH, card))
    return rate


def no_pipeline_threads():
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("mxtpu-")]
    if left:
        raise AssertionError("pipeline threads left running: %s" % left)


def train_rec(torch, pk, args, synthetic_ips):
    """The `train` phase's model and step fed from records: see the module
    docstring's phase 4."""
    import multiprocessing

    from mxnet_tpu_torch import io, telemetry, train_imagenet
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    card = smi_line()
    t_phase = time.monotonic()
    cpus = os.cpu_count()
    threads = min(cpus, 16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-rec-") as d:
        t0 = time.monotonic()
        tbytes, _, _ = write_records(os.path.join(d, "T"), args.seed,
                                     REC_TRAIN, cpus)
        vbytes, vlabels, vimages = write_records(os.path.join(d, "V"),
                                                 args.seed + 1, REC_VAL,
                                                 cpus)
        log("train_rec: %d training and %d validation PNG records (short "
            "side %d, long %d-%d), %d + %d bytes, written in %.1f s on %d "
            "CPUs (os.cpu_count()); %s" % (
                REC_TRAIN, REC_VAL, REC_SHORT, REC_LONG[0], REC_LONG[1],
                tbytes, vbytes, time.monotonic() - t0, cpus, card))
        trec, vrec = os.path.join(d, "T.rec"), os.path.join(d, "V.rec")

        # data gate: center crops in record order, exact (PNG is lossless)
        it = io.ImageRecordIter(path_imgrec=vrec, data_shape=(3, 224, 224),
                                batch_size=TRAIN_BATCH, shuffle=False,
                                preprocess_threads=8)
        got = []
        try:
            for b in it:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        finally:
            it.close()
        pad = 2 * TRAIN_BATCH - REC_VAL
        if [g[2] for g in got] != [0, pad]:
            raise AssertionError("validation pads %s, not [0, %d]"
                                 % ([g[2] for g in got], pad))
        data = np.concatenate([g[0] for g in got])[:REC_VAL]
        labels = np.concatenate([g[1] for g in got])[:REC_VAL]
        want = np.stack([center_crop_chw(im) for im in vimages])
        if not np.array_equal(data, want):
            raise AssertionError("ImageRecordIter's center crops differ from "
                                 "the images written: max abs err %g"
                                 % np.abs(data - want).max())
        if not np.array_equal(labels, np.asarray(vlabels, np.float32)):
            raise AssertionError("validation labels not in record order")
        log("  data gate: %d validation images through ImageRecordIter (8 "
            "threads) equal their center crops exactly; labels in record "
            "order; pads [0, %d]" % (REC_VAL, pad))
        no_pipeline_threads()

        # training and validation through the script
        state = {"losses": []}
        wait = telemetry.counter("mxtpu_data_wait_seconds_total",
                                 {"src": "train_imagenet"})

        prof = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])

        def on_batch(p):
            state["losses"].append(p.locals["loss"])
            if p.nbatch == TRAIN_WARMUP - 1:
                torch.cuda.synchronize()
                for k in EPI_KERNELS:   # the timed steps' counts start here
                    getattr(pk, k).launches = 0
                torch.cuda.reset_peak_memory_stats()
                if prof is not None:
                    prof.start()
                state["t0"], state["w0"] = time.perf_counter(), wait.value
            elif p.nbatch == TRAIN_WARMUP + TRAIN_STEPS - 1:
                torch.cuda.synchronize()
                state["t1"], state["w1"] = time.perf_counter(), wait.value
                if prof is not None:
                    prof.stop()
                state["train"] = {k: getattr(pk, k).launches
                                  for k in EPI_KERNELS}
                state["peak"] = torch.cuda.max_memory_allocated()

        def on_eval(p):
            state["val"] = {k: getattr(pk, k).launches - state["train"][k]
                            for k in EPI_KERNELS}
            m = p.eval_metric
            state["scored"] = m.metrics[0].num_inst
            state["metrics"] = dict(m.get_name_value())

        argv = ["--network", "resnet50_v1", "--layout", "NHWC", "--dtype",
                "bfloat16", "--batch-size", str(TRAIN_BATCH), "--lr", "0.02",
                "--num-epochs", "1", "--data-train", trec, "--data-val",
                vrec, "--top-k", "5", "--random-crop", "1",
                "--random-mirror", "1", "--rgb-mean",
                ",".join(map(str, IMAGENET_MEAN)), "--rgb-std",
                ",".join(map(str, IMAGENET_STD)), "--data-nthreads",
                str(threads), "--seed", str(args.seed), "--disp-batches",
                "1000"]
        # the train phase's graph: every BN -> ReLU fused, as there
        old = os.environ.get("MXTPU_PALLAS_CONV_EPILOGUE")
        os.environ["MXTPU_PALLAS_CONV_EPILOGUE"] = "1"
        try:
            train_imagenet.main(argv, batch_end_callback=on_batch,
                                eval_end_callback=on_eval)
        finally:
            if old is None:
                os.environ.pop("MXTPU_PALLAS_CONV_EPILOGUE")
            else:
                os.environ["MXTPU_PALLAS_CONV_EPILOGUE"] = old
        no_pipeline_threads()
        losses = torch.stack(state["losses"]).float().cpu().numpy()
        if len(losses) != TRAIN_WARMUP + TRAIN_STEPS or \
                not np.isfinite(losses).all():
            raise AssertionError("record training losses: %s" % losses)
        for k in EPI_KERNELS:
            if state["train"][k] != 53 * TRAIN_STEPS:
                raise AssertionError("%s launched %d times in %d record "
                                     "steps, not %d" % (
                                         k, state["train"][k], TRAIN_STEPS,
                                         53 * TRAIN_STEPS))
            if state["val"][k] != 0:
                raise AssertionError("%s launched %d times in validation"
                                     % (k, state["val"][k]))
        if state["scored"] != REC_VAL:
            raise AssertionError("validation scored %d samples, not %d"
                                 % (state["scored"], REC_VAL))
        wall = state["t1"] - state["t0"]
        waited = state["w1"] - state["w0"]
        ips = TRAIN_BATCH * TRAIN_STEPS / wall
        log("  train_imagenet from records: %d timed steps (after %d "
            "warm-up) in %.3f s: %.1f images/s, %.2f ms a step, against "
            "%.1f images/s of the train phase's one synthetic batch on the "
            "card; the loop waited in next() %.3f s = %.1f%% of the step "
            "time; %d decode threads; peak allocated %d bytes; losses %s; "
            "launches %s (= 53 x %d each), validation launches %s; "
            "validation scored %d samples: %s; %s" % (
                TRAIN_STEPS, TRAIN_WARMUP, wall, ips, wall / TRAIN_STEPS * 1e3,
                synthetic_ips, waited, 100.0 * waited / wall, threads,
                state["peak"], ["%.4f" % v for v in losses],
                json.dumps(state["train"]), TRAIN_STEPS,
                json.dumps(state["val"]), state["scored"],
                json.dumps({k: round(v, 6) for k, v in
                            state["metrics"].items()}), card))
        if prof is not None:
            busy = 0.0
            for ev in prof.key_averages():
                if is_annotation(ev) or \
                        not str(ev.device_type).endswith("CUDA"):
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0)
                busy += dev_us / 1e3
            log("  profile of the timed steps (the profiler slows the "
                "host): device busy %.2f ms a step = %.1f%% of the %.2f ms "
                "step; %s" % (busy / TRAIN_STEPS, 100.0 * busy / (wall * 1e3),
                              wall / TRAIN_STEPS * 1e3, card))
        for n_threads, batches in ((1, 2), (4, 4), (threads, 6)):
            decode_rate(trec, n_threads, batches, card)
        no_pipeline_threads()

        # the gluon DataLoader over the validation records, after CUDA is up
        tf = T.Compose([T.CenterCrop(224), T.ToTensor(),
                        T.Normalize([m / 255 for m in IMAGENET_MEAN],
                                    [s / 255 for s in IMAGENET_STD])])
        dataset = ImageRecordDataset(vrec).transform_first(tf)
        runs = {}
        for workers in (0, 4):
            loader = DataLoader(dataset, batch_size=TRAIN_BATCH,
                                num_workers=workers, timeout=120)
            secs = []
            try:
                for _ in range(2):   # the first pass forks the workers
                    t0 = time.perf_counter()
                    runs[workers] = [(x.asnumpy(), y.asnumpy())
                                     for x, y in loader]
                    secs.append(time.perf_counter() - t0)
            finally:
                loader.close()
            log("  gluon DataLoader (ImageRecordDataset + CenterCrop, "
                "ToTensor, Normalize; batches on the card) at %d workers: "
                "%.1f images/s in the first pass over the %d images (%.3f "
                "s), %.1f in the second; %s" % (
                    workers, REC_VAL / secs[0], REC_VAL, secs[0],
                    REC_VAL / secs[1], card))
        left = multiprocessing.active_children()
        if left:
            raise AssertionError("DataLoader worker processes left: %s"
                                 % left)
        for (x0, y0), (x4, y4) in zip(runs[0], runs[4]):
            if not (np.array_equal(x0, x4) and np.array_equal(y0, y4)):
                raise AssertionError("DataLoader batches differ between 0 "
                                     "and 4 workers")
        x = np.concatenate([r[0] for r in runs[4]])
        mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(1, 3, 1, 1)
        std = np.asarray(IMAGENET_STD, np.float32).reshape(1, 3, 1, 1)
        err = float(np.abs(x - (want - mean) / std).max())
        if x.shape != want.shape or err > 1e-6:
            raise AssertionError("DataLoader batches differ from the "
                                 "iterator's normalized crops by %g" % err)
        log("  DataLoader batches at 0 and 4 workers equal; against the "
            "iterator's normalized center crops max abs err %.3g (tol "
            "1e-6); no worker process left; the phase took %.1f s"
            % (err, time.monotonic() - t_phase))
    return state["train"]


# ---------------------------------------------------------------------------
# phase 4, train_vision: the rest of the vision zoo trained through
# train_imagenet's build_network and DistributedTrainer
# ---------------------------------------------------------------------------

# Inception v3 as bench.py's _TRAIN_NETS row (bench.py:178): batch 128 at
# 299 x 299, 3 x 11.46e9 FLOPs an image for a training step
VISION_BATCH, VISION_SIDE, VISION_FLOPS = 128, 299, 3 * 11.46e9
# every other family at full width: its BatchNorms, and those whose
# backward runs (ResNet v2's input BatchNorm has no gamma or beta and its
# input, the image, takes no gradient, so autograd runs no backward for it)
VISION_OTHERS = [("alexnet", 0, 0), ("vgg16_bn", 13, 13),
                 ("squeezenet1_1", 0, 0), ("densenet121", 121, 121),
                 ("mobilenet1_0", 27, 27), ("mobilenet_v2_1_0", 53, 53),
                 ("resnet50_v2", 51, 50)]
VISION_OTHER_BATCH, VISION_OTHER_STEPS = 32, 2
INCEPTION_BNS = 94


def vision_trainer(torch, name, side, seed, amp="bfloat16", lr=0.02,
                   device="cuda"):
    """``name`` built by `train_imagenet.build_network` (NHWC, 1000
    classes, Xavier from ``seed``) and its `DistributedTrainer` (SGD,
    momentum 0.9, wd 1e-4, softmax cross-entropy, ``amp`` over f32
    masters)."""
    from mxnet_tpu_torch import train_imagenet
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import DistributedTrainer

    net = train_imagenet.build_network(name, 1000, (3, side, side), "NHWC",
                                       device, seed)
    tr = DistributedTrainer(
        net, "sgd", {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype=amp)
    return net, tr


def vision_batch(torch, seed, batch, side, device="cuda"):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, side, side, 3))
                         .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, 1000, batch)).to(device)
    return x, y


def profile_vision(torch, trainer, x, y, step_ms, label, steps=2):
    """Device busy time of ``steps`` steps under `torch.profiler`, as a
    share of ``step_ms`` (timed without it), split into the conv-epilogue
    kernels, depthwise convolutions, other convolutions and the rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(x, y)
        torch.cuda.synchronize()
    groups = {"conv epilogue": lambda k: any(
                  "::%s<" % f in k or "::%s(" % f in k for f in EPI_FUNCS),
              # cuDNN's grouped kernels of one channel a group
              "depthwise conv": lambda k: "depthwise" in k.lower()
              or "_c1_k1_" in k,
              "other conv": lambda k: any(
                  t in k for t in ("xmma", "cudnn", "conv", "implicit_gemm",
                                   "cutlass")),
              "rest": lambda k: True}
    shares = dict.fromkeys(groups, 0.0)
    rows, host = [], []
    for ev in prof.key_averages():
        if is_annotation(ev):
            continue
        if not str(ev.device_type).endswith("CUDA"):
            host.append((ev.self_cpu_time_total / steps / 1e3,
                         ev.count // steps, ev.key))
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        rows.append((us / steps / 1e3, ev.count // steps, ev.key))
        for name, test in groups.items():
            if test(ev.key):
                shares[name] += us / steps / 1e3
                break
    busy = sum(shares.values())
    rows.sort(reverse=True)
    host.sort(reverse=True)
    log("  profile %s: device busy %.3f ms a step = %.1f%% of the %.2f ms "
        "step; %s" % (label, busy, 100.0 * busy / step_ms, step_ms,
                      "; ".join("%s %.3f ms (%.1f%%)" % (
                          k, v, 100.0 * v / max(busy, 1e-9))
                          for k, v in shares.items())))
    for ms, count, key in rows[:10]:
        log("    %8.3f ms  x%-4d %s" % (ms, count, key[:100]))
    log("    host, by own CPU time a step (profiled):")
    for ms, count, key in host[:8]:
        log("    %8.3f ms  x%-4d %s" % (ms, count, key[:100]))


def train_vision(torch, pk, args):
    """Inception v3 (NHWC, bf16 over f32 masters, batch 128 at 299 x 299,
    SGD lr 0.02 with momentum) on one synthetic batch: 3 warm-up steps,
    then the epilogue counts set to 0 and 10 timed steps; then every other
    family at full width, 2 steps each at batch 32. Returns the epilogue
    kernels' launches in the Inception run."""
    from mxnet_tpu_torch.gluon import nn as gnn

    t0 = time.monotonic()
    net, trainer = vision_trainer(torch, "inception_v3", VISION_SIDE,
                                  args.seed)
    n_bn = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
    if n_bn != INCEPTION_BNS:
        raise AssertionError("inception_v3 has %d BatchNorms, not %d"
                             % (n_bn, INCEPTION_BNS))
    fwd_flops, stem_flops = count_flops(torch, net, gnn,
                                        (VISION_SIDE, VISION_SIDE, 3))
    x, y = vision_batch(torch, args.seed + 7, VISION_BATCH, VISION_SIDE)
    log("train_vision: inception_v3 NHWC bf16, %d parameters, %d "
        "BatchNorms, built in %.1f s; %.4g forward FLOPs an image by the "
        "forward hooks (3 x that = %.4g; bench.py's row: %.4g)"
        % (sum(p.numel() for p in net.parameters()), n_bn,
           time.monotonic() - t0, fwd_flops, 3 * fwd_flops, VISION_FLOPS))
    t0 = time.monotonic()
    warm = [float(trainer.step(x, y)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    log("  %d warm-up steps in %.2f s, losses %s"
        % (TRAIN_WARMUP, time.monotonic() - t0, ["%.4f" % v for v in warm]))
    torch.cuda.reset_peak_memory_stats()
    for k in EPI_KERNELS:   # the Inception path's counts start here
        getattr(pk, k).launches = 0
    t0 = time.monotonic()
    losses = [trainer.step(x, y) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite inception_v3 loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("inception_v3 loss did not fall over the timed "
                             "steps: %s" % losses)
    for k, n in launches.items():
        if n != n_bn * TRAIN_STEPS:
            raise AssertionError("%s launched %d times in %d inception_v3 "
                                 "steps, not %d" % (k, n, TRAIN_STEPS,
                                                    n_bn * TRAIN_STEPS))
    ips = VISION_BATCH * TRAIN_STEPS / wall
    step_ms = wall / TRAIN_STEPS * 1e3
    log("  %d timed steps in %.3f s: %.1f images/s, %.2f ms a step; MFU "
        "%.4f (bench.py's 3 x 11.46e9 FLOPs an image at 989 TFLOP/s bf16; "
        "%.4f by the hooks' count); peak allocated %d bytes; losses %s; "
        "launches %s (= %d x %d each)"
        % (TRAIN_STEPS, wall, ips, step_ms,
           ips * VISION_FLOPS / BF16_FLOPS_PER_S,
           ips * 3 * fwd_flops / BF16_FLOPS_PER_S, peak,
           ["%.4f" % v for v in losses], json.dumps(launches), n_bn,
           TRAIN_STEPS))
    if args.profile:
        profile_vision(torch, trainer, x, y, step_ms, "inception_v3")
    del net, trainer, x, y
    torch.cuda.empty_cache()
    for name, bns, bwd in VISION_OTHERS:
        t0 = time.monotonic()
        net, trainer = vision_trainer(torch, name, 224, args.seed)
        n_bn = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
        if n_bn != bns:
            raise AssertionError("%s has %d BatchNorms, not %d"
                                 % (name, n_bn, bns))
        x, y = vision_batch(torch, args.seed + 8, VISION_OTHER_BATCH, 224)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in EPI_KERNELS:
            getattr(pk, k).launches = 0
        first = time.monotonic()
        losses = [float(trainer.step(x, y))]
        last = time.monotonic()
        losses += [float(trainer.step(x, y))
                   for _ in range(VISION_OTHER_STEPS - 1)]
        step_ms = (time.monotonic() - last) / (VISION_OTHER_STEPS - 1) * 1e3
        counts = {k: getattr(pk, k).launches for k in EPI_KERNELS}
        if not np.isfinite(losses).all():
            raise AssertionError("non-finite %s loss: %s" % (name, losses))
        for k, n in counts.items():
            want = (bns if k in ("epi_stats", "epi_apply") else bwd) \
                * VISION_OTHER_STEPS
            if n != want:
                raise AssertionError("%s launched %d times in %d %s steps, "
                                     "not %d" % (k, n, VISION_OTHER_STEPS,
                                                 name, want))
        log("  %s NHWC bf16 batch %d: built in %.1f s, first step %.1f ms, "
            "then %.2f ms a step (%.1f images/s); peak allocated %d bytes; "
            "losses %s; epilogue launches %s (forward %d x %d, backward "
            "%d x %d)"
            % (name, VISION_OTHER_BATCH, first - t0,
               (last - first) * 1e3, step_ms,
               VISION_OTHER_BATCH / step_ms * 1e3,
               torch.cuda.max_memory_allocated(),
               ["%.4f" % v for v in losses], json.dumps(counts), bns,
               VISION_OTHER_STEPS, bwd, VISION_OTHER_STEPS))
        if args.profile and name in ("densenet121", "mobilenet1_0",
                                     "mobilenet_v2_1_0"):
            profile_vision(torch, trainer, x, y, step_ms, name)
        del net, trainer, x, y
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4: BERT-base pretraining through DistributedTrainer
# ---------------------------------------------------------------------------

# bench.py's bench_bert: batch 8 x 512 tokens, vocab 30522, Adam lr 1e-4,
# bf16 over f32 masters; warm-up steps, then timed steps
BERT_BATCH, BERT_SEQ, BERT_VOCAB = 8, 512, 30522
BERT_WARMUP, BERT_STEPS = 3, 10
BERT_PARAMS = 132953658   # 109,482,240 BERT + 23,471,418 MLM head


def bert_pretrain(torch, device, vocab=BERT_VOCAB, mini=False):
    """bench.py's pretraining block: a BERT (`bert_12_768_12`, or
    `bert_mini`) without dropout and an MLM Dense(vocab, flatten=False) on
    its sequence output; children ``bert`` and ``mlm``."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo import transformer as zoo

    class BERTPretrain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            make = zoo.bert_mini if mini else zoo.bert_12_768_12
            self.bert = make(vocab_size=vocab, dropout=0.0, device=device)
            units = self.bert.pooler.weight.shape[0]
            self.mlm = gnn.Dense(vocab, flatten=False, in_units=units,
                                 device=device)

        def forward(self, tokens):
            return self.mlm(self.bert(tokens)[0])

    return BERTPretrain()


def profile_bert(torch, trainer, x, y, step_ms, steps=3):
    """`torch.profiler` over ``steps`` BERT steps: the device busy share
    against ``step_ms`` (timed without the profiler) and device time by
    group: the flash kernels and the GEMMs by kernel name, LayerNorm by the
    `_LayerNorm` Function that launched it, the optimizer by the trainer's
    ``trainer.optimizer`` range, the copies that reshapes and
    ``contiguous`` make (chiefly the attention heads' (B, L, H, Dh) <->
    (B*H, L, Dh) layout, in both directions), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(x, y)
        torch.cuda.synchronize()
    kernels = {}
    by_range = {"LayerNorm": 0.0, "optimizer": 0.0, "layout copies": 0.0}
    for ev in prof.events():
        if is_annotation(ev):
            continue
        if str(ev.device_type).endswith("CUDA"):
            row = kernels.setdefault(ev.name, [0.0, 0])
            row[0] += (ev.time_range.end - ev.time_range.start) / 1e3
            row[1] += 1
            continue
        launched = sum(k.duration for k in getattr(ev, "kernels", ()))
        if not launched:
            continue
        names, up = [], ev
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        if any("_LayerNorm" in n for n in names):
            by_range["LayerNorm"] += launched / 1e3
        elif "trainer.optimizer" in names:
            by_range["optimizer"] += launched / 1e3
        elif ev.name == "aten::copy_" and {"aten::reshape",
                                           "aten::contiguous"} & set(names):
            by_range["layout copies"] += launched / 1e3
    busy = sum(r[0] for r in kernels.values()) / steps
    groups = {"flash (this port's kernels)": lambda k: "::flash_" in k,
              "GEMM (cuBLAS)": lambda k: any(
                  t in k.lower() for t in ("gemm", "cutlass", "xmma",
                                           "nvjet", "cublas"))}
    shares = dict.fromkeys(groups, 0.0)
    for key, (ms, _) in kernels.items():
        for name, test in groups.items():
            if test(key):
                shares[name] += ms / steps
                break
    shares.update({k: v / steps for k, v in by_range.items()})
    shares["rest"] = busy - sum(shares.values())
    log("profile BERT step (bf16, %d x %d tokens, %d steps): device busy "
        "%.3f ms a step = %.1f%% of the %.2f ms step timed without the "
        "profiler; %s" % (x.shape[0], x.shape[1], steps, busy,
                          100.0 * busy / step_ms, step_ms,
                          "; ".join("%s %.3f ms" % kv
                                    for kv in shares.items())))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for key, (ms, count) in top:
        log("  %8.3f ms  x%-4d %s" % (ms / steps, count // steps, key[:100]))
    host = sorted(((ev.self_cpu_time_total / steps / 1e3, ev.count // steps,
                    ev.key) for ev in prof.key_averages()
                   if not str(ev.device_type).endswith("CUDA")),
                  reverse=True)
    log("  host, by own CPU time a step (profiled):")
    for ms, count, key in host[:12]:
        log("  %8.3f ms  x%-4d %s" % (ms, count, key[:100]))


def train_bert(torch, pk, args):
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import DistributedTrainer

    t0 = time.monotonic()
    net = initializer.initialize(bert_pretrain(torch, "cuda"),
                                 seed=args.seed)
    n_params = sum(p.numel() for p in net.parameters())
    if n_params != BERT_PARAMS:
        raise AssertionError("BERT-base + MLM head has %d parameters, not %d"
                             % (n_params, BERT_PARAMS))
    # bench.py's count: 6 x the parameters less the word, segment and
    # position tables, plus 12 x layers x units x seq for the scores
    embed = sum(t._held("weight").numel() for t in (
        net.bert.word_embed, net.bert.token_type_embed,
        net.bert.position_embed))
    layers = len(net.bert.encoder.cells)
    flops_token = 6 * (n_params - embed) + 12 * layers * 768 * BERT_SEQ
    rng = np.random.RandomState(args.seed + 4)
    x = torch.from_numpy(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
                         .astype(np.float32)).cuda()
    trainer = DistributedTrainer(
        net, "adam", {"learning_rate": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype="bfloat16")
    log("train: BERT-base (12 x 768, 12 heads) + MLM head (vocab %d), %d "
        "parameters, built in %.1f s; %d FLOPs a token (bench.py's count)"
        % (BERT_VOCAB, n_params, time.monotonic() - t0, flops_token))
    t0 = time.monotonic()
    warm = [float(trainer.step(x, y)) for _ in range(BERT_WARMUP)]
    torch.cuda.synchronize()
    log("  %d warm-up steps in %.2f s, losses %s"
        % (BERT_WARMUP, time.monotonic() - t0, ["%.4f" % v for v in warm]))
    torch.cuda.reset_peak_memory_stats()
    for k in FLASH_KERNELS:   # the BERT path's counts start here
        getattr(pk, k).launches = 0
    t0 = time.monotonic()
    losses = [trainer.step(x, y) for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite BERT loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("BERT loss did not fall over the timed steps: "
                             "%s" % losses)
    for k, n in launches.items():
        if n != layers * BERT_STEPS:
            raise AssertionError("%s launched %d times in %d steps, not %d"
                                 % (k, n, BERT_STEPS, layers * BERT_STEPS))
    tps = BERT_BATCH * BERT_SEQ * BERT_STEPS / wall
    log("  %d timed steps in %.3f s: %.1f tokens/s, %.2f ms a step; MFU "
        "%.4f (%d FLOPs a token at 989 TFLOP/s bf16); peak allocated %d "
        "bytes; losses %s; launches %s (= %d x %d each)"
        % (BERT_STEPS, wall, tps, wall / BERT_STEPS * 1e3,
           tps * flops_token / BF16_FLOPS_PER_S, flops_token, peak,
           ["%.4f" % v for v in losses], json.dumps(launches), layers,
           BERT_STEPS))
    if args.profile:
        profile_bert(torch, trainer, x, y, wall / BERT_STEPS * 1e3)
    return launches


# ---------------------------------------------------------------------------
# phase 4: word-LM training and evaluation
# ---------------------------------------------------------------------------

# bench.py's bench_lstm: RNNModel(10000, 650, 650, 2, dropout 0), bptt 35,
# batch 32, SGD lr 1.0, bf16 over f32 masters; warm-up steps, then timed
# steps; the evaluation's windows
LM_VOCAB, LM_UNITS, LM_LAYERS, LM_BPTT, LM_BATCH = 10000, 650, 2, 35, 32
LM_WARMUP, LM_STEPS, LM_EVAL_WINDOWS = 3, 10, 4
LM_PARAMS = 19780400
# bench.py:1176-1179: 4 gates x (h x in + h x h) multiply-adds x 2 a layer,
# the decoder's h x vocab x 2, all x 3 for training
LM_FLOPS_TOKEN = 3 * (sum(2 * 4 * (LM_UNITS * LM_UNITS + LM_UNITS * LM_UNITS)
                          for _ in range(LM_LAYERS))
                      + 2 * LM_UNITS * LM_VOCAB)
# the card's evaluation against the CPU's, f32 over 4 x 35 steps: rtol 1e-4
# with a floor of 1e-4 x max|CPU| (f32 sums in other orders, carried
# through the recurrence)
LM_EVAL_TOL = 1e-4


def seq_ce(gloss):
    """bench_lstm's SeqCE, softmax cross-entropy over (-1, vocab), taken on
    the logits cast to f32. From Xavier weights the logits are about 4e-3,
    so every token's loss is ln(10000) = 9.2103 to within 1e-2, and in bf16
    each one rounds to 9.1875 (bf16 steps are 0.0625 there): a bf16 loss
    stays flat for hundreds of SGD steps at lr 1.0 and cannot show the fall
    this phase checks. The model's forward and backward stay bf16."""
    ce = gloss.SoftmaxCrossEntropyLoss()

    def loss(pred, label):
        return ce(pred.float().reshape(-1, pred.shape[-1]),
                  label.reshape(-1))

    return loss


def profile_word_lm(torch, trainer, x, y, step_ms, steps=3):
    """`lstm_profile` over ``steps`` word-LM steps."""
    lstm_profile(torch, lambda: [trainer.step(x, y) for _ in range(steps)],
                 steps, "profile word-LM step (bf16, %d x %d tokens, %d "
                 "steps)" % (x.shape[0], x.shape[1], steps), step_ms)


def lstm_profile(torch, run, steps, label, step_ms):
    """`torch.profiler` over ``run()``, ``steps`` steps of an LSTM model:
    the device busy share against ``step_ms`` (timed without the profiler)
    and device time by group: the LSTM kernels and the GEMMs by kernel
    name, the loss (softmax, log-softmax and their gathers, both ways) by
    kernel name, the optimizer by a ``trainer.optimizer`` range, and the
    rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, optimizer = {}, 0.0
    for ev in prof.events():
        if is_annotation(ev):
            continue
        if str(ev.device_type).endswith("CUDA"):
            row = kernels.setdefault(ev.name, [0.0, 0])
            row[0] += (ev.time_range.end - ev.time_range.start) / 1e3
            row[1] += 1
            continue
        launched = sum(k.duration for k in getattr(ev, "kernels", ()))
        if not launched:
            continue
        names, up = [], ev
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        if "trainer.optimizer" in names:
            optimizer += launched / 1e3
    busy = sum(r[0] for r in kernels.values()) / steps
    groups = {"LSTM (this port's kernels)": lambda k: "lstm_" in k,
              "GEMM (cuBLAS)": lambda k: any(
                  t in k.lower() for t in ("gemm", "cutlass", "xmma",
                                           "nvjet", "cublas")),
              "loss (log-softmax, gather)": lambda k: any(
                  t in k.lower() for t in ("softmax", "gather", "scatter"))}
    shares = dict.fromkeys(groups, 0.0)
    for key, (ms, _) in kernels.items():
        for name, test in groups.items():
            if test(key):
                shares[name] += ms / steps
                break
    shares["optimizer"] = optimizer / steps
    shares["rest"] = busy - sum(shares.values())
    log("%s: device busy %.3f ms a step = %.1f%% of the %.2f ms step timed "
        "without the profiler; %s" % (label, busy, 100.0 * busy / step_ms,
                                      step_ms, "; ".join(
                                          "%s %.3f ms" % kv
                                          for kv in shares.items())))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for key, (ms, count) in top:
        log("  %8.3f ms  x%-4d %s" % (ms / steps, count // steps, key[:100]))
    host = sorted(((ev.self_cpu_time_total / steps / 1e3, ev.count // steps,
                    ev.key) for ev in prof.key_averages()
                   if not str(ev.device_type).endswith("CUDA")),
                  reverse=True)
    log("  host, by own CPU time a step (profiled):")
    for ms, count, key in host[:10]:
        log("  %8.3f ms  x%-4d %s" % (ms, count, key[:100]))


def train_word_lm(torch, pk, args):
    """bench_lstm's training on the card. Returns the launch counts of the
    timed steps and the trained model."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
    from mxnet_tpu_torch.parallel import DistributedTrainer

    t0 = time.monotonic()
    net = RNNModel(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.0,
                   device="cuda").initialize(seed=args.seed)
    n_params = sum(p.numel() for p in net.parameters())
    if n_params != LM_PARAMS:
        raise AssertionError("RNNModel(10000, 650, 650, 2) has %d "
                             "parameters, not %d" % (n_params, LM_PARAMS))
    rng = np.random.RandomState(args.seed + 6)
    x = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                         .astype(np.float32)).cuda()
    trainer = DistributedTrainer(net, "sgd", {"learning_rate": 1.0},
                                 loss=seq_ce(gloss), amp_dtype="bfloat16")
    log("train: word LM RNNModel(%d, %d, %d, %d layers), %d parameters, "
        "built in %.1f s; %d FLOPs a token (bench.py's count)"
        % (LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, n_params,
           time.monotonic() - t0, LM_FLOPS_TOKEN))
    t0 = time.monotonic()
    warm = [float(trainer.step(x, y)) for _ in range(LM_WARMUP)]
    torch.cuda.synchronize()
    log("  %d warm-up steps in %.2f s, losses %s"
        % (LM_WARMUP, time.monotonic() - t0, ["%.4f" % v for v in warm]))
    torch.cuda.reset_peak_memory_stats()
    for k in LSTM_KERNELS:   # the word-LM training path's counts start here
        getattr(pk, k).launches = 0
    t0 = time.monotonic()
    losses = [trainer.step(x, y) for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite word-LM loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("word-LM loss did not fall over the timed "
                             "steps: %s" % losses)
    want = {"lstm_infer": 0, "lstm_fwd": LM_LAYERS * LM_STEPS,
            "lstm_bwd": LM_LAYERS * LM_STEPS}
    if launches != want:
        raise AssertionError("word-LM training launches %s, not %s"
                             % (launches, want))
    tps = LM_BPTT * LM_BATCH * LM_STEPS / wall
    log("  %d timed steps in %.3f s: %.1f tokens/s, %.2f ms a step; MFU "
        "%.4f (%d FLOPs a token at 989 TFLOP/s bf16); peak allocated %d "
        "bytes; losses %s; launches %s"
        % (LM_STEPS, wall, tps, wall / LM_STEPS * 1e3,
           tps * LM_FLOPS_TOKEN / BF16_FLOPS_PER_S, LM_FLOPS_TOKEN, peak,
           ["%.4f" % v for v in losses], json.dumps(launches)))
    if args.profile:
        profile_word_lm(torch, trainer, x, y, wall / LM_STEPS * 1e3)
    return {k: launches[k] for k in ("lstm_fwd", "lstm_bwd")}, net


def eval_word_lm(torch, pk, args, net):
    """Truncated-BPTT evaluation of the trained model (its f32 master
    weights) under no_grad: LM_EVAL_WINDOWS consecutive (35, 32) windows,
    the state carried from one to the next (`begin_state`, then the
    returned state); perplexity of the next-token labels. Then the same
    windows through a CPU copy of the model (the plain versions): the
    logits of every window and the final state must agree."""
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel

    rng = np.random.RandomState(args.seed + 7)
    stream = rng.randint(0, LM_VOCAB, (LM_EVAL_WINDOWS * LM_BPTT + 1,
                                       LM_BATCH)).astype(np.int64)
    windows = [torch.from_numpy(stream[i * LM_BPTT:(i + 1) * LM_BPTT])
               for i in range(LM_EVAL_WINDOWS)]
    labels = [torch.from_numpy(stream[i * LM_BPTT + 1:(i + 1) * LM_BPTT + 1])
              for i in range(LM_EVAL_WINDOWS)]
    cpu = RNNModel(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.0,
                   device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})

    def run(model, device):
        model.eval()
        state = model.begin_state(LM_BATCH)
        outs, nll = [], 0.0
        with torch.no_grad():
            for w, lab in zip(windows, labels):
                logits, state = model(w.to(device), state)
                logp = torch.log_softmax(logits.float(), dim=-1)
                nll += float(-logp.gather(-1, lab.to(device)[..., None])
                             .mean())
                outs.append(logits)
        return outs, state, float(np.exp(nll / len(windows)))

    for k in LSTM_KERNELS:   # the evaluation path's counts start here
        getattr(pk, k).launches = 0
    t0 = time.monotonic()
    outs, state, ppl = run(net, "cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    want = {"lstm_infer": LM_LAYERS * LM_EVAL_WINDOWS, "lstm_fwd": 0,
            "lstm_bwd": 0}
    if launches != want:
        raise AssertionError("word-LM evaluation launches %s, not %s"
                             % (launches, want))
    if not np.isfinite(ppl):
        raise AssertionError("word-LM evaluation perplexity %s" % ppl)
    cpu_outs, cpu_state, cpu_ppl = run(cpu, "cpu")
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs, cpu_outs)):
        worst = max(worst, max_err(torch, a.cpu(), b, LM_EVAL_TOL,
                                   "word-LM evaluation logits, window %d"
                                   % i))
    for name, a, b in zip(("h", "c"), state, cpu_state):
        worst = max(worst, max_err(torch, a.cpu(), b, LM_EVAL_TOL,
                                   "word-LM evaluation final " + name))
    log("eval: word LM, %d windows of %d x %d tokens with the state carried, "
        "f32, in %.3f s: perplexity %.3f (CPU %.3f); the logits of every "
        "window and the final state equal the CPU run's (max abs err %.3g, "
        "tol %g x |CPU| + %g x max|CPU|); launches %s"
        % (LM_EVAL_WINDOWS, LM_BPTT, LM_BATCH, wall, ppl, cpu_ppl, worst,
           LM_EVAL_TOL, LM_EVAL_TOL, json.dumps(launches)))
    return {"lstm_infer": launches["lstm_infer"]}


# ---------------------------------------------------------------------------
# phase 4, last part: the word LM through the Gluon façade, as the JAX
# package's examples/rnn/word_lm.py loop drives it
# ---------------------------------------------------------------------------

# windows of 35 x 32 tokens: warm-up, timed, then evaluation
FACADE_WARMUP, FACADE_STEPS, FACADE_EVAL = 2, 10, 4
# the reference's word_lm train(): clip the gradients' global norm at
# clip x bptt x batch
FACADE_CLIP = 0.25
# successors of each token in the smoke's corpus
FACADE_SUCCESSORS = 4


def facade_corpus(seed, windows=FACADE_WARMUP + FACADE_STEPS + FACADE_EVAL):
    """(windows x 35 + 2, 32) token ids, TNC: 32 streams of a Markov chain
    in which each of the 10,000 tokens has 4 successors drawn from the
    seed, so a model can learn it (the loss can fall)."""
    rng = np.random.RandomState(seed + 10)
    succ = rng.randint(0, LM_VOCAB, (LM_VOCAB, FACADE_SUCCESSORS))
    rows = [rng.randint(0, LM_VOCAB, LM_BATCH)]
    for _ in range(windows * LM_BPTT + 1):
        rows.append(succ[rows[-1], rng.randint(0, FACADE_SUCCESSORS,
                                               LM_BATCH)])
    return np.stack(rows).astype(np.int32)


def device_busy_ms(torch, run, steps):
    """Device busy time a step of ``run()`` (``steps`` steps), from the
    kernels on a `torch.profiler` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum((ev.time_range.end - ev.time_range.start) / 1e3
               for ev in prof.events()
               if str(ev.device_type).endswith("CUDA")
               and not is_annotation(ev))
    return busy / steps


def facade_word_lm(torch, pk, args):
    """The word LM at bench_lstm's width through the Gluon façade: an
    `RNNModel` built and initialised (Xavier, from the seed, on the card)
    through `gluon`, `gluon.Trainer` with SGD lr 1.0, softmax cross-entropy
    and `train_word_lm.train_epoch`'s truncated BPTT over `facade_corpus`
    as the reference's word_lm ``train()`` runs it (the state detached and
    carried; a loss a token, summed by the backward, gradients clipped at
    0.25 x 35 x 32, ``trainer.step(32)``), f32: 2 warm-up windows, then the
    LSTM launch counts set to 0 and 10 timed windows, each ``record()`` /
    ``backward()`` / ``trainer.step``.
    Then 4 evaluation windows of ``net(x, state)`` outside ``record()``
    with `metric.Perplexity`; ``--profile`` then traces 3 more windows.
    Returns the launch counts of training and evaluation."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, metric, nd
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
    from mxnet_tpu_torch.train_word_lm import train_epoch

    dev = mx.gpu(0)
    corpus = facade_corpus(args.seed)
    t0 = time.monotonic()
    with mx.context.scope(dev):
        net = RNNModel(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.0)
        net.initialize(mx.init.Xavier(), ctx=dev, seed=args.seed)
        n_params = sum(int(np.prod(p.shape))
                       for p in net.collect_params().values())
        if n_params != LM_PARAMS:
            raise AssertionError("façade RNNModel has %d parameters, not %d"
                                 % (n_params, LM_PARAMS))
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1.0})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()

        def train(state, start, count):
            return train_epoch(net, trainer, ce, corpus, LM_BPTT, LM_BATCH,
                               ctx=dev, state=state, start=start,
                               limit_batches=count, clip=FACADE_CLIP,
                               flat_loss=True)

        warm, state = train(None, 0, FACADE_WARMUP)
        torch.cuda.synchronize()
        log("façade: word LM RNNModel(%d, %d, %d, %d layers) through "
            "gluon, %d parameters, f32; %d warm-up windows in %.2f s, "
            "losses %s" % (LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, n_params,
                           FACADE_WARMUP, time.monotonic() - t0,
                           ["%.4f" % v for v in warm]))
        torch.cuda.reset_peak_memory_stats()
        for k in LSTM_KERNELS:   # the façade training path's counts
            getattr(pk, k).launches = 0
        t0 = time.monotonic()
        losses, state = train(state, FACADE_WARMUP, FACADE_STEPS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        train_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        everything = np.asarray(warm + losses)
        if not np.isfinite(everything).all():
            raise AssertionError("non-finite façade loss: %s" % everything)
        if not everything[-1] < everything[0]:
            raise AssertionError("façade word-LM loss did not fall: %s"
                                 % everything)
        want = {"lstm_infer": 0, "lstm_fwd": LM_LAYERS * FACADE_STEPS,
                "lstm_bwd": LM_LAYERS * FACADE_STEPS}
        if train_launches != want:
            raise AssertionError("façade training launches %s, not %s"
                                 % (train_launches, want))
        tps = LM_BPTT * LM_BATCH * FACADE_STEPS / wall
        log("  %d timed windows of %d x %d tokens in %.3f s: %.1f tokens/s, "
            "%.2f ms a window; peak allocated %d bytes (%s); losses %s; "
            "launches %s" % (FACADE_STEPS, LM_BPTT, LM_BATCH, wall, tps,
                             wall / FACADE_STEPS * 1e3, peak, smi_line(),
                             ["%.4f" % v for v in losses],
                             json.dumps(train_launches)))
        ppl = metric.Perplexity()
        for k in LSTM_KERNELS:   # the façade evaluation's counts
            getattr(pk, k).launches = 0
        first = (FACADE_WARMUP + FACADE_STEPS) * LM_BPTT
        t0 = time.monotonic()
        for i in range(FACADE_EVAL):
            t = first + i * LM_BPTT
            logits, state = net(nd.array(corpus[t:t + LM_BPTT],
                                         dtype="int32"), state)
            ppl.update([nd.array(corpus[t + 1:t + LM_BPTT + 1])],
                       [nd.softmax(logits)])
        torch.cuda.synchronize()
        eval_wall = time.monotonic() - t0
        eval_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
        if args.profile:   # after the evaluation, which it would change
            busy = device_busy_ms(
                torch, lambda: train(state, FACADE_STEPS - 1, 3), 3)
            log("  profile façade window (3 more windows, f32): device busy "
                "%.3f ms a window = %.1f%% of the %.2f ms window timed "
                "without the profiler" % (busy, 100.0 * busy * FACADE_STEPS
                                          / wall / 1e3,
                                          wall / FACADE_STEPS * 1e3))
    want = {"lstm_infer": LM_LAYERS * FACADE_EVAL, "lstm_fwd": 0,
            "lstm_bwd": 0}
    if eval_launches != want:
        raise AssertionError("façade evaluation launches %s, not %s"
                             % (eval_launches, want))
    name, value = ppl.get()
    if not np.isfinite(value):
        raise AssertionError("façade evaluation perplexity %s" % value)
    log("  evaluation: %d windows outside record() in %.3f s, %s %.3f "
        "(uniform would be %d); launches %s"
        % (FACADE_EVAL, eval_wall, name, value, LM_VOCAB,
           json.dumps(eval_launches)))
    return train_launches, eval_launches


# ---------------------------------------------------------------------------
# phase 5: a small ResNet's step on the card against the CPU
# ---------------------------------------------------------------------------

def insitu_parity(torch, args):
    """One f32 DistributedTrainer step of ResNetV1(BottleneckV1, [1, 1],
    [8, 16, 32], thumbnail) on the card (the kernels; TF32 off) and on the
    CPU (the plain versions) from the same weights and batch: the loss, and
    every parameter and running statistic both after the step and as the
    change the step made (a weight moves by about lr x its gradient, so
    the change is what holds the backward). Tolerance: rtol 1e-4 with a
    floor of 1e-4 x max|CPU value| of the compared tensor (f32 sums in
    other orders, cuDNN against the CPU's convolutions)."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as zoo
    from mxnet_tpu_torch.parallel import DistributedTrainer

    rng = np.random.RandomState(args.seed + 3)
    x = rng.uniform(-1, 1, (32, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 10, 32)
    nets, losses = {}, {}
    for dev in ("cpu", "cuda"):
        with gnn.layout_scope():
            nets[dev] = zoo.ResNetV1(zoo.BottleneckV1, [1, 1], [8, 16, 32],
                                     classes=10, thumbnail=True,
                                     fuse_epilogue=True, device=dev)
    nets["cpu"].initialize(seed=args.seed)
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"].load_state_dict(before)
    for dev, net in nets.items():
        tr = DistributedTrainer(net, "sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-4},
                                loss=gloss.SoftmaxCrossEntropyLoss())
        losses[dev] = float(tr.step(x, y))
    worst = max_err(torch, torch.tensor(losses["cuda"]),
                    torch.tensor(losses["cpu"]), 1e-4, "small ResNet loss")
    want = nets["cpu"].state_dict()
    worst_delta = 0.0
    for k, v in nets["cuda"].state_dict().items():
        v = v.cpu()
        worst = max(worst, max_err(torch, v, want[k], 1e-4,
                                   "small ResNet step: " + k))
        if v.is_floating_point():
            worst_delta = max(worst_delta, max_err(
                torch, v - before[k], want[k] - before[k], 1e-4,
                "small ResNet step, change of " + k))
    log("parity: one f32 step of the small ResNet on the card equals the "
        "CPU step (loss %.6f vs %.6f; %d tensors, max abs err %.3g after "
        "the step, %.3g in the change it made)"
        % (losses["cuda"], losses["cpu"], len(want), worst, worst_delta))


# the card-against-CPU steps of the vision families: (name, image side)
VISION_PARITY = [("inception_v3", 299), ("densenet121", 224),
                 ("mobilenet_v2_1_0", 224)]


# a layer's tolerance in the layer parity, relative to the sums of the
# magnitudes of the terms each of its results sums: cuDNN's f32 weight
# gradient of Inception v3's 5 x 5 convolutions (an algorithm its
# heuristics pick; TF32 off) was 8.2e-4 to 9.7e-4 of those sums from the
# CPU's in three runs and above 1e-3 in a fourth, on an H100 80GB HBM3
# (7e-4 of its L2 norm); PyTorch's own CUDA convolution 4e-7 and every
# other cuDNN convolution of the three nets within 9.1e-6. Convolutions
# take 4e-3, every other layer 1e-4
CONV_PARITY_TOL, LAYER_PARITY_TOL = 4e-3, 1e-4


def _layer_forward(ops_nn, mod, x, w, b):
    """A Conv2D's or a Dense layer's forward from its weight and bias,
    its activation included."""
    from mxnet_tpu_torch.gluon import nn as gnn

    if isinstance(mod, gnn.Conv2D):
        out = ops_nn.convolution(x, w, b, **mod._kwargs)
    else:
        out = ops_nn.fully_connected(x, w, b, flatten=mod._flatten)
    if mod._act_type is not None:
        out = ops_nn.activation(out, act_type=mod._act_type)
    return out


def _terms(torch, mod, x, g, ops_nn):
    """The sums of the magnitudes of the terms of a Conv2D's or a Dense
    layer's output, input gradient and parameter gradients: the same layer
    (without its activation) on |x|, |w| and the cotangent |g| (a sum's
    rounding scales with them, not with the sum)."""
    from mxnet_tpu_torch.gluon import nn as gnn

    xa = x.detach().abs().requires_grad_()
    w = mod._held("weight").detach().cpu().abs().requires_grad_()
    b = None
    if mod._held("bias") is not None:
        b = mod._held("bias").detach().cpu().abs().requires_grad_()
    if isinstance(mod, gnn.Conv2D):
        out = ops_nn.convolution(xa, w, b, **mod._kwargs)
    else:
        out = ops_nn.fully_connected(xa, w, b, flatten=mod._flatten)
    leaves = [xa, w] + ([] if b is None else [b])
    grads = torch.autograd.grad(out, leaves, g.abs())
    terms = {"out": out.detach(), "dx": grads[0], "weight": grads[1]}
    if b is not None:
        terms["bias"] = grads[2]
    return terms


def layer_parity(torch, net, x, y):
    """The card's f32 training forward and backward of ``net`` on (x, y),
    every layer recorded (each Conv2D, BatchNorm with its training
    statistics through the epilogue kernels, Dense, pooling and
    activation), then each recomputed on the CPU (the plain versions) from
    the very inputs, weights and output cotangent the card gave it: its output, its own share of its input's gradient, its
    parameters' gradients and, for a BatchNorm, its moving statistics
    after. Returns the loss, the largest error of each kind over its
    tolerance, and the layer count. Tolerance: rtol 1e-4 with a floor of
    a tolerance x the sums of the magnitudes of the terms the result sums
    (a gradient summed over the rows can cancel far below its terms, and
    summed in another order then differs by a rounding of the terms):
    `CONV_PARITY_TOL` for a convolution's results, `LAYER_PARITY_TOL` for
    the rest; a BatchNorm's or a parameterless layer's output and input
    gradient take 1e-4 x max|CPU value|, and a moving statistic 1e-4 x its largest change plus
    1e-4 x (1 - momentum) x the batch mean of |x| (of x^2 for the
    variance), the terms its batch mean sums."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.ops import nn as ops_nn

    records = []

    def hook(mod, inp, out):
        rec = {"mod": mod, "x": inp[0].detach().clone(),
               "out": out.detach().clone(), "grad_x": inp[0].requires_grad}
        if isinstance(mod, gnn.BatchNorm):
            rec["stats"] = [mod._held(n).detach().clone() for n in
                            ("running_mean", "running_var")]
        records.append(rec)
        mod._record = rec
        if out.requires_grad:   # ResNet v2's input BatchNorm: no grad
            out.register_hook(lambda g: rec.__setitem__("g", g.clone()))

    def backward_hook(mod, grad_in, grad_out):
        # this layer's own share of its input's gradient (the input's
        # tensor hook would see the sum over all its consumers)
        if grad_in[0] is not None:
            mod._record["dx"] = grad_in[0].detach().clone()

    def pre_hook(mod, inp):
        mod._stats_before = [mod._held(n).detach().clone() for n in
                             ("running_mean", "running_var")]

    hooks = []
    for m in net.modules():
        # every layer: the leaves of the module tree (the concatenations
        # and residual adds of the blocks above them are torch.cat and +)
        if isinstance(m, gnn.HybridBlock) and not list(m.children()):
            hooks.append(m.register_forward_hook(hook))
            hooks.append(m.register_full_backward_hook(backward_hook))
            if isinstance(m, gnn.BatchNorm):
                hooks.append(m.register_forward_pre_hook(pre_hook))
    net.train()
    for p in net.parameters():
        p.grad = None
    out = net(x)
    loss = F.cross_entropy(out.float(), y)
    with warnings.catch_warnings():
        # the first layer's hook fires with no input gradient, as meant
        warnings.simplefilter("ignore", UserWarning)
        loss.backward()
    for h in hooks:
        h.remove()
    worst = {"out": 0.0, "dx": 0.0, "grad": 0.0, "stats": 0.0}

    def check(kind, got, want, floor, what):
        got, want = got.detach().float().cpu(), want.detach().float()
        diff = (got - want).abs()
        bound = 1e-4 * want.abs() + floor
        excess = float((diff - bound).max())
        if excess > 0:
            raise AssertionError("%s: beyond tolerance by %g (largest "
                                 "|CPU value| %g)" % (
                                     what, excess, float(want.detach().abs().max())))
        worst[kind] = max(worst[kind], float(
            (diff / torch.as_tensor(bound).clamp_min(1e-30)).max()))

    for i, rec in enumerate(records):
        mod = rec["mod"]
        what = "%s %d (%s)" % (type(mod).__name__, i, mod.name)
        xc = rec["x"].cpu().requires_grad_(rec["grad_x"])
        params = [(n, p) for n, p in mod.named_parameters(recurse=False)
                  if p is not None]
        leaves = {n: p.detach().cpu().clone().requires_grad_(p.requires_grad)
                  for n, p in params}
        bn = isinstance(mod, gnn.BatchNorm)
        if bn:
            rm, rv = [t.cpu().clone() for t in mod._stats_before]
            want = ops_nn.batch_norm(xc, leaves["gamma"], leaves["beta"], rm,
                                     rv, is_train=True, **mod._kwargs)[0]
            # a moving statistic moves by (1 - momentum) x a batch mean
            # (of x, of the squared deviations): its rounding scales with
            # the mean of |x| (of x^2), which can be far above the mean
            with torch.no_grad():
                c = xc.shape[mod._axis]
                x2 = xc.detach().movedim(mod._axis, -1).reshape(-1, c)
                step = 1e-4 * (1 - mod._kwargs["momentum"])
                stat_floors = (step * x2.abs().mean(0),
                               step * x2.square().mean(0))
            for t, before, after, sf in zip((rm, rv), mod._stats_before,
                                            rec["stats"], stat_floors):
                change = t - before.cpu()
                check("stats", after - before, change,
                      1e-4 * float(change.abs().max()) + sf,
                      what + " moving statistic")
        elif isinstance(mod, (gnn.Conv2D, gnn.Dense)):
            want = _layer_forward(ops_nn, mod, xc, leaves["weight"],
                                  leaves.get("bias"))
        else:   # a layer without parameters: pooling, activation, Flatten
            want = mod(xc)
        if "g" not in rec:
            check("out", rec["out"], want, 1e-4 * float(want.detach().abs().max()),
                  what + " output")
            continue
        g = rec["g"].cpu()
        if bn:
            with torch.no_grad():
                c = xc.shape[mod._axis]
                x2 = xc.detach().movedim(mod._axis, -1).reshape(-1, c)
                var, mean = torch.var_mean(x2, 0, correction=0)
                xhat = (x2 - mean) * torch.rsqrt(var + mod._kwargs["eps"])
                g2 = g.movedim(mod._axis, -1).reshape(-1, c)
                floors = {"out": 1e-4 * float(want.detach().abs().max()),
                          "gamma": 1e-4 * (g2 * xhat).abs().sum(0),
                          "beta": 1e-4 * g2.abs().sum(0)}
        elif isinstance(mod, (gnn.Conv2D, gnn.Dense)):
            tol = CONV_PARITY_TOL if isinstance(mod, gnn.Conv2D) \
                else LAYER_PARITY_TOL
            floors = {k: tol * v for k, v in
                      _terms(torch, mod, xc, g, ops_nn).items()}
        else:
            floors = {"out": 1e-4 * float(want.detach().abs().max())}
        check("out", rec["out"], want, floors["out"], what + " output")
        need = [t for t in [xc] + list(leaves.values()) if t.requires_grad]
        grads = dict(zip([id(t) for t in need],
                         torch.autograd.grad(want, need, g)))
        if rec["grad_x"]:
            if "dx" not in rec:
                raise AssertionError("%s: no input gradient recorded" % what)
            ref = grads[id(xc)]
            check("dx", rec["dx"], ref, floors.get(
                "dx", 1e-4 * float(ref.abs().max())), what + " input gradient")
        for n, p in params:
            if p.grad is None or not p.requires_grad:
                continue
            check("grad", p.grad, grads[id(leaves[n])], floors[n],
                  "%s d%s" % (what, n))
    return float(loss.detach()), worst, len(records)


def vision_parity(torch, args):
    """Inception v3 at batch 2, 299 x 299, and DenseNet-121 and MobileNet
    v2 at batch 2, 224 x 224 (NHWC, full width, f32, TF32 off, Dropout at
    rate 0: the card's and the CPU's generators differ), from the same
    weights and batch. One `DistributedTrainer` step (SGD lr 0.1,
    momentum 0.9, wd 1e-4) on the card and on the CPU: the losses agree
    within rtol 1e-4. The step's every gradient cannot be held across the
    two devices element by element in f32: these deep ReLU + BatchNorm
    nets carry a rounding apart (cuDNN's and the CPU's convolutions sum in
    other orders) into ReLUs taking the other branch, and the gradients
    below then differ by up to tens of percent (the CPU alone differs so
    from itself at another thread count: tools/vision_grad_spread.py). So
    each layer is held instead (`layer_parity`): the card's training
    forward and backward, every Conv2D, BatchNorm and Dense against the
    CPU's plain computation on the very inputs the card gave it."""
    for name, side in VISION_PARITY:
        x, y = vision_batch(torch, args.seed + 9, 2, side, device="cpu")
        nets, losses = {}, {}
        for dev in ("cpu", "cuda"):
            nets[dev], tr = vision_trainer(torch, name, side, args.seed,
                                           amp=None, lr=0.1, device=dev)
            for m in nets[dev].modules():
                if type(m).__name__ == "Dropout":
                    m._rate = 0.0
            if dev == "cpu":
                before = {k: v.clone()
                          for k, v in nets[dev].state_dict().items()}
            else:
                nets[dev].load_state_dict(before)
            losses[dev] = float(tr.step(x.to(dev), y.to(dev)))
        max_err(torch, torch.tensor(losses["cuda"]),
                torch.tensor(losses["cpu"]), 1e-4, name + " loss")
        nets["cuda"].load_state_dict(before)
        loss, worst, n = layer_parity(torch, nets["cuda"], x.cuda(),
                                      y.cuda())
        log("parity: %s (batch 2, %d x %d, f32): one trainer step's loss "
            "on the card %.6f, on the CPU %.6f; %d layers of the card's "
            "step each equal the CPU's on the same inputs (largest error "
            "over its tolerance: outputs %.3g, input gradients %.3g, "
            "parameter gradients %.3g, moving statistics %.3g; 1 is the "
            "tolerance)"
            % (name, side, side, losses["cuda"], losses["cpu"], n,
               worst["out"], worst["dx"], worst["grad"], worst["stats"]))
        del nets
        torch.cuda.empty_cache()


def bert_parity(torch, args):
    """One f32 DistributedTrainer Adam step of bert_mini + an MLM head
    (vocab 1000) on 4 x 128 tokens, on the card (the flash kernels; TF32
    off) and on the CPU (the plain versions), from the same weights and
    batch: the loss, and every parameter after the step and as the change
    the step made. Tolerance: rtol 1e-4 with a floor of 1e-4 x max|CPU
    value| of the compared tensor, and at least 1e-4 x the step's largest
    change (the key bias's gradient is zero in exact arithmetic, so both
    sides move it by rounding noise). Adam's epsilon is 1e-2 and its lr
    0.1: at the default epsilon a first step moves each weight by lr x the
    sign of its gradient, which hides the gradient's value."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import DistributedTrainer

    rng = np.random.RandomState(args.seed + 5)
    x = rng.randint(0, 1000, (4, 128)).astype(np.int64)
    y = rng.randint(0, 1000, (4, 128)).astype(np.float32)
    nets = {dev: bert_pretrain(torch, dev, vocab=1000, mini=True)
            for dev in ("cpu", "cuda")}
    initializer.initialize(nets["cpu"], seed=args.seed)
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"].load_state_dict(before)
    losses = {}
    for dev, net in nets.items():
        tr = DistributedTrainer(net, "adam", {"learning_rate": 0.1,
                                              "epsilon": 1e-2},
                                loss=gloss.SoftmaxCrossEntropyLoss())
        losses[dev] = float(tr.step(x, y))
    want = nets["cpu"].state_dict()
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    worst = max_err(torch, torch.tensor(losses["cuda"]),
                    torch.tensor(losses["cpu"]), 1e-4, "bert_mini loss")
    worst_delta = 0.0
    for k, v in nets["cuda"].state_dict().items():
        v = v.cpu()
        worst = max(worst, max_err(torch, v, want[k], 1e-4,
                                   "bert_mini step: " + k, scale=big))
        worst_delta = max(worst_delta, max_err(
            torch, v - before[k], want[k] - before[k], 1e-4,
            "bert_mini step, change of " + k, scale=big))
    log("parity: one f32 Adam step of bert_mini + MLM head on the card "
        "equals the CPU step (loss %.6f vs %.6f; %d tensors, max abs err "
        "%.3g after the step, %.3g in the change it made; largest change "
        "%.3g)" % (losses["cuda"], losses["cpu"], len(want), worst,
                   worst_delta, big))


def word_lm_parity(torch, args):
    """One f32 DistributedTrainer SGD step (lr 1.0) of a small word LM
    (vocab 1000, 650 units, so the LSTM kernels cut w_hh across the
    card's SMs as at full width; 2 layers) on 12 x 8 tokens, on the card
    (the LSTM kernels; TF32 off) and on the CPU (the plain versions), from
    the same weights and batch: the loss, and every parameter after the
    step and as the change the step made. Tolerance: rtol 1e-4 with a floor
    of 1e-4 x max|CPU value| of the compared tensor, and at least 1e-4 x
    the step's largest change."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
    from mxnet_tpu_torch.parallel import DistributedTrainer

    rng = np.random.RandomState(args.seed + 8)
    x = rng.randint(0, 1000, (12, 8)).astype(np.int64)
    y = rng.randint(0, 1000, (12, 8)).astype(np.float32)
    nets = {dev: RNNModel(1000, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.0,
                          device=dev) for dev in ("cpu", "cuda")}
    nets["cpu"].initialize(seed=args.seed)
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"].load_state_dict(before)
    losses = {}
    for dev, net in nets.items():
        tr = DistributedTrainer(net, "sgd", {"learning_rate": 1.0},
                                loss=seq_ce(gloss))
        losses[dev] = float(tr.step(x, y))
    want = nets["cpu"].state_dict()
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    worst = max_err(torch, torch.tensor(losses["cuda"]),
                    torch.tensor(losses["cpu"]), 1e-4, "word LM loss")
    worst_delta = 0.0
    for k, v in nets["cuda"].state_dict().items():
        v = v.cpu()
        worst = max(worst, max_err(torch, v, want[k], 1e-4,
                                   "word LM step: " + k, scale=big))
        worst_delta = max(worst_delta, max_err(
            torch, v - before[k], want[k] - before[k], 1e-4,
            "word LM step, change of " + k, scale=big))
    log("parity: one f32 SGD step of the small word LM (vocab 1000, 2 x 650) "
        "on the card equals the CPU step (loss %.6f vs %.6f; %d tensors, max "
        "abs err %.3g after the step, %.3g in the change it made; largest "
        "change %.3g)" % (losses["cuda"], losses["cpu"], len(want), worst,
                          worst_delta, big))


def facade_lm_step(torch, seed, device):
    """One façade step of a small word LM (vocab 1000, 2 x 650 units) on
    ``device``: `RNNModel` through gluon, Xavier from ``seed`` (drawn on the
    host, so the same weights on every device), one ``record()`` forward of
    12 x 8 tokens from zero states, ``loss.backward()`` and
    ``gluon.Trainer`` SGD lr 1.0. Returns host copies of the loss, every
    `Parameter.grad()`, and every parameter before and after the step, by
    name."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel

    rng = np.random.RandomState(seed + 9)
    x = rng.randint(0, 1000, (12, 8)).astype(np.int32)
    y = rng.randint(0, 1000, (12, 8)).astype(np.float32)
    with mx.context.scope(device):
        net = RNNModel(1000, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.0,
                       prefix="lm_")
        net.initialize(mx.init.Xavier(), seed=seed)
        params = net.collect_params()
        before = {k: torch.from_numpy(p.data().asnumpy())
                  for k, p in params.items()}
        trainer = gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        state = net.begin_state(8, ctx=device)
        with autograd.record():
            logits, state = net(nd.array(x, dtype="int32"), state)
            loss = ce(logits, nd.array(y))
        loss.backward()
        grads = {k: torch.from_numpy(p.grad().asnumpy())
                 for k, p in params.items()}
        trainer.step(x.size)
        after = {k: torch.from_numpy(p.data().asnumpy())
                 for k, p in params.items()}
    return torch.from_numpy(loss.asnumpy()), grads, before, after


def facade_step_errors(torch, card, cpu, tol=1e-4):
    """Holds `facade_lm_step`'s card results to the CPU's: the loss, every
    gradient (a floor of tol x max|CPU gradient| of the tensor), every
    parameter after the step and the change the step made (a floor of tol
    x the step's largest change as well, as `word_lm_parity`). Returns the
    largest errors of the loss, the gradients and the parameters."""
    loss = max_err(torch, card[0], cpu[0], tol, "façade word LM loss")
    for k, w in cpu[2].items():
        if not torch.equal(card[2][k], w):
            raise AssertionError("façade word LM: %s starts differently" % k)
    grad = max(max_err(torch, card[1][k], w, tol, "façade grad of " + k)
               for k, w in cpu[1].items())
    big = max(float((cpu[3][k] - cpu[2][k]).abs().max()) for k in cpu[3])
    param = 0.0
    for k, w in cpu[3].items():
        param = max(param, max_err(torch, card[3][k], w, tol,
                                   "façade step: " + k, scale=big))
        max_err(torch, card[3][k] - cpu[2][k], w - cpu[2][k], tol,
                "façade step, change of " + k, scale=big)
    return loss, grad, param


def facade_parity(torch, args):
    """`facade_lm_step` on the card (the LSTM kernels; TF32 off) and on the
    CPU (the plain versions), held together by `facade_step_errors`."""
    card = facade_lm_step(torch, args.seed, torch.device("cuda", 0))
    cpu = facade_lm_step(torch, args.seed, torch.device("cpu"))
    loss, grad, param = facade_step_errors(torch, card, cpu)
    log("parity: one f32 façade step of the small word LM (vocab 1000, 2 x "
        "650; record, backward, gluon.Trainer SGD) on the card equals the "
        "CPU step (loss %.6f vs %.6f; %d parameters, max abs err %.3g in "
        "the loss, %.3g in the gradients, %.3g after the step)"
        % (float(card[0].mean()), float(cpu[0].mean()), len(cpu[1]), loss,
           grad, param))


# ---------------------------------------------------------------------------
# phase 6: the symbolic path (mx.sym, Module / BucketingModule, mx.rnn) on
# the word LM, as example/rnn/bucketing/cudnn_lstm_bucketing.py trains it
# ---------------------------------------------------------------------------

# buckets (sequence lengths, 35 the default); batches: warm-up, timed
# (4 of each bucket, in the iterator's shuffled order), score (bucket 35)
SYM_BUCKETS = (10, 20, 35)
SYM_WARMUP_PLAN = (35, 10)
SYM_STEPS, SYM_EVAL = 12, 4
SYM_LR = 1.0
# BucketSentenceIter's default padding label: the label of each sentence's
# last step, which SoftmaxOutput's one-hot leaves at zero and the metric
# ignores
SYM_INVALID = -1


def symbolic_sentences(rng, succ, plan):
    """LM_BATCH sentences for each bucket length in ``plan``: walks of the
    Markov chain ``succ`` (each token has FACADE_SUCCESSORS successors)
    from random tokens, exactly as long as their bucket."""
    out = []
    for length in plan:
        for _ in range(LM_BATCH):
            tok = [int(rng.randint(LM_VOCAB))]
            for _ in range(length - 1):
                tok.append(int(succ[tok[-1], rng.randint(FACADE_SUCCESSORS)]))
            out.append(tok)
    return out


def symbolic_iters(seed):
    """`BucketSentenceIter`s (time-major, "TN") of the warm-up, timed and
    score batches, over one chain drawn from the seed."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(seed + 12)
    succ = rng.randint(0, LM_VOCAB, (LM_VOCAB, FACADE_SUCCESSORS))
    timed = tuple(b for b in SYM_BUCKETS
                  for _ in range(SYM_STEPS // len(SYM_BUCKETS)))

    def it(plan):
        return mx.rnn.BucketSentenceIter(
            symbolic_sentences(rng, succ, plan), LM_BATCH,
            buckets=list(SYM_BUCKETS), invalid_label=SYM_INVALID,
            layout="TN")

    return it(SYM_WARMUP_PLAN), it(timed), it((35,) * SYM_EVAL)


def symbolic_word_lm(torch, pk, args, ckpt_dir=None):
    """The word LM at bench_lstm's width through the symbolic API: a
    `BucketingModule` over `train_lstm_bucketing.lm_sym_gen`
    (Embedding(10000, 650) -> FusedRNNCell(650, 2 layers).unroll(layout
    "TNC") -> Reshape -> FullyConnected(10000) -> SoftmaxOutput), 19,780,400
    f32 parameters (Xavier and the FusedRNN initializer from the seed), SGD
    lr SYM_LR through `Module.init_optimizer` (its rescale_grad is
    1 / data_shapes[0][1][0], 1/35 for time-major data), fed by
    `BucketSentenceIter` at batch 32 and buckets 10, 20 and 35: `fit` over
    2 warm-up batches, then the LSTM launch counts set to 0 and `fit` over
    12 timed batches; then the counts set to 0 and `score` with
    `Perplexity` over 4 batches at bucket 35. Then `save_checkpoint` and
    `Module.load` of the default bucket, whose outputs over those 4 batches
    must equal the trained module's bit for bit. Given ``ckpt_dir``, the
    checkpoint stays there for the predict_serving phase. Returns the
    launch counts of `fit` and of `score`, and the checkpoint's prefix
    (None without ``ckpt_dir``)."""
    import random

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.train_lstm_bucketing import lm_sym_gen

    dev = mx.gpu(0)
    mx.random.seed(args.seed)
    random.seed(args.seed)
    np.random.seed(args.seed)
    t0 = time.monotonic()
    with mx.context.scope(dev):
        warm_it, timed_it, eval_it = symbolic_iters(args.seed)
        bm = mx.mod.BucketingModule(
            lm_sym_gen(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, fused=True,
                       layout="TNC"),
            default_bucket_key=max(SYM_BUCKETS), context=dev)
        record = []   # (bucket, end time, the batch's perplexity)

        def batch_end(param):
            b = param.locals["data_batch"]
            m = mx.metric.Perplexity(SYM_INVALID)
            m.update(b.label, bm.get_outputs())
            record.append((b.bucket_key, time.perf_counter(), m.get()[1]))

        def fit(it):
            bm.fit(it, eval_metric=mx.metric.Perplexity(SYM_INVALID),
                   optimizer="sgd",
                   optimizer_params={"learning_rate": SYM_LR},
                   initializer=mx.init.Xavier(), num_epoch=1,
                   batch_end_callback=batch_end)

        fit(warm_it)
        torch.cuda.synchronize()
        n_params = sum(int(np.prod(a.shape))
                       for a in bm.get_params()[0].values())
        if n_params != LM_PARAMS:
            raise AssertionError("symbolic LM has %d parameters, not %d"
                                 % (n_params, LM_PARAMS))
        warm = [r[2] for r in record]
        log("symbolic: word LM BucketingModule(FusedRNNCell(%d, %d layers)), "
            "%d parameters, f32, buckets %s, SGD lr %g (rescale_grad 1/%d); "
            "%d warm-up batches in %.2f s, perplexities %s"
            % (LM_UNITS, LM_LAYERS, n_params, list(SYM_BUCKETS), SYM_LR,
               max(SYM_BUCKETS), len(warm), time.monotonic() - t0,
               ["%.1f" % v for v in warm]))
        torch.cuda.reset_peak_memory_stats()
        for k in LSTM_KERNELS:   # the symbolic training path's counts
            getattr(pk, k).launches = 0
        del record[:]
        t0 = time.perf_counter()
        fit(timed_it)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        ppls = np.asarray([r[2] for r in record])
        if not np.isfinite(np.asarray(warm + list(ppls))).all():
            raise AssertionError("non-finite symbolic perplexity: %s" % ppls)
        if not ppls[-1] < ppls[0]:
            raise AssertionError("symbolic perplexity did not fall over the "
                                 "timed batches: %s" % ppls)
        want = {"lstm_infer": 0, "lstm_fwd": LM_LAYERS * SYM_STEPS,
                "lstm_bwd": LM_LAYERS * SYM_STEPS}
        if fit_launches != want:
            raise AssertionError("symbolic fit launches %s, not %s"
                                 % (fit_launches, want))
        ends = [t0] + [r[1] for r in record]
        b35 = [ends[i + 1] - ends[i] for i, r in enumerate(record)
               if r[0] == 35]
        ms35 = 1e3 * float(np.mean(b35))
        tokens = sum(r[0] * LM_BATCH for r in record)
        log("  fit: %d timed batches (buckets %s) in %.3f s: %.1f tokens/s, "
            "%.2f ms a batch; bucket 35: %.2f ms a batch, %.1f tokens/s (%d "
            "batches); peak allocated %d bytes (%s); perplexities %s; "
            "launches %s"
            % (len(record), [r[0] for r in record], wall, tokens / wall,
               1e3 * wall / len(record), ms35, 35 * LM_BATCH / ms35 * 1e3,
               len(b35), peak, smi_line(), ["%.1f" % v for v in ppls],
               json.dumps(fit_launches)))
        for k in LSTM_KERNELS:   # the symbolic evaluation's counts
            getattr(pk, k).launches = 0
        t0 = time.perf_counter()
        score = dict(bm.score(eval_it, mx.metric.Perplexity(SYM_INVALID)))
        torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t0
        score_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
        want = {"lstm_infer": LM_LAYERS * SYM_EVAL, "lstm_fwd": 0,
                "lstm_bwd": 0}
        if score_launches != want:
            raise AssertionError("symbolic score launches %s, not %s"
                                 % (score_launches, want))
        if not np.isfinite(score["perplexity"]):
            raise AssertionError("symbolic score perplexity %s" % score)
        log("  score: %d batches at bucket 35 in %.3f s, %.1f tokens/s, "
            "perplexity %.3f (uniform would be %d); launches %s"
            % (SYM_EVAL, eval_wall, SYM_EVAL * 35 * LM_BATCH / eval_wall,
               score["perplexity"], LM_VOCAB, json.dumps(score_launches)))
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(ckpt_dir or tmp, "lm")
            bm.save_checkpoint(prefix, 0)
            loaded = mx.mod.Module.load(prefix, 0, context=dev)
            loaded.bind(eval_it.provide_data, eval_it.provide_label,
                        for_training=False)
            loaded.init_params()
        # one pass over the score batches (a reset reshuffles them)
        eval_it.reset()
        metrics = [mx.metric.Perplexity(SYM_INVALID) for _ in range(2)]
        for b in eval_it:
            for m, module in zip(metrics, (bm, loaded)):
                module.forward(b, is_train=False)
                module.update_metric(m, b.label)
            if not torch.equal(bm.get_outputs()[0]._data,
                               loaded.get_outputs()[0]._data):
                raise AssertionError("symbolic checkpoint: the reloaded "
                                     "module's outputs differ")
        if metrics[0].get() != metrics[1].get():
            raise AssertionError("symbolic checkpoint: score %s, not %s"
                                 % (metrics[1].get(), metrics[0].get()))
        log("  checkpoint: save_checkpoint, then Module.load of the default "
            "bucket: its outputs over the %d score batches equal the trained "
            "module's bit for bit; perplexity %r both"
            % (SYM_EVAL, metrics[1].get()[1]))
        if args.profile:
            timed_it.reset()
            batches = [b for b in timed_it if b.bucket_key == 35][:3]
            lstm_profile(torch, lambda: fit_body(torch, bm, batches),
                         len(batches), "  profile symbolic batch (f32, "
                         "bucket 35, %d batches)" % len(batches), ms35)
    return fit_launches, score_launches, prefix if ckpt_dir else None


def fit_body(torch, bm, batches):
    """`BaseModule.fit`'s loop body over ``batches`` (forward_backward,
    update, update_metric), the update inside a ``trainer.optimizer``
    range for `lstm_profile`."""
    import mxnet_tpu_torch as mx

    ppl = mx.metric.Perplexity(SYM_INVALID)
    for b in batches:
        bm.forward_backward(b)
        with torch.profiler.record_function("trainer.optimizer"):
            bm.update()
        bm.update_metric(ppl, b.label)


def module_step(torch, mod, seed, batch):
    """Initialise the bound ``mod`` (Xavier from ``seed``, drawn on the
    host, so the same weights on every device), then one training
    `forward_backward` and SGD `update` (lr 0.1) on ``batch``. Returns host
    tensors by name: the outputs, the parameters' gradients, and the
    arguments and aux states before and after the step."""
    import mxnet_tpu_torch as mx

    def host(arrays):
        return {k: torch.from_numpy(v.asnumpy()) for k, v in arrays.items()}

    mx.random.seed(seed)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    ex = mod._exec
    before = host(dict(ex.arg_dict, **ex.aux_dict))
    mod.forward_backward(batch)
    outs = host(dict(zip(mod.output_names, mod.get_outputs())))
    grads = host({k: ex.grad_dict[k] for k in mod._param_names})
    mod.update()
    after = host(dict(ex.arg_dict, **ex.aux_dict))
    return outs, grads, before, after


def symbolic_lm_step(torch, seed, device):
    """`module_step` of a small FusedRNNCell LM (vocab 50, embedding 16,
    2 x 16 units; `lm_sym_gen` time-major) on a 6 x 4 batch on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.train_lstm_bucketing import lm_sym_gen

    rng = np.random.RandomState(seed + 13)
    x = rng.randint(1, 50, (6, 4)).astype(np.float32)
    y = rng.randint(0, 50, (6, 4)).astype(np.float32)
    net, data_names, label_names = lm_sym_gen(50, 16, 16, 2, fused=True,
                                              layout="TNC")(6)
    with mx.context.scope(device):
        mod = mx.mod.Module(net, data_names, label_names, context=device)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        return module_step(torch, mod, seed, DataBatch([mx.nd.array(x)],
                                                       [mx.nd.array(y)]))


def symbolic_conv_step(torch, seed, device):
    """`module_step` of Convolution(3 x 3, 8, no bias) -> BatchNorm -> relu ->
    Pooling(max 2 x 2) -> FullyConnected(10) -> SoftmaxOutput on a
    (4, 3, 8, 8) batch on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch

    sym = mx.sym
    rng = np.random.RandomState(seed + 14)
    x = rng.randn(4, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.float32)
    # no bias before the BatchNorm: its gradient is zero up to rounding
    net = sym.Convolution(sym.var("data"), kernel=(3, 3), pad=(1, 1),
                          num_filter=8, no_bias=True, name="conv")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.FullyConnected(net, num_hidden=10, name="fc")
    net = sym.SoftmaxOutput(net, name="softmax")
    with mx.context.scope(device):
        mod = mx.mod.Module(net, context=device)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        return module_step(torch, mod, seed, DataBatch([mx.nd.array(x)],
                                                       [mx.nd.array(y)]))


def module_step_errors(torch, card, cpu, what, tol=1e-4):
    """Holds `module_step`'s card results to the CPU's, as
    `facade_step_errors`: every output and gradient (a floor of tol x
    max|CPU value|), every argument and aux state after the step and the
    change the step made (a floor of tol x the step's largest change).
    Returns the largest errors of the outputs, gradients and arguments."""
    for k, w in cpu[2].items():
        if not torch.equal(card[2][k], w):
            raise AssertionError("%s: %s starts differently" % (what, k))
    out = max(max_err(torch, card[0][k], w, tol, "%s output %s" % (what, k))
              for k, w in cpu[0].items())
    grad = max(max_err(torch, card[1][k], w, tol,
                       "%s grad of %s" % (what, k))
               for k, w in cpu[1].items())
    big = max(float((cpu[3][k] - cpu[2][k]).abs().max()) for k in cpu[3])
    arg = 0.0
    for k, w in cpu[3].items():
        arg = max(arg, max_err(torch, card[3][k], w, tol,
                               "%s step: %s" % (what, k), scale=big))
        max_err(torch, card[3][k] - cpu[2][k], w - cpu[2][k], tol,
                "%s step, change of %s" % (what, k), scale=big)
    return out, grad, arg


SYMBOLIC_STEPS = (
    ("small FusedRNNCell LM (vocab 50, 2 x 16)", symbolic_lm_step,
     ("lstm_fwd", "lstm_bwd")),
    ("conv -> BatchNorm -> Pooling -> FC net", symbolic_conv_step,
     tuple(EPI_KERNELS)))


def symbolic_parity(torch, pk, args):
    """Each of SYMBOLIC_STEPS on the card (its kernels, which must launch;
    TF32 off) against the same step on the CPU (plain versions), held
    together by `module_step_errors`."""
    for name, step, kernels in SYMBOLIC_STEPS:
        for k in kernels:
            getattr(pk, k).launches = 0
        card = step(torch, args.seed, torch.device("cuda", 0))
        launched = {k: getattr(pk, k).launches for k in kernels}
        if min(launched.values()) < 1:
            raise AssertionError("symbolic %s step on the card launched %s"
                                 % (name, launched))
        cpu = step(torch, args.seed, torch.device("cpu"))
        out, grad, arg = module_step_errors(torch, card, cpu,
                                            "symbolic " + name)
        log("parity: one f32 symbolic step (Module forward_backward, SGD "
            "update) of the %s on the card equals the CPU step (%d "
            "outputs, %d gradients, %d arguments and aux states; max abs "
            "err %.3g in the outputs, %.3g in the gradients, %.3g after the "
            "step); launches %s" % (name, len(cpu[0]), len(cpu[1]),
                                    len(cpu[3]), out, grad, arg,
                                    json.dumps(launched)))


# ---------------------------------------------------------------------------
# phase 7: predict serving (ModelRepository -> DynamicBatcher -> bucketed
# Predictors -> the RNN op's lstm_infer) of the symbolic phase's word LM
# as a scoring model
# ---------------------------------------------------------------------------

SERVE_MAX_BATCH = 32          # buckets 1, 2, 4, 8, 16, 32
SERVE_SEQ = 35
SERVE_SEQUENTIAL = 32         # single-sentence requests, one client
SERVE_CONCURRENT = (32, 8)    # clients, requests each: one sentence each
SERVE_MIXED = (16, 4)         # clients, requests each: 1-4 sentences each
SERVE_DRAIN = 32              # requests in flight at the SIGTERM
# each token's log-likelihood (magnitude about 9) on the card against the
# CPU's plain versions, f32 with TF32 off
SERVE_ATOL = 1e-3


def score_symbol(mx, vocab=LM_VOCAB, units=LM_UNITS, layers=LM_LAYERS,
                 seq=SERVE_SEQ):
    """The word LM's scoring graph with `lm_sym_gen`'s argument names:
    ``data`` (N, seq) token ids -> Embedding -> FusedRNNCell unrolled
    batch-major -> FullyConnected(flatten=False) -> log_softmax ->
    pick(``label``): (N, seq), each token's log-likelihood."""
    with mx.name.NameManager():
        embed = mx.sym.Embedding(mx.sym.var("data"), input_dim=vocab,
                                 output_dim=units, name="embed")
        cell = mx.rnn.FusedRNNCell(units, num_layers=layers, mode="lstm",
                                   prefix="lstm_")
        out, _ = cell.unroll(seq, inputs=embed, layout="NTC",
                             merge_outputs=True)
        pred = mx.sym.FullyConnected(out, num_hidden=vocab, flatten=False,
                                     name="pred")
        return mx.sym.pick(mx.sym.log_softmax(pred, axis=-1),
                           mx.sym.var("label"), axis=-1)


def score_inputs(seed, n):
    """``n`` sentences of SERVE_SEQ + 1 tokens from the symbolic phase's
    chain (`symbolic_sentences`): data the first SERVE_SEQ, label the next
    token of each."""
    rng = np.random.RandomState(seed + 12)
    succ = rng.randint(0, LM_VOCAB, (LM_VOCAB, FACADE_SUCCESSORS))
    plan = [SERVE_SEQ + 1] * -(-n // LM_BATCH)
    toks = np.asarray(symbolic_sentences(np.random.RandomState(seed + 13),
                                         succ, plan), np.int32)[:n]
    return toks[:, :-1], toks[:, 1:]


def serve_clients(port, bodies, clients):
    """``bodies`` split over ``clients`` threads, each POSTing its share in
    turn over one keep-alive connection. Returns per body (status, reply,
    seconds) and the wall seconds of the whole."""
    import http.client

    results = [None] * len(bodies)
    gate = threading.Barrier(clients)

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        gate.wait()
        try:
            for i in range(k, len(bodies), clients):
                t0 = time.perf_counter()
                conn.request("POST", "/v1/models/lm:predict",
                             json.dumps(bodies[i]),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                reply = json.loads(r.read())
                results[i] = (r.status, reply, time.perf_counter() - t0)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,),
                                name="smoke-client-%d" % k)
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def predict_serving(torch, pk, args, prefix):
    """The symbolic phase's trained word LM (its ``save_checkpoint``
    params, as they are) served as a scoring model: `score_symbol` saved
    beside the params, loaded by `ModelRepository.load` on the card with
    max_batch 32 (buckets 1 to 32, each a `Predictor` over the
    prototype's weight tensors, warmed before publishing) and the default
    MXTPU_SERVE_MAX_DELAY_MS, served by `ServingServer` on a free port.
    With the LSTM launch counts set to 0 just before the load: 32
    sequential one-sentence requests, 256 from 32 concurrent clients, 64
    of 1 to 4 sentences from 16 clients, then SIGTERM with 32 requests in
    flight. Every request must answer 200 with the log-likelihoods a
    `Predictor` on the CPU (plain versions) gives the same sentences
    (within SERVE_ATOL), lstm_infer must launch 2 x (batches dispatched +
    buckets warmed) times and lstm_fwd / lstm_bwd never, the buckets must
    hold one copy of the weights, and the drain must complete. Returns the
    launch counts."""
    import signal

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.serving import ModelRepository, ServingServer

    score = os.path.join(os.path.dirname(prefix), "score")
    score_symbol(mx).save(score + "-symbol.json")
    os.link(prefix + "-0000.params", score + "-0000.params")
    shapes = {"data": (SERVE_SEQ,), "label": (SERVE_SEQ,)}
    dtypes = {"data": "int32", "label": "int32"}

    n_seq = SERVE_SEQUENTIAL
    n_con = SERVE_CONCURRENT[0] * SERVE_CONCURRENT[1]
    rng = np.random.RandomState(args.seed + 14)
    mixed = rng.randint(1, 5, SERVE_MIXED[0] * SERVE_MIXED[1])
    sizes = [1] * (n_seq + n_con) + list(mixed) + [4] * SERVE_DRAIN
    data, label = score_inputs(args.seed, sum(sizes))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    bodies = [{"inputs": {"data": data[a:b].tolist(),
                          "label": label[a:b].tolist()},
               "timeout_ms": 60000} for a, b in zip(offsets, offsets[1:])]
    parts = [("sequential", 0, n_seq, 1),
             ("concurrent", n_seq, n_seq + n_con, SERVE_CONCURRENT[0]),
             ("mixed 1-4 sentences", n_seq + n_con,
              n_seq + n_con + len(mixed), SERVE_MIXED[0])]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in LSTM_KERNELS:   # the predict-serving path's counts
        getattr(pk, k).launches = 0
    repo = ModelRepository()
    t0 = time.monotonic()
    model = repo.load("lm", score, input_shapes=shapes, input_dtypes=dtypes,
                      max_batch=SERVE_MAX_BATCH, ctx=mx.gpu(0))
    load_s = time.monotonic() - t0
    preds = model._runner.predictors
    proto = preds[SERVE_MAX_BATCH]
    n_params = sum(a.size for k, a in proto._args.items()
                   if k not in shapes)
    if n_params != LM_PARAMS:
        raise AssertionError("served LM has %d parameters, not %d"
                             % (n_params, LM_PARAMS))
    for b, p in preds.items():
        if p is proto:
            continue
        for k, a in proto._args.items():
            same = p._args[k]._data.data_ptr() == a._data.data_ptr()
            if same != (k not in shapes):
                raise AssertionError("bucket %d: %s %s the prototype's "
                                     "tensor" % (b, k, "shares" if same
                                                 else "does not share"))
    log("predict_serving: the symbolic phase's word LM (%d parameters, "
        "f32) served as a scoring model (log-likelihood of each of %d "
        "tokens): loaded in %.3f s, of which warming buckets %s %.3f s; "
        "the %d buckets bind one copy of the weights (data_ptr equal); %s"
        % (n_params, SERVE_SEQ, load_s, model.buckets, model.warm_seconds,
           len(model.buckets), smi_line()))

    server = ServingServer(repo, port=0, addr="127.0.0.1")
    previous = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGINT)}
    server.install_signal_handlers()
    server.start()
    replies = [None] * len(bodies)
    try:
        for name, a, b, clients in parts:
            res, wall = serve_clients(server.port, bodies[a:b], clients)
            replies[a:b] = res
            lat = np.asarray([r[2] for r in res]) * 1e3
            log("  %s: %d requests (%d sentences) from %d client(s) in "
                "%.3f s: %.1f requests/s, %.1f sentences/s; latency p50 "
                "%.2f ms, p99 %.2f ms"
                % (name, b - a, sum(sizes[a:b]), clients, wall,
                   (b - a) / wall, sum(sizes[a:b]) / wall,
                   np.percentile(lat, 50), np.percentile(lat, 99)))
        # the drain: SIGTERM once every request of the last part is
        # admitted to the batcher (its request counter says so)
        a = len(bodies) - SERVE_DRAIN
        admitted = telemetry.counter("mxtpu_serve_requests_total",
                                     {"model": "lm/1"})
        before = admitted.value
        drain_box = {}

        def drain_traffic():
            drain_box["res"] = serve_clients(server.port, bodies[a:],
                                             SERVE_DRAIN)

        sender = threading.Thread(target=drain_traffic)
        sender.start()
        deadline = time.monotonic() + 60
        while admitted.value - before < SERVE_DRAIN:
            if time.monotonic() > deadline:
                raise AssertionError("drain requests never reached the "
                                     "batcher")
            time.sleep(0.0002)
        pending = model.pending()
        t_drain = time.monotonic()
        os.kill(os.getpid(), signal.SIGTERM)
        sender.join(120)
        server._serve_thread.join(120)
        drain_s = time.monotonic() - t_drain
        replies[a:] = drain_box["res"][0]
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
        if server._serve_thread.is_alive():
            server.shutdown()
    if server.drain_failed or server._serve_thread.is_alive():
        raise AssertionError("predict serving: the SIGTERM drain did not "
                             "complete")
    peak = torch.cuda.max_memory_allocated()
    snap = telemetry.snapshot()
    batches = int(snap['mxtpu_serve_batches_total{model="lm/1"}']["value"])
    examples = int(snap['mxtpu_serve_examples_total{model="lm/1"}'][
        "value"])
    hist = snap['mxtpu_serve_batch_size{model="lm/1"}']["buckets"]
    launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    repo.unload("lm", timeout=30)
    log("  drain: SIGTERM with %d requests pending in the batcher; the "
        "server drained and stopped in %.3f s" % (pending, drain_s))
    bad = [(i, r[0], r[1]) for i, r in enumerate(replies)
           if r is None or r[0] != 200]
    if bad:
        raise AssertionError("predict serving: %d of %d requests did not "
                             "answer 200: %s" % (len(bad), len(replies),
                                                 bad[:3]))
    want = {"lstm_infer": LM_LAYERS * (batches + len(model.buckets)),
            "lstm_fwd": 0, "lstm_bwd": 0}
    if launches != want:
        raise AssertionError("predict serving launches %s, not %s (%d "
                             "batches, %d buckets warmed)"
                             % (launches, want, batches,
                                len(model.buckets)))
    if examples != sum(sizes):
        raise AssertionError("predict serving: %d examples dispatched, "
                             "not %d" % (examples, sum(sizes)))
    cum, per_bucket = 0, {}
    for bound, count in hist.items():
        if bound != "+Inf" and count > cum:
            per_bucket[bound] = count - cum
        cum = count if bound != "+Inf" else cum
    log("  %d batches dispatched for %d requests (%d sentences): mean "
        "batch %.2f sentences; batches by size up to each bucket %s; "
        "peak allocated %d bytes; launches %s"
        % (batches, len(replies), examples, examples / batches,
           json.dumps(per_bucket), peak, json.dumps(launches)))

    # the replies against a CPU Predictor of the same artifact
    got = np.concatenate([np.asarray(r[1]["outputs"][0], np.float32)
                          for r in replies])
    chunk = 64
    cpu = Predictor(score + "-symbol.json", score + "-0000.params",
                    ctx=mx.cpu(), input_dtypes=dtypes,
                    input_shapes={k: (chunk, SERVE_SEQ) for k in shapes})
    want_ll = []
    for i in range(0, len(data), chunk):
        d, lab = data[i:i + chunk], label[i:i + chunk]
        pad = chunk - len(d)
        if pad:
            d = np.concatenate([d, np.zeros((pad, SERVE_SEQ), np.int32)])
            lab = np.concatenate([lab, np.zeros((pad, SERVE_SEQ),
                                                np.int32)])
        out = cpu.forward(data=d, label=lab).get_output(0).asnumpy()
        want_ll.append(out[:chunk - pad])
    want_ll = np.concatenate(want_ll)
    err = float(np.abs(got - want_ll).max())
    if got.shape != want_ll.shape or not np.isfinite(got).all() \
            or err > SERVE_ATOL:
        raise AssertionError("predict serving: replies differ from the "
                             "CPU by %g (atol %g)" % (err, SERVE_ATOL))
    log("  every reply (%d sentences x %d tokens, log-likelihoods from %.2f "
        "to %.2f) equals a CPU Predictor's on the plain versions: max abs "
        "err %.3g (atol %g)" % (got.shape[0], SERVE_SEQ, got.min(),
                                 got.max(), err, SERVE_ATOL))
    if args.profile:
        run = model._runner
        batch = {"data": data[:SERVE_MAX_BATCH],
                 "label": label[:SERVE_MAX_BATCH]}
        run(batch, SERVE_MAX_BATCH, SERVE_MAX_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run(batch, SERVE_MAX_BATCH, SERVE_MAX_BATCH)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        lstm_profile(torch, lambda: [run(batch, SERVE_MAX_BATCH,
                                         SERVE_MAX_BATCH)
                                     for _ in range(3)], 3,
                     "  profile predict batch (f32, bucket 32, the runner "
                     "alone)", ms)
    return launches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--profile", action="store_true",
                   help="add torch.profiler breakdowns of a decode step "
                        "and of training steps")
    p.add_argument("--details", default=None,
                   help="write every conv-epilogue kernel case to this "
                        "JSON file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    # full-f32 matrix products everywhere: greedy parity with the full
    # forward must not be lost to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi_line()
    log("card: %s (torch %s, CUDA %s, %d device(s))"
        % (card, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    t0 = time.monotonic()
    sources = sorted({os.path.splitext(os.path.basename(k["source"]))[0]
                      for k in KERNELS if k["route"] == "cuda"})
    built = _build.build_all(sources)
    log("kernels built in %.1f s" % (time.monotonic() - t0))
    for name, info in built.items():
        lines = info["log"].splitlines()
        regs = [int(m.group(1)) for m in
                (re.search(r"Used (\d+) registers", ln) for ln in lines) if m]
        spills, entry = [], "?"
        for ln in lines:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif "spill" in ln and not re.search(r" 0 bytes spill stores",
                                                 ln):
                spills.append("%s: %s" % (entry, ln.strip()))
        log("  %s: %s s, %s; %d kernel instantiations, %s registers at "
            "most; %s" % (name, info["seconds"], info["path"], len(regs),
                          max(regs) if regs else "?",
                          "spills: " + " | ".join(spills) if spills
                          else "no spills"))
        if name == "lstm" and spills:
            raise AssertionError("lstm.cu: registers spill: "
                                 + " | ".join(spills))

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    tiny = torch.zeros(16, device="cuda")
    log("timing floor: a zero_ of 16 floats, timed as every kernel below "
        "(CUDA events, L2 flushed, card kept busy), reads %.4f ms: launch "
        "and event overhead that each kernel time below includes"
        % time_ms(torch, tiny.zero_, flush))
    rows = {"paged_attention": check_paged_attention(torch, pk, args.seed,
                                                     flush)}
    rows.update(check_epilogue(torch, pk, args.seed, flush, args.details))
    rows.update(check_flash(torch, pk, args.seed, flush))
    rows.update(check_lstm(torch, pk, args.seed, flush))
    rows["rtc"], rtc_launches = rtc_phase(torch, args.seed, flush)
    del flush
    torch.cuda.empty_cache()
    launches = serve(torch, pk, args)
    launches["rtc"] = rtc_launches
    train_launches, train_ips = train(torch, pk, args)
    launches.update(train_launches)
    torch.cuda.empty_cache()
    train_rec(torch, pk, args, train_ips)
    torch.cuda.empty_cache()
    vision_launches = train_vision(torch, pk, args)
    torch.cuda.empty_cache()
    launches.update(train_bert(torch, pk, args))
    torch.cuda.empty_cache()
    lm_launches, lm = train_word_lm(torch, pk, args)
    launches.update(lm_launches)
    launches.update(eval_word_lm(torch, pk, args, lm))
    del lm
    torch.cuda.empty_cache()
    facade_word_lm(torch, pk, args)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as ckpt:
        prefix = symbolic_word_lm(torch, pk, args, ckpt)[2]
        torch.cuda.empty_cache()
        predict_serving(torch, pk, args, prefix)
    torch.cuda.empty_cache()
    for k in KERNELS:
        if launches[k["name"]] < 1:
            raise AssertionError("%s never launched on its main path"
                                 % k["name"])
    insitu_parity(torch, args)
    vision_parity(torch, args)
    bert_parity(torch, args)
    word_lm_parity(torch, args)
    facade_parity(torch, args)
    symbolic_parity(torch, pk, args)

    kernels = []
    for k in KERNELS:
        row = dict(k)
        row["launches"] = launches[k["name"]]
        if k["name"] in vision_launches:
            # the Inception v3 run of train_vision, beside the train
            # phase's ResNet-50 count in "launches"
            row["launches_train_vision"] = vision_launches[k["name"]]
        row.update(rows[k["name"]])
        kernels.append(row)
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
