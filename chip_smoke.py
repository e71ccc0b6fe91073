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
   layer whose cluster units do not divide H, and the OCR net's layers
   (examples/ctc/lstm_ocr.py: T 24, H 64, B 32 in training and 256 in its
   closing decode), bf16 and f32, each run twice
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

8. random (after the kernels): the 19 drawing ops of ``mx.nd.random``
   (and ``mx.nd.shuffle``) on the card at 2^20 draws each (`check_random`:
   moments within 5 standard errors of the scipy distribution, a KS test
   for continuous draws, each likely value's frequency for discrete ones,
   ranges and dtypes, the permutation, the multinomial's ``get_prob``, the
   zipfian's unique rows; one seed twice the same bits, the next seed
   other draws); ``GridGenerator``, ``BilinearSampler`` and
   ``SpatialTransformer``, the 15 linalg ops and ``foreach`` /
   ``while_loop`` / ``cond`` on card tensors against the CPU, values and
   gradients (`spatial_run`, `linalg_run`, `control_flow_run`).
9. F1 (after serve): ``ModelRepository.load(generate=True)`` of a small LM
   under ``context.scope(mx.cpu())`` builds its engine on the CPU, and
   without a scope on the card.
10. ctc_ocr (after the façade): the OCR net of examples/ctc/lstm_ocr.py
   (``rnn.LSTM(64, num_layers=2, layout="NTC")`` + ``Dense(11)``, f32)
   built and initialized with ``ctx=mx.gpu()``, Adam lr 5e-3,
   ``gluon.loss.CTCLoss``, the example's 350 steps of 32 from its
   generator (`ocr_generator`): losses finite, the last 25 steps' mean at
   most half the first 25's; lstm_fwd and lstm_bwd 2 x 350 launches, then
   lstm_infer 2 in the closing greedy decode of 256 samples; steps/s and
   the sequence accuracy printed. The CTC op on the card against the CPU
   op, loss and gradient within 1e-5, at the OCR shape and at (T 200, B
   32, C 30, L 40), with its card time.
11. dropout (after ctc_ocr): `bert_12_768_12(dropout=0.1)` + the MLM head
   (Adam, bf16, 8 x 512) and ``RNNModel(10000, 650, 650, 2,
   dropout=0.5)`` (SGD, bf16, 35 x 32), 3 steps each: losses finite,
   every dropout call's kept share (`DropoutMeter`) within 1 % of 1 - p,
   its kept values x / (1 - p) within two of the dtype's eps and a new
   mask each step, each flash kernel 12 launches a step and each LSTM
   training kernel 2, as without dropout; then the masks' cost, A/B on
   the same model: 8 rounds of 10 steps with dropout and 10 with
   ``ops.nn.dropout`` the identity, the medians and paired differences
   printed.
12. predict_vision (after predict_serving): ``train_imagenet.main
   --network resnet50_v1 --layout NHWC --batch-size 32 --num-batches 2
   --model-prefix`` (bf16; the epilogue kernels 53 x 2 launches each),
   its export loaded by ``ModelRepository.load`` on the card (f32,
   buckets 1 to 32) and served by ``ServingServer``: 320 sequential
   one-image requests, then 320 of 1 to 4 images from 8 clients, each
   image one of 64. Every reply 200 and equal to a CPU ``Predictor`` on
   the same files within 1e-3 of the logits' largest magnitude; inference
   launches no epilogue kernel; requests/s, p50 / p99 / max over each
   part's requests, load and warm seconds printed.

13. detection (after predict_vision, before parity): ``ssd_512_resnet50_v1
   (num_classes=20)`` (ResNet-50 v1 cut at stages 3 and 4, four extras,
   6,140 anchors; channels-first, the fused ResNet graph, Xavier from
   ``--seed``) trained in f32 with TF32 off as examples/ssd/train.py
   trains it (``record()``, ``net(x)``, ``training_targets``:
   MultiBoxTarget with hard-negative mining 3, ``SSDMultiBoxLoss``,
   ``backward``, ``gluon.Trainer`` Adam lr 2e-3), batch 32 at 3 x 512 x
   512 from `image.ImageDetIter` (``rand_mirror``) over 64 generated PNGs
   with 1 to 3 boxes of the 20 classes each: 3 warm-up steps, then the
   epilogue counts set to 0 and 10 timed steps. Gates: the loss finite,
   its last 3 steps' mean below its first 3's; each epilogue kernel 61 x
   10 launches (53 BatchNorms in the ResNet, 8 in the extras);
   ``net.detections`` over the last batch equal to MultiBoxDetection on
   the CPU over the same class probabilities (ids and kept set exactly,
   scores and boxes within 1e-5). Prints images/s, ms a step, the share
   of it in ``next()`` and the copy to the card, peak allocated bytes, the
   reductions' launches a step by route and the detections' time and
   count (``--profile``: the device busy share and time by group, the
   BatchNorms' movedim copies as "layout copies"). Then MultiBoxTarget,
   MultiBoxDetection, box_nms, Proposal, ROIAlign and ROIPooling on card
   tensors (`detection_op_cases`: SSD-512's shapes at batch 32, Faster
   R-CNN's default Proposal and ROI ops on a stride-16 map, and
   examples/rcnn/train.py's shapes) against the CPU, values and gradients
   within 1e-5, the discrete parts exactly; then examples/rcnn/train.py
   --steps 20 --image-size 64 on the card (its ``mxnet_tpu`` imports
   answered by the port; the script asserts that the loss falls). The
   kernel phase also holds the epilogue at SSD's shapes
   (`EPI_SSD_SHAPES`: R = 2,097,152 at C 64, 8,192 at 2,048, 128 at 128
   and 256, 32 at 128).

14. profiler (after symbolic, before predict_serving): the symbolic phase's
   word LM (a fresh ``BucketingModule`` over FusedRNNCell(650, 2 layers),
   f32, SGD lr 1.0, Xavier from ``--seed``, 2 warm-up batches) ``fit`` over
   6 bucket-35 batches three times: under ``mx.profiler`` with
   ``set_config(profile_all=True, profile_sync=True)`` and
   ``set_state("run")``, the same without ``profile_sync``, then with the
   profiler off. Gates: each ``dump`` parses and holds an
   ``ExecutorForward`` and an ``ExecutorBackward`` event ("symbolic") a
   batch, and ``dumps()`` lists both; the synced run's op events on the
   fitting thread sum to no more than its wall time; each run launches
   lstm_fwd and lstm_bwd 2 x 6 times and lstm_infer never. Then the
   overhead A/B: 8 rounds, each a window of 24 batches (the 6 replayed,
   ``forward_backward``, ``update``, ``update_metric`` as ``fit`` runs
   them) off, on and on with sync, the order reversed every other round,
   the profiler switched and its events cleared outside the clock; prints
   each mode's median ms a batch, the on / off ratio of each round, lowest
   to highest, and whether the cost is resolved (every round's ratio on
   one side of 1). Then ``start_xla_trace`` / ``stop_xla_trace`` around
   one batch: the torch.profiler trace must name the LSTM kernels. Then
   examples/profiler/profile_training.py --steps 3 on the card through the
   port, its trace parsed: each step's two Dense events, its
   SoftmaxCrossEntropyLoss event and their ``_backward_*`` events
   (imperative), a step marker a step and the task.
15. quantization (after predict_vision, before detection): bench.py's
   ``bench_score_int8`` flow through the port: ``resnet50_v1``
   (channels-first, ``fuse_epilogue=False``: Convolution -> BatchNorm ->
   Activation, a plain add; Xavier from ``--seed``) hybridized and run on
   a batch of 32 x 3 x 224 x 224 from the seed, exported,
   ``load_checkpoint``, ``fold_batch_norm``, ``quantize_model`` (naive
   calibration over that batch, on the card), ``save_checkpoint`` and a
   ``Predictor`` on the card. Gates: the quantized graph holds 53
   quantized convolutions and 1 quantized FC, no float convolution or FC
   and no BatchNorm, its 54 weights int8 in the file and in the
   Predictor; the card's int8 logits equal a CPU ``Predictor``'s over the
   same files and batch bit for bit; top-1 agreement with the folded f32
   graph on the card at least 0.75. Prints int8 images/s and the folded
   f32 graph's (TF32 off): 3 warm-up forwards each, then 6 rounds of 20
   timed forwards each, the order reversed every other round, the median
   and the rounds' range; and the peak allocated bytes of an int8
   forward. Then fault F3 on the net's own activations: 64 batches from
   the seed through the folded graph on the card up to the global average
   pool, whose input is averaged on the card and on the CPU by PyTorch's
   f32 ``mean`` and by the port's pool, each then quantized as the FC's
   ``quantize_v2`` does; prints the values that differ and the int8 steps
   that flip, and each pool's card ms; gate: the port's pool gives both
   devices the same bits. ``--profile`` adds the int8 forward's device time
   split into the im2col gathers, ``_int_mm`` (its zero padding
   included), the quantize / requantize / dequantize passes and the rest
   (each kernel under the ``record_function`` range of the call that
   launched it), and the f32 forward's device time. Then the 9 ops
   (`int8_op_cases`: 14 cases at ResNet-50's shapes at batch 32) on card
   tensors against the CPU, every output bit for bit; then
   examples/quantization/quantize_lenet.py --smoke through the port
   (training and entropy calibration on the card; the script binds its
   quantized Module on the CPU).
16. sparse (after detection, before parity): sparse storage. First
   examples/sparse/linear_classification.py at its own settings (150
   steps, DIM 1000, batch 32, AdaGrad, ``kv.row_sparse_pull``) through
   the port under ``context.scope(gpu(0))``; its own accuracy gate (above
   0.8) stands. Then a logistic linear model over 1,000,000 features (f32
   weight (1,000,000, 1), ``attach_grad(stype="row_sparse")``) on CSR
   batches of 8,192 rows x 32 nonzeros made with numpy from the seed,
   each step ``record`` -> ``sparse.dot`` -> the example's loss ->
   ``backward`` -> AdaGrad's lazy update -> ``kv.push``: 60 steps, the
   last 50 timed (a sync at each end); prints steps/s, rows/s, the
   gradient's rows, one step's host syncs (torch's sync debug mode) and
   the peak allocated bytes. Gates: the step-1 weights within 1e-6 of
   their largest magnitude and the step-60 loss within 1e-4 relative of
   the port's CPU run of the same batches, a second card run equal bit
   for bit, and ``sparse.dot`` with its backward repeated bit for bit.
   Then ``gluon.contrib.nn.SparseEmbedding(30522, 768)`` and
   ``nn.Embedding(sparse_grad=False)`` from one weight under a gluon
   Trainer with Adam over 8 x 512 tokens: the touched rows within 1e-6,
   the lazy run's untouched rows and moments unchanged bit for bit, each
   update's device time. Then ``KVStore("local")`` (init, push, pull,
   row_sparse_pull, set_optimizer, 2-bit compression) on the card equal to
   the CPU bit for bit, and a SyncBatchNorm training step, whose
   conv-epilogue launches are the ``launches_sparse`` counts.
17. mesh (after sparse, before parity): one mesh over
   ``torch.distributed`` and expert-parallel MoE. A one-rank NCCL group
   from a free local port; every in-graph collective of
   `parallel.collectives` over each axis of a dp 1 x ep 1 mesh, their
   gradients and the eager ones on card tensors, each equal to its input
   bit for bit. Then the census's last three scripts through the port
   (`run_example`, ``import jax`` answered by `jax_standin`) at their own
   defaults and gates: examples/moe/train_moe.py (40 steps, loss below
   2.0), examples/distributed/train_dist.py (30 steps, loss below 1.5)
   and examples/image_classification/train_imagenet.py at
   tests/test_examples.py's arguments (resnet18_v1, NHWC, 4 x 3 x 32 x
   32), whose conv-epilogue launches are the ``launches_mesh`` counts.
   Then train_moe.py's MoELM at bert_12_768_12's widths (vocab 30,522,
   768 units, FFN 3,072) with 8 experts top-2, capacity factor 1.25 and
   z-loss 1e-3, bf16 over f32 masters, Adam lr 1e-4, 8 x 512 tokens,
   through `DistributedTrainer` over ``make_mesh([("dp", 1), ("ep",
   1)])``: 3 warm-up and 20 timed steps; prints tokens/s, ms a step, peak
   allocated bytes, the share of token choices dropped by capacity, and
   one step's host syncs and collectives (``--profile``: the device busy
   share, split into the dispatch / combine einsums, the expert GEMMs, the
   router and the rest). Gates: a finite loss, lower at the last timed
   step than the first; no collective and no host sync of the trainer or
   the MoE op in a step at world size 1; and one f32 step (TF32 off) on
   the card equal to the CPU's from the same weights: the loss within
   1e-5 relative, the gate, expert and head parameters within 1e-5 of
   each tensor's largest magnitude. The group is destroyed at the end.
18. pipeline (after mesh, before parity): `bert_12_768_12(dropout=0.0)`
   through `parallel.PipelineTrainer` over ``make_mesh([("pp", 1)])``,
   8 x 512 tokens in 4 microbatches, Adam 1e-4, bf16 over f32 masters,
   an L2Loss on the pooled output against seeded targets; once with
   remat off and once on, each 2 warm-up steps, one step under torch's
   sync debug mode and 8 timed steps: tokens/s, ms a step, peak allocated
   bytes. Gates: a finite loss, falling; the flash launches 12 x 4 x 8
   for dQ and dK/dV and as many forwards (twice as many under remat, the
   stage run again in the backward); no collective and no host sync in a
   step. Then, after ``sync_params``, the pipeline's f32 pooled output at
   2 x 128 tokens against the model's own forward within 1e-4.
19. ranks2 (after pipeline, before parity): two child processes of this
   script (``--ranks2-child``), ranks 0 and 1 of a gloo group over a free
   local port, share the card (NCCL takes one rank a device), each killed
   at 480 s; a child's failure fails the phase. Each: ResNet-50 v1 NHWC
   bf16 at 128 images over dp 2 (64 a rank), SGD with momentum as the
   train phase, 2 warm-up and 10 timed steps; every BatchNorm's
   statistics are the global batch's: the two reductions' raw mode, one
   gather of the ranks' sums, `epi_stats_finish` / `epi_bwd_finish` (the
   ``launches_ranks2`` counts, 53 x 10 each, and the finishing kernels'
   ``launches``); prints images/s and the raw reductions' routes. Gates:
   both ranks' losses alike, finite and falling; the raw mode on
   (200,704, 256) bf16 rows against its plain version, bit for bit on a
   rerun. Then f32 on the card (TF32 off), held to the same runs at one
   rank made here meanwhile: `tests/test_parallel.py`'s SyncBatchNorm net
   at dp 2 (losses, moving statistics, parameters within rtol 1e-4, atol
   1e-5), examples/distributed/train_dist.py's MLP at dp 1 x tp 2 and at
   fsdp 2 (5 steps; losses within 1e-5, parameters within rtol 2e-4,
   atol 2e-5; fewer elements resident a rank), a 4-layer BERT through
   `PipelineTrainer` at pp 2 (forward, 3 Adam steps); and ring attention
   over sp 2 at B, L, H, D = 2, 8,192, 12, 64, causal and not, against
   full attention on the rank's rows within 1e-4. In the kernel phase the
   raw mode and the finishing kernels are held to their plain versions
   at Inception v3's (8,192, 448), ResNet-50's (401,408, 256) and a
   folded (1,000, 3), as two ranks' halves, bf16 and f32, and timed.
20. dist_kv (after ranks2, before parity): ``python -m
   mxnet_tpu_torch.launch -n 2 --launcher local`` starts this script twice
   (``--dist-kv-child``); the ranks join one gloo group from the
   launcher's environment and share the card; the launcher is stopped at
   600 s, and a rank's failure fails the phase. Each rank: the JAX
   package's kvstore worker (dense, list, row_sparse and 2-bit pushes over
   a ``dist_sync`` store) on card arrays; its dist-Trainer regression
   (ranks equal, within 0.05 of the truth); then ResNet-50 v1 NHWC f32 at
   64 images (128 over the two), 1,000 classes, initialised on
   ``mx.gpu(0)`` from a seed of its own, ``gluon.Trainer(..., kvstore=
   'dist_sync')``, SGD momentum 0.9, wd 1e-4, ``record()`` /
   ``backward()`` / ``step(64)``, 2 warm-up and 10 timed steps. Gates: the
   ranks' trained weights equal bit for bit (sha-256); losses finite and
   falling; each epilogue kernel launched 53 x 10 a rank (the net's
   BatchNorms counted; the ``launches_dist_kv`` counts). Prints images/s
   over the two ranks, push/pull ms a step, the collectives a step and
   the peak bytes a rank, with the card's name and power limit.
21. replica_pool (after predict_vision, in its directory): the serve
   phase's LM (`bert_base_lm`, 108,890,112 parameters, f32 KV, page 16,
   256 pages), written by ``save_lm`` and loaded by
   ``ModelRepository.load("poollm", prefix, generate=True, replicas=2)``
   on the card: two replica processes (``python -m
   mxnet_tpu_torch.serving.replica_worker --device cuda:0``) share it,
   each with its own CUDA context and copy of the weights, behind
   ``ServingServer(port=0)``. 24 concurrent greedy requests (the serve
   phase's prompts and budgets) go first through an in-process engine
   (``replicas=0``, unloaded before the pool loads), then through the
   pool in a timed clean run, then again with replica 0's process group
   SIGKILLed at the first reply. Gates: every reply 200 and equal to the
   full-sequence greedy oracle (one whole forward a token, on the card)
   in all three runs; after the clean run each replica's
   ``stats_result`` shows paged-kernel launches > 0 since it reported
   ready (its warm-up apart; the ``launches_replica_pool`` count sums
   them); no failover in the clean run, at least one and exactly one
   restart (replica 0's) in the chaos run, the pool back at 2 healthy;
   after the drain each replica shows no KV page used, nothing pending
   and no kernel built after warm-up. Then predict_vision's
   ResNet-50 v1 export through ``replicas=2`` with
   ``MXTPU_FAULT_INJECT=kill_replica@batch=3,replica=0`` (and
   ``NVIDIA_TF32_OVERRIDE=0``: the replicas compute in full f32, as this
   process does): 4 clients send 64 one-image requests; codes within
   {200, 429, 503, 504} and at least 48 at 200, every 200 equal to an
   in-process `Predictor` on the card within 1e-3 of the logits' largest
   magnitude, one ejection and one respawn in the counters and events,
   the pool back at full health. Prints requests/s and generated tokens/s
   through the pool beside the in-process engine's at the same load,
   request p50 /
   p99, seconds from the kill to healthy, each replica's peak allocated
   bytes (``torch.cuda.max_memory_allocated`` in the worker) and predict
   requests/s under the fault, with the card's name and power limit.
22. autoscale (after replica_pool, in its directory): that phase's LM
   loaded by ``ModelRepository.load("autolm", prefix, generate=True,
   replicas=1, min_replicas=1, max_replicas=3)`` behind
   ``ServingServer(port=0)`` with an `Autoscaler` attached (laps of 250
   ms, up after 2 breached laps, a 20 s cooldown that outlasts a
   replica's spawn, down after 5 s idle), ``MXTPU_SLO`` windows of 250 ms
   with fast windows of 4 and 8 s, the pooled LM's p99 objective at
   2,500 ms and ``MXTPU_SERVE_MEMORY_BUDGET`` at 2.5 copies of its
   ``memory_bytes`` (room for two replicas, not three). Waves of 48
   concurrent greedy requests (replica_pool's 24 bodies twice, so its
   oracle replies serve again) until the pool holds 2 healthy replicas
   (at most 90 s); one wave at 2; then the 24 bodies once a wave until
   the p99 verdict is healthy on data; then idle. Gates: every reply 200
   and equal to the oracle; the decision trail holds one ``up`` (1 -> 2)
   and, if the breach held at 2, ``blocked`` for ``memory_budget``, never
   a third replica, then one idle ``down`` back to 1 (drained); the added
   replica's ``stats_result`` shows paged launches > 0 since it reported
   ready (``launches_autoscale`` on the paged row); after the drain no KV
   page used, nothing pending, no kernel built after warm-up; the
   model's ``memory_bytes`` equals its ``param_bytes + kv_bytes`` and
   each replica's ``max_memory_allocated`` lies within 1.0-1.3 times it;
   ``GET /statusz`` carries ``autolm/1``'s verdicts and the trail, and
   the telemetry endpoint's ``/metrics`` ``mxtpu_serve_replicas`` and
   ``mxtpu_autoscale_decisions_total{action="up"}`` >= 1. Prints the
   seconds from the first breach to 2 healthy, from there to the
   verdict's recovery and from the last request to the scale-down;
   generated tokens/s at 1 and at 2 replicas; peak bytes a replica; with
   the card's name and power limit.
23. resilience (after dist_kv; cuDNN's deterministic algorithms and no
   TF32 in every process of it): (a) ``python -m mxnet_tpu_torch.launch
   -n 1 --max-restarts 1`` of this script (``--resilience-child DIR``):
   ResNet-50 v1 NHWC bf16 at 128 images through `DistributedTrainer`
   (SGD momentum 0.9, wd 1e-4, lr 0.02), an async checkpoint every 2
   steps (`CheckpointManager.maybe_save_async` of the trainer's
   snapshots), preempted at step 4 by ``MXTPU_FAULT_INJECT=preempt@step=
   4,grace=60``; generation 0 lands an emergency checkpoint and exits 83,
   the launcher restarts it without using its budget, generation 1
   restores and reaches step 8. Gates: the launcher's free restart; the
   emergency checkpoint at step 4; the parameters, buffers and momentum
   equal to an uninterrupted run in this process bit for bit (else within
   two reference runs' difference); each generation's epilogue launches >
   0. (b) the word LM (`RNNModel`'s width as a `BucketingModule` over
   FusedRNNCell, f32) through ``fit(checkpoint_dir=, num_epoch=2)`` with a
   `Monitor`, then ``corrupt_ckpt`` on the newest checkpoint and a fresh
   module's ``fit(resume="auto")``: it falls back to the verified older
   one and ends equal to the uninterrupted fit bit for bit; the monitor's
   first row equals a CPU forward's within 1e-5 of the statistic;
   lstm_fwd, lstm_bwd and (in each epoch's `score`) lstm_infer launched. (c) ResNet-50 f32 at 32 images over
   ``fsdp`` 2 (two gloo ranks of the launcher sharing the card), a
   sharded checkpoint every 2 steps, rank 1 preempted at step 3 (its
   emergency checkpoint refused: its shard cannot restore the model);
   one rank restores elastically and reaches step 6: the restore equals
   the two ranks' model bit for bit, their first loss the one-rank run's
   within ``ranks2``'s rtol 1e-5 of losses, the end one rank resuming
   here bit for bit (the weights' drift from the one-rank run printed). Prints SIGTERM to rc 83, the restart to the first resumed
   step, a checkpoint's bytes and seconds (sync, and the async save's
   share on the training thread), steps/s with and without saves, the
   phase's seconds, with the card's name and power limit; its launches
   are the ``launches_resilience`` counts.
24. interop (after resilience; cuDNN's deterministic algorithms and no
   TF32): (a) ResNet-50 v1 (NCHW, f32, from ``--seed``) traced with
   ``net(mx.sym.var("data"))``, written by ``contrib.onnx.export_model``
   at (1, 3, 224, 224) and read back by ``import_model``;
   ``get_model_metadata`` names the input and its shape and the output;
   the imported graph bound on ``mx.gpu(0)`` gives the gluon net's eval
   logits on 32 images within rtol 1e-4 and atol 1e-4. (b) the custom op
   ``softmax_rtc`` (`operator.CustomOp`): its forward launches the rtc
   phase's ``softmax_fwd<float>`` and its backward a user kernel of its
   own (``p - onehot(label)``), both through ``mx.rtc.CudaModule`` on the
   op's own arrays in place, after asserting that every input lies on
   ``cuda:0``; ``test_utils.check_symbolic_forward`` / ``_backward`` of
   ``sym.Custom(x, label, op_type="softmax_rtc")`` at (32, 1000) equal
   the built-in ``SoftmaxOutput``'s within 1e-5. (c) the imported graph
   with that head, ``subgraph.partition``ed with ``"default"`` and not:
   two `Module`s on the card take 3 SGD steps (momentum 0.9) at 32 x
   224^2 from the same weights; their losses and final weights are equal
   bit for bit (else within a second unpartitioned run's difference); a
   third module with ``SoftmaxOutput`` gives the same first-step
   gradients within 1e-4 of their scale; the launches of the four
   epilogue kernels and of rtc are > 0 in each run and equal between the
   partitioned and the unpartitioned. (d) ``runtime.Features()`` has
   GPU, CUDA, CUDNN, NCCL and CUDA_RTC on and TPU and PALLAS off;
   ``runtime.dial_devices()`` returns the card and writes the topology
   cache with its name; ``test_utils.default_context()`` is ``gpu(0)``;
   ``engine.wait_all()`` returns after a queued sleep kernel is done (its
   event not done before, done after); under ``engine.naive_engine()`` the
   stream is idle after an ``mx.nd`` op (and busy after one without).
   Prints the ONNX file's bytes and the export and import seconds, the
   custom op's host µs a call, ms a step of the partitioned and the
   unpartitioned module, and the phase's seconds, with the card's name
   and power limit; its launches are the ``launches_interop`` counts.

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
import signal
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
    # the two reductions' finish over ranks (a batch split over dp)
    {"name": "epi_stats_finish", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:769"},
    {"name": "epi_bwd_finish", "route": "cuda", "source": _EPI_SRC,
     "replaces": "mxnet_tpu/ops/pallas_kernels.py:807"},
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


def post_all(url, bodies, on_first=None):
    """POST every body at once, one thread each. Returns per request
    (status, reply, t_sent, t_answered). ``on_first()`` runs once, in the
    thread that got the first answer, before any other thread goes on."""
    results = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))
    first = threading.Lock()
    fired = []

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
        if on_first is not None:
            with first:
                if not fired:
                    fired.append(i)
                    on_first()

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
# SSD-512 ResNet-50 v1's training BatchNorms at batch 32, 512 x 512 (the
# detection phase; channels-first, so each behind a movedim copy), that no
# other path reaches: the stem (32 x 256 x 256 rows of 64), stage 4 (32 x
# 16 x 16 rows of 2048), and the extras' smallest maps (2 x 2 x 32 = 128
# rows of 128 and 256, 1 x 1 x 32 = 32 rows of 128)
EPI_SSD_SHAPES = [("ssd-stem", 2097152, 64), ("ssd-stage4-out", 8192, 2048),
                  ("ssd-extra4-mid", 128, 128),
                  ("ssd-extra3-out", 128, 256), ("ssd-extra4-out", 32, 128)]
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
    for i, (label, r, c) in enumerate(EPI_SHAPES + EPI_SSD_SHAPES):
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
        "%s; routes %s" % (len(EPI_SHAPES + EPI_SSD_SHAPES),
                           json.dumps(worst),
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
              ("served B 16", (35, 16, 650)),
              # the ctc_ocr phase's layers (examples/ctc/lstm_ocr.py) and
              # its closing decode's batch
              ("OCR", (24, 32, 64)), ("OCR decode", (24, 256, 64))]
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


# ---------------------------------------------------------------------------
# the training side of telemetry, read in the train, train_bert and word-LM
# phases: the automatic step FLOPs (telemetry.flops: FlopCounterMode once a
# signature, the flash and LSTM kernels by formula), the MFU gauge, the
# goodput brackets, host syncs and the instrumentation's host cost
# ---------------------------------------------------------------------------

# the automatic count against PERF.md's hand count, and the MFU gauge
# against the MFU of the phase's own throughput: each within 10 %
AUTO_FLOPS_TOL = 0.10
MFU_GAUGE_TOL = 0.10
# the instrumentation's host cost a step, against the step
INSTRUMENT_MAX_SHARE = 0.02


class StepTelemetry:
    """Reads a trainer's telemetry over a phase's timed steps: call
    `start` after the warm-up steps (the first of which the FLOP counter
    priced), `after_step` after each timed step, `finish` with the timed
    steps' wall seconds."""

    def __init__(self, kind):
        from mxnet_tpu_torch import telemetry

        self.tm = telemetry
        self.kind = kind
        self.gauge = telemetry.gauge("mxtpu_step_mfu", {"kind": kind})
        self.mfus = []

    def start(self):
        self.step_flops = self.tm.flops.last_step_flops()
        self.good0 = self.tm.goodput.totals()
        self.mfus = []

    def after_step(self):
        self.mfus.append(self.gauge.value)

    def finish(self):
        good1 = self.tm.goodput.totals()
        wall = good1["wall"] - self.good0["wall"]
        compute = good1["phases"].get("compute", 0.0) - \
            self.good0["phases"].get("compute", 0.0)
        self.compute_share = compute / wall if wall > 0 else float("nan")
        # the harmonic mean of the per-step gauge: the MFU over the steps'
        # summed host seconds
        self.gauge_mfu = len(self.mfus) / sum(1.0 / m for m in self.mfus) \
            if self.mfus and all(m > 0 for m in self.mfus) else 0.0

    def check(self, what, units_a_step, unit, hand_per_unit, units_per_s):
        """Print and gate the automatic FLOPs a unit against the hand count
        and the gauge's MFU against the MFU of ``units_per_s`` (both with
        the automatic count over 989 TFLOP/s)."""
        auto = (self.step_flops or 0.0) / units_a_step
        want_mfu = units_per_s * auto / BF16_FLOPS_PER_S
        log("  %s telemetry: automatic step FLOPs %.6g a step = %.6g a %s "
            "(PERF.md's hand count %.6g: %+.2f%%); MFU gauge "
            "mxtpu_step_mfu{kind=\"%s\"} %.4f over the timed steps (last "
            "%.4f) against %.4f from the phase's %.1f %ss/s (%+.2f%%); "
            "goodput's compute share %.4f of the bracketed wall; %s"
            % (what, self.step_flops or 0.0, auto, unit, hand_per_unit,
               100.0 * (auto / hand_per_unit - 1.0), self.kind,
               self.gauge_mfu, self.mfus[-1] if self.mfus else 0.0,
               want_mfu, units_per_s, unit,
               100.0 * (self.gauge_mfu / want_mfu - 1.0) if want_mfu
               else float("nan"), self.compute_share, smi_line()))
        if not abs(auto / hand_per_unit - 1.0) <= AUTO_FLOPS_TOL:
            raise AssertionError("%s: automatic FLOPs a %s %.6g, not within "
                                 "%d%% of %.6g" % (what, unit, auto,
                                                   100 * AUTO_FLOPS_TOL,
                                                   hand_per_unit))
        if not abs(self.gauge_mfu / want_mfu - 1.0) <= MFU_GAUGE_TOL:
            raise AssertionError("%s: MFU gauge %.4f, not within %d%% of "
                                 "%.4f" % (what, self.gauge_mfu,
                                           100 * MFU_GAUGE_TOL, want_mfu))


def step_syncs(torch, telemetry, step):
    """Host syncs of one ``step()`` with telemetry on, then one with it
    off: (on sites, off sites). The instrumentation may add none."""
    on = count_host_syncs(torch, step)[1]
    telemetry.set_enabled(False)
    try:
        off = count_host_syncs(torch, step)[1]
    finally:
        telemetry.set_enabled(True)
    return on, off


def instrumentation_cost_s(telemetry, batch, kind, chunks=20, inner=100):
    """Host seconds a step that the step instrumentation costs: every call
    a trainer's step makes around its body (the goodput bracket and
    phases, the trace root and span, the FLOP memo's priced lookup on the
    step's inputs, `observe_step`), with an empty body, against the empty
    body alone; each the min over ``chunks`` chunks of ``inner`` steps, as
    tests/test_telemetry.py measures `observe_step`'s."""
    memo = telemetry.flops.PerShapeFlops(lambda *a: None)
    memo(*batch)

    def body(*a):
        return None

    def instrumented(i):
        t0 = time.perf_counter()
        telemetry.goodput.step_start(kind=kind, t0=t0)
        with telemetry.goodput.phase("data_wait"):
            pass
        with telemetry.tracing.root("train.step", component="train",
                                    attrs={"step": i, "kind": kind}):
            telemetry.goodput.mark_launch()
            with telemetry.tracing.span("train.fused_step"), \
                    telemetry.goodput.phase("compute"):
                memo(*batch)
            telemetry.observe_step(time.perf_counter() - t0, examples=1,
                                   step=i, kind=kind)
            telemetry.goodput.step_end(step=i)

    def bare(i):
        body(*batch)

    def per_step(fn):
        best = float("inf")
        for _ in range(chunks):
            t0 = time.perf_counter()
            for i in range(inner):
                fn(i)
            best = min(best, (time.perf_counter() - t0) / inner)
        return best

    return max(0.0, per_step(instrumented) - per_step(bare))


def check_instrumentation(torch, what, trainer, x, y, step_s):
    """The timed phase's host syncs and instrumentation cost: printed, and
    gated (no sync the instrumentation adds; its cost under 2 % of the
    step)."""
    from mxnet_tpu_torch import telemetry

    on, off = step_syncs(torch, telemetry, lambda: trainer.step(x, y))
    cost = instrumentation_cost_s(telemetry, (x, y), "overhead")
    log("  %s instrumentation: host syncs a step %d with telemetry on %s, "
        "%d off %s; host cost %.2f us a step = %.4f%% of the %.2f ms step "
        "(min over chunks, on against off); %s"
        % (what, len(on), on, len(off), off, cost * 1e6,
           100.0 * cost / step_s, step_s * 1e3, smi_line()))
    if len(on) > len(off):
        raise AssertionError("%s: the instrumentation adds host syncs: %s "
                             "against %s" % (what, on, off))
    if not cost / step_s < INSTRUMENT_MAX_SHARE:
        raise AssertionError("%s: instrumentation %.2f us a step, not under "
                             "%d%% of the %.2f ms step"
                             % (what, cost * 1e6, 100 * INSTRUMENT_MAX_SHARE,
                                step_s * 1e3))


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
    tel = StepTelemetry("dist")
    tel.start()
    t0 = time.monotonic()
    losses = []
    for _ in range(steps):
        losses.append(trainer.step(x, y)._data)
        tel.after_step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel.finish()
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
    tel.check("ResNet-50", batch, "image", train_flops, ips)
    check_instrumentation(torch, "ResNet-50", trainer, x, y, wall / steps)
    if args.profile:
        profile_train(torch, trainer, x, y, wall / steps * 1e3)
        log("  (goodput's compute share of the timed steps: %.4f)"
            % tel.compute_share)
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
            state["losses"].append(p.locals["loss"]._data)
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
    losses = [trainer.step(x, y)._data for _ in range(TRAIN_STEPS)]
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


def bert_pretrain(torch, device, vocab=BERT_VOCAB, mini=False, dropout=0.0):
    """bench.py's pretraining block: a BERT (`bert_12_768_12`, or
    `bert_mini`), without dropout unless ``dropout`` is given, and an MLM
    Dense(vocab, flatten=False) on its sequence output; children ``bert``
    and ``mlm``."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo import transformer as zoo

    class BERTPretrain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            make = zoo.bert_mini if mini else zoo.bert_12_768_12
            self.bert = make(vocab_size=vocab, dropout=dropout,
                             device=device)
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
    tel = StepTelemetry("dist")
    tel.start()
    t0 = time.monotonic()
    losses = []
    for _ in range(BERT_STEPS):
        losses.append(trainer.step(x, y)._data)
        tel.after_step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel.finish()
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
    # the flash kernels report their FLOPs: without them the count would
    # miss attention
    tel.check("BERT-base", BERT_BATCH * BERT_SEQ, "token", flops_token, tps)
    check_instrumentation(torch, "BERT-base", trainer, x, y,
                          wall / BERT_STEPS)
    if args.profile:
        profile_bert(torch, trainer, x, y, wall / BERT_STEPS * 1e3)
        log("  (goodput's compute share of the timed steps: %.4f)"
            % tel.compute_share)
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
    tel = StepTelemetry("dist")
    tel.start()
    t0 = time.monotonic()
    losses = []
    for _ in range(LM_STEPS):
        losses.append(trainer.step(x, y)._data)
        tel.after_step()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tel.finish()
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
    # the LSTM kernels report their FLOPs: without them the count would
    # miss the recurrence
    tel.check("word LM", LM_BPTT * LM_BATCH, "token", LM_FLOPS_TOKEN, tps)
    check_instrumentation(torch, "word LM", trainer, x, y, wall / LM_STEPS)
    if args.profile:
        profile_word_lm(torch, trainer, x, y, wall / LM_STEPS * 1e3)
        log("  (goodput's compute share of the timed steps: %.4f)"
            % tel.compute_share)
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
# the rnn_cells phase: the Gluon recurrent cells at the word LM's width (2 x
# 650 LSTM, 35 x 32, f32, TF32 off), each held against the fused layer it
# unrolls: a SequentialRNNCell of LSTMCells against gluon.rnn.LSTM (the
# LSTM kernels: lstm_infer without a gradient, lstm_fwd and lstm_bwd with
# one), a bidirectional mx.rnn.FusedRNNCell against its unfuse(), and a
# Conv2DLSTMCell step on the card against the CPU's
# ---------------------------------------------------------------------------

# f32 on both sides, in other summation orders: each difference within
# 1e-4 of the reference's largest |value|
RNN_CELL_TOL = 1e-4
CONV_CELL_SHAPE = (16, 32, 32)    # (C, H, W) of the Conv2DLSTMCell's input
CONV_CELL_HIDDEN, CONV_CELL_BATCH = 32, 8


def _nd_rand(mx, ctx, rng, shape, scale=1.0):
    return mx.nd.array(rng.uniform(-scale, scale, shape).astype(np.float32),
                       ctx=ctx)


def lstm_cell_stack(mx, ctx, seed, h, layers):
    """A `SequentialRNNCell` of ``layers`` `LSTMCell`(h)s, initialized on
    ``ctx`` from ``seed``."""
    from mxnet_tpu_torch.gluon import rnn

    stack = rnn.SequentialRNNCell()
    with stack.name_scope():
        for _ in range(layers):
            stack.add(rnn.LSTMCell(h, input_size=h))
    stack.initialize(mx.init.Uniform(0.08), ctx=ctx, seed=seed)
    return stack


def fused_from_cells(mx, ctx, stack, h, layers):
    """The fused `gluon.rnn.LSTM`(h, layers) holding ``stack``'s weights
    (`convert.fused_rnn_params_from_cells`)."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon import rnn

    fused = rnn.LSTM(h, layers, input_size=h)
    fused.initialize(ctx=ctx)
    cells = {n: p.data().asnumpy()
             for n, p in stack.collect_params().items()}
    params = fused.collect_params()
    for n, a in convert.fused_rnn_params_from_cells(cells, fused).items():
        params[n].set_data(mx.nd.array(a, ctx=ctx))
    return fused


def _errors(pairs):
    """{what: (max |got - want|, max |want|)} of numpy pairs."""
    out = {}
    for what, (got, want) in pairs.items():
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape:
            raise AssertionError("%s: shape %s, not %s"
                                 % (what, got.shape, want.shape))
        out[what] = (float(np.abs(got - want).max()),
                     float(np.abs(want).max()))
    return out


def cells_vs_fused(mx, ctx, seed, t, b, h, layers, grad):
    """A `SequentialRNNCell` of `LSTMCell`s unrolled over (t, b, h) in TNC
    against the fused `gluon.rnn.LSTM` with its weights, from the same
    begin states: outputs and final states and, with ``grad``, every
    weight's and the input's gradient of a random linear loss on the
    outputs and final states. Returns `_errors`, the fused layer the
    reference."""
    from functools import reduce

    from mxnet_tpu_torch import autograd, convert

    rng = np.random.RandomState(seed + 1)
    stack = lstm_cell_stack(mx, ctx, seed, h, layers)
    fused = fused_from_cells(mx, ctx, stack, h, layers)
    x = rng.uniform(-1, 1, (t, b, h)).astype(np.float32)
    begin = [_nd_rand(mx, ctx, rng, (b, h), 0.5) for _ in range(2 * layers)]
    dy = _nd_rand(mx, ctx, rng, (t, b, h))
    dst = [_nd_rand(mx, ctx, rng, (b, h)) for _ in range(2 * layers)]

    def cells(xx):
        return stack.unroll(t, xx, begin_state=begin, layout="TNC",
                            merge_outputs=True)

    def fused_run(xx):
        out, (hs, cs) = fused(xx, [mx.nd.stack(*begin[0::2], axis=0),
                                   mx.nd.stack(*begin[1::2], axis=0)])
        return out, [s for i in range(layers) for s in (hs[i], cs[i])]

    def run(fn):
        xx = mx.nd.array(x, ctx=ctx)
        if not grad:
            out, st = fn(xx)
            return out, st, None
        xx.attach_grad()
        with autograd.record():
            out, st = fn(xx)
            loss = reduce(lambda a, c: a + c,
                          [(s * d).sum() for s, d in zip(st, dst)],
                          (out * dy).sum())
        loss.backward()
        return out, st, xx.grad

    out_c, st_c, dx_c = run(cells)
    out_f, st_f, dx_f = run(fused_run)
    pairs = {"outputs": (out_c.asnumpy(), out_f.asnumpy())}
    for i in range(layers):
        pairs["h%d" % i] = (st_c[2 * i].asnumpy(), st_f[2 * i].asnumpy())
        pairs["c%d" % i] = (st_c[2 * i + 1].asnumpy(),
                            st_f[2 * i + 1].asnumpy())
    if grad:
        pairs["d_input"] = (dx_c.asnumpy(), dx_f.asnumpy())
        grads = convert.fused_rnn_params_from_cells(
            {n: p.grad().asnumpy()
             for n, p in stack.collect_params().items()}, fused)
        for n, p in fused.collect_params().items():
            pairs["d_" + n[len(fused.prefix):]] = (grads[n],
                                                   p.grad().asnumpy())
    return _errors(pairs)


def unfuse_vs_fused(mx, ctx, seed, t, b, h, layers):
    """A bidirectional `mx.rnn.FusedRNNCell` (LSTM, ``layers`` layers)
    against its `unfuse()` stack, both unrolled over (t, b, h) in TNC and
    evaluated on ``ctx`` with one random parameter vector. Returns
    `_errors`, the fused cell the reference."""
    rng = np.random.RandomState(seed + 2)
    cell = mx.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm",
                               bidirectional=True, prefix="bi_")
    data = mx.sym.var("data")
    fused_out, _ = cell.unroll(t, data, layout="TNC", merge_outputs=True)
    stack = cell.unfuse()
    stack_out, _ = stack.unroll(t, data, layout="TNC", merge_outputs=True)
    shapes = dict(zip(fused_out.list_arguments(),
                      fused_out.infer_shape(data=(t, b, h))[0]))
    flat = mx.nd.array(rng.uniform(-0.08, 0.08, shapes["bi_parameters"])
                       .astype(np.float32), ctx=ctx)
    args = stack.pack_weights(cell.unpack_weights({"bi_parameters": flat}))
    x = _nd_rand(mx, ctx, rng, (t, b, h))
    got = stack_out.eval(ctx=ctx, data=x, **args)[0]
    want = fused_out.eval(ctx=ctx, data=x, bi_parameters=flat)[0]
    return _errors({"bidirectional outputs": (got.asnumpy(),
                                              want.asnumpy())})


def conv_lstm_step(mx, ctx, seed, shape=CONV_CELL_SHAPE,
                   hidden=CONV_CELL_HIDDEN, batch=CONV_CELL_BATCH):
    """One `Conv2DLSTMCell` step (3 x 3 kernels, 'same' padding) on ``ctx``
    from ``seed``'s weights, input and states: numpy (output, h, c)."""
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    rng = np.random.RandomState(seed + 3)
    cell = crnn.Conv2DLSTMCell(shape, hidden, 3, 3, i2h_pad=1)
    cell.initialize(mx.init.Xavier(), ctx=ctx, seed=seed)
    x = _nd_rand(mx, ctx, rng, (batch,) + tuple(shape))
    states = [_nd_rand(mx, ctx, rng, (batch, hidden) + tuple(shape[1:]),
                       0.5) for _ in range(2)]
    out, new = cell(x, states)
    return out.asnumpy(), new[0].asnumpy(), new[1].asnumpy()


def nd_op_host_us(mx, ctx, telemetry, chunks=20, inner=500):
    """Host µs of one small `mx.nd` op (``a + b`` on 16 floats, min over
    chunks) with telemetry on (NDArray live accounting counts each output)
    and off."""
    a = mx.nd.ones((16,), ctx=ctx)
    b = mx.nd.ones((16,), ctx=ctx)

    def per_op():
        best = float("inf")
        for _ in range(chunks):
            t0 = time.perf_counter()
            for _ in range(inner):
                a + b
            best = min(best, (time.perf_counter() - t0) / inner)
        return best * 1e6

    on = per_op()
    telemetry.set_enabled(False)
    try:
        off = per_op()
    finally:
        telemetry.set_enabled(True)
    return on, off


def check_rnn_errors(what, errors, tol=RNN_CELL_TOL):
    """Gate `_errors` at ``tol`` of each reference's largest |value|."""
    worst = max(errors.items(), key=lambda kv: kv[1][0] / max(kv[1][1],
                                                              1e-30))
    log("  %s: largest difference %s %.3g of max |ref| %.4g (tolerance "
        "%.0e of it); %d quantities; %s"
        % (what, worst[0], worst[1][0], worst[1][1], tol, len(errors),
           smi_line()))
    bad = {k: v for k, v in errors.items() if not v[0] <= tol * v[1]}
    if bad:
        raise AssertionError("%s: beyond %.0e of the reference: %s"
                             % (what, tol, bad))


def rnn_cells_phase(torch, pk, args):
    """The rnn_cells phase; returns its LSTM kernels' launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry

    t0 = time.monotonic()
    ctx = mx.gpu(0)
    log("rnn_cells: the Gluon cells at the word LM's width (%d x %d LSTM, "
        "%d x %d, f32, TF32 off); %s" % (LM_LAYERS, LM_UNITS, LM_BPTT,
                                         LM_BATCH, smi_line()))
    for k in LSTM_KERNELS:   # this phase's counts start here
        getattr(pk, k).launches = 0

    def launched():
        return {k: getattr(pk, k).launches for k in LSTM_KERNELS}

    check_rnn_errors("SequentialRNNCell of 2 LSTMCells, unrolled, against "
                     "the fused gluon.rnn.LSTM(650, 2), no gradient",
                     cells_vs_fused(mx, ctx, args.seed, LM_BPTT, LM_BATCH,
                                    LM_UNITS, LM_LAYERS, grad=False))
    after_infer = launched()
    check_rnn_errors("the same with a gradient (outputs, states, the input's "
                     "and every weight's gradient)",
                     cells_vs_fused(mx, ctx, args.seed, LM_BPTT, LM_BATCH,
                                    LM_UNITS, LM_LAYERS, grad=True))
    after_grad = launched()
    want = {"lstm_infer": LM_LAYERS, "lstm_fwd": 0, "lstm_bwd": 0}
    if after_infer != want:
        raise AssertionError("rnn_cells: the fused side without a gradient "
                             "launched %s, not %s" % (after_infer, want))
    want = {"lstm_infer": LM_LAYERS, "lstm_fwd": LM_LAYERS,
            "lstm_bwd": LM_LAYERS}
    if after_grad != want:
        raise AssertionError("rnn_cells: the fused side with a gradient "
                             "launched %s in all, not %s" % (after_grad,
                                                             want))
    check_rnn_errors("bidirectional mx.rnn.FusedRNNCell(650, 2) against its "
                     "unfuse()", unfuse_vs_fused(mx, ctx, args.seed,
                                                 LM_BPTT, LM_BATCH, LM_UNITS,
                                                 LM_LAYERS))
    launches = launched()
    if launches["lstm_infer"] != after_grad["lstm_infer"] + 2 * LM_LAYERS:
        raise AssertionError("rnn_cells: the bidirectional fused cell "
                             "launched lstm_infer %d times, not %d"
                             % (launches["lstm_infer"]
                                - after_grad["lstm_infer"], 2 * LM_LAYERS))
    card = conv_lstm_step(mx, ctx, args.seed)
    with mx.context.scope(mx.cpu()):
        host = conv_lstm_step(mx, mx.cpu(), args.seed)
    check_rnn_errors("Conv2DLSTMCell(%s, %d) step, card against CPU"
                     % (CONV_CELL_SHAPE, CONV_CELL_HIDDEN),
                     _errors(dict(zip(("output", "h", "c"),
                                      zip(card, host)))))
    on, off = nd_op_host_us(mx, ctx, telemetry)
    log("  mx.nd host time of one op (a + b, 16 floats on the card, min "
        "over chunks): %.2f us with telemetry on (NDArray live accounting), "
        "%.2f us off; LSTM launches %s; the phase %.1f s; %s"
        % (on, off, json.dumps(launches), time.monotonic() - t0,
           smi_line()))
    return launches


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


def bucket_iters(seed, plans):
    """A `BucketSentenceIter` (time-major, "TN") a plan of bucket lengths,
    over one chain drawn from the seed."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(seed + 12)
    succ = rng.randint(0, LM_VOCAB, (LM_VOCAB, FACADE_SUCCESSORS))
    return [mx.rnn.BucketSentenceIter(
        symbolic_sentences(rng, succ, plan), LM_BATCH,
        buckets=list(SYM_BUCKETS), invalid_label=SYM_INVALID, layout="TN")
        for plan in plans]


def symbolic_iters(seed):
    """`bucket_iters` of the warm-up, timed and score batches."""
    timed = tuple(b for b in SYM_BUCKETS
                  for _ in range(SYM_STEPS // len(SYM_BUCKETS)))
    return bucket_iters(seed, (SYM_WARMUP_PLAN, timed, (35,) * SYM_EVAL))


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


def serve_clients(port, bodies, clients, model="lm"):
    """``bodies`` (dicts, or JSON already made) split over ``clients``
    threads, each POSTing its share in turn to ``model``'s :predict over one keep-alive connection. Returns per
    body (status, reply, seconds) and the wall seconds of the whole."""
    import http.client

    results = [None] * len(bodies)
    gate = threading.Barrier(clients)

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        gate.wait()
        try:
            for i in range(k, len(bodies), clients):
                t0 = time.perf_counter()
                conn.request("POST", "/v1/models/%s:predict" % model,
                             bodies[i] if isinstance(bodies[i], str)
                             else json.dumps(bodies[i]),
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


# ---------------------------------------------------------------------------
# phase random: the 22 random ops of mx.nd.random (and ``shuffle``) on the
# card, each draw held to its distribution; linalg and control flow on card
# tensors against the CPU. The CPU tests run the same checks on the host.
# ---------------------------------------------------------------------------

RANDOM_DRAWS = 1 << 20
RANDOM_SE = 5.0        # moments and frequencies within 5 standard errors
RANDOM_KS_P = 1e-4     # a continuous draw's KS p-value must exceed this


def random_cases(mx, ctx, n):
    """(op, draw, rows) for every drawing op at ``n`` draws on ``ctx``:
    ``draw()`` makes the NDArray; ``rows`` is a list of (index into the
    draw's first axis or None, scipy frozen distribution, discrete) for a
    distribution op, or the name of a custom check."""
    from scipy import stats

    nd = mx.nd

    def arr(v):
        return nd.array(v, ctx=ctx)

    half = n // 2
    zipf_rows = n // 8
    return [
        ("_random_uniform", lambda: nd.random.uniform(
            -1.0, 3.0, shape=(n,), ctx=ctx),
         [(None, stats.uniform(-1.0, 4.0), False)]),
        ("_random_normal", lambda: nd.random.normal(
            1.0, 2.0, shape=(n,), ctx=ctx),
         [(None, stats.norm(1.0, 2.0), False)]),
        ("_random_gamma", lambda: nd.random.gamma(
            0.5, 2.0, shape=(n,), ctx=ctx),
         [(None, stats.gamma(0.5, scale=2.0), False)]),
        ("_random_exponential", lambda: nd.random.exponential(
            2.0, shape=(n,), ctx=ctx),
         [(None, stats.expon(scale=0.5), False)]),
        ("_random_poisson", lambda: nd.random.poisson(
            4.0, shape=(n,), ctx=ctx),
         [(None, stats.poisson(4.0), True)]),
        ("_random_negative_binomial", lambda: nd.random.negative_binomial(
            3, 0.4, shape=(n,), ctx=ctx),
         [(None, stats.nbinom(3, 0.4), True)]),
        ("_random_generalized_negative_binomial",
         lambda: nd.random.generalized_negative_binomial(
             2.0, 0.5, shape=(n,), ctx=ctx),
         [(None, stats.nbinom(2.0, 0.5), True)]),
        ("_random_randint", lambda: nd.random.randint(
            -3, 7, shape=(n,), ctx=ctx),
         [(None, stats.randint(-3, 7), True)]),
        ("_sample_uniform", lambda: nd.random.sample_uniform(
            arr([0.0, -2.0]), arr([1.0, 5.0]), shape=(half,)),
         [(0, stats.uniform(0.0, 1.0), False),
          (1, stats.uniform(-2.0, 7.0), False)]),
        ("_sample_normal", lambda: nd.random.sample_normal(
            arr([0.0, 3.0]), arr([1.0, 0.5]), shape=(half,)),
         [(0, stats.norm(0.0, 1.0), False),
          (1, stats.norm(3.0, 0.5), False)]),
        ("_sample_gamma", lambda: nd.random.sample_gamma(
            arr([0.5, 3.0]), arr([1.0, 2.0]), shape=(half,)),
         [(0, stats.gamma(0.5, scale=1.0), False),
          (1, stats.gamma(3.0, scale=2.0), False)]),
        ("_sample_exponential", lambda: nd.random.sample_exponential(
            arr([1.0, 4.0]), shape=(half,)),
         [(0, stats.expon(scale=1.0), False),
          (1, stats.expon(scale=0.25), False)]),
        ("_sample_poisson", lambda: nd.random.sample_poisson(
            arr([0.5, 10.0]), shape=(half,)),
         [(0, stats.poisson(0.5), True), (1, stats.poisson(10.0), True)]),
        ("_sample_negative_binomial",
         lambda: nd.random.sample_negative_binomial(
             arr([2.0, 5.0]), arr([0.3, 0.7]), shape=(half,)),
         [(0, stats.nbinom(2.0, 0.3), True),
          (1, stats.nbinom(5.0, 0.7), True)]),
        ("_sample_generalized_negative_binomial",
         lambda: nd.random.sample_generalized_negative_binomial(
             arr([1.0, 4.0]), arr([0.5, 1.0]), shape=(half,)),
         # n = 1 / alpha, p = 1 / (1 + alpha mu)
         [(0, stats.nbinom(2.0, 2.0 / 3.0), True),
          (1, stats.nbinom(1.0, 0.2), True)]),
        ("_sample_unique_zipfian", lambda: nd.random.sample_unique_zipfian(
            range_max=50, shape=(zipf_rows, 8), ctx=ctx), "zipfian"),
        ("_sample_multinomial", lambda: nd.random.sample_multinomial(
            arr(RANDOM_PROBS), shape=(half,), get_prob=True),
         "multinomial"),
        ("_shuffle", lambda: nd.shuffle(nd.arange(n, ctx=ctx)), "shuffle"),
        ("_sample_token", lambda: nd.random.sample_token(
            arr(np.tile(RANDOM_LOGITS, (n // len(RANDOM_LOGITS), 1))),
            temperature=0.7, top_k=5), "token"),
    ]


RANDOM_PROBS = [[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]
RANDOM_LOGITS = np.linspace(-1.5, 2.0, 16).astype(np.float32)[::-1].copy()


def _within(what, got, want, se):
    if not abs(got - want) <= RANDOM_SE * se:
        raise AssertionError("%s: %.6g is %.2f standard errors (%.3g) from "
                             "%.6g" % (what, got, abs(got - want) / se, se,
                                       want))


def check_distribution(what, x, dist, discrete):
    """``x`` (numpy, 1-D) against the scipy distribution ``dist``: mean and
    variance within RANDOM_SE standard errors, and for a continuous one
    the KS test, for a discrete one each value's frequency where its
    probability is at least 1e-3. Returns the KS p-value (None if
    discrete)."""
    from scipy import stats

    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if not np.isfinite(x).all():
        raise AssertionError("%s: non-finite draws" % what)
    mean, var, kurt = (float(v) for v in dist.stats(moments="mvk"))
    _within(what + " mean", x.mean(), mean, (var / n) ** 0.5)
    _within(what + " variance", x.var(), var,
            ((kurt + 2.0) * var * var / n) ** 0.5)
    if discrete:
        if not np.array_equal(x, np.round(x)):
            raise AssertionError("%s: a discrete draw is not whole" % what)
        lo, hi = dist.ppf(1e-6), dist.ppf(1 - 1e-6)
        for v in np.arange(max(lo, x.min()), hi + 1):
            p = float(dist.pmf(v))
            if p >= 1e-3:
                _within("%s P(%d)" % (what, v), float((x == v).mean()), p,
                        (p * (1 - p) / n) ** 0.5)
        return None
    p_ks = float(stats.kstest(x, dist.cdf).pvalue)
    if not p_ks > RANDOM_KS_P:
        raise AssertionError("%s: KS p-value %.3g" % (what, p_ks))
    return p_ks


def _check_custom(kind, out, n):
    """The draws of zipfian, multinomial, shuffle and sample_token."""
    if kind == "zipfian":
        x = out.asnumpy()
        if out.dtype != np.int32 or x.min() < 0 or x.max() >= 50:
            raise AssertionError("zipfian: dtype %s, range [%d, %d]"
                                 % (out.dtype, x.min(), x.max()))
        s = np.sort(x, axis=1)
        if (s[:, 1:] == s[:, :-1]).any():
            raise AssertionError("zipfian: a row repeats a class")
        freq = np.bincount(x.ravel(), minlength=50) / x.shape[0]
        # inclusion falls with the class: p(k) ∝ log((k + 2) / (k + 1))
        if not freq[0] > freq[5] > freq[20] > freq[49]:
            raise AssertionError("zipfian: inclusion frequencies %s do not "
                                 "fall" % freq[[0, 5, 20, 49]])
        return
    if kind == "multinomial":
        draws, logp = (a.asnumpy() for a in out)
        probs = np.asarray(RANDOM_PROBS)
        for r in range(probs.shape[0]):
            for k in range(probs.shape[1]):
                p = probs[r, k]
                _within("multinomial row %d P(%d)" % (r, k),
                        float((draws[r] == k).mean()), p,
                        (p * (1 - p) / draws.shape[1]) ** 0.5)
            want = np.log(probs[r][draws[r]]).astype(np.float32)
            if not np.allclose(logp[r], want, rtol=1e-6, atol=1e-6):
                raise AssertionError("multinomial: get_prob is not the "
                                     "draws' log-probability")
        return
    if kind == "shuffle":
        x = out.asnumpy()
        if not np.array_equal(np.sort(x), np.arange(n, dtype=x.dtype)):
            raise AssertionError("shuffle: not a permutation")
        if np.array_equal(x, np.arange(n, dtype=x.dtype)):
            raise AssertionError("shuffle: the identity")
        first = x[: n // 2].astype(np.float64)
        _within("shuffle: mean of the first half", first.mean(),
                (n - 1) / 2.0, (n * n / 12.0 / first.size) ** 0.5)
        return
    if kind == "token":
        x = out.asnumpy().ravel()
        logits = RANDOM_LOGITS.astype(np.float64) / 0.7
        top = np.argsort(-RANDOM_LOGITS, kind="stable")[:5]
        p = np.zeros_like(logits)
        p[top] = np.exp(logits[top] - logits[top].max())
        p /= p.sum()
        for k in range(len(p)):
            _within("sample_token P(%d)" % k, float((x == k).mean()), p[k],
                    max(p[k] * (1 - p[k]) / x.size, 1e-12) ** 0.5)
        return
    raise ValueError(kind)


def check_random(mx, ctx, n, seed):
    """Every case of `random_cases` on ``ctx`` at ``n`` draws: the draws
    held to their distribution; the same seed twice gives the same bits,
    and the next seed other draws. Returns {op: smallest KS p-value or
    None}."""
    import torch

    report = {}
    for op, draw, rows in random_cases(mx, ctx, n):
        mx.random.seed(seed)
        out = draw()
        again_out = (mx.random.seed(seed), draw())[1]
        other_out = (mx.random.seed(seed + 1), draw())[1]
        outs = out if isinstance(out, list) else [out]
        again = again_out if isinstance(again_out, list) else [again_out]
        other = other_out if isinstance(other_out, list) else [other_out]
        for a, b in zip(outs, again):
            if not torch.equal(a._data, b._data):
                raise AssertionError("%s: one seed gave two draws" % op)
        if torch.equal(outs[0]._data, other[0]._data):
            raise AssertionError("%s: two seeds gave one draw" % op)
        if outs[0]._data.device != mx.context.resolve_device(ctx):
            raise AssertionError("%s: drawn on %s, not %s"
                                 % (op, outs[0].context, ctx))
        if isinstance(rows, str):
            _check_custom(rows, out, n)
            report[op] = None
            continue
        x = out.asnumpy()
        ps = [check_distribution("%s[%s]" % (op, i), x if i is None else
                                 x[i], dist, discrete)
              for i, dist, discrete in rows]
        ps = [p for p in ps if p is not None]
        report[op] = min(ps) if ps else None
    return report


LINALG_RTOL = 1e-4     # f32 factorizations in other libraries' orders


def linalg_inputs(seed):
    """Batched f32 inputs of the 15 linalg ops (2 x 4 x 4 unless named):
    general A, B, C; SPD S; lower L with a diagonal in [1, 2]; wide W (2 x
    3 x 5) for gelqf; symmetric Y for syevd."""
    rng = np.random.RandomState(seed)
    f = np.float32
    a = rng.randn(2, 4, 4).astype(f)
    b = rng.randn(2, 4, 4).astype(f)
    c = rng.randn(2, 4, 4).astype(f)
    s = (np.einsum("bij,bkj->bik", a, a) + 4 * np.eye(4)).astype(f)
    low = np.tril(rng.randn(2, 4, 4)).astype(f)
    low[:, range(4), range(4)] = rng.uniform(1.0, 2.0, (2, 4))
    w = rng.randn(2, 3, 5).astype(f)
    y = (a + a.transpose(0, 2, 1)).astype(f)
    v = rng.randn(2, 4).astype(f)
    return {"A": a, "B": b, "C": c, "S": s, "L": low, "W": w, "Y": y,
            "v": v}


# (op, input names, attrs); factor ops come back sign-aligned (see
# `linalg_run`)
LINALG_CASES = [
    ("gemm", ("A", "B", "C"), {"transpose_a": True, "alpha": 0.5,
                               "beta": 2.0}),
    ("gemm2", ("A", "B"), {"transpose_b": True, "alpha": 1.5}),
    ("potrf", ("S",), {}),
    ("potri", ("L",), {}),
    ("trsm", ("L", "B"), {"alpha": 2.0}),
    ("trsm", ("L", "B"), {"transpose": True, "rightside": True}),
    ("trsm", ("L", "B"), {"transpose": True}),
    ("trsm", ("L", "B"), {"rightside": True}),
    ("trmm", ("L", "B"), {"transpose": True, "alpha": 0.5}),
    ("trmm", ("L", "B"), {"rightside": True}),
    ("sumlogdiag", ("L",), {}),
    ("syrk", ("W",), {"alpha": 2.0}),
    ("syrk", ("W",), {"transpose": True}),
    ("gelqf", ("W",), {}),
    ("syevd", ("Y",), {}),
    ("makediag", ("v",), {}),
    ("extractdiag", ("A",), {"offset": 1}),
    ("inverse", ("S",), {}),
    ("det", ("A",), {}),
    ("slogdet", ("A",), {}),
]


def _sign_align(op, outs):
    """gelqf's (L, Q) with L's diagonal made positive; syevd's (V^T, w)
    with each eigenvector's largest component made positive: factors of
    two libraries then compare element by element."""
    if op == "gelqf":
        low, q = outs
        d = np.sign(np.diagonal(low, axis1=-2, axis2=-1))
        d[d == 0] = 1
        return [low * d[..., None, :], q * d[..., :, None]]
    if op == "syevd":
        vt, w = outs
        pick = np.take_along_axis(
            vt, np.abs(vt).argmax(axis=-1)[..., None], axis=-1)
        return [vt * np.sign(pick), w]
    return outs


def linalg_run(mx, ctx, seed):
    """Each case of LINALG_CASES through ``mx.nd.linalg`` on ``ctx`` of the
    package ``mx`` (the port or the JAX package): its outputs and the
    gradient of every input under ``autograd.record()``, for a cotangent
    of the outputs (for gelqf and syevd, of functions their signs leave
    alone: L^2, Q^2 and w). Returns [(label, [numpy arrays])]."""
    data = linalg_inputs(seed)
    rng = np.random.RandomState(seed + 1)
    results = []
    for op, names, attrs in LINALG_CASES:
        xs = [mx.nd.array(data[k], ctx=ctx) for k in names]
        for x in xs:
            x.attach_grad()
        with mx.autograd.record():
            outs = getattr(mx.nd.linalg, op)(*xs, **attrs)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            if op == "gelqf":
                terms = [outs[0] * outs[0], outs[1] * outs[1]]
            elif op == "syevd":
                terms = [outs[1]]
            elif op == "slogdet":
                terms = [outs[1]]
            else:
                terms = list(outs)
            total = None
            for t in terms:
                cot = mx.nd.array(rng.randn(*t.shape).astype(np.float32),
                                  ctx=ctx)
                part = (t * cot).sum()
                total = part if total is None else total + part
        total.backward()
        vals = _sign_align(op, [o.asnumpy() for o in outs])
        if op == "gelqf":
            vals.append(np.matmul(*[o.asnumpy() for o in outs]))
        if op == "syevd":
            vt, w = (o.asnumpy() for o in outs)
            vals.append(np.einsum("bki,bk,bkj->bij", vt, w, vt))
        results.append(("%s %s" % (op, attrs), vals
                        + [x.grad.asnumpy() for x in xs]))
    return results


CONTROL_FLOW_TOL = 1e-5


def control_flow_run(mx, ctx, seed):
    """``foreach`` (a tanh recurrence over 6 steps), ``while_loop`` (stopping
    after 4 of at most 4 and of at most 7 iterations: outputs padded) and
    ``cond`` (each branch) of ``mx.nd.contrib`` on ``ctx`` of the package
    ``mx``, under ``autograd.record()``: outputs, final states and the
    gradients of the inputs. Returns [(label, [numpy arrays])]."""
    rng = np.random.RandomState(seed)
    f = np.float32
    nd = mx.nd
    results = []

    data = nd.array(rng.randn(6, 3).astype(f), ctx=ctx)
    w = nd.array(rng.randn(3).astype(f), ctx=ctx)
    h0 = nd.array(rng.randn(3).astype(f), ctx=ctx)
    for x in (w, h0):
        x.attach_grad()
    with mx.autograd.record():
        outs, h = nd.contrib.foreach(
            lambda x, s: (s * 2.0, nd.tanh(x * w + s)), data, h0)
        loss = (outs * outs).sum() + (h * 3.0).sum()
    loss.backward()
    # data's gradient is left out: the JAX package's NDArray indexing (the
    # slice a step) is not on its tape (ROADMAP queue 3, not queued)
    results.append(("foreach", [outs.asnumpy(), h.asnumpy(),
                                w.grad.asnumpy(), h0.grad.asnumpy()]))

    for max_it in (4, 7):
        i0 = nd.array(np.zeros(1, f), ctx=ctx)
        acc0 = nd.array(rng.randn(2).astype(f), ctx=ctx)
        acc0.attach_grad()
        with mx.autograd.record():
            outs, (i, acc) = nd.contrib.while_loop(
                lambda i, acc: i < 4,
                lambda i, acc: (acc * 2.0, (i + 1, nd.sin(acc) + acc)),
                [i0, acc0], max_iterations=max_it)
            # the JAX package's padding rows are off its tape: the
            # gradient flows through the outputs only when no row is pad
            loss = (acc * acc).sum() + (outs.sum() if max_it == 4 else 0)
        loss.backward()
        results.append(("while_loop max %d" % max_it,
                        [outs.asnumpy(), i.asnumpy(), acc.asnumpy(),
                         acc0.grad.asnumpy()]))

    for flag in (1.0, 0.0):
        x = nd.array(rng.randn(4).astype(f), ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            out = nd.contrib.cond(nd.array([flag], ctx=ctx),
                                  lambda: nd.exp(x) * 2.0,
                                  lambda: x * x - 1.0)
            loss = (out * out).sum()
        loss.backward()
        results.append(("cond %g" % flag, [out.asnumpy(),
                                           x.grad.asnumpy()]))
    return results


def compare_runs(what, got, want, rtol):
    """Two `linalg_run` / `control_flow_run` results, array by array:
    |got - want| <= rtol |want| + rtol max|want|."""
    worst = 0.0
    for (label, g_arrs), (label2, w_arrs) in zip(got, want):
        assert label == label2, (label, label2)
        for i, (g, w) in enumerate(zip(g_arrs, w_arrs)):
            g = np.asarray(g, np.float64)
            w = np.asarray(w, np.float64)
            if g.shape != w.shape:
                raise AssertionError("%s %s [%d]: shape %s, not %s"
                                     % (what, label, i, g.shape, w.shape))
            diff = np.abs(g - w)
            floor = rtol * max(float(np.abs(w).max(initial=0.0)), 1e-30)
            if not (diff <= rtol * np.abs(w) + floor).all():
                raise AssertionError("%s %s [%d]: off by %.3g (rtol %g)"
                                     % (what, label, i, diff.max(), rtol))
            worst = max(worst, float(diff.max(initial=0.0)))
    return worst


def spatial_run(torch, device, seed):
    """``GridGenerator`` (affine and warp), ``BilinearSampler`` (a grid
    reaching past the image) and ``SpatialTransformer`` on ``device``:
    outputs and the gradients of every input for a random cotangent, as
    numpy [(label, [arrays])]."""
    from mxnet_tpu_torch import ops as tops

    rng = np.random.RandomState(seed)
    f = np.float32
    theta = (np.tile([[0.9, 0.1, 0.05, -0.2, 1.1, 0.1]], (4, 1))
             + 0.1 * rng.randn(4, 6)).astype(f)
    data = rng.randn(4, 3, 32, 40).astype(f)
    flow = (2.0 * rng.randn(4, 2, 24, 30)).astype(f)
    grid = (1.3 * rng.uniform(-1, 1, (4, 2, 24, 30))).astype(f)
    cases = [("GridGenerator affine", "GridGenerator", [theta],
              {"transform_type": "affine", "target_shape": (24, 30)}),
             ("GridGenerator warp", "GridGenerator", [flow],
              {"transform_type": "warp", "target_shape": (24, 30)}),
             ("BilinearSampler", "BilinearSampler", [data, grid], {}),
             ("SpatialTransformer", "SpatialTransformer", [data, theta],
              {"target_shape": (24, 30)})]
    out = []
    for label, op, inputs, attrs in cases:
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in inputs]
        y = tops.get(op).fn(*ts, **attrs)
        cot = torch.tensor(rng.randn(*y.shape).astype(f), device=device)
        y.backward(cot)
        out.append((label, [y.detach().cpu().numpy()]
                    + [t.grad.cpu().numpy() for t in ts]))
    return out


def random_phase(torch, args):
    """The random ops on the card: `check_random` at RANDOM_DRAWS draws
    (each op's distribution, one seed twice the same bits, the next seed
    other draws), the spatial transformer ops, linalg and control flow on
    card tensors against the CPU at the CPU tests' tolerances."""
    import mxnet_tpu_torch as mx

    t0 = time.monotonic()
    report = check_random(mx, mx.gpu(0), RANDOM_DRAWS, args.seed + 20)
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    log("random: %d drawing ops on the card at %d draws each held to their "
        "distribution (moments within %g standard errors, KS p > %g for "
        "continuous draws, each likely value's frequency for discrete "
        "ones), the same seed twice the same bits and the next seed other "
        "draws, in %.2f s; smallest KS p-value an op %s"
        % (len(report), RANDOM_DRAWS, RANDOM_SE, RANDOM_KS_P, draw_s,
           json.dumps({k: None if v is None else round(v, 4)
                       for k, v in report.items()})))
    spatial = compare_runs("spatial", spatial_run(torch, "cuda", args.seed),
                           spatial_run(torch, "cpu", args.seed), 1e-5)
    linalg = compare_runs("linalg", linalg_run(mx, mx.gpu(0), args.seed),
                          linalg_run(mx, mx.cpu(), args.seed), LINALG_RTOL)
    flow = compare_runs("control flow",
                        control_flow_run(mx, mx.gpu(0), args.seed),
                        control_flow_run(mx, mx.cpu(), args.seed),
                        CONTROL_FLOW_TOL)
    log("  GridGenerator / BilinearSampler / SpatialTransformer values and "
        "gradients on the card equal the CPU's (rtol 1e-5; largest abs "
        "err %.3g); the 15 linalg ops (%d cases, values and gradients, "
        "gelqf and syevd sign-aligned) within rtol %g (%.3g); foreach / "
        "while_loop / cond within %g (%.3g)"
        % (spatial, len(LINALG_CASES), LINALG_RTOL, linalg,
           CONTROL_FLOW_TOL, flow))


# ---------------------------------------------------------------------------
# phase ctc_ocr: examples/ctc/lstm_ocr.py on the card
# ---------------------------------------------------------------------------

OCR_SEQ, OCR_FEAT, OCR_CLASSES = 24, 16, 11     # the example's task
OCR_STEPS, OCR_BATCH, OCR_LR, OCR_HIDDEN = 350, 32, 5e-3, 64
OCR_TEST = 256                                  # the closing decode's batch
CTC_TOL = 1e-5
# (T, B, C, L) of the CTC op's card-against-CPU check: the OCR net's, and
# a long one
CTC_SHAPES = [(OCR_SEQ, OCR_BATCH, OCR_CLASSES, 4), (200, 32, 30, 40)]


def ocr_generator(seed=7):
    """The example's ``make_generator`` (examples/ctc/lstm_ocr.py, numpy
    only; the example module imports the JAX package's name): per-digit
    column signatures, and a sampler of unaligned 3-4 digit sequences
    (zero-based labels, the blank the last class)."""
    rng = np.random.RandomState(seed)
    signatures = rng.uniform(-1, 1, (10, OCR_FEAT)).astype(np.float32) * 2.0

    def sample(batch):
        x = rng.normal(0, 0.2, (batch, OCR_SEQ, OCR_FEAT)).astype(np.float32)
        labels = np.zeros((batch, 4), np.float32)
        lab_len = np.zeros((batch,), np.float32)
        for i in range(batch):
            n = rng.randint(3, 5)
            digits = rng.randint(0, 10, n)
            pos = 1
            kept = []
            for d in digits:
                width, gap = 4, 1
                if pos + width >= OCR_SEQ:
                    break
                x[i, pos:pos + width] += signatures[d]
                kept.append(d)
                pos += width + gap
            labels[i, :len(kept)] = np.array(kept)
            lab_len[i] = len(kept)
        return x, labels, lab_len

    return sample


def ocr_net(mx):
    """The example's OCRNet: ``rnn.LSTM(64, num_layers=2, layout="NTC")``
    then ``Dense(11, flatten=False)``."""

    class OCRNet(mx.gluon.HybridBlock):
        def __init__(self, hidden=OCR_HIDDEN, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.lstm = mx.gluon.rnn.LSTM(hidden, num_layers=2,
                                              layout="NTC")
                self.fc = mx.gluon.nn.Dense(OCR_CLASSES, flatten=False)

        def hybrid_forward(self, F, x):
            return self.fc(self.lstm(x))

    return OCRNet()


def greedy_decode(logits):
    """argmax a step, repeats collapsed, blanks dropped (the example's)."""
    seqs = []
    for row in logits.argmax(axis=-1):
        out, prev = [], -1
        for c in row:
            if c != prev and c != OCR_CLASSES - 1:
                out.append(int(c))
            prev = c
        seqs.append(out)
    return seqs


def check_ctc_op(torch, seed):
    """The CTC op on the card against the CPU op on the same inputs at
    CTC_SHAPES ("last" blank, label lengths given): loss and the input
    gradient within CTC_TOL; the card's forward + backward ms."""
    from mxnet_tpu_torch.ops import rnn as rnn_ops

    rng = np.random.RandomState(seed)
    notes = []
    for t, b, c, l in CTC_SHAPES:
        pred = rng.randn(t, b, c).astype(np.float32)
        lab_len = rng.randint(1, l + 1, b).astype(np.float32)
        lab = rng.randint(0, c - 1, (b, l)).astype(np.float32)
        cot = rng.rand(b).astype(np.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            p = torch.tensor(pred, device=dev, requires_grad=True)

            def run():
                loss = rnn_ops.ctc_loss(
                    p, torch.tensor(lab, device=dev), None,
                    torch.tensor(lab_len, device=dev),
                    use_label_lengths=True, blank_label="last")
                loss.backward(torch.tensor(cot, device=dev))
                return loss

            loss = run()
            res[dev] = (loss.detach(), p.grad.clone())
            if dev == "cuda":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    p.grad = None
                    run()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 5 * 1e3
        errs = [max_err(torch, g.cpu(), w, CTC_TOL, "CTC %s %s" % (
            what, (t, b, c, l))) for what, g, w in zip(
                ("loss", "gradient"), res["cuda"], res["cpu"])]
        notes.append("(T %d, B %d, C %d, L %d): loss err %.3g, gradient err "
                     "%.3g, forward + backward %.2f ms (%d frames of small "
                     "ops)" % (t, b, c, l, errs[0], errs[1], ms, t))
    return notes


def ctc_ocr(torch, pk, args):
    """examples/ctc/lstm_ocr.py on the card: OCRNet built and initialized
    with ``ctx=mx.gpu()`` (Xavier), Adam lr 5e-3, ``gluon.loss.CTCLoss``
    (NTC, NT), the example's 350 steps of 32 from its generator; the
    closing greedy decode of 256 fresh samples outside ``record()``. The
    losses finite, the last 25 steps' mean at most half the first 25's;
    lstm_fwd and lstm_bwd 2 x 350 launches in training and lstm_infer 2
    in the decode. Then the CTC op on the card against the CPU. Returns
    the launch counts of the training steps and the decode."""
    import mxnet_tpu_torch as mx

    mx.random.seed(args.seed)
    net = ocr_net(mx)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": OCR_LR})
    ctc = mx.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
    sample = ocr_generator()
    torch.cuda.reset_peak_memory_stats()
    for k in LSTM_KERNELS:   # the OCR training path's counts start here
        getattr(pk, k).launches = 0
    losses = []
    t0 = time.monotonic()
    for _ in range(OCR_STEPS):
        xb, yb, yl = sample(OCR_BATCH)
        x = mx.nd.array(xb, ctx=mx.gpu())
        with mx.autograd.record():
            loss = ctc(net(x), mx.nd.array(yb, ctx=mx.gpu()), None,
                       mx.nd.array(yl, ctx=mx.gpu()))
        loss.backward()
        trainer.step(OCR_BATCH)
        losses.append(loss.mean()._data)
    losses = torch.stack(losses).cpu().numpy()
    wall = time.monotonic() - t0
    train_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    if not np.isfinite(losses).all():
        raise AssertionError("ctc_ocr: non-finite loss")
    first, last = losses[:25].mean(), losses[-25:].mean()
    if not last <= 0.5 * first:
        raise AssertionError("ctc_ocr: the last 25 steps' mean loss %.4f is "
                             "above half the first 25's %.4f" % (last, first))
    want = {"lstm_infer": 0, "lstm_fwd": 2 * OCR_STEPS,
            "lstm_bwd": 2 * OCR_STEPS}
    if train_launches != want:
        raise AssertionError("ctc_ocr training launches %s, not %s"
                             % (train_launches, want))
    for k in LSTM_KERNELS:
        getattr(pk, k).launches = 0
    xb, yb, yl = sample(OCR_TEST)
    logits = net(mx.nd.array(xb, ctx=mx.gpu())).asnumpy()
    decode_launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    if decode_launches != {"lstm_infer": 2, "lstm_fwd": 0, "lstm_bwd": 0}:
        raise AssertionError("ctc_ocr decode launches %s, not lstm_infer 2"
                             % decode_launches)
    hits = sum(pred == [int(v) for v in lab[:int(n)]]
               for pred, lab, n in zip(greedy_decode(logits), yb, yl))
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    log("ctc_ocr: examples/ctc/lstm_ocr.py's OCRNet (LSTM(64) x 2 NTC + "
        "Dense(11), %d parameters, f32, ctx=mx.gpu()), Adam lr %g, %d steps "
        "of %d in %.2f s: %.2f steps/s; CTC loss mean of the first 25 steps "
        "%.4f, of the last 25 %.4f; training launches %s; greedy decode of "
        "%d: sequence accuracy %.3f, launches %s; peak allocated %d bytes"
        % (n_params, OCR_LR, OCR_STEPS, OCR_BATCH, wall, OCR_STEPS / wall,
           first, last, json.dumps(train_launches), OCR_TEST,
           hits / OCR_TEST, json.dumps(decode_launches),
           torch.cuda.max_memory_allocated()))
    log("  CTC op on the card against the CPU op (blank last, label "
        "lengths; tol %g): %s" % (CTC_TOL, "; ".join(check_ctc_op(
            torch, args.seed + 21))))
    return train_launches, decode_launches


# ---------------------------------------------------------------------------
# phase dropout: BERT-base at dropout 0.1 and the word LM at 0.5 on the card
# ---------------------------------------------------------------------------

DROPOUT_STEPS = 3
DROPOUT_KEEP_TOL = 0.01    # kept share within 1 % of 1 - p
DROPOUT_SAMPLE = 4096      # leading mask elements compared across steps
DROPOUT_ROUNDS, DROPOUT_ROUND_STEPS = 8, 10   # the timed A/B


class DropoutMeter:
    """Records every dropout call (`ops.nn.dropout`, which the gluon
    ``Dropout`` layers and the RNN op's inter-layer dropout both call)
    while it is entered: the share of an input's nonzero elements that
    stay nonzero, the largest relative gap between a kept element and
    x / (1 - p), and the keep pattern of the leading DROPOUT_SAMPLE
    elements."""

    def __init__(self, torch):
        self._torch = torch
        self.shares = []

    def __enter__(self):
        from mxnet_tpu_torch.ops import nn as ops_nn

        self._mod, self._fn = ops_nn, ops_nn.dropout
        torch = self._torch

        def measured(x, p=0.5, is_train=False, generator=None, axes=()):
            out = self._fn(x, p, is_train=is_train, generator=generator,
                           axes=axes)
            if is_train and p > 0:
                with torch.no_grad():
                    live = x != 0
                    kept = (out != 0) & live
                    share = kept.sum() / live.sum()
                    want = x.float() / (1 - p)
                    gap = torch.where(kept, (out.float() - want).abs()
                                      / want.abs().clamp_min(1e-30),
                                      torch.zeros_like(want)).max()
                    dropped = torch.where(kept, torch.zeros_like(want),
                                          out.float().abs()).max()
                    pattern = (out != 0).flatten()[:DROPOUT_SAMPLE].clone()
                self.shares.append((float(p), share, gap, dropped, pattern,
                                    tuple(x.shape), x.dtype))
            return out

        ops_nn.dropout = measured
        return self

    def __exit__(self, *exc):
        self._mod.dropout = self._fn

    def check(self, what, steps):
        """Every call's share within DROPOUT_KEEP_TOL of 1 - p, every kept
        element x / (1 - p) within two of its dtype's eps, every other one
        0, and each call's keep pattern different from the same call's a
        step later (a fresh mask a step); returns (calls, smallest share,
        largest share, largest relative gap)."""
        torch = self._torch
        if not self.shares or len(self.shares) % steps:
            raise AssertionError("%s: %d dropout calls over %d steps"
                                 % (what, len(self.shares), steps))
        gaps = []
        for p, share, gap, dropped, _, shape, dtype in self.shares:
            share, gap = float(share), float(gap)
            gaps.append(gap)
            if abs(share - (1 - p)) > DROPOUT_KEEP_TOL * (1 - p):
                raise AssertionError("%s: a dropout of p %g over %s kept "
                                     "%.5f" % (what, p, shape, share))
            if gap > 2 * torch.finfo(dtype).eps:
                raise AssertionError("%s: a dropout of p %g over %s (%s) "
                                     "kept values %.3g from x / (1 - p)"
                                     % (what, p, shape, dtype, gap))
            if float(dropped) != 0:
                raise AssertionError("%s: a dropout over %s left %g where "
                                     "it dropped" % (what, shape,
                                                     float(dropped)))
        per_step = len(self.shares) // steps
        for i in range(len(self.shares) - per_step):
            if torch.equal(self.shares[i][4], self.shares[i + per_step][4]):
                raise AssertionError("%s: dropout call %d of a step (%s) "
                                     "drew the same mask in two steps"
                                     % (what, i % per_step,
                                        self.shares[i][5]))
        vals = [float(v[1]) for v in self.shares]
        return len(vals), min(vals), max(vals), max(gaps)


def _dropout_off(calls):
    """`ops.nn.dropout` replaced by the identity while entered (the same
    model and trainer without the masks), each training call counted in
    ``calls``."""
    from contextlib import contextmanager
    from mxnet_tpu_torch.ops import nn as ops_nn

    @contextmanager
    def off():
        fn = ops_nn.dropout

        def identity(x, p=0.5, is_train=False, generator=None, axes=()):
            if is_train and p > 0:
                calls.append(1)
            return x

        ops_nn.dropout = identity
        try:
            yield
        finally:
            ops_nn.dropout = fn
    return off()


def _dropout_steps(torch, pk, trainer, x, y, kernels, per_step, what):
    """DROPOUT_STEPS steps with the launch counts of ``kernels`` from 0 and
    every dropout call measured (`DropoutMeter`), and the gates; then the
    cost of the masks, A/B on the same model and trainer: DROPOUT_ROUNDS
    rounds, each DROPOUT_ROUND_STEPS steps with dropout and as many with
    `ops.nn.dropout` the identity, queued back to back with one
    synchronize a block. Returns (ms a step with and without dropout, each
    a list over rounds; launches; meter stats; losses)."""
    for k in kernels:
        getattr(pk, k).launches = 0
    with DropoutMeter(torch) as meter:
        losses = [trainer.step(x, y)._data for _ in range(DROPOUT_STEPS)]
    launches = {k: getattr(pk, k).launches for k in kernels}
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("%s: non-finite loss %s" % (what, losses))
    want = {k: n * DROPOUT_STEPS for k, n in per_step.items()}
    if launches != want:
        raise AssertionError("%s: launches %s, not %s (as without dropout)"
                             % (what, launches, want))
    stats = meter.check(what, DROPOUT_STEPS)

    def block():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DROPOUT_ROUND_STEPS):
            trainer.step(x, y)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DROPOUT_ROUND_STEPS * 1e3

    on, off, calls = [], [], []
    for _ in range(DROPOUT_ROUNDS):
        on.append(block())
        with _dropout_off(calls):
            off.append(block())
    if len(calls) != stats[0] // DROPOUT_STEPS * DROPOUT_ROUNDS \
            * DROPOUT_ROUND_STEPS:
        raise AssertionError("%s: the runs without dropout passed %d "
                             "dropout calls, not %d a step"
                             % (what, len(calls), stats[0] // DROPOUT_STEPS))
    return on, off, launches, stats, losses


def _ab_line(on, off):
    """The A/B's medians, each side's range, and the rounds' paired
    differences (a round with dropout less the round after it without)."""
    a, b = float(np.median(on)), float(np.median(off))
    d = [x - y for x, y in zip(on, off)]
    return ("with dropout %.4f ms a step (median of %d rounds of %d steps; "
            "range %.4f to %.4f), without %.4f (range %.4f to %.4f); paired "
            "differences median %.4f ms a step (%.2f %%), range %.4f to %.4f"
            % (a, len(on), DROPOUT_ROUND_STEPS, min(on), max(on), b,
               min(off), max(off), float(np.median(d)),
               float(np.median(d)) / b * 100, min(d), max(d)))


def dropout_phase(torch, pk, args):
    """BERT-base (`bert_12_768_12(dropout=0.1)` + MLM head, Adam, bf16, 8 x
    512) and the word LM (`RNNModel(10000, 650, 650, 2, dropout=0.5)`,
    SGD lr 1.0, bf16, 35 x 32) for DROPOUT_STEPS steps each: finite
    losses, every dropout call right (`DropoutMeter.check`), and each
    flash kernel 12 launches a step, each LSTM training kernel 2, as the
    runs without dropout; then the masks' cost, A/B (`_dropout_steps`).
    Returns the launch counts."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.word_lm import RNNModel
    from mxnet_tpu_torch.parallel import DistributedTrainer

    net = initializer.initialize(bert_pretrain(torch, "cuda", dropout=0.1),
                                 seed=args.seed)
    rng = np.random.RandomState(args.seed + 22)
    x = torch.from_numpy(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
                         .astype(np.float32)).cuda()
    trainer = DistributedTrainer(
        net, "adam", {"learning_rate": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype="bfloat16")
    layers = len(net.bert.encoder.cells)
    on, off, launches, stats, losses = _dropout_steps(
        torch, pk, trainer, x, y, FLASH_KERNELS,
        dict.fromkeys(FLASH_KERNELS, layers), "dropout BERT")
    log("dropout: bert_12_768_12(dropout=0.1) + MLM head, bf16, %d x %d, "
        "%d steps: losses %s; %d dropout calls kept %.5f to %.5f (1 - p = "
        "0.9), kept values x / 0.9 within %.3g, a new mask each step; "
        "launches %s (= %d a step each, as without dropout); %s; %.1f "
        "tokens/s with dropout"
        % (BERT_BATCH, BERT_SEQ, DROPOUT_STEPS, ["%.4f" % v for v in losses],
           stats[0], stats[1], stats[2], stats[3], json.dumps(launches),
           layers, _ab_line(on, off),
           BERT_BATCH * BERT_SEQ / float(np.median(on)) * 1e3))
    out = dict(launches)
    del net, trainer
    torch.cuda.empty_cache()

    lm = RNNModel(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, dropout=0.5,
                  device="cuda").initialize(seed=args.seed)
    x = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                         .astype(np.int32)).cuda()
    y = torch.from_numpy(rng.randint(0, LM_VOCAB, (LM_BPTT, LM_BATCH))
                         .astype(np.float32)).cuda()
    trainer = DistributedTrainer(lm, "sgd", {"learning_rate": 1.0},
                                 loss=seq_ce(gloss), amp_dtype="bfloat16")
    on, off, launches, stats, losses = _dropout_steps(
        torch, pk, trainer, x, y, LSTM_KERNELS,
        {"lstm_infer": 0, "lstm_fwd": LM_LAYERS, "lstm_bwd": LM_LAYERS},
        "dropout word LM")
    log("  RNNModel(%d, %d, %d, %d, dropout=0.5), bf16, %d x %d, %d steps: "
        "losses %s; %d dropout calls (embedding, between the LSTM layers, "
        "output) kept %.5f to %.5f (1 - p = 0.5), kept values x / 0.5 "
        "within %.3g, a new mask each step; launches %s; %s; %.1f tokens/s "
        "with dropout"
        % (LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, LM_BPTT, LM_BATCH,
           DROPOUT_STEPS, ["%.4f" % v for v in losses], stats[0], stats[1],
           stats[2], stats[3], json.dumps(launches), _ab_line(on, off),
           LM_BPTT * LM_BATCH / float(np.median(on)) * 1e3))
    out.update({k: launches[k] for k in ("lstm_fwd", "lstm_bwd")})
    return out


# ---------------------------------------------------------------------------
# phase predict_vision: ResNet-50 v1 trained by train_imagenet
# --model-prefix, exported, served by :predict on the card
# ---------------------------------------------------------------------------

VISION_SERVE_BATCH = 32     # buckets 1 to 32, f32
VISION_TRAIN_BATCH = 32
VISION_IMAGES = 64          # distinct images the requests draw from
VISION_SEQUENTIAL = 320     # one image each, one client
VISION_MIXED = (8, 40)      # clients, requests each: 1 to 4 images each
VISION_BODIES = 32          # distinct bodies the concurrent requests cycle
VISION_RTOL = 1e-3          # of the logits' largest magnitude


def predict_vision(torch, pk, args, workdir):
    """`train_imagenet.main` with ``--model-prefix`` (resnet50_v1, NHWC,
    bf16, batch 32, 2 steps, the epilogue kernels 53 x 2 launches each),
    its export loaded by `ModelRepository.load` on the card (f32 buckets 1
    to 32, warmed) and served by `ServingServer`: VISION_SEQUENTIAL
    one-image requests from one client, then VISION_MIXED[0] clients of
    VISION_MIXED[1] requests of 1 to 4 images, every image one of
    VISION_IMAGES (the JSON bodies made once, before the clock starts).
    Every reply 200 and equal to a CPU `Predictor` on the same files, run
    over the VISION_IMAGES images, within VISION_RTOL of the logits'
    largest magnitude. Returns the training run's epilogue launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import train_imagenet
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.serving import ModelRepository, ServingServer

    prefix = os.path.join(workdir, "resnet50_v1")
    for k in EPI_KERNELS:   # the training run behind the export
        getattr(pk, k).launches = 0
    t0 = time.monotonic()
    train_imagenet.main(["--network", "resnet50_v1", "--layout", "NHWC",
                         "--batch-size", str(VISION_TRAIN_BATCH),
                         "--num-batches", "2", "--lr", "0.02",
                         "--seed", str(args.seed),
                         "--model-prefix", prefix])
    train_s = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    if launches != dict.fromkeys(EPI_KERNELS, 53 * 2):
        raise AssertionError("predict_vision: train_imagenet's 2 steps "
                             "launched %s, not 53 x 2 each" % launches)
    for f in (prefix + "-symbol.json", prefix + "-0000.params"):
        if not os.path.exists(f):
            raise AssertionError("predict_vision: --model-prefix wrote no "
                                 "%s" % f)
    shape = (224, 224, 3)
    rng = np.random.RandomState(args.seed + 23)
    # pixels in halves of [-1, 1]: the JSON stays short
    images = (rng.randint(-2, 3, (VISION_IMAGES,) + shape) / 2.0).astype(
        np.float32)

    def body(idx):
        return json.dumps({"inputs": {"data": images[idx].tolist()},
                           "timeout_ms": 120000})

    single = [body([i]) for i in range(VISION_IMAGES)]
    mixed = [list(rng.randint(0, VISION_IMAGES, n))
             for n in rng.randint(1, 5, VISION_BODIES)]
    mixed_bodies = [body(idx) for idx in mixed]
    n_mixed = VISION_MIXED[0] * VISION_MIXED[1]
    # per request: its body and the images it sends
    requests = ([(single[i % VISION_IMAGES], [i % VISION_IMAGES])
                 for i in range(VISION_SEQUENTIAL)]
                + [(mixed_bodies[i % VISION_BODIES], mixed[i % VISION_BODIES])
                   for i in range(n_mixed)])

    for k in EPI_KERNELS:
        getattr(pk, k).launches = 0
    repo = ModelRepository()
    t0 = time.monotonic()
    model = repo.load("resnet", prefix, input_shapes={"data": shape},
                      max_batch=VISION_SERVE_BATCH, ctx=mx.gpu(0))
    load_s = time.monotonic() - t0
    server = ServingServer(repo, port=0, addr="127.0.0.1").start()
    replies = []
    try:
        for name, a, b, clients in (
                ("sequential", 0, VISION_SEQUENTIAL, 1),
                ("concurrent 1-4 images", VISION_SEQUENTIAL, len(requests),
                 VISION_MIXED[0])):
            res, wall = serve_clients(server.port,
                                      [r[0] for r in requests[a:b]],
                                      clients, model="resnet")
            replies += res
            lat = np.asarray([r[2] for r in res]) * 1e3
            n_img = sum(len(r[1]) for r in requests[a:b])
            log("  %s: %d requests (%d images) from %d client(s) in %.3f "
                "s: %.2f requests/s, %.2f images/s; latency over the %d "
                "requests p50 %.2f ms, p99 %.2f ms, max %.2f ms"
                % (name, b - a, n_img, clients, wall, (b - a) / wall,
                   n_img / wall, b - a, np.percentile(lat, 50),
                   np.percentile(lat, 99), lat.max()))
    finally:
        server.shutdown()
        serve_launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
        repo.unload("resnet", timeout=30)
    bad = [(i, r[0]) for i, r in enumerate(replies) if r[0] != 200]
    if bad:
        raise AssertionError("predict_vision: %d of %d requests did not "
                             "answer 200: %s" % (len(bad), len(replies),
                                                 bad[:3]))
    if any(serve_launches.values()):
        raise AssertionError("predict_vision: inference launched epilogue "
                             "kernels %s" % serve_launches)
    cpu = Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                    ctx=mx.cpu(), input_shapes={"data": (16,) + shape})
    want = []
    for i in range(0, len(images), 16):
        chunk = images[i:i + 16]
        pad = 16 - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + shape,
                                                    np.float32)])
        want.append(cpu.forward(data=chunk).get_output(0).asnumpy()
                    [:16 - pad])
    want = np.concatenate(want)
    scale = float(np.abs(want).max())
    err = 0.0
    for (_, idx), r in zip(requests, replies):
        got = np.asarray(r[1]["outputs"][0], np.float32)
        err = max(err, float(np.abs(got - want[idx]).max())
                  if got.shape == want[idx].shape and np.isfinite(got).all()
                  else float("inf"))
    if err > VISION_RTOL * scale:
        raise AssertionError("predict_vision: replies differ from the CPU "
                             "Predictor by %g (%g of the logits' scale %g)"
                             % (err, VISION_RTOL, scale))
    log("predict_vision: train_imagenet --network resnet50_v1 --layout NHWC "
        "--batch-size %d --num-batches 2 --model-prefix (bf16) in %.1f s, "
        "epilogue launches %s (53 x 2 each); the export served by "
        "ModelRepository.load on the card (f32, buckets %s): loaded in "
        "%.3f s, of which warming %.3f s; %d replies (%d images, each one "
        "of %d) all 200, equal to a CPU Predictor within %.3g (logits' "
        "scale %.4g, rtol %g); inference launched no epilogue kernel; %s"
        % (VISION_TRAIN_BATCH, train_s, json.dumps(launches), model.buckets,
           load_s, model.warm_seconds, len(replies),
           sum(len(r[1]) for r in requests), VISION_IMAGES, err, scale,
           VISION_RTOL, smi_line()))
    return launches


# ---------------------------------------------------------------------------
# replica_pool: the serving paths through supervised replica processes
# ---------------------------------------------------------------------------

POOL_REQUESTS = 24          # concurrent greedy generation requests a run
POOL_PREDICT = (4, 64)      # clients, one-image predict requests
POOL_IMAGES = 16            # distinct images the predict requests cycle
POOL_SPAWN_S = 300.0        # a replica's budget from spawn to ready


def pool_events(telemetry, model, since):
    """The telemetry events of ``model`` recorded at or after ``since``."""
    return [dict(e["fields"], event=e["event"], ts=e["ts"])
            for e in telemetry.events()
            if e["fields"].get("model") == model and e["ts"] >= since]


def wait_healthy(pool, n, timeout):
    deadline = time.monotonic() + timeout
    while pool.healthy_count < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return pool.healthy_count >= n


def replica_pool_phase(torch, args, workdir):
    """Generation and predict through `ModelRepository.load(...,
    replicas=2)` on the card: two replica processes sharing it, each with
    its own CUDA context and copy of the weights. Returns the paged
    kernel's launches summed over the generation replicas' own counts."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch import context as mx_context
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_base_lm
    from mxnet_tpu_torch.predict import Predictor
    from mxnet_tpu_torch.serving import (ModelRepository, ServingServer,
                                         load_lm, save_lm)

    t_phase = time.monotonic()
    card = smi_line()
    device = mx_context.resolve_device()   # the card (no scope is open)
    # -- (a) generation: the serve phase's LM through a pool of 2 --------
    lm = bert_base_lm(device="cpu").initialize(args.seed)
    prefix = save_lm(lm, os.path.join(workdir, "pool_lm"))
    del lm
    reg = telemetry.get_registry()
    labels = {"model": "poollm/1"}
    failovers = reg.counter("mxtpu_serve_failover_total", labels)
    restarts = reg.counter("mxtpu_serve_replica_restart_total", labels)
    repo = ModelRepository()
    # the same 24 greedy requests through one in-process engine first
    # (replicas=0, the same default geometry), so that the pool's rates
    # have a comparison at equal load in this run
    inproc = repo.load("inproclm", prefix, generate=True)
    geo = inproc.generate_info
    oracle_lm = load_lm(prefix, device=device)
    bodies = make_requests(args.seed + 1, POOL_REQUESTS,
                           oracle_lm.config["vocab_size"],
                           geo["max_prompt"], geo["max_new_tokens"])
    for b in bodies:   # the serve phase's prompts and budgets, all greedy
        for k in ("temperature", "top_k", "top_p"):
            b.pop(k, None)
    t0 = time.monotonic()
    oracle = [greedy(torch, oracle_lm, b["tokens"], b["max_new_tokens"])
              for b in bodies]
    oracle_s = time.monotonic() - t0
    del oracle_lm
    torch.cuda.empty_cache()
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    base_url = "http://127.0.0.1:%d/v1/models/%%s:generate" % srv.port
    url = base_url % "poollm"
    kill = {}

    def kill_replica0():
        kill["pid"] = pool.replica_pid(0)
        kill["ts"] = time.time()
        os.killpg(kill["pid"], signal.SIGKILL)

    def check(name, res):
        bad = [(i, r[0], r[1] if r[0] != 200 else r[1]["tokens"])
               for i, r in enumerate(res)
               if r[0] != 200 or r[1]["tokens"] != oracle[i]]
        if bad:
            raise AssertionError(
                "replica_pool %s run: %d of %d replies not 200 and equal "
                "to the greedy oracle, e.g. %s"
                % (name, len(bad), len(res), bad[:2]))

    try:
        inproc_res = post_all(base_url % "inproclm", bodies)
        check("in-process", inproc_res)
        if not repo.unload("inproclm", timeout=60):
            raise AssertionError("replica_pool: the in-process LM did not "
                                 "drain")
        del inproc
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        model = repo.load("poollm", prefix, generate=True, replicas=2,
                          spawn_timeout_s=POOL_SPAWN_S)
        load_s = time.monotonic() - t0
        pool = model.pool
        if model.meta["device"] != str(device) or \
                dict(model.generate_info, device=None) != dict(geo,
                                                              device=None):
            raise AssertionError("replica_pool: the pool runs on %s with "
                                 "%s" % (model.meta["device"],
                                         model.generate_info))
        runs = {}
        for name, hook in (("clean", None), ("chaos", kill_replica0)):
            base = (failovers.value, restarts.value)
            res = post_all(url, bodies, on_first=hook)
            check(name, res)
            runs[name] = (res, failovers.value - base[0],
                          restarts.value - base[1])
            if name == "clean":
                # each replica's paged launches since it reported ready
                # (its warm-up apart): the clean run is all it served,
                # and replica 0's count dies with it in the chaos run
                served = {rid: pool.replica_stats(rid, timeout=60)
                          for rid in pool.replica_ids()}
                for rid, st in served.items():
                    # (a CPU rehearsal launches no kernel: a CPU tensor
                    # takes the plain version)
                    if st is None or (device.type == "cuda"
                                      and st["launches"] < 1):
                        raise AssertionError(
                            "replica_pool: replica %d served no paged "
                            "launch in the clean run: %s" % (rid, st))
        _, chaos_failovers, chaos_restarts = runs["chaos"]
        if not wait_healthy(pool, 2, 180):
            raise AssertionError("replica_pool: %s after the kill"
                                 % pool.describe())
        ejects = [e for e in pool_events(telemetry, "poollm/1", kill["ts"])
                  if e["event"] == "serve_replica_eject"]
        ready = [e for e in pool_events(telemetry, "poollm/1", kill["ts"])
                 if e["event"] == "serve_replica_ready"]
        if runs["clean"][1:] != (0, 0) or chaos_failovers < 1 \
                or chaos_restarts != 1 or [e["replica"] for e in ejects] \
                != [0] or pool.describe()["generations"] != {0: 1, 1: 0}:
            raise AssertionError(
                "replica_pool: clean failovers/restarts %s, chaos %d/%d, "
                "ejections %s, %s" % (runs["clean"][1:], chaos_failovers,
                                      chaos_restarts, ejects,
                                      pool.describe()))
        recovered_s = ready[-1]["ts"] - kill["ts"]
        if not model.drain(60):
            raise AssertionError("replica_pool: the LM pool did not drain")
        # each replica's stats_result after the drain: its KV pages,
        # pending requests, kernel builds after warm-up and peak
        # allocated bytes, read in its own process
        stats = {rid: pool.replica_stats(rid, timeout=60)
                 for rid in pool.replica_ids()}
        for rid, st in stats.items():
            if st is None:
                raise AssertionError("replica_pool: replica %d answered no "
                                     "stats" % rid)
            if st["kv_pages_used"] or st["pending"] or st["jit_after_warm"]:
                raise AssertionError("replica_pool: replica %d after the "
                                     "drain: %s" % (rid, st))
    finally:
        srv.shutdown()
        for name in repo.names():
            repo.unload(name, timeout=60)

    def rates(res):
        wall = max(r[3] for r in res) - min(r[2] for r in res)
        lat = np.asarray([r[3] - r[2] for r in res])
        tokens = sum(r[1]["num_generated"] for r in res)
        return (len(res) / wall, tokens / wall, np.percentile(lat, 50),
                np.percentile(lat, 99))

    clean = rates(runs["clean"][0])
    alone = rates(inproc_res)
    chaos = runs["chaos"][0]
    chaos_wall = max(r[3] for r in chaos) - min(r[2] for r in chaos)
    # the launches of the clean run alone: counted from each replica's
    # ready report, read before the chaos run
    launches = sum(st["launches"] for st in served.values())
    lm_run = {"prefix": prefix, "bodies": bodies, "oracle": oracle,
              "geometry": geo}
    log("replica_pool generate: bert_base_lm (%s) through "
        "ModelRepository.load(replicas=2) on the card, loaded in %.1f s "
        "(every replica warmed); %d greedy requests (the serve phase's "
        "prompts and budgets), oracle %.1f s. In-process engine "
        "(replicas=0), the same requests first: all 200 and equal to the "
        "oracle, %.2f requests/s, %.1f generated tokens/s, request p50 "
        "%.3f s p99 %.3f s. Clean run through the pool: all 200 and equal "
        "to the full-sequence greedy oracle, %.2f requests/s, %.1f "
        "generated tokens/s (%.3fx the in-process run), request p50 %.3f s "
        "p99 %.3f s; paged launches served a replica %s (warm-up apart). "
        "Chaos run (replica 0's process group SIGKILLed at the first "
        "reply): all 200 and equal to the oracle in %.3f s, %d "
        "failover(s), 1 restart, healthy again %.2f s after the kill. "
        "After the drain each replica: %s; %s"
        % (json.dumps(geo, sort_keys=True), load_s, len(bodies), oracle_s,
           alone[0], alone[1], alone[2], alone[3], clean[0], clean[1],
           clean[1] / alone[1], clean[2], clean[3],
           json.dumps({r: st["launches"] for r, st in served.items()}),
           chaos_wall, chaos_failovers, recovered_s,
           json.dumps({r: {k: st[k] for k in
                           ("kv_pages_used", "pending", "jit_after_warm",
                            "launches", "warm_launches",
                            "max_memory_allocated")}
                       for r, st in stats.items()}), card))

    # -- (b) predict: predict_vision's ResNet-50 export under kill_replica
    vprefix = os.path.join(workdir, "resnet50_v1")
    shape = (224, 224, 3)
    rng = np.random.RandomState(args.seed + 24)
    images = (rng.randint(-2, 3, (POOL_IMAGES,) + shape) / 2.0).astype(
        np.float32)
    ref = Predictor(vprefix + "-symbol.json", vprefix + "-0000.params",
                    ctx=device, input_shapes={"data": (POOL_IMAGES,) + shape})
    want = ref.forward(data=images).get_output(0).asnumpy()
    del ref
    torch.cuda.empty_cache()
    clients, n_req = POOL_PREDICT
    plabels = {"model": "poolrn/1"}
    pfail = reg.counter("mxtpu_serve_failover_total", plabels)
    prestart = reg.counter("mxtpu_serve_replica_restart_total", plabels)
    t_load = time.time()
    repo = ModelRepository()
    model = repo.load(
        "poolrn", vprefix, input_shapes={"data": shape},
        max_batch=VISION_SERVE_BATCH, replicas=2,
        spawn_timeout_s=POOL_SPAWN_S,
        # replica 0 dies at its third batch; the replicas' cuDNN and
        # cuBLAS compute in full f32, as this process does (TF32 off)
        extra_env={"MXTPU_FAULT_INJECT": "kill_replica@batch=3,replica=0",
                   "NVIDIA_TF32_OVERRIDE": "0"})
    server = ServingServer(repo, port=0, addr="127.0.0.1").start()
    try:
        pbodies = [json.dumps({"inputs": {"data": images[[i % POOL_IMAGES]]
                                          .tolist()},
                               "timeout_ms": 120000})
                   for i in range(n_req)]
        replies, pwall = serve_clients(server.port, pbodies, clients,
                                       model="poolrn")
        if not wait_healthy(model.pool, 2, 180):
            raise AssertionError("replica_pool predict: %s"
                                 % model.pool.describe())
        pev = pool_events(telemetry, "poolrn/1", t_load)
        pdesc = model.pool.describe()
    finally:
        server.shutdown()
        repo.unload("poolrn", timeout=60)
    codes = {}
    err = 0.0
    scale = float(np.abs(want).max())
    for i, (code, reply, _) in enumerate(replies):
        codes[code] = codes.get(code, 0) + 1
        if code == 200:
            got = np.asarray(reply["outputs"][0], np.float32)
            want_i = want[[i % POOL_IMAGES]]
            err = max(err, float(np.abs(got - want_i).max())
                      if got.shape == want_i.shape and np.isfinite(got).all()
                      else float("inf"))
    ejects = [e for e in pev if e["event"] == "serve_replica_eject"]
    respawns = [e for e in pev if e["event"] == "serve_replica_ready"
                and e["generation"] >= 1]
    if not set(codes) <= {200, 429, 503, 504} or codes.get(200, 0) < 48 \
            or err > VISION_RTOL * scale or pfail.value < 1 \
            or prestart.value != 1 or [e["replica"] for e in ejects] != [0] \
            or len(respawns) != 1 or pdesc["healthy"] != 2:
        raise AssertionError(
            "replica_pool predict: codes %s, max error %g (scale %g), "
            "failovers %d, restarts %d, ejections %s, respawns %d, %s"
            % (codes, err, scale, pfail.value, prestart.value, ejects,
               len(respawns), pdesc))
    log("replica_pool predict: resnet50_v1 export through "
        "ModelRepository.load(replicas=2) on the card under "
        "kill_replica@batch=3,replica=0: %d clients, %d one-image requests "
        "in %.3f s = %.2f requests/s, codes %s, every 200 equal to the "
        "in-process Predictor within %.3g (logits' scale %.4g, rtol %g); "
        "%d failover(s), 1 ejection (%s), 1 respawn, back to 2 healthy; "
        "phase %.1f s; %s"
        % (clients, n_req, pwall, n_req / pwall, json.dumps(codes), err,
           scale, VISION_RTOL, pfail.value, ejects[0]["reason"],
           time.monotonic() - t_phase, card))
    return {"paged_attention": launches}, lm_run


# ---------------------------------------------------------------------------
# autoscale: an LM pool that grows and drains on its SLO verdicts
# ---------------------------------------------------------------------------

AUTOSCALE_SURGE_S = 90.0    # the surge's budget to reach 2 healthy
AUTOSCALE_SETTINGS = {
    "MXTPU_SLO": "1",
    "MXTPU_SLO_WINDOW_MS": "250",
    "MXTPU_SLO_EVAL_MS": "250",
    "MXTPU_SLO_FAST_WINDOWS": "4,8",
    "MXTPU_SLO_SLOW_WINDOW_S": "60",
    "MXTPU_SLO_SERVE_P99_MS": "2500",
}


def autoscale_phase(torch, args, lm_run):
    """`ModelRepository.load(..., replicas=1, min_replicas=1,
    max_replicas=3)` of replica_pool's LM behind a server with an
    `Autoscaler`: a surge grows the pool to 2 within the memory budget, a
    light load recovers the p99 verdict, idle drains it back to 1. Returns
    the paged kernel's launches in the added replica since it reported
    ready."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import (Autoscaler, ModelRepository,
                                         ServingServer)
    from mxnet_tpu_torch.telemetry import slo

    t_phase = time.monotonic()
    card = smi_line()
    bodies, oracle = lm_run["bodies"], lm_run["oracle"]
    geo = lm_run["geometry"]
    per_copy = geo["param_bytes"] + geo["kv_bytes"]
    budget = int(2.5 * per_copy)
    settings = dict(AUTOSCALE_SETTINGS,
                    MXTPU_SERVE_MEMORY_BUDGET=str(budget))
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    log("autoscale: %s" % json.dumps(settings, sort_keys=True))
    slo.stop()   # the next registration starts an evaluator at this cadence
    label = "autolm/1"
    repo = ModelRepository()
    srv = None
    metrics_port = None
    t_load = time.time()
    try:
        model = repo.load("autolm", lm_run["prefix"], generate=True,
                          replicas=1, min_replicas=1, max_replicas=3,
                          spawn_timeout_s=POOL_SPAWN_S)
        pool = model.pool
        srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
        asc = srv.attach_autoscaler(Autoscaler(
            repo, interval_ms=250, up_windows=2, idle_s=5.0,
            cooldown_s=20.0))
        metrics_port = telemetry.start_http_server(port=0, addr="127.0.0.1")
        url = "http://127.0.0.1:%d/v1/models/autolm:generate" % srv.port
        replies = []

        def run(reqs):
            """POST ``reqs`` (the bodies once or twice) at once; keeps each
            reply beside its oracle; returns generated tokens/s."""
            res = post_all(url, reqs)
            replies.extend(zip(res, oracle * (len(reqs) // len(oracle))))
            tokens = sum(r[1]["num_generated"] for r in res if r[0] == 200)
            return tokens / (max(r[3] for r in res) - min(r[2] for r in res))

        # -- surge: waves of 48 until 2 healthy ---------------------------
        rates_1 = []
        deadline = time.monotonic() + AUTOSCALE_SURGE_S
        while time.monotonic() < deadline and not (
                pool.size == 2 and pool.healthy_count == 2):
            at_one = pool.size == 1
            rate = run(bodies + bodies)
            if at_one and pool.size == 1:
                rates_1.append(rate)
        t_two = time.time()
        if pool.size != 2 or pool.healthy_count != 2:
            raise AssertionError("autoscale: the pool is not at 2 healthy "
                                 "after %.0f s of surge: %s, decisions %s"
                                 % (AUTOSCALE_SURGE_S, pool.describe(),
                                    asc.describe()["decisions"]))
        rate_2 = run(bodies + bodies)
        # both replicas' own figures while the pool is at 2
        added = max(pool.replica_ids())
        at_two = {rid: pool.replica_stats(rid, timeout=60)
                  for rid in pool.replica_ids()}

        # -- recovery: the 24 bodies until the p99 verdict is healthy ------
        def verdict():
            return next((v for v in slo.verdicts()
                         if v["slo"] == "serve-p99:" + label), None)

        recovered = None
        for _ in range(8):
            run(bodies)
            v = verdict()
            if v is not None and v["healthy"] and not v["no_data"]:
                recovered = time.time()
                break
        if recovered is None:
            raise AssertionError("autoscale: the p99 verdict did not "
                                 "recover at 2 replicas: %s" % verdict())
        last_answer = max(r[0][3] for r in replies)
        t_last = time.time() - (time.monotonic() - last_answer)
        added_stats = pool.replica_stats(added, timeout=60)

        # -- idle: the autoscaler drains back to 1 -------------------------
        # (the pool's size drops as the drain starts, the decision lands
        # when it ends)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                d["action"] == "down" for d in asc.describe()["decisions"]):
            time.sleep(0.1)
        trail = asc.describe()["decisions"]
        with urllib.request.urlopen("http://127.0.0.1:%d/statusz" % srv.port,
                                    timeout=30) as r:
            statusz = json.loads(r.read())
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % metrics_port, timeout=30) as r:
            metrics = r.read().decode()
        if not wait_healthy(pool, 1, 60):
            raise AssertionError("autoscale: %s" % pool.describe())
        left = {rid: pool.replica_stats(rid, timeout=60)
                for rid in pool.replica_ids()}
        breaches = [e for e in telemetry.events()
                    if e["event"] == "slo_breach" and e["ts"] >= t_load
                    and e["fields"].get("slo") == "serve-p99:" + label]
        ready = [e for e in pool_events(telemetry, label, t_load)
                 if e["event"] == "serve_replica_ready"
                 and e["replica"] == added]
    finally:
        if srv is not None:
            srv.shutdown()   # stops and joins the autoscaler
        if metrics_port is not None:
            telemetry.stop_http_server()
        for name in repo.names():
            repo.unload(name, timeout=60)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        slo.stop()

    bad = [(i, r[0], r[1] if r[0] != 200 else r[1]["tokens"])
           for i, (r, want) in enumerate(replies)
           if r[0] != 200 or r[1]["tokens"] != want]
    if bad:
        raise AssertionError("autoscale: %d of %d replies not 200 and equal "
                             "to the greedy oracle, e.g. %s"
                             % (len(bad), len(replies), bad[:2]))
    acts = [(d["action"], d.get("reason"), d.get("size")) for d in trail]
    ups = [a for a in acts if a[0] == "up"]
    downs = [a for a in acts if a[0] == "down"]
    others = [a for a in acts if a[0] not in ("up", "down")]
    if ups != [("up", None, 2)] or downs != [("down", "idle", 1)] \
            or any(a[:2] != ("blocked", "memory_budget") for a in others):
        raise AssertionError("autoscale: decision trail %s" % trail)
    for rid, st in left.items():
        if st is None or st["kv_pages_used"] or st["pending"] \
                or st["jit_after_warm"]:
            raise AssertionError("autoscale: replica %d after the drain: %s"
                                 % (rid, st))
    if model.memory_bytes != per_copy:
        raise AssertionError("autoscale: memory_bytes %s != param_bytes + "
                             "kv_bytes %d" % (model.memory_bytes, per_copy))
    verdicts = [v for v in statusz["slo"]["verdicts"]
                if (v.get("labels") or {}).get("model") == label]
    if not verdicts or [d["action"] for d in
                        statusz["autoscaler"]["decisions"]] \
            != [d["action"] for d in trail]:
        raise AssertionError("autoscale: /statusz %s"
                             % json.dumps(statusz)[:2000])
    m_up = re.search(r'^mxtpu_autoscale_decisions_total\{action="up"\} '
                     r'(\d+)', metrics, re.M)
    if 'mxtpu_serve_replicas{model="%s"} 1' % label not in metrics \
            or m_up is None or int(m_up.group(1)) < 1:
        raise AssertionError("autoscale: /metrics lacks the replica gauge "
                             "or the up counter")
    if not breaches or not ready:
        raise AssertionError("autoscale: breach events %s, ready events %s"
                             % (breaches, ready))
    # what only the card shows: the kernel in the added replica, and each
    # replica's peak allocated bytes
    launches = added_stats["launches"] if added_stats else 0
    if launches < 1:
        raise AssertionError("autoscale: the added replica %d launched no "
                             "paged kernel since it reported ready: %s"
                             % (added, added_stats))
    peaks = {rid: st["max_memory_allocated"] for rid, st in at_two.items()}
    if any(not 1.0 <= p / per_copy <= 1.3 for p in peaks.values()):
        raise AssertionError("autoscale: peak bytes a replica %s against "
                             "memory_bytes %d" % (peaks, per_copy))
    down_ts = next(d["ts"] for d in trail if d["action"] == "down")
    log("autoscale: bert_base_lm through ModelRepository.load(replicas=1, "
        "min_replicas=1, max_replicas=3) with an Autoscaler, budget %d "
        "bytes (2.5 x memory_bytes %d = param_bytes + kv_bytes); %d "
        "replies all 200 and equal to the greedy oracle; trail %s; first "
        "breach to 2 healthy %.2f s, to the p99 verdict's recovery %.2f s "
        "more, last request to the scale-down %.2f s; generated tokens/s "
        "at 1 replica %s, at 2 %.1f; peak allocated bytes a replica %s "
        "(%.3f-%.3fx memory_bytes); the added replica's paged launches "
        "since ready %d; phase %.1f s; %s"
        % (budget, per_copy, len(replies), json.dumps(acts),
           ready[0]["ts"] - breaches[0]["ts"], recovered - t_two,
           down_ts - t_last, json.dumps([round(r, 1) for r in rates_1]),
           rate_2, json.dumps(peaks), min(peaks.values()) / per_copy,
           max(peaks.values()) / per_copy, launches,
           time.monotonic() - t_phase, card))
    return {"paged_attention": launches}


def f1_scope_check(torch):
    """Fault F1 on the card: ``generate_lm``'s load under ``scope(cpu())``
    builds its engine on the CPU, and without a scope on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.transformer import lm_mini
    from mxnet_tpu_torch.serving import ModelRepository, save_lm

    with tempfile.TemporaryDirectory(prefix="chip_smoke-lm-") as d:
        lm = lm_mini(vocab_size=128)
        lm.initialize(mx.init.Xavier(), ctx=mx.cpu())
        prefix = save_lm(lm, os.path.join(d, "lm"))
        repo = ModelRepository()
        opts = dict(num_pages=64, page_size=4, max_prompt=8,
                    max_new_tokens=2, max_batch=4)
        devices = []
        for scoped in (True, False):
            if scoped:
                with mx.context.scope(mx.cpu()):
                    model = repo.load("lm", prefix, generate=True,
                                      generate_opts=opts)
            else:
                model = repo.load("lm", prefix, generate=True,
                                  generate_opts=opts)
            engine = model.scheduler.engine
            devices.append((str(engine.device),
                            str(next(engine.lm.parameters()).device)))
            repo.unload("lm", timeout=30)
    if devices != [("cpu", "cpu"), ("cuda:0", "cuda:0")]:
        raise AssertionError("F1: generate loads built on %s, not the CPU "
                             "under scope(cpu()) and the card without"
                             % devices)
    log("F1: ModelRepository.load(generate=True) under scope(cpu()) builds "
        "its engine and weights on the CPU, without a scope on the card "
        "(%s)" % devices)



# ---------------------------------------------------------------------------
# the detection ops (ops/contrib.py): cases shared with the CPU tests
# ---------------------------------------------------------------------------

# SSD-512's anchor layout: feature sides and (sizes, ratios) a scale (the
# JAX package's _SIZES_512 / _RATIOS_6), 6,140 anchors in all
SSD_SIDES = (32, 16, 8, 4, 2, 1)
SSD_SIZES = [[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79],
             [.88, .961]]
SSD_RATIOS = [[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
              [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3], [1, 2, .5]]
SSD_ANCHORS = 6140
# detection ops on the card against the CPU, and the port against JAX:
# f32 values and gradients within 1e-5 (|got - want| <= 1e-5 |want| +
# 1e-5 max|want|); the discrete parts exactly
DET_TOL = 1e-5


def ssd_anchors(sides, sizes, ratios):
    """(1, A, 4) anchors of feature maps of the given sides, as
    ``MultiBoxPrior`` makes them scale by scale."""
    import torch
    from mxnet_tpu_torch.ops import contrib

    return np.concatenate([contrib.multibox_prior(
        torch.zeros(1, 1, s, s), sizes=z, ratios=r).numpy()
        for s, z, r in zip(sides, sizes, ratios)], axis=1)


def det_labels(rng, batch, classes, most=3):
    """(batch, most, 5) labels: 1 to ``most`` boxes of random classes a
    sample, normalized corners inside the image, then -1 rows."""
    lab = np.full((batch, most, 5), -1.0, np.float32)
    for b in range(batch):
        for m in range(rng.randint(1, most + 1)):
            w, h = rng.uniform(0.1, 0.6, 2)
            x0, y0 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            lab[b, m] = [rng.randint(classes), x0, y0, x0 + w, y0 + h]
    return lab


def image_rois(rng, n, batch, side, lo, hi):
    """(n, 5) ROIs ``[batch, x1, y1, x2, y2]`` in image coordinates, sides
    in [lo, hi) inside a ``side`` x ``side`` image."""
    w = rng.uniform(lo, hi, n)
    h = rng.uniform(lo, hi, n)
    x0 = rng.uniform(0, side - w)
    y0 = rng.uniform(0, side - h)
    return np.stack([rng.randint(0, batch, n), x0, y0, x0 + w, y0 + h],
                    axis=1).astype(np.float32)


def detection_op_cases(seed, full):
    """The detection ops' cases: (label, op, [(argument, array)], attrs,
    arguments whose gradient is taken, exact parts as (result index,
    column or None)). ``full``: the SSD-512 shapes (batch 32, 6,140
    anchors, 21 classes; the NMS ops on 4 samples), Faster R-CNN's
    default Proposal (12 anchors on a 32 x 32 map of a 512^2 image, 6,000
    -> 300) and ROI ops on SSD-512's stride-16 map (32 x 32, 256 channels,
    128 ROIs, 7 x 7); else a small SSD (352 anchors, 4 classes, batch 2).
    Both include
    examples/rcnn/train.py's shapes (64^2 images, stride 8, 2 anchors,
    48 -> 12, 64 ROIs pooled 3 x 3 from 32 channels)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    if full:
        anchors = ssd_anchors(SSD_SIDES, SSD_SIZES, SSD_RATIOS)
        batch, classes = 32, 21
    else:
        anchors = ssd_anchors((8, 4), SSD_SIZES[:2], SSD_RATIOS[:2])
        batch, classes = 2, 4
    a = anchors.shape[1]
    labels = det_labels(rng, batch, classes - 1)
    cls_pred = rng.randn(batch, classes, a).astype(f)
    e = np.exp(cls_pred - cls_pred.max(1, keepdims=True))
    cls_prob = (e / e.sum(1, keepdims=True)).astype(f)
    loc = (0.5 * rng.randn(batch, 4 * a)).astype(f)
    # the NMS ops at SSD-512's 6,140 rows on 4 samples (the detection
    # phase holds its whole batch's MultiBoxDetection on its own)
    nb = 4 if full else batch
    n_nms = a if full else 64
    nms = np.concatenate([rng.randint(0, 3, (nb, n_nms, 1)),
                          rng.uniform(0, 1, (nb, n_nms, 1)),
                          det_labels_boxes(rng, nb, n_nms)],
                         axis=2).astype(f)
    cases = [
        ("MultiBoxTarget", "multibox_target",
         [("anchor", anchors), ("label", labels), ("cls_pred", cls_pred)],
         {"overlap_threshold": 0.5, "ignore_label": -1,
          "negative_mining_ratio": 3, "negative_mining_thresh": 0.5},
         [], [(1, None), (2, None)]),
        ("MultiBoxDetection", "multibox_detection",
         [("cls_prob", cls_prob[:nb]), ("loc_pred", loc[:nb]),
          ("anchor", anchors)],
         {"nms_threshold": 0.45, "threshold": 0.01},
         ["cls_prob", "loc_pred"], [(0, 0)]),
        ("box_nms", "box_nms", [("data", nms)],
         {"overlap_thresh": 0.5, "id_index": 0, "coord_start": 2,
          "score_index": 1}, ["data"], [(0, 0)])]
    rcnn = [("rcnn", 2, 32, 8, 64, (2.0, 4.0), (1.0,), 48, 12, 4, 64,
             (3, 3))]
    if full:
        rcnn.append(("Faster R-CNN", 2, 256, 16, 512, (4, 8, 16, 32),
                     (0.5, 1, 2), 6000, 300, 16, 128, (7, 7)))
    for (name, b, ch, stride, side, scales, ratios, pre, post, min_size,
         n_rois, pooled) in rcnn:
        hw = side // stride
        na = len(scales) * len(ratios)
        logit = rng.randn(b, 2, na, hw, hw).astype(f)
        ex = np.exp(logit - logit.max(1, keepdims=True))
        prob = (ex / ex.sum(1, keepdims=True)).reshape(b, 2 * na, hw, hw)
        deltas = (0.2 * rng.randn(b, 4 * na, hw, hw)).astype(f)
        info = np.tile([side, side, 1.0], (b, 1)).astype(f)
        cases.append((
            "Proposal " + name, "proposal",
            [("cls_prob", prob.astype(f)), ("bbox_pred", deltas),
             ("im_info", info)],
            {"rpn_pre_nms_top_n": pre, "rpn_post_nms_top_n": post,
             "threshold": 0.7, "rpn_min_size": min_size, "scales": scales,
             "ratios": ratios, "feature_stride": stride,
             "output_score": True}, ["cls_prob", "bbox_pred"], []))
        feat_b = b if not full or name == "rcnn" else 8
        feat = rng.randn(feat_b, ch, hw, hw).astype(f)
        rois = image_rois(rng, n_rois, feat_b, side, stride,
                          side / 2)
        cases.append((
            "ROIAlign " + name, "roi_align",
            [("data", feat), ("rois", rois)],
            {"pooled_size": pooled, "spatial_scale": 1.0 / stride,
             "sample_ratio": 2}, ["data", "rois"], []))
        # ReLU zeros: bins whose maximum is a tie of zeros
        cases.append((
            "ROIPooling " + name, "roi_pooling",
            [("data", np.maximum(feat, 0)), ("rois", rois)],
            {"pooled_size": pooled, "spatial_scale": 1.0 / stride},
            ["data"], []))
    return cases


def det_labels_boxes(rng, batch, n):
    """(batch, n, 4) random normalized corner boxes."""
    w = rng.uniform(0.05, 0.5, (batch, n, 1))
    h = rng.uniform(0.05, 0.5, (batch, n, 1))
    x0 = rng.uniform(0, 1, (batch, n, 1)) * (1 - w)
    y0 = rng.uniform(0, 1, (batch, n, 1)) * (1 - h)
    return np.concatenate([x0, y0, x0 + w, y0 + h], axis=2)


def detection_op_run(torch, device, cases, seed):
    """Each case's op (`mxnet_tpu_torch.ops.contrib`) on ``device``: its
    outputs, then the gradients of its gradient arguments for a random
    cotangent of every float output, as numpy [(label, [arrays])], and the
    seconds each took (synchronised)."""
    from mxnet_tpu_torch.ops import contrib

    rng = np.random.RandomState(seed)
    out, times = [], {}
    for label, op, args, attrs, grad, _exact in cases:
        ts = [torch.tensor(a, device=device, requires_grad=n in grad)
              for n, a in args]
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        res = getattr(contrib, op)(*ts, **attrs)
        res = list(res) if isinstance(res, (tuple, list)) else [res]
        if device != "cpu":
            torch.cuda.synchronize()
        times[label] = time.monotonic() - t0
        arrays = [r.detach().cpu().numpy() for r in res]
        if grad:
            cot = [torch.tensor(rng.randn(*r.shape).astype(np.float32),
                                device=device) for r in res]
            loss = sum((r * c).sum() for r, c in zip(res, cot))
            wrt = [t for (n, _), t in zip(args, ts) if n in grad]
            arrays += [g.cpu().numpy()
                       for g in torch.autograd.grad(loss, wrt)]
        out.append((label, arrays))
    return out, times


def compare_detection(what, cases, got, want, tol=DET_TOL):
    """Two `detection_op_run` results: the exact parts bit for bit, every
    array within ``tol`` (`compare_runs`); returns the largest error."""
    for (label, op, args, attrs, grad, exact), (l1, g), (l2, w) in zip(
            cases, got, want):
        assert label == l1 == l2, (label, l1, l2)
        dtypes = [(a.dtype, b.dtype) for a, b in zip(g, w)]
        if any(a != b for a, b in dtypes):
            raise AssertionError("%s %s: dtypes %s" % (what, label, dtypes))
        for i, col in exact:
            gi, wi = g[i], w[i]
            if col is not None:
                gi, wi = gi[..., col], wi[..., col]
            if not np.array_equal(gi, wi):
                raise AssertionError(
                    "%s %s: result %d%s differs at %d of %d elements"
                    % (what, label, i, "" if col is None else
                       " column %d" % col, int((gi != wi).sum()), wi.size))
    return compare_runs(what, got, want, tol)


# ---------------------------------------------------------------------------
# the detection phase: SSD-512 ResNet-50 v1 trained from ImageDetIter, its
# detections, the detection ops on the card, examples/rcnn/train.py's loop
# ---------------------------------------------------------------------------

DET_BATCH, DET_WARMUP, DET_STEPS = 32, 3, 10
DET_SIDE, DET_CLASSES, DET_IMAGES = 512, 20, 64
# BatchNorms of ssd_512_resnet50_v1: 53 in ResNet-50 v1 through stage 4, 8
# in the four extra blocks
SSD_BNS = 61
DET_LR = 2e-3


def det_image(rng, side, classes):
    """One generated detection sample: a smooth noisy background and 1 to 3
    filled boxes, each of its class's colour -> (HWC uint8, label [2, 5,
    cls, x1, y1, x2, y2, ...] with normalized corners)."""
    yy, xx = np.mgrid[0:side, 0:side] / float(side)
    base = rng.uniform(0, 90, 3)
    img = (base + 40 * np.sin(2 * np.pi * (xx[..., None] * rng.uniform(
        0.5, 2, 3) + yy[..., None] * rng.uniform(0.5, 2, 3)))
        + rng.normal(0, 8, (side, side, 3)))
    label = [2.0, 5.0]
    for _ in range(rng.randint(1, 4)):
        c = rng.randint(classes)
        w, h = rng.randint(side // 8, side // 2, 2)
        x0, y0 = rng.randint(0, side - w), rng.randint(0, side - h)
        colour = np.array([(c * 53) % 256, (c * 97 + 80) % 256,
                           (c * 151 + 160) % 256], np.float64)
        img[y0:y0 + h, x0:x0 + w] = colour
        label += [float(c), x0 / side, y0 / side, (x0 + w) / side,
                  (y0 + h) / side]
    return np.clip(img, 0, 255).astype(np.uint8), label


def write_det_images(workdir, seed, n, side=DET_SIDE, classes=DET_CLASSES):
    """``n`` `det_image` samples as PNG files (the port's encoder: the card's
    machine has no Pillow) -> the imglist of `image.ImageDetIter`."""
    from mxnet_tpu_torch import image

    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        img, label = det_image(rng, side, classes)
        path = os.path.join(workdir, "det%03d.png" % i)
        with open(path, "wb") as f:
            f.write(image.imencode(img, fmt=".png"))
        items.append(label + [path])
    return items


def profile_groups(torch, run, steps, step_ms, label, groups, top=20):
    """Device busy time of ``steps`` calls of ``run`` under `torch.profiler`
    as a share of ``step_ms`` (timed without it), split into ``groups``
    (name -> test of a kernel's name, the first that matches); the ``top``
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    shares = dict.fromkeys(groups, 0.0)
    rows = []
    for ev in prof.key_averages():
        if is_annotation(ev) or not str(ev.device_type).endswith("CUDA"):
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
    log("  profile %s: device busy %.3f ms a step = %.1f%% of the %.2f ms "
        "step; %s" % (label, busy, 100.0 * busy / step_ms, step_ms,
                      "; ".join("%s %.3f ms (%.1f%%)" % (
                          k, v, 100.0 * v / max(busy, 1e-9))
                          for k, v in shares.items())))
    for ms, count, key in rows[:top]:
        log("    %8.3f ms  x%-4d %s" % (ms, count, key[:150]))


DET_GROUPS = {
    "conv epilogue": lambda k: any("::%s<" % f in k or "::%s(" % f in k
                                   for f in EPI_FUNCS),
    # the channels-first BatchNorms' movedim copies in and out (PyTorch's
    # copy of a permuted view)
    "layout copies": lambda k: "copy_kernel" in k,
    # cuDNN's own NCHW <-> NHWC transforms around its kernels
    "cuDNN layout transforms": lambda k: "nhwcToNchw" in k
    or "nchwToNhwc" in k,
    # cuDNN's convolutions, the FFT ones among them
    "convolution": lambda k: any(t in k for t in (
        "xmma", "cudnn", "conv", "implicit_gemm", "cutlass", "sm90_",
        "fft", "complex")),
    "batch to the card": lambda k: "Memcpy HtoD" in k,
    "rest": lambda k: True}


def ssd_step(autograd, net, loss_fn, trainer, x, labels):
    """One step of examples/ssd/train.py's loop; the loss as a float."""
    with autograd.record():
        cls_preds, loc_preds, anchors = net(x)
        targets = net.training_targets(anchors, cls_preds, labels)
        loss = loss_fn(cls_preds, loc_preds, *targets)
    loss.backward()
    trainer.step(x.shape[0])
    return float(loss.asnumpy()), (cls_preds, loc_preds, anchors)


def train_ssd(torch, pk, args, workdir):
    """SSD-512 ResNet-50 v1 (VOC's 20 classes, channels-first, Xavier from
    the seed, the fused ResNet graph) trained in f32 as
    examples/ssd/train.py trains it, from `ImageDetIter` over DET_IMAGES
    generated PNGs with ``rand_mirror``: DET_WARMUP steps, then the
    epilogue counts set to 0 and DET_STEPS timed steps. Gates: a finite
    loss whose last 3 steps' mean is below the first 3's; each epilogue
    kernel SSD_BNS launches a step; the detections of the last batch on
    the card equal MultiBoxDetection on the CPU over the same inputs.
    Returns the timed steps' epilogue launches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, image
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import (SSDMultiBoxLoss,
                                                        ssd_512_resnet50_v1)
    from mxnet_tpu_torch.ops import contrib

    t0 = time.monotonic()
    items = write_det_images(workdir, args.seed + 40, DET_IMAGES)
    write_s = time.monotonic() - t0
    np.random.seed(args.seed)   # the mirror's draws
    it = image.ImageDetIter(DET_BATCH, (3, DET_SIDE, DET_SIDE),
                            imglist=items, path_root="", rand_mirror=True)
    net = ssd_512_resnet50_v1(num_classes=DET_CLASSES, fuse_epilogue=True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0), seed=args.seed)
    n_bn = sum(isinstance(m, gnn.BatchNorm) for m in net.modules())
    if n_bn != SSD_BNS:
        raise AssertionError("ssd_512_resnet50_v1 has %d BatchNorms, not %d"
                             % (n_bn, SSD_BNS))
    loss_fn = SSDMultiBoxLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": DET_LR})

    def batch():
        t = time.monotonic()
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        x = b.data[0].as_in_context(mx.gpu(0))
        y = b.label[0].as_in_context(mx.gpu(0))
        torch.cuda.synchronize()
        return x, y, time.monotonic() - t

    losses = []
    t0 = time.monotonic()
    for _ in range(DET_WARMUP):
        x, y, _ = batch()
        losses.append(ssd_step(autograd, net, loss_fn, trainer, x, y)[0])
    warm_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in net.parameters())
    torch.cuda.reset_peak_memory_stats()
    for k in EPI_KERNELS:
        getattr(pk, k).launches = 0
    for k in ("epi_stats", "epi_bwd_reduce"):
        getattr(pk, k).routes = dict.fromkeys(getattr(pk, k).routes, 0)
    wait = 0.0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(DET_STEPS):
        x, y, w = batch()
        wait += w
        loss, outs = ssd_step(autograd, net, loss_fn, trainer, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    routes = {k: {r: n / DET_STEPS for r, n in getattr(pk, k).routes.items()}
              for k in ("epi_stats", "epi_bwd_reduce")}
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(losses)
    if not np.isfinite(losses).all():
        raise AssertionError("detection: non-finite loss %s" % losses)
    if not losses[-3:].mean() < losses[:3].mean():
        raise AssertionError("detection: the loss did not fall: %s" % losses)
    for k, n in launches.items():
        if n != SSD_BNS * DET_STEPS:
            raise AssertionError("detection: %s launched %d times in %d "
                                 "steps, not %d x %d" % (
                                     k, n, DET_STEPS, SSD_BNS, DET_STEPS))
    step_ms = wall / DET_STEPS * 1e3
    log("detection: ssd_512_resnet50_v1 (20 classes, NCHW, fused ResNet "
        "graph, f32, TF32 off), %d parameters, %d BatchNorms, %d anchors; "
        "%d PNGs of %d x %d written in %.1f s; Adam lr %g, batch %d from "
        "ImageDetIter (rand_mirror); %d warm-up steps in %.1f s, then %d "
        "timed in %.3f s: %.2f images/s, %.2f ms a step, %.1f%% of it in "
        "next() and the copy to the card; peak allocated %d bytes; losses "
        "%s (first 3 mean %.4f, last 3 %.4f); epilogue launches %s (= %d "
        "x %d); the reductions' launches a step by route %s; %s"
        % (n_params, n_bn, outs[2].shape[1], DET_IMAGES, DET_SIDE, DET_SIDE,
           write_s, DET_LR, DET_BATCH, DET_WARMUP, warm_s, DET_STEPS, wall,
           DET_BATCH * DET_STEPS / wall, step_ms, 100.0 * wait / wall, peak,
           ["%.4f" % v for v in losses], losses[:3].mean(),
           losses[-3:].mean(), json.dumps(launches), SSD_BNS, DET_STEPS,
           json.dumps(routes), smi_line()))
    if outs[2].shape[1] != SSD_ANCHORS:
        raise AssertionError("detection: %d anchors, not %d"
                             % (outs[2].shape[1], SSD_ANCHORS))
    if args.profile:
        def run():
            xb, yb, _ = batch()
            ssd_step(autograd, net, loss_fn, trainer, xb, yb)

        profile_groups(torch, run, 2, step_ms, "SSD-512 f32 step", DET_GROUPS)

    # the detections of the last batch, on the card and on the CPU
    cls_preds, loc_preds, anchors = (o.detach() for o in outs)
    cls_prob = mx.nd.softmax(mx.nd.transpose(cls_preds, (0, 2, 1)), axis=1)
    det_args = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    det = net.detections(cls_preds, loc_preds, anchors)
    torch.cuda.synchronize()
    det_s = time.monotonic() - t0
    t0 = time.monotonic()
    card = contrib.multibox_detection(cls_prob._data, loc_preds._data,
                                      anchors._data, **det_args)
    torch.cuda.synchronize()
    op_s = time.monotonic() - t0
    t0 = time.monotonic()
    cpu = contrib.multibox_detection(cls_prob._data.cpu(),
                                     loc_preds._data.cpu(),
                                     anchors._data.cpu(), **det_args)
    cpu_s = time.monotonic() - t0
    # the NMS's parts: the packed suppression matrix of the score-ordered
    # boxes on the card (class-blind here), then its read to the host
    torch.cuda.synchronize()
    t0 = time.monotonic()
    words = contrib._suppression_words(card[..., 2:6], 0.45)
    torch.cuda.synchronize()
    words_s = time.monotonic() - t0
    t0 = time.monotonic()
    words = words.cpu()
    read_s = time.monotonic() - t0
    det_np, card_np, cpu_np = (t.cpu().numpy() for t in
                               (det._data, card, cpu))
    if not np.array_equal(det_np, card_np):
        raise AssertionError("detection: net.detections differs from "
                             "MultiBoxDetection over its softmax")
    if not np.array_equal(card_np[..., 0], cpu_np[..., 0]):
        raise AssertionError("detection: the card's kept ids differ from "
                             "the CPU's at %d of %d rows"
                             % (int((card_np[..., 0] != cpu_np[..., 0])
                                    .sum()), cpu_np[..., 0].size))
    err = compare_runs("detection card vs CPU", [("det", [card_np[..., 1:]])],
                       [("det", [cpu_np[..., 1:]])], DET_TOL)
    kept = int((card_np[..., 0] >= 0).sum())
    log("  detections of the last batch (MultiBoxDetection, NMS 0.45 over "
        "%d anchors x %d images): net.detections %.1f ms, the op alone on "
        "the card %.1f ms (of it the suppression matrix %.1f ms and its "
        "read of %d bytes %.1f ms, the rest the decode, sort and host "
        "sweep), on the CPU %.1f ms; %d kept (%.1f an image); ids and kept "
        "set equal to the CPU's, scores and boxes within %.3g"
        % (SSD_ANCHORS, DET_BATCH, det_s * 1e3, op_s * 1e3, words_s * 1e3,
           words.numel() * 4, read_s * 1e3, cpu_s * 1e3, kept,
           kept / DET_BATCH, err))
    return launches


def detection_ops_phase(torch, args):
    """Every case of `detection_op_cases` (full: SSD-512's and Faster
    R-CNN's shapes, and examples/rcnn/train.py's) on the card against the
    CPU: values and gradients within DET_TOL, the discrete parts exact."""
    cases = detection_op_cases(args.seed + 41, full=True)
    card, card_s = detection_op_run(torch, "cuda", cases, args.seed + 42)
    cpu, cpu_s = detection_op_run(torch, "cpu", cases, args.seed + 42)
    err = compare_detection("detection ops card vs CPU", cases, card, cpu)
    log("detection ops on the card equal the CPU's (values and gradients "
        "within %g, largest error %.3g; targets, ids, kept sets and ROI "
        "order exact); card / CPU seconds, forward with its backward where "
        "taken: %s" % (DET_TOL, err, "; ".join(
            "%s %.4f / %.4f" % (k, card_s[k], cpu_s[k]) for k in card_s)))


def jax_standin():
    """A module that answers ``import jax`` in the census scripts, which
    call ``jax.devices()`` themselves (the card's machine has no JAX):
    ``devices()`` / ``local_devices()`` give the port's mesh devices
    (`parallel.devices`), ``config.update`` does nothing, and
    ``process_count()`` is the process group's size."""
    import types

    from mxnet_tpu_torch import parallel

    jax = types.ModuleType("jax")
    jax.MXNET_TPU_TORCH_STANDIN = True
    jax.devices = lambda backend=None: parallel.devices()
    jax.local_devices = lambda *a, **k: parallel.local_devices()
    jax.device_count = lambda: len(parallel.devices())
    jax.process_count = parallel.num_workers
    jax.process_index = parallel.rank
    jax.config = types.SimpleNamespace(update=lambda *a, **k: None)
    return jax


def run_example(rel_script, argv, env=None):
    """``examples/<rel_script>`` run as a script in this process on the card,
    each ``mxnet_tpu`` import answered by the port's module of the same
    path (an import hook) and ``import jax`` by `jax_standin`, under
    ``context.scope(gpu(0))``, with ``env`` set for the run. Returns its
    standard output's lines and the seconds it took."""
    import contextlib
    import importlib
    import importlib.abc
    import importlib.util
    import io
    import runpy

    class Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        def find_spec(self, name, path, target=None):
            if name == "mxnet_tpu" or name.startswith("mxnet_tpu."):
                return importlib.util.spec_from_loader(name, self)
            return None

        def create_module(self, spec):
            return importlib.import_module(
                "mxnet_tpu_torch" + spec.name[len("mxnet_tpu"):])

        def exec_module(self, module):
            pass

    import mxnet_tpu_torch as mx

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", rel_script)
    finder = Alias()
    sys.meta_path.insert(0, finder)
    real_jax = sys.modules.get("jax")
    sys.modules["jax"] = jax_standin()
    argv_, out = sys.argv, io.StringIO()
    sys.argv = [script] + list(argv)
    saved_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out), mx.context.scope(mx.gpu(0)):
            runpy.run_path(script, run_name="__main__")
    finally:
        sys.argv = argv_
        sys.meta_path.remove(finder)
        if real_jax is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = real_jax
        for name in [n for n in sys.modules if n == "mxnet_tpu"
                     or n.startswith("mxnet_tpu.")]:
            del sys.modules[name]
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out.getvalue().strip().splitlines(), time.monotonic() - t0


def rcnn_example(torch):
    """examples/rcnn/train.py --steps 20 --image-size 64 on the card
    (`run_example`): the FasterRCNN net, Proposal, the host-side target
    sampling, ROIAlign and the four losses; the script's own gate is that
    the loss falls over its 20 steps."""
    lines, secs = run_example(os.path.join("rcnn", "train.py"),
                              ["--steps", "20", "--image-size", "64"])
    falls = [ln for ln in lines if "->" in ln]
    if not falls:
        raise AssertionError("rcnn: no loss line in %s" % lines[-3:])
    log("rcnn: examples/rcnn/train.py --steps 20 --image-size 64 on the "
        "card in %.1f s: %s; %s" % (secs, falls[-1], lines[-1]))


def detection_phase(torch, pk, args):
    """The detection slice on the card: `train_ssd`, then
    `detection_ops_phase` and `rcnn_example`. Returns the SSD training's
    epilogue launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke-det-") as workdir:
        launches = train_ssd(torch, pk, args, workdir)
    torch.cuda.empty_cache()
    detection_ops_phase(torch, args)
    rcnn_example(torch)
    return launches


# ---------------------------------------------------------------------------
# profiler: the symbolic word LM's fit under mx.profiler, on and off
# ---------------------------------------------------------------------------

PROF_BATCHES = 6      # bucket-35 batches a run (each run replays the same)
PROF_OP_CATS = ("symbolic", "imperative")
# the overhead A/B: rounds, each a window of PROF_WINDOW batches in each
# mode, the modes' order reversed every other round
PROF_MODES = ("off", "on", "on, profile_sync")
PROF_ROUNDS, PROF_WINDOW = 8, 24
PROF_EXAMPLE_STEPS = 3


class _Replay:
    """A data iterator over a fixed list of `DataBatch`es (each `fit` of the
    profiler phase sees the same batches in the same order)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.provide_data = self.batches[0].provide_data
        self.provide_label = self.batches[0].provide_label
        self.default_bucket_key = self.batches[0].bucket_key

    def reset(self):
        pass

    def __iter__(self):
        return iter(self.batches)


def profiler_runs(torch, pk, bm, batches, workdir):
    """`fit` over ``batches`` three times: under the profiler with
    ``profile_sync``, under it without, and with it off. Returns, a run,
    (wall seconds, the LSTM launch counts, the trace's events or None, the
    `dumps` table)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler

    data = _Replay(batches)
    out = {}
    for label, sync_on in (("on, profile_sync", True), ("on", False),
                           ("off", None)):
        path = os.path.join(workdir, "trace-%d.json" % len(out))
        if sync_on is not None:
            profiler.set_config(filename=path, profile_all=True,
                                aggregate_stats=True, profile_sync=sync_on)
        for k in LSTM_KERNELS:
            getattr(pk, k).launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync_on is not None:
            profiler.set_state("run")
        try:
            bm.fit(data, eval_metric=mx.metric.Perplexity(SYM_INVALID),
                   optimizer="sgd",
                   optimizer_params={"learning_rate": SYM_LR}, num_epoch=1)
            torch.cuda.synchronize()
        finally:
            profiler.set_state("stop")
        wall = time.perf_counter() - t0
        launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
        events, table = None, ""
        if sync_on is not None:
            table = profiler.dumps(reset=True)
            profiler.dump(finished=True)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        out[label] = (wall, launches, events, table)
    return out


def check_profiler_runs(runs, n):
    """The phase's gates over `profiler_runs`: each trace holds an
    ExecutorForward and an ExecutorBackward event a batch (symbolic), the
    synced run's op events on the fitting thread sum to no more than its
    wall time, each run launches lstm_fwd / lstm_bwd once a layer a batch
    and lstm_infer never, and each `dumps` table lists both events.
    Returns the synced op events' share of that run's wall."""
    want = {"lstm_infer": 0, "lstm_fwd": LM_LAYERS * n,
            "lstm_bwd": LM_LAYERS * n}
    share = None
    for label, (wall, launches, events, table) in runs.items():
        if launches != want:
            raise AssertionError("profiler %s: launches %s, not %s"
                                 % (label, launches, want))
        if events is None:
            continue
        ops = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in PROF_OP_CATS]
        for name in ("ExecutorForward", "ExecutorBackward"):
            got = [e for e in ops if e["name"] == name]
            if len(got) != n or any(e["cat"] != "symbolic" for e in got):
                raise AssertionError("profiler %s: %d %s events over %d "
                                     "batches" % (label, len(got), name, n))
            if name not in table:
                raise AssertionError("profiler %s: dumps() lacks %s:\n%s"
                                     % (label, name, table))
        tid = [e for e in ops if e["name"] == "ExecutorForward"][0]["tid"]
        total = 1e-6 * sum(e["dur"] for e in ops if e["tid"] == tid)
        if label.endswith("profile_sync"):
            if total > wall:
                raise AssertionError("profiler %s: op events sum to %.4f s, "
                                     "more than the %.4f s wall"
                                     % (label, total, wall))
            share = total / wall
    return share


def profiler_overhead(torch, bm, batches, workdir):
    """ms a batch of `fit`'s work a batch (``forward_backward``,
    ``update``, ``update_metric``) with the profiler off, on, and on with
    ``profile_sync``: PROF_ROUNDS rounds, each a window of PROF_WINDOW
    batches (``batches`` replayed) in each mode, the modes' order reversed
    every other round; the profiler is switched, and its events written
    and cleared, outside the clock. Returns each mode's ms a batch by
    round."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler

    metric = mx.metric.Perplexity(SYM_INVALID)
    work = [batches[i % len(batches)] for i in range(PROF_WINDOW)]
    out = {m: [] for m in PROF_MODES}
    for r in range(PROF_ROUNDS):
        for mode in PROF_MODES[::-1] if r % 2 else PROF_MODES:
            if mode != "off":
                profiler.set_config(
                    filename=os.path.join(workdir, "ab.json"),
                    profile_all=True, aggregate_stats=True,
                    profile_sync=mode.endswith("profile_sync"))
                profiler.set_state("run")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in work:
                bm.forward_backward(b)
                bm.update()
                bm.update_metric(metric, b.label)
            torch.cuda.synchronize()
            out[mode].append(1e3 * (time.perf_counter() - t0) / len(work))
            if mode != "off":
                profiler.set_state("stop")
                profiler.dump(finished=True)
    return out


def overhead_line(ms):
    """Each profiled mode of `profiler_overhead` beside "off": the medians,
    and the ratio to the same round's "off" window, lowest to highest; a
    cost is "resolved" only where every round's ratio lies on one side of
    1."""
    off = ms["off"]
    parts = ["off %.3f ms a batch (rounds %.3f-%.3f)"
             % (float(np.median(off)), min(off), max(off))]
    for mode in PROF_MODES[1:]:
        ratio = [a / b for a, b in zip(ms[mode], off)]
        parts.append(
            "%s %.3f ms (rounds %.3f-%.3f), its ratio to the round's off "
            "%.4f-%.4f, median %.4f: %s"
            % (mode, float(np.median(ms[mode])), min(ms[mode]), max(ms[mode]),
               min(ratio), max(ratio), float(np.median(ratio)),
               "resolved" if min(ratio) > 1 or max(ratio) < 1
               else "not resolved"))
    return "; ".join(parts)


def profile_training_example():
    """examples/profiler/profile_training.py --steps PROF_EXAMPLE_STEPS on
    the card (`run_example`), its trace parsed: each step's two Dense
    events, its SoftmaxCrossEntropyLoss event and their ``_backward_*``
    events (imperative), a step marker a step, the task."""
    steps = PROF_EXAMPLE_STEPS
    want = {("Dense", "X"): 2 * steps,
            ("SoftmaxCrossEntropyLoss", "X"): steps,
            ("_backward_SoftmaxCrossEntropyLoss", "X"): steps,
            ("_backward_Dense", "X"): 2 * steps,
            ("train-steps", "X"): 1}
    want.update({("step-%d" % i, "i"): 1 for i in range(steps)})
    with tempfile.TemporaryDirectory(prefix="chip_smoke-prof-") as workdir:
        out = os.path.join(workdir, "profile.json")
        lines, secs = run_example(os.path.join("profiler",
                                               "profile_training.py"),
                                  ["--steps", str(steps)],
                                  env={"MXTPU_PROFILE_OUT": out})
        with open(out) as f:
            events = json.load(f)["traceEvents"]
    got = {}
    for e in events:
        key = (e.get("name"), e.get("ph"))
        if key in want:
            got[key] = got.get(key, 0) + 1
        if key[0] in ("Dense", "SoftmaxCrossEntropyLoss",
                      "_backward_Dense", "_backward_SoftmaxCrossEntropyLoss") \
                and e.get("cat") != "imperative":
            raise AssertionError("profile_training: %s in category %s"
                                 % (key[0], e.get("cat")))
    if got != want or not any("chrome trace written" in ln for ln in lines):
        raise AssertionError("profile_training: trace events %s, not %s; "
                             "output %s" % (got, want, lines[-3:]))
    log("profile_training: examples/profiler/profile_training.py --steps %d "
        "on the card in %.1f s: %d trace events, of them %s"
        % (steps, secs, len(events), ", ".join(
            "%s %d" % (k[0], v) for k, v in sorted(got.items()))))


def profiler_phase(torch, pk, args):
    """The word LM of the symbolic phase (a fresh `BucketingModule` over
    FusedRNNCell(650, 2 layers), f32, SGD lr SYM_LR, Xavier from the
    seed, 2 warm-up batches) `fit` over PROF_BATCHES bucket-35 batches
    under ``profiler.set_config(profile_all=True)`` / ``set_state("run")``
    with
    ``profile_sync``, then without, then with the profiler off
    (`profiler_runs`, `check_profiler_runs`); then the overhead A/B
    (`profiler_overhead`); then `start_xla_trace` / `stop_xla_trace`
    around one batch, whose torch.profiler trace must name the LSTM
    kernels; then `profile_training_example` with the profiler's config as
    it was before the phase."""
    import random

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.train_lstm_bucketing import lm_sym_gen

    dev, n = mx.gpu(0), PROF_BATCHES
    mx.random.seed(args.seed)
    random.seed(args.seed)
    np.random.seed(args.seed)
    saved = dict(profiler._config)
    t0 = time.monotonic()
    with mx.context.scope(dev), tempfile.TemporaryDirectory(
            prefix="chip_smoke-prof-") as workdir:
        warm_it, timed_it = bucket_iters(args.seed + 1,
                                         (SYM_WARMUP_PLAN, (35,) * n))
        bm = mx.mod.BucketingModule(
            lm_sym_gen(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, fused=True,
                       layout="TNC"),
            default_bucket_key=max(SYM_BUCKETS), context=dev)
        bm.fit(warm_it, eval_metric=mx.metric.Perplexity(SYM_INVALID),
               optimizer="sgd", optimizer_params={"learning_rate": SYM_LR},
               initializer=mx.init.Xavier(), num_epoch=1)
        batches = list(timed_it)
        runs = profiler_runs(torch, pk, bm, batches, workdir)
        share = check_profiler_runs(runs, n)
        ab = profiler_overhead(torch, bm, batches, workdir)
        xdir = os.path.join(workdir, "xla")
        profiler.start_xla_trace(xdir)
        try:
            bm.fit(_Replay(batches[:1]),
                   eval_metric=mx.metric.Perplexity(SYM_INVALID),
                   optimizer="sgd",
                   optimizer_params={"learning_rate": SYM_LR}, num_epoch=1)
            torch.cuda.synchronize()
        finally:
            profiler.stop_xla_trace()
        files = os.listdir(xdir)
        with open(os.path.join(xdir, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    profiler._config.update(saved)
    kernels = sorted({nm for nm in names if "lstm_forward_kernel" in nm
                      or "lstm_backward" in nm})
    if not any("lstm_forward_kernel" in k for k in kernels) or \
            not any("lstm_backward" in k for k in kernels):
        raise AssertionError("profiler: the torch.profiler trace names no "
                             "LSTM kernel (%d names)" % len(names))
    launches = {k: sum(r[1][k] for r in runs.values()) for k in LSTM_KERNELS}
    log("profiler: symbolic word LM fit over %d bucket-35 batches (f32, 2 x "
        "%d) with profile_sync, without, off: traces of %d / %d events, "
        "ExecutorForward and ExecutorBackward %d each, the synced op events "
        "%.1f %% of the wall; lstm_fwd / lstm_bwd %d each a run; "
        "start_xla_trace around one batch names %s; %.1f s; %s"
        % (n, LM_UNITS, len(runs["on"][2]), len(runs["on, profile_sync"][2]),
           n, 100.0 * share, LM_LAYERS * n, kernels[:3],
           time.monotonic() - t0, smi_line()))
    log("  overhead A/B, %d rounds of %d batches in each mode: %s"
        % (PROF_ROUNDS, PROF_WINDOW, overhead_line(ab)))
    del bm
    torch.cuda.empty_cache()
    profile_training_example()
    return launches


# ---------------------------------------------------------------------------
# quantization: int8 ResNet-50 v1 scored on the card, the 9 ops card vs CPU,
# examples/quantization/quantize_lenet.py
# ---------------------------------------------------------------------------

# bench.py's `_SCORE_NETS["resnet50"]` and `bench_score_int8` flow: the
# unfused channels-first graph (Convolution -> BatchNorm -> Activation, a
# plain add), so every BatchNorm folds and every convolution quantizes
INT8_NET, INT8_BATCH, INT8_SIDE = "resnet50_v1", 32, 224
INT8_CONVS, INT8_FCS = 53, 1
INT8_TOP1 = 0.75      # the JAX package's own bar, tests/test_contrib.py:354
# the int8 / f32 A/B: warm-up forwards each, then rounds of INT8_ITERS
# timed forwards each, the order reversed every other round
INT8_WARMUP, INT8_ROUNDS, INT8_ITERS = 3, 6, 20
INT8_PROFILE_STEPS = 2
# the F3 check: batches of INT8_BATCH made on the card from the seed
POOL_BATCHES = 64
# the int8 forward's device time by part (`int8_profile`): the ranges put
# around these functions of ops/quantization.py and registered ops
INT8_RANGES = {"im2col gathers": ("im2col_int8", None),
               "_int_mm (padding included)": ("int8_matmul", None),
               "quantize / requantize / dequantize": (
                   None, ("_contrib_quantize_v2", "_contrib_requantize",
                          "_contrib_dequantize"))}


def bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def predictor_ips(torch, preds, xd):
    """Images/s of each Predictor of ``preds`` (label -> Predictor) over
    the card batch ``xd``: INT8_WARMUP forwards each, then INT8_ROUNDS
    rounds of INT8_ITERS timed forwards each, the order reversed every
    other round, the card synchronized at both ends of every window.
    Returns each label's images/s by round."""
    order = list(preds)
    for label in order:
        for _ in range(INT8_WARMUP):
            preds[label].forward(data=xd)
    out = {label: [] for label in order}
    for r in range(INT8_ROUNDS):
        for label in order[::-1] if r % 2 else order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INT8_ITERS):
                preds[label].forward(data=xd)
            torch.cuda.synchronize()
            out[label].append(xd.shape[0] * INT8_ITERS
                              / (time.perf_counter() - t0))
    return out


def pool_check(torch, args, fsym, ffiles, qsym, shape):
    """Fault F3 shown on ResNet-50's own activations: POOL_BATCHES batches
    (uniform in [-1, 1) from the seed, made on the card) through the
    folded f32 graph on the card up to the global average pool's input;
    that input's mean over the spatial axes taken on the card and on the
    CPU, by PyTorch's f32 ``mean`` (the pool before the repair) and by the
    port's ``Pooling``; each mean then quantized as the int8 graph does it
    (``quantize_v2`` with the calibrated range of the FC's input, on the
    CPU). Gate: the port's pool gives the card and the CPU the same bits.
    Returns the counts of values, of f32 means that differ, of int8 steps
    they flip, the pool input's shape, and the card's ms
    of each pool at this shape (`time_ms`)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.nn import pooling
    from mxnet_tpu_torch.predict import Predictor

    pool = [n for n in fsym._topo() if n.op == "Pooling"
            and n.attrs.get("global_pool")]
    if len(pool) != 1:
        raise AssertionError("F3: %d global pools in the folded graph"
                             % len(pool))
    feat = pool[0].inputs[0][0].name + "_output"
    fc = [n for n in qsym._topo()
          if n.op == "_contrib_quantized_fully_connected"][0]
    q = fc.inputs[0][0]
    while q.op != "_contrib_quantize_v2":
        q = q.inputs[0][0]
    rng = {k: float(q.attrs[k]) for k in ("min_calib_range",
                                          "max_calib_range")}
    pred = Predictor(*ffiles, ctx=mx.gpu(0), input_shapes=shape,
                     output_names=[feat])
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 41)

    def quant(t):
        return mx.nd.contrib.quantize_v2(mx.nd.array(t.numpy(), ctx=mx.cpu()),
                                         **rng)[0].asnumpy()

    values = diff_mean = flips = diff_pool = 0
    for _ in range(POOL_BATCHES):
        x = torch.rand(shape["data"], generator=gen, device="cuda") * 2 - 1
        f = pred.forward(data=x).get_output(0)._data
        host = f.cpu()
        card, cpu = f.mean(dim=(2, 3)).cpu(), host.mean(dim=(2, 3))
        values += cpu.numel()
        diff_mean += int((card != cpu).sum())
        flips += int((quant(card) != quant(cpu)).sum())
        pc = pooling(f, global_pool=True, pool_type="avg").cpu()
        pp = pooling(host, global_pool=True, pool_type="avg")
        diff_pool += int((pc.view(torch.int32) != pp.view(torch.int32)).sum())
    if diff_pool:
        raise AssertionError("F3: the port's global average pool differs "
                             "card vs CPU in %d of %d values"
                             % (diff_pool, values))
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ms_mean = time_ms(torch, lambda: f.mean(dim=(2, 3), keepdim=True), flush)
    ms_pool = time_ms(torch, lambda: pooling(f, global_pool=True,
                                             pool_type="avg"), flush)
    return values, diff_mean, flips, tuple(f.shape), ms_mean, ms_pool


def int8_profile(torch, pred, xd):
    """Device time of INT8_PROFILE_STEPS forwards under `torch.profiler`,
    split by the `INT8_RANGES` parts (each kernel counted under the
    ``record_function`` range of the call that launched it) and the rest;
    ms a forward, and the kernels launched a forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import quantization as qops

    def ranged(label, fn):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    saved = []
    for label, (func, opnames) in INT8_RANGES.items():
        if func is not None:
            saved.append((qops, func, getattr(qops, func)))
            setattr(qops, func, ranged(label, getattr(qops, func)))
        for name in opnames or ():
            od = ops.get(name)
            saved.append((od, "fn", od.fn))
            od.fn = ranged(label, od.fn)
    steps = INT8_PROFILE_STEPS
    try:
        pred.forward(data=xd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                pred.forward(data=xd)
            torch.cuda.synchronize()
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)
    parts = dict.fromkeys(INT8_RANGES, 0.0)
    for ev in prof.events():
        if ev.name in parts and ev.device_type == DeviceType.CPU:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            parts[ev.name] += us / steps / 1e3
    busy, kernels = 0.0, 0
    for ev in prof.key_averages():
        if is_annotation(ev) or not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        busy += us / steps / 1e3
        kernels += ev.count
    parts["rest"] = busy - sum(parts.values())
    return busy, parts, kernels // steps


def int8_resnet(torch, args, workdir):
    """bench.py's ``bench_score_int8`` flow through the port: INT8_NET
    (channels-first, ``fuse_epilogue=False``, Xavier from ``--seed``)
    hybridized and run once on a batch from the seed, exported,
    ``load_checkpoint``, `fold_batch_norm`, `quantize_model` with naive
    calibration over that batch, ``save_checkpoint``, then a `Predictor`
    on the card, at INT8_BATCH x 3 x INT8_SIDE^2. Gates: every
    convolution and the FC quantized and no BatchNorm left (the census);
    the card's int8 logits equal to a CPU `Predictor`'s over the same
    files and batch bit for bit; top-1 agreement with the folded f32 graph
    on the card at least INT8_TOP1; `pool_check`. Prints int8 and f32
    (TF32 off) images/s (`predictor_ips`), peak allocated bytes, the F3
    counts and, under ``--profile``, the int8 forward's device time by
    part."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.model import load_checkpoint, save_checkpoint
    from mxnet_tpu_torch.predict import Predictor

    ctx, name, batch, convs = mx.gpu(0), INT8_NET, INT8_BATCH, INT8_CONVS
    rng = np.random.RandomState(args.seed + 31)
    x = rng.uniform(-1, 1, (batch, 3, INT8_SIDE, INT8_SIDE)).astype(
        np.float32)
    shape = {"data": x.shape}
    prefix = os.path.join(workdir, name)
    t0 = time.monotonic()
    with mx.context.scope(ctx):
        mx.random.seed(args.seed)
        net = vision.get_model(name, fuse_epilogue=False)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net.hybridize()
        net(mx.nd.array(x))
        net.export(prefix)
        del net
        sym, arg_params, aux_params = load_checkpoint(prefix, 0)
        fsym, fargs, fauxs = q.fold_batch_norm(sym, arg_params, aux_params)
        save_checkpoint(prefix + "-folded", 0, fsym, fargs, fauxs)
        t1 = time.monotonic()
        qsym, qargs, qauxs = q.quantize_model(
            fsym, fargs, fauxs, calib_mode="naive",
            calib_data=mx.io.NDArrayIter(x, batch_size=batch))
        calib_s = time.monotonic() - t1
        save_checkpoint(prefix + "-quant", 0, qsym, qargs, qauxs)
    prep_s = time.monotonic() - t0
    census = {}
    for n in qsym._topo():
        if not n.is_var:
            census[n.op] = census.get(n.op, 0) + 1
    folded_ops = {n.op for n in fsym._topo() if not n.is_var}
    if "BatchNorm" in folded_ops or census.get("BatchNorm"):
        raise AssertionError("int8: a BatchNorm was not folded: %s" % census)
    if census.get("_contrib_quantized_conv") != convs \
            or census.get("_contrib_quantized_fully_connected") != INT8_FCS \
            or census.get("Convolution") or census.get("FullyConnected"):
        raise AssertionError("int8: the quantized graph's census %s, not %d "
                             "quantized convolutions and %d FC and no float "
                             "one" % (census, convs, INT8_FCS))
    qw = [k for k in qargs if k.endswith("_weight_quantize")]
    if len(qw) != convs + INT8_FCS or any(
            qargs[k].dtype != np.int8 for k in qw):
        raise AssertionError("int8: %d offline-quantized weights, dtypes %s"
                             % (len(qw), {str(qargs[k].dtype) for k in qw}))
    files = (prefix + "-quant-symbol.json", prefix + "-quant-0000.params")
    ffiles = (prefix + "-folded-symbol.json", prefix + "-folded-0000.params")
    pred = Predictor(*files, ctx=ctx, input_shapes=shape)
    if pred._args[qw[0]].dtype != np.int8:
        raise AssertionError("int8: the Predictor bound %s as %s"
                             % (qw[0], pred._args[qw[0]].dtype))
    xd = mx.nd.array(x, ctx=ctx)
    got = pred.forward(data=xd).get_output(0).asnumpy()
    t0 = time.monotonic()
    cpu = Predictor(*files, ctx=mx.cpu(), input_shapes=shape)
    want = cpu.forward(data=x).get_output(0).asnumpy()
    cpu_s = time.monotonic() - t0
    del cpu
    if not np.isfinite(got).all() or got.shape != (batch, 1000):
        raise AssertionError("int8 logits: shape %s, finite %s"
                             % (got.shape, np.isfinite(got).all()))
    if not bits_equal(got, want):
        diff = np.abs(got.astype(np.float64) - want)
        raise AssertionError(
            "int8: the card's logits differ from the CPU Predictor's in %d "
            "of %d elements, by up to %g (logits' scale %g)"
            % (int((diff > 0).sum()), diff.size, diff.max(),
               np.abs(want).max()))
    fpred = Predictor(*ffiles, ctx=ctx, input_shapes=shape)
    fp = fpred.forward(data=xd).get_output(0).asnumpy()
    agree = float((fp.argmax(1) == got.argmax(1)).mean())
    if agree < INT8_TOP1:
        raise AssertionError("int8: top-1 agreement with the folded f32 "
                             "graph %.3f < %g" % (agree, INT8_TOP1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred.forward(data=xd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ips = predictor_ips(torch, {"int8": pred, "f32": fpred}, xd)
    int8_ips = float(np.median(ips["int8"]))
    f32_ips = float(np.median(ips["f32"]))
    ops_line = ", ".join("%s %d" % (k.replace("_contrib_", ""), v)
                         for k, v in sorted(census.items()))
    log("quantization: %s (channels-first, fuse_epilogue=False, Xavier from "
        "the seed) at %d x 3 x %d^2: export, fold_batch_norm, quantize_model"
        "(naive, one batch: %.2f s), save_checkpoint and the card Predictor "
        "in %.1f s; graph: %s; int8 logits equal the CPU Predictor's bit for "
        "bit (CPU forward %.1f s; logits' scale %.4g); top-1 agreement with "
        "the folded f32 graph %.3f; images/s, median of %d rounds of %d "
        "forwards after %d (rounds lowest-highest): int8 %.2f (%.2f-%.2f), "
        "f32 (TF32 off) %.2f (%.2f-%.2f); peak allocated in an int8 forward "
        "%d bytes; %s"
        % (name, batch, INT8_SIDE, calib_s, prep_s, ops_line, cpu_s,
           np.abs(want).max(), agree, INT8_ROUNDS, INT8_ITERS, INT8_WARMUP,
           int8_ips, min(ips["int8"]), max(ips["int8"]), f32_ips,
           min(ips["f32"]), max(ips["f32"]), peak, smi_line()))
    values, diff_mean, flips, fshape, ms_mean, ms_pool = pool_check(
        torch, args, fsym, ffiles, qsym, shape)
    log("  F3: the global average pool's input over %d batches of %d from "
        "the seed (%d means): PyTorch's f32 mean differs card vs CPU in %d "
        "values and flips %d int8 steps of the FC's quantize_v2; the port's "
        "pool (f64 sum, one division) gives the same bits on both; card ms "
        "at %s: f32 mean %.4f, the port's pool %.4f"
        % (POOL_BATCHES, batch, values, diff_mean, flips, fshape, ms_mean,
           ms_pool))
    if args.profile:
        busy, parts, kernels = int8_profile(torch, pred, xd)
        log("  profile int8 forward: device %.3f ms a forward (%.2f ms "
            "timed without the profiler, %.1f %% busy), %d kernels; %s"
            % (busy, 1e3 * batch / int8_ips, 100.0 * busy * int8_ips
               / (1e3 * batch), kernels, "; ".join(
                   "%s %.3f ms (%.1f %%)" % (k, v, 100.0 * v / max(busy,
                                                                   1e-9))
                   for k, v in parts.items())))
        fbusy, _, fkernels = int8_profile(torch, fpred, xd)
        log("  profile f32 forward: device %.3f ms a forward (%.2f ms timed "
            "without the profiler), %d kernels"
            % (fbusy, 1e3 * batch / f32_ips, fkernels))


def int8_op_cases(seed):
    """The 9 ops (and their calibrated variants) at ResNet-50's shapes at
    batch 32: (op, arrays, attrs) a case."""
    rng = np.random.RandomState(seed + 37)
    b = 32

    def i8(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)

    def r(lo, hi):
        return np.array([lo], np.float32), np.array([hi], np.float32)

    dmn, dmx = r(-2.5, 3.1)
    wmn, wmx = r(-0.21, 0.19)
    stem = rng.randn(b, 3, 224, 224).astype(np.float32)
    acc = rng.randint(-3000000, 3000000, (b, 256, 56, 56)).astype(np.int32)
    return {
        "quantize_v2 (stem input)": ("quantize_v2", [stem], {}),
        "quantize_v2 calibrated": ("quantize_v2", [stem],
                                   {"min_calib_range": -2.2,
                                    "max_calib_range": 2.4}),
        "dequantize (stage 1 out)": ("dequantize", [acc, dmn, dmx], {}),
        "requantize": ("requantize", [acc, dmn, dmx], {}),
        "requantize calibrated": ("requantize", [acc, dmn, dmx],
                                  {"min_calib_range": -1.5,
                                   "max_calib_range": 1.7}),
        "quantized_conv stem 7x7/2": (
            "quantized_conv", [i8(b, 3, 224, 224), i8(64, 3, 7, 7),
                               rng.randn(64).astype(np.float32), dmn, dmx,
                               wmn, wmx],
            {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
             "num_filter": 64}),
        "quantized_conv stage 1 3x3": (
            "quantized_conv", [i8(b, 64, 56, 56), i8(64, 64, 3, 3),
                               rng.randn(64).astype(np.float32), dmn, dmx,
                               wmn, wmx],
            {"kernel": (3, 3), "pad": (1, 1), "num_filter": 64}),
        "quantized_conv stage 4 1x1/2 down": (
            "quantized_conv", [i8(b, 1024, 14, 14),
                               i8(2048, 1024, 1, 1),
                               rng.randn(2048).astype(np.float32), dmn, dmx,
                               wmn, wmx],
            {"kernel": (1, 1), "stride": (2, 2), "num_filter": 2048}),
        "quantized_fully_connected": (
            "quantized_fully_connected", [i8(b, 2048), i8(1000, 2048),
                                          rng.randn(1000).astype(np.float32),
                                          dmn, dmx, wmn, wmx],
            {"num_hidden": 1000}),
        "quantized_pooling max 3x3/2": (
            "quantized_pooling", [i8(b, 64, 112, 112), dmn, dmx],
            {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": "max"}),
        "quantized_pooling global avg": (
            "quantized_pooling", [i8(b, 2048, 7, 7), dmn, dmx],
            {"global_pool": True, "pool_type": "avg"}),
        "quantized_act": ("quantized_act", [i8(b, 64, 112, 112), dmn,
                                            dmx], {}),
        "quantized_flatten": ("quantized_flatten", [i8(b, 2048, 1, 1), dmn,
                                                    dmx], {}),
        "quantized_concat": ("quantized_concat",
                             [i8(b, 64, 28, 28),
                              i8(b, 128, 28, 28), dmn, dmx, wmn, wmx],
                             {"num_args": 2, "dim": 1}),
    }


def int8_ops_phase(torch, args):
    """Each case of `int8_op_cases` on card tensors against the CPU: int8
    and int32 outputs exactly, ranges and f32 outputs bit for bit."""
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    t0 = time.monotonic()
    cases = int8_op_cases(args.seed)
    for label, (op, arrays, attrs) in cases.items():
        fn = getattr(mx.nd.contrib, op)
        got = fn(*[mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays],
                 **attrs)
        want = fn(*[mx.nd.array(a, ctx=mx.cpu(), dtype=a.dtype)
                    for a in arrays], **attrs)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        for i, (g, w) in enumerate(zip(got, want)):
            if not bits_equal(g.asnumpy(), w.asnumpy()):
                raise AssertionError("int8 op %s output %d: the card's "
                                     "differs from the CPU's" % (label, i))
    log("quantization ops: %d cases of the 9 ops at ResNet-50's shapes at "
        "batch 32 on the card equal the CPU's bit for bit (%.1f s)"
        % (len(cases), time.monotonic() - t0))


def lenet_example():
    """examples/quantization/quantize_lenet.py --smoke on the card
    (`run_example`): LeNet trained, exported, quantized with entropy (KL)
    calibration over 128 samples, rebound in a Module (on the CPU, as the
    script binds it); its own gate is the int8 accuracy within 6 % of the
    f32 one."""
    lines, secs = run_example(os.path.join("quantization",
                                           "quantize_lenet.py"), ["--smoke"])
    acc = [ln for ln in lines if "int8 accuracy" in ln]
    if not acc:
        raise AssertionError("quantize_lenet: no accuracy line in %s"
                             % lines[-3:])
    log("quantize_lenet: examples/quantization/quantize_lenet.py --smoke in "
        "%.1f s (training and calibration on the card, the quantized Module "
        "on the CPU as the script binds it): %s" % (secs, acc[-1]))


def quantization_phase(torch, args):
    """The int8 slice on the card: `int8_resnet`, `int8_ops_phase`,
    `lenet_example`."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke-int8-") as workdir:
        int8_resnet(torch, args, workdir)
    torch.cuda.empty_cache()
    int8_ops_phase(torch, args)
    torch.cuda.empty_cache()
    lenet_example()


# ---------------------------------------------------------------------------
# sparse: the example, a 1,000,000-feature linear model, lazy vs dense
# embedding updates, the local kvstore, SyncBatchNorm
# ---------------------------------------------------------------------------

SPARSE_DIM = 1_000_000        # the linear model's features
SPARSE_ROWS, SPARSE_NNZ = 8192, 32   # a batch: rows x nonzeros a row
SPARSE_STEPS, SPARSE_WARM = 60, 10   # steps; the last 50 are timed
SPARSE_LR = 0.5               # AdaGrad, as the example
SPARSE_W1_TOL, SPARSE_LOSS_TOL = 1e-6, 1e-4
EMB_SHAPE = (30522, 768)      # BERT-base's vocabulary and width
EMB_TOKENS = (8, 512)
EMB_TIMED = 5                 # timed updates after the first of each run
EMB_TOL = 1e-6
KV_SHAPE = (4096, 64)


def sparse_batches(seed, steps, rows=SPARSE_ROWS, nnz=SPARSE_NNZ,
                   dim=SPARSE_DIM):
    """CSR batches of a hashed click log, made with numpy from ``seed``:
    ``nnz`` columns a row drawn uniformly over ``dim`` (repeats within a
    row are hash collisions, summed), standard normal values, and labels
    from a hidden weight as examples/sparse/linear_classification.py makes
    them. A list of (data, indices, indptr, labels), one a step."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal(dim).astype(np.float32)
    indptr = np.arange(0, rows * nnz + 1, nnz, dtype=np.int64)
    out = []
    for _ in range(steps):
        cols = rng.integers(0, dim, (rows, nnz))
        vals = rng.standard_normal((rows, nnz)).astype(np.float32)
        y = ((vals * w_true[cols]).sum(axis=1) > 0).astype(np.float32)
        out.append((vals.ravel(), cols.ravel(), indptr, y))
    return out


def count_host_syncs(torch, fn):
    """(fn's result, the host syncs it made on the card, each as the
    ``file:line`` of the Python call that made it): torch's sync debug mode
    warns at each synchronizing call, and the warnings are counted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, ["%s:%d" % (os.path.basename(w.filename), w.lineno)
                 for w in caught
                 if "called a synchronizing" in str(w.message)]


def sparse_linear_run(torch, device, batches, dim=SPARSE_DIM, timed=False):
    """The example's training loop at ``dim`` features on ``device``: a
    (dim, 1) f32 weight with a row_sparse gradient, each step
    ``autograd.record`` -> ``sparse.dot`` -> the logistic loss ->
    ``backward`` -> AdaGrad's lazy update -> ``kv.push``. The batches are
    on the device before the first step. Returns a dict: the losses, the
    weights after step 1 and at the end, the last gradient's rows, and,
    with ``timed``, the seconds of the steps after `SPARSE_WARM` (a sync at
    each end), one step's host syncs and the peak allocated bytes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import sparse

    rows = len(batches[0][3])
    res = {}
    with mx.context.scope(torch.device(device)):
        xs = [sparse.csr_matrix((d, i, p), shape=(rows, dim))
              for d, i, p, _ in batches]
        ys = [mx.nd.array(y) for *_, y in batches]
        weight = mx.nd.zeros((dim, 1))
        weight.attach_grad(stype="row_sparse")
        opt = mx.optimizer.create("adagrad", learning_rate=SPARSE_LR)
        state = opt.create_state(0, weight)
        kv = mx.kv.create("local")
        kv.init(0, weight)

        def step(i):
            with autograd.record():
                logits = sparse.dot(xs[i], weight).reshape((rows,))
                loss = mx.nd.log(1 + mx.nd.exp(-(2 * ys[i] - 1)
                                               * logits)).mean()
            loss.backward()
            opt.update(0, weight, weight.grad, state)
            kv.push(0, weight)
            return loss._data.detach()

        if timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses = [step(0)]
        res["w1"] = weight.asnumpy()
        for i in range(1, len(batches)):
            if timed and i == SPARSE_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if timed and i == 2:
                loss, res["syncs"] = count_host_syncs(torch,
                                                      lambda: step(i))
                losses.append(loss)
                continue
            losses.append(step(i))
        if timed:
            torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
            res["peak"] = torch.cuda.max_memory_allocated()
        res["losses"] = torch.stack(losses).cpu()
        res["w"] = weight.asnumpy()
        res["nnz_rows"] = weight.grad.num_rows
    return res


def sparse_dot_grad(torch, device, batch, dim):
    """``sparse.dot(csr, w)`` and the gradient of its squares' sum with
    respect to ``w`` (the transposed product) on ``device``, for a
    (dim, 4) weight drawn from a seed of the batch's size."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import sparse

    d, i, p, _ = batch
    w0 = np.random.default_rng(len(d)).standard_normal((dim, 4)) \
        .astype(np.float32)
    with mx.context.scope(torch.device(device)):
        x = sparse.csr_matrix((d, i, p), shape=(len(p) - 1, dim))
        w = mx.nd.array(w0)
        w.attach_grad()
        with autograd.record():
            out = sparse.dot(x, w)
            (out * out).sum().backward()
        return out._data.detach().cpu(), w.grad._data.cpu()


def sparse_embedding_run(torch, lazy, w0, tokens):
    """`gluon.contrib.nn.SparseEmbedding` (``lazy``) or ``nn.Embedding``
    over BERT-base's table from ``w0``, under a gluon Trainer with Adam:
    one step over ``tokens`` (the weight and both moments after it), then
    `EMB_TIMED` more steps, each update timed by CUDA events around
    ``trainer.step`` (the card's idle time while the host enqueues counts,
    as it does for the user). Returns (weight, mean, var, median ms)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    dev = torch.device("cuda")
    if lazy:
        emb = gluon.contrib.nn.SparseEmbedding(*EMB_SHAPE)
    else:
        emb = gluon.nn.Embedding(*EMB_SHAPE, sparse_grad=False)
    emb.initialize(ctx=dev)
    emb.weight.set_data(w0)
    trainer = gluon.Trainer(emb.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    x = nd.array(tokens, ctx=dev)
    ms = []
    for k in range(1 + EMB_TIMED):
        with autograd.record():
            out = emb(x)
            (out * out).mean().backward()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        trainer.step(tokens.size)
        e.record()
        torch.cuda.synchronize()
        if k == 0:
            mean, var = trainer._updater.states[0]
            first = (emb.weight.data()._data.detach().clone(), mean.clone(),
                     var.clone())
        else:
            ms.append(s.elapsed_time(e))
    return first + (float(np.median(ms)),)


def kvstore_run(torch, device, seed):
    """The local kvstore's calls on ``device``: dense and row_sparse pushes
    summed, pull, row_sparse_pull into a row_sparse and a dense output,
    set_optimizer (SGD with momentum and wd on dense and row_sparse
    pushes) and 2-bit compression over four pushes. Returns the results
    as numpy arrays, by name; raises unless the row_sparse output holds the
    rows asked for."""
    import mxnet_tpu_torch as mx

    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(KV_SHAPE).astype(np.float32)
            for _ in range(4)]
    rows = [np.sort(rng.choice(KV_SHAPE[0], 300, replace=False))
            for _ in range(3)]
    asked = rng.choice(KV_SHAPE[0], 64)
    out = {}
    with mx.context.scope(torch.device(device)):
        sp = mx.nd.sparse

        def rsp(i):
            return sp.row_sparse_array((vals[i][rows[i]], rows[i]),
                                       shape=KV_SHAPE)

        kv = mx.kv.create("local")
        kv.init([0, 1], [mx.nd.array(vals[3]), mx.nd.zeros(KV_SHAPE)])
        kv.push(0, [mx.nd.array(vals[0]), mx.nd.array(vals[1])])
        kv.push(1, [rsp(0), rsp(1), rsp(2)])
        for k in (0, 1):
            o = mx.nd.zeros(KV_SHAPE)
            kv.pull(k, out=o)
            out["pull%d" % k] = o.asnumpy()
        o = mx.nd.zeros(KV_SHAPE).tostype("row_sparse")
        kv.row_sparse_pull(1, out=o, row_ids=mx.nd.array(asked))
        out["rsp_pull_indices"] = o.indices.asnumpy()
        out["rsp_pull_data"] = o.data.asnumpy()
        o = mx.nd.zeros((len(asked), KV_SHAPE[1]))
        kv.row_sparse_pull(1, out=o, row_ids=mx.nd.array(asked))
        out["dense_rows"] = o.asnumpy()
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9, wd=1e-4))
        kv.init(2, mx.nd.array(vals[3]))
        for g in (mx.nd.array(vals[0]), rsp(1), rsp(2)):
            kv.push(2, g)
        o = mx.nd.zeros(KV_SHAPE)
        kv.pull(2, out=o)
        out["sgd"] = o.asnumpy()
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(3, mx.nd.zeros(KV_SHAPE))
        for i in range(4):
            kv.push(3, [mx.nd.array(vals[i]), mx.nd.array(vals[3 - i])])
            o = mx.nd.zeros(KV_SHAPE)
            kv.pull(3, out=o)
            out["2bit%d" % i] = o.asnumpy()
    want = np.unique(asked)
    if not (np.array_equal(out["rsp_pull_indices"], want)
            and np.array_equal(out["rsp_pull_data"], out["pull1"][want])
            and np.array_equal(out["dense_rows"], out["pull1"][asked])):
        raise AssertionError("row_sparse_pull on %s did not return the rows "
                             "asked for" % device)
    return out


def sync_bn_step(torch, pk, device, seed):
    """`gluon.contrib.nn.SyncBatchNorm` (one device: BatchNorm over axis 1)
    in training on a (32, 64, 28, 28) f32 batch: the output, the input's
    gradient, and the conv-epilogue launches of the step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    rng = np.random.default_rng(seed)
    x_np = rng.standard_normal((32, 64, 28, 28)).astype(np.float32)
    r_np = rng.standard_normal(x_np.shape).astype(np.float32)
    with mx.context.scope(torch.device(device)):
        bn = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=64)
        bn.initialize()
        x, r = mx.nd.array(x_np), mx.nd.array(r_np)
        x.attach_grad()
        for k in EPI_KERNELS:
            getattr(pk, k).launches = 0
        with autograd.record():
            y = bn(x)
            (y * r).sum().backward()
        y, dx = y.asnumpy(), x.grad.asnumpy()
    return y, dx, {k: getattr(pk, k).launches for k in EPI_KERNELS}


def sparse_phase(torch, pk, args):
    """Sparse storage on the card (phase 16 of the module docstring).
    Returns SyncBatchNorm's epilogue launches."""
    card = smi_line()
    lines, secs = run_example(os.path.join("sparse",
                                           "linear_classification.py"), [])
    acc = [ln for ln in lines if ln.startswith("final accuracy")]
    if not acc:
        raise AssertionError("sparse example: no accuracy line in %s"
                             % lines[-3:])
    log("sparse: examples/sparse/linear_classification.py (150 steps, DIM "
        "1000, batch 32, AdaGrad, kv.row_sparse_pull) on the card in %.2f s, "
        "%s; %s" % (secs, acc[-1], card))

    batches = sparse_batches(args.seed + 61, SPARSE_STEPS)
    card_a = sparse_linear_run(torch, "cuda", batches, timed=True)
    card_b = sparse_linear_run(torch, "cuda", batches)
    cpu = sparse_linear_run(torch, "cpu", batches)
    if not (torch.equal(card_a["losses"], card_b["losses"])
            and np.array_equal(card_a["w"], card_b["w"])):
        raise AssertionError("sparse linear model: two card runs differ")
    scale = float(np.abs(cpu["w1"]).max())
    w1_err = float(np.abs(card_a["w1"] - cpu["w1"]).max()) / scale
    loss_card = float(card_a["losses"][-1])
    loss_cpu = float(cpu["losses"][-1])
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    if not (w1_err <= SPARSE_W1_TOL and loss_err <= SPARSE_LOSS_TOL
            and np.isfinite(card_a["losses"].numpy()).all()):
        raise AssertionError(
            "sparse linear model card vs CPU: step-1 weights %.3g of their "
            "largest magnitude (limit %g), step-%d loss %.9g vs %.9g (%.3g "
            "relative, limit %g)" % (w1_err, SPARSE_W1_TOL, SPARSE_STEPS,
                                     loss_card, loss_cpu, loss_err,
                                     SPARSE_LOSS_TOL))
    timed = SPARSE_STEPS - SPARSE_WARM
    steps_s = timed / card_a["seconds"]
    log("sparse: linear model, %d features (f32 weight (%d, 1), "
        "row_sparse gradient), CSR batches %d rows x %d nonzeros, AdaGrad "
        "lazy + kv.push: %.2f steps/s, %.0f rows/s (%d timed steps in %.4f "
        "s after %d warm-up); gradient rows at the last step %d; host syncs "
        "in one step %d (%s); peak allocated %.1f MiB; card vs CPU: step-1 "
        "weights %.3g of their largest magnitude, step-%d loss %.9g vs "
        "%.9g (%.3g relative); a second card run equal bit for bit; %s"
        % (SPARSE_DIM, SPARSE_DIM, SPARSE_ROWS, SPARSE_NNZ, steps_s,
           steps_s * SPARSE_ROWS, timed, card_a["seconds"], SPARSE_WARM,
           card_a["nnz_rows"], len(card_a["syncs"]),
           " | ".join(card_a["syncs"]) or "none",
           card_a["peak"] / 2 ** 20, w1_err, SPARSE_STEPS, loss_card,
           loss_cpu, loss_err, card))
    dots = [sparse_dot_grad(torch, dev, batches[0], SPARSE_DIM)
            for dev in ("cuda", "cuda", "cpu")]
    if not all(torch.equal(a, b) for a, b in zip(dots[0], dots[1])):
        raise AssertionError("sparse.dot or its backward differs between "
                             "two card runs")
    dot_err = [max_err(torch, a, b, 1e-5, "sparse.dot card vs CPU",
                       float(b.abs().max())) for a, b in
               zip(dots[0], dots[2])]
    log("sparse: sparse.dot (%d x %d csr, %d nonzeros, by a (%d, 4) weight) "
        "and its backward repeat bit for bit on the card; card vs CPU "
        "largest differences %.3g / %.3g" % (
            SPARSE_ROWS, SPARSE_DIM, SPARSE_ROWS * SPARSE_NNZ, SPARSE_DIM,
            *dot_err))
    del card_a, card_b, cpu, dots
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed + 62)
    w0 = rng.uniform(-0.05, 0.05, EMB_SHAPE).astype(np.float32)
    tokens = rng.integers(0, EMB_SHAPE[0], EMB_TOKENS).astype(np.float32)
    lazy = sparse_embedding_run(torch, True, w0, tokens)
    dense = sparse_embedding_run(torch, False, w0, tokens)
    touched = np.unique(tokens).astype(np.int64)
    mask = torch.zeros(EMB_SHAPE[0], dtype=torch.bool, device="cuda")
    mask[torch.from_numpy(touched).cuda()] = True
    scale = float(dense[0][mask].abs().max())
    emb_err = float((lazy[0][mask] - dense[0][mask]).abs().max()) / scale
    w0_t = torch.from_numpy(w0).cuda()
    stale = (torch.equal(lazy[0][~mask], w0_t[~mask])
             and not lazy[1][~mask].any() and not lazy[2][~mask].any())
    if emb_err > EMB_TOL or not stale:
        raise AssertionError(
            "SparseEmbedding lazy Adam vs dense: touched rows %.3g (limit "
            "%g); untouched rows and moments unchanged: %s"
            % (emb_err, EMB_TOL, stale))
    log("sparse: SparseEmbedding(%d, %d) + Trainer(adam), %d x %d tokens, "
        "%d rows touched: lazy update %.4f ms, dense update "
        "(Embedding(sparse_grad=False)) %.4f ms (CUDA events around "
        "trainer.step, the card's waits for the host after the lazy "
        "update's sync included; median of %d); touched rows agree within "
        "%.3g of "
        "their largest magnitude, the lazy run's %d untouched rows and "
        "their moments unchanged bit for bit; %s"
        % (EMB_SHAPE + EMB_TOKENS + (len(touched), lazy[3], dense[3],
                                     EMB_TIMED, emb_err,
                                     EMB_SHAPE[0] - len(touched), card)))
    del lazy, dense, mask, w0_t
    torch.cuda.empty_cache()

    kv_card = kvstore_run(torch, "cuda", args.seed + 63)
    kv_cpu = kvstore_run(torch, "cpu", args.seed + 63)
    diff = [k for k in kv_cpu if not np.array_equal(kv_card[k], kv_cpu[k])]
    if diff:
        raise AssertionError("kvstore card vs CPU differ in %s" % diff)
    log("sparse: KVStore('local') on the card: init, dense and row_sparse "
        "push, pull, row_sparse_pull (the %d rows asked for), set_optimizer "
        "(SGD momentum on dense and row_sparse pushes) and 2-bit "
        "compression over 4 pushes equal the CPU's bit for bit (%d arrays, "
        "%s); %s" % (len(kv_card["rsp_pull_indices"]), len(kv_card),
                     KV_SHAPE, card))

    y, dx, launches = sync_bn_step(torch, pk, "cuda", args.seed + 64)
    y_cpu, dx_cpu, _ = sync_bn_step(torch, pk, "cpu", args.seed + 64)
    bn_err = [max_err(torch, torch.from_numpy(a), torch.from_numpy(b), 1e-4,
                      "SyncBatchNorm card vs CPU", float(np.abs(b).max()))
              for a, b in ((y, y_cpu), (dx, dx_cpu))]
    if min(launches.values()) < 1:
        raise AssertionError("SyncBatchNorm in training launched %s"
                             % launches)
    log("sparse: SyncBatchNorm (one device) training step on (32, 64, 28, "
        "28): epilogue launches %s; output and input gradient vs CPU "
        "largest differences %.3g / %.3g" % (launches, *bn_err))
    return launches


# -- phase 17: one mesh over torch.distributed, and expert-parallel MoE ------

# train_moe.py's MoELM at bert_12_768_12's widths, with Mixtral 8x7B's 8
# experts and top-2 routing (arXiv:2401.04088) and MoEFFN's default
# capacity factor
MOE_VOCAB, MOE_UNITS, MOE_HIDDEN = 30522, 768, 3072
MOE_EXPERTS, MOE_TOPK, MOE_CF, MOE_ZCOEF = 8, 2, 1.25, 1e-3
MOE_BATCH, MOE_SEQ = 8, 512
MOE_WARMUP, MOE_STEPS = 3, 20
MOE_TOL = 1e-5
DIST_CALLS = ("all_gather", "all_reduce", "broadcast", "all_to_all_single",
              "barrier")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class count_collectives:
    """Counts the `torch.distributed` collectives made inside the block, by
    name (the functions `parallel.collectives` calls, wrapped)."""

    def __enter__(self):
        import torch.distributed as dist

        self.counts = dict.fromkeys(DIST_CALLS, 0)
        self._saved = {n: getattr(dist, n) for n in DIST_CALLS}

        def wrap(name, fn):
            def call(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return call

        for n, fn in self._saved.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._saved.items():
            setattr(dist, n, fn)

    @property
    def total(self):
        return sum(self.counts.values())


def nccl_collectives(torch, seed):
    """Every in-graph collective over each axis of a dp 1 x ep 1 mesh on
    the one-rank NCCL group, and the eager ones, on card tensors: each
    equal to its input bit for bit (pbroadcast's and psum's gradients to
    the incoming one). Returns the NCCL calls made."""
    import torch.distributed as dist

    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import collectives as C

    if dist.get_backend() != "nccl":
        raise AssertionError("the group's backend is %s, not nccl"
                             % dist.get_backend())
    mesh = parallel.make_mesh([("dp", 1), ("ep", 1)])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(64, 48, generator=gen, device="cuda")
    bad = []

    def same(what, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            bad.append(what)

    with count_collectives() as calls, parallel.use_mesh(mesh):
        for ax in ("dp", "ep"):
            for what, got in (
                    ("psum", C.psum(x, ax)), ("pmean", C.pmean(x, ax)),
                    ("pmax", C.pmax(x, ax)), ("pmin", C.pmin(x, ax)),
                    ("all_gather", C.all_gather(x, ax)),
                    ("all_gather untiled", C.all_gather(x, ax,
                                                        tiled=False)[0]),
                    ("reduce_scatter", C.reduce_scatter(x, ax)),
                    ("ppermute", C.ppermute(x, ax, [(0, 0)])),
                    ("all_to_all", C.all_to_all(x, ax, 0, 1)),
                    ("pbroadcast", C.pbroadcast(x, ax))):
                same("%s over %s" % (what, ax), got, x)
            for fn in (C.psum, C.pbroadcast):
                w = x.clone().requires_grad_(True)
                (fn(w, ax) * x).sum().backward()
                same("%s's gradient over %s" % (fn.__name__, ax), w.grad, x)
            if C.axis_index(ax) != 0 or C.axis_size(ax) != 1:
                bad.append("axis_index / axis_size over " + ax)
        same("all_reduce_arrays", C.all_reduce_arrays([x])[0], x)
        same("broadcast_arrays", C.broadcast_arrays(
            x, [torch.device("cuda", 0)])[0], x)
        C.barrier()
    torch.cuda.synchronize()
    if bad or calls.counts["all_gather"] == 0:
        raise AssertionError("one-rank NCCL collectives: %s differ from "
                             "their inputs; calls %s" % (bad, calls.counts))
    return calls.counts


def census_scripts(torch, pk):
    """The census's last three examples through the port on the card
    (`run_example`, ``jax`` answered by `jax_standin`), at their own
    defaults and gates; the conv-epilogue launches of train_imagenet.py's
    run."""
    lines, secs = run_example(os.path.join("moe", "train_moe.py"), [])
    log("mesh: examples/moe/train_moe.py (40 steps, 4 experts top-2 over "
        "%s; its gate: loss below 2.0) on the card in %.1f s: %s | %s"
        % (lines[0], secs, lines[-2], lines[-1]))
    lines, secs = run_example(os.path.join("distributed", "train_dist.py"),
                              [])
    log("mesh: examples/distributed/train_dist.py (30 steps, batch 64, SGD "
        "momentum; its gate: loss below 1.5) on the card in %.1f s: %s | %s"
        % (secs, lines[-2], lines[-1]))
    for k in EPI_KERNELS:
        getattr(pk, k).launches = 0
    lines, secs = run_example(
        os.path.join("image_classification", "train_imagenet.py"),
        ["--network", "resnet18_v1", "--batch-size", "4", "--num-batches",
         "4", "--num-classes", "10", "--image-shape", "3,32,32",
         "--layout", "NHWC"])
    torch.cuda.synchronize()
    launches = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    if min(launches.values()) < 1:
        raise AssertionError("train_imagenet.py on the card launched %s"
                             % launches)
    log("mesh: examples/image_classification/train_imagenet.py (resnet18_v1, "
        "NHWC, bf16, 4 x 3 x 32 x 32, 4 batches) on the card in %.1f s: %s; "
        "epilogue launches %s" % (secs, lines[-1], launches))
    return launches


def moe_lm(mx, device, seed):
    """train_moe.py's MoELM (Embedding -> Dense(relu) mixer + residual ->
    MoEFFN -> Dense head) at MOE_* widths, Xavier from ``seed``, on
    ``device``."""
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN

    gluon, nn = mx.gluon, mx.gluon.nn

    class MoELM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(MOE_VOCAB, MOE_UNITS)
                self.mix = nn.Dense(MOE_UNITS, flatten=False,
                                    activation="relu", in_units=MOE_UNITS)
                self.moe = MoEFFN(units=MOE_UNITS, hidden_size=MOE_HIDDEN,
                                  num_experts=MOE_EXPERTS,
                                  num_experts_per_token=MOE_TOPK,
                                  z_loss_coef=MOE_ZCOEF,
                                  capacity_factor=MOE_CF, return_aux=True)
                self.head = nn.Dense(MOE_VOCAB, flatten=False,
                                     in_units=MOE_UNITS)

        def hybrid_forward(self, F, tokens):
            h = self.embed(tokens)
            h = h + self.mix(h)
            ffn, aux = self.moe(h)
            return self.head(h + ffn), aux

    net = MoELM()
    net.initialize(mx.init.Xavier(), ctx=device, seed=seed)
    return net


def moe_loss(mx):
    """train_moe.py's ``lm_loss``, its logits taken in f32: from bf16
    logits the loss near ln(30522) = 10.33 moves in steps of 0.0625, more
    than 20 steps at lr 1e-4 move it."""
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(out, labels):
        logits, aux = out
        return sce(logits.float().reshape((-1, MOE_VOCAB)),
                   labels.reshape((-1,))) + 0.01 * aux

    return lm_loss


def moe_batches(seed, n):
    """train_moe.py's task at MOE_VOCAB: tok[t+1] = (3 tok[t] + 7) % V."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        seq = [rng.randint(0, MOE_VOCAB, (MOE_BATCH, 1))]
        for _ in range(MOE_SEQ):
            seq.append((3 * seq[-1] + 7) % MOE_VOCAB)
        toks = np.concatenate(seq, axis=1)
        # int32 ids: the trainer casts floating inputs to bf16, which holds
        # integers only up to 256 exactly
        out.append((toks[:, :MOE_SEQ].astype(np.int32),
                    toks[:, 1:].astype(np.float32)))
    return out


def moe_dropped_share(torch, h, gate):
    """The share of token choices past the capacity, by the routing rule of
    `ops.contrib.topk_moe` on the MoE layer's input ``h`` and gate."""
    logits = h.reshape(-1, h.shape[-1]).float() @ gate.float().t()
    probs = torch.softmax(logits, -1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, :MOE_TOPK]
    t = logits.shape[0]
    cap = max(1, int(MOE_CF * MOE_TOPK * t / MOE_EXPERTS))
    counts = torch.zeros(MOE_EXPERTS, device=h.device)
    kept = 0
    experts = torch.arange(MOE_EXPERTS, device=h.device)
    for j in range(MOE_TOPK):
        oh = (order[:, j, None] == experts).float()
        pos = (torch.cumsum(oh, 0) - 1.0 + counts) * oh
        kept += int(((pos < cap) & (oh > 0)).sum())
        counts = counts + oh.sum(0)
    return 1.0 - kept / float(t * MOE_TOPK), cap


MOE_GROUPS = ("dispatch / combine einsums", "expert GEMMs", "router",
              "rest")


def profile_moe(torch, trainer, x, y, step_ms, steps=3):
    """`torch.profiler` over ``steps`` MoE LM steps: the device busy share
    against ``step_ms`` and device time by group, each kernel by the shapes
    of the product that launched it: a dimension of E x C (the dense
    dispatch / combine einsums, forward and backward), a batched product
    over the E experts (the expert GEMMs), a dimension of E (the router);
    the rest (the head, mixer and embedding, the routing masks, the loss,
    the optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    cap = int(MOE_CF * MOE_TOPK * MOE_BATCH * MOE_SEQ / MOE_EXPERTS)
    ec = MOE_EXPERTS * cap
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            trainer.step(x, y)
        torch.cuda.synchronize()
    kernels, groups = {}, dict.fromkeys(MOE_GROUPS, 0.0)
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
        dims = [d for s in (getattr(ev, "input_shapes", None) or [])
                for d in (s or [])]
        product = any(t in ev.name for t in ("mm", "matmul", "einsum"))
        if product and ec in dims:
            group = MOE_GROUPS[0]
        elif product and "bmm" in ev.name and MOE_EXPERTS in dims:
            group = MOE_GROUPS[1]
        elif product and MOE_EXPERTS in dims:
            group = MOE_GROUPS[2]
        else:
            group = "rest"
        groups[group] += launched / 1e3 / steps
    busy = sum(r[0] for r in kernels.values()) / steps
    groups["rest"] += busy - sum(groups.values())
    log("  profile MoE LM step (bf16, %d x %d tokens, %d steps): device busy "
        "%.3f ms a step = %.1f%% of the %.2f ms step timed without the "
        "profiler; %s" % (MOE_BATCH, MOE_SEQ, steps, busy,
                          100.0 * busy / step_ms, step_ms,
                          "; ".join("%s %.3f ms" % kv
                                    for kv in groups.items())))
    for key, (ms, count) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        log("    %8.3f ms  x%-4d %s" % (ms / steps, count // steps,
                                         key[:110]))


def moe_train(torch, args):
    """The slice's full-width path: `moe_lm` in bf16 over f32 masters,
    Adam lr 1e-4, train_moe.py's loss, through `DistributedTrainer` over
    ``make_mesh([("dp", 1), ("ep", 1)])``: MOE_WARMUP steps, then
    MOE_STEPS timed (a sync at each end). Prints tokens/s, ms a step, the
    peak allocated bytes, the dropped share of token choices, one step's
    host syncs and collectives. Gate: a finite loss, lower at the last
    timed step than at the first."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel

    card = smi_line()
    net = moe_lm(mx, torch.device("cuda"), args.seed)
    n_params = sum(p.numel() for p in net.parameters())
    mesh = parallel.make_mesh([("dp", 1), ("ep", 1)])
    trainer = parallel.DistributedTrainer(
        net, "adam", {"learning_rate": 1e-4}, loss=moe_loss(mx), mesh=mesh,
        amp_dtype="bfloat16")
    batches = [(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
               for x, y in moe_batches(args.seed + 71,
                                       MOE_WARMUP + MOE_STEPS + 1)]
    for x, y in batches[:MOE_WARMUP]:
        trainer.step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.step(x, y)._data
              for x, y in batches[MOE_WARMUP:MOE_WARMUP + MOE_STEPS]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("MoE LM: losses %s (finite, falling)" % losses)
    seen = {}
    hook = net.moe.register_forward_pre_hook(
        lambda mod, inp: seen.update(
            h=getattr(inp[0], "_data", inp[0]).detach(),
            gate=mod._held("gate_weight").detach()))
    x, y = batches[-1]
    with count_collectives() as calls:
        _, syncs = count_host_syncs(torch, lambda: trainer.step(x, y))
    hook.remove()
    dropped, cap = moe_dropped_share(torch, seen["h"], seen["gate"])
    ours = [w for w in syncs if w.split(":")[0] in (
        "trainer.py", "contrib.py", "collectives.py", "mesh.py", "moe.py")]
    if calls.total or ours:
        raise AssertionError("MoE LM step at world size 1: collectives %s, "
                             "host syncs of the trainer or the MoE op %s"
                             % (calls.counts, ours))
    ms = secs * 1e3 / MOE_STEPS
    tokens = MOE_BATCH * MOE_SEQ
    log("mesh: MoE LM (vocab %d, %d units, FFN %d, %d experts top-%d, "
        "capacity factor %g -> %d slots an expert, z-loss %g; %d parameters), "
        "bf16 over f32 masters, Adam lr 1e-4, %d x %d tokens, "
        "DistributedTrainer over dp 1 x ep 1: %.1f tokens/s, %.2f ms a step "
        "(%d steps after %d warm-up); loss %.4f -> %.4f; peak allocated "
        "%.2f GiB; token choices dropped by capacity %.4f; one step: %d "
        "host syncs (%s), %d collectives; %s"
        % (MOE_VOCAB, MOE_UNITS, MOE_HIDDEN, MOE_EXPERTS, MOE_TOPK, MOE_CF,
           cap, MOE_ZCOEF, n_params, MOE_BATCH, MOE_SEQ,
           tokens * MOE_STEPS / secs, ms, MOE_STEPS, MOE_WARMUP, losses[0],
           losses[-1], peak / 2 ** 30, dropped, len(syncs),
           " | ".join(syncs) or "none", calls.total, card))
    if args.profile:
        profile_moe(torch, trainer, x, y, ms)
    del trainer, net, batches
    torch.cuda.empty_cache()


def moe_parity(torch, args):
    """One f32 step of `moe_lm` (TF32 off) on the card and on the CPU from
    the same weights and batch, Adam lr 0.1 with epsilon 1e-2 (its update
    then follows the gradient, not only its sign): the loss within
    MOE_TOL relative, and the gate, expert and head parameters after the
    step within MOE_TOL of each tensor's largest magnitude."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel

    x, y = moe_batches(args.seed + 72, 1)[0]
    nets = {"cpu": moe_lm(mx, torch.device("cpu"), args.seed)}
    before = {k: v.clone() for k, v in nets["cpu"].state_dict().items()}
    nets["cuda"] = moe_lm(mx, torch.device("cuda"), args.seed + 1)
    nets["cuda"].load_state_dict(before)
    losses, secs = {}, {}
    for dev, net in nets.items():
        tr = parallel.DistributedTrainer(
            net, "adam", {"learning_rate": 0.1, "epsilon": 1e-2},
            loss=moe_loss(mx))
        t0 = time.perf_counter()
        losses[dev] = float(tr.step(x, y).asnumpy())
        secs[dev] = time.perf_counter() - t0
    want = nets["cpu"].state_dict()
    got = {k: v.cpu() for k, v in nets["cuda"].state_dict().items()}
    errs = {}
    for k in want:
        if any(t in k for t in ("gate", "expert", "head")):
            scale = float(want[k].abs().max())
            errs[k] = float((got[k] - want[k]).abs().max()) / scale
    big = max(float((want[k] - before[k]).abs().max()) for k in want)
    loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if loss_err > MOE_TOL or max(errs.values()) > MOE_TOL:
        raise AssertionError("MoE LM f32 step card vs CPU: loss %.8f vs "
                             "%.8f, parameters %s (limit %g)"
                             % (losses["cuda"], losses["cpu"], errs,
                                MOE_TOL))
    log("parity: one f32 Adam step of the full-width MoE LM on the card "
        "equals the CPU step: loss %.8f vs %.8f (%.3g relative); %s (of "
        "each tensor's largest magnitude); largest change %.3g; card %.2f "
        "s, CPU %.2f s" % (losses["cuda"], losses["cpu"], loss_err,
                           ", ".join("%s %.3g" % kv for kv in errs.items()),
                           big, secs["cuda"], secs["cpu"]))
    del nets
    torch.cuda.empty_cache()


def mesh_phase(torch, pk, args):
    """Phase 17: a one-rank NCCL group from a free local port, its
    collectives bit for bit, the census's last three scripts, and the MoE
    LM at full width with its f32 parity step; the group is destroyed at
    the end. Returns train_imagenet.py's epilogue launches."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                            % free_port(), world_size=1, rank=0)
    try:
        calls = nccl_collectives(torch, args.seed + 70)
        log("mesh: one-rank NCCL group; psum, pmean, pmax, pmin, all_gather "
            "(tiled and not), reduce_scatter, ppermute, all_to_all, "
            "pbroadcast over dp and over ep, the psum / pbroadcast "
            "gradients, all_reduce_arrays, broadcast_arrays and barrier on "
            "card tensors equal their inputs bit for bit (NCCL calls %s)"
            % calls)
        launches = census_scripts(torch, pk)
        torch.cuda.empty_cache()
        moe_train(torch, args)
        moe_parity(torch, args)
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------------------
# the conv epilogue over ranks (a batch split over dp): the two reductions'
# raw mode and the finishing kernels, against their plain versions
# ---------------------------------------------------------------------------

EPI_SYNC_KERNELS = ["epi_stats_finish", "epi_bwd_finish"]
# two ranks' halves of a batch, each with its own offset (so the ranks'
# proxies differ): Inception v3's narrowest BatchNorm (the cluster route),
# ResNet-50's stage-1 block output at batch 128 over dp 2 (streamed), and a
# folded narrow C
EPI_SYNC_SHAPES = [("inception-narrowest", 8192, 448),
                   ("stage1-out", 401408, 256), ("odd", 1000, 3)]
EPI_SYNC_ROW = ("stage1-out", "bfloat16")


def finish_bound(k, c, n_in, n_out):
    """Least time of a finishing kernel: k ranks' n_in f32 (C,) vectors,
    gamma and beta read and n_out vectors written once, over the HBM
    rate (its FLOPs, a few a rank and channel, are far below)."""
    return (k * n_in + 2 + n_out) * c * 4 / HBM_BYTES_PER_S * 1e3, "bytes"


def check_epilogue_sync(torch, pk, seed, flush):
    """The reductions' raw mode (the rank's sums) against its plain
    version and bit for bit on a second run, and the finishing kernels
    over two ranks' sums against the plain whole-batch statistics and
    coefficients, at `EPI_SYNC_SHAPES` in bf16 and f32; the raw mode's
    and the finishing kernels' times at the bf16 cases. Returns the
    finishing kernels' rows and the raw mode's times."""
    names = ("mean", "var", "inv", "scale", "shift")
    worst = {"raw": 0.0, "epi_stats_finish": 0.0, "epi_bwd_finish": 0.0}
    out, raw_rows = {}, []
    for i, (label, r, c) in enumerate(EPI_SYNC_SHAPES):
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            elem = torch.empty((), dtype=tdt).element_size()
            tag = "%s 2 x (%d, %d) %s" % (label, r, c, dtype)
            g = torch.Generator(device="cuda").manual_seed(seed + 90 + i)
            xs = [(torch.randn(r, c, generator=g, device="cuda") * 2 + 3
                   + 2 * k).to(tdt) for k in range(2)]
            cts = [torch.randn(r, c, generator=g, device="cuda").to(tdt)
                   for _ in range(2)]
            gamma = torch.rand(c, generator=g, device="cuda") + 0.5
            beta = torch.randn(c, generator=g, device="cuda")
            raws = []
            for x in xs:
                raw = pk.epi_stats(x, gamma, beta, EPI_EPS, False, raw=True)
                if not torch.equal(raw, pk.epi_stats(x, gamma, beta, EPI_EPS,
                                                     False, raw=True)):
                    raise AssertionError("epi_stats raw %s: two runs "
                                         "differ" % tag)
                worst["raw"] = max(worst["raw"], max_err(
                    torch, raw, pk.epi_stats_reference(
                        x, gamma, beta, EPI_EPS, False, raw=True), 1e-4,
                    "epi_stats raw " + tag))
                raws.append(raw)
            parts = torch.stack(raws)
            got = pk.epi_stats_finish(parts, r, gamma, beta, EPI_EPS)
            again = pk.epi_stats_finish(parts, r, gamma, beta, EPI_EPS)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("epi_stats_finish %s: two runs differ"
                                     % tag)
            whole, ct_whole = torch.cat(xs), torch.cat(cts)
            want = pk.epi_stats_reference(whole, gamma, beta, EPI_EPS, False)
            for name, a, b in zip(names, got, want):
                worst["epi_stats_finish"] = max(
                    worst["epi_stats_finish"], max_err(
                        torch, a, b, 1e-4, "epi_stats_finish %s %s"
                        % (name, tag)))
            mean, _, inv, _, _ = got
            sums = []
            for x, ct in zip(xs, cts):
                d = pk.epi_bwd_reduce(ct, x, None, mean, inv, gamma, False,
                                      raw=True)
                again = pk.epi_bwd_reduce(ct, x, None, mean, inv, gamma,
                                          False, raw=True)
                if not all(torch.equal(a, b) for a, b in zip(d, again)):
                    raise AssertionError("epi_bwd_reduce raw %s: two runs "
                                         "differ" % tag)
                ref = pk.epi_bwd_reduce_reference(ct, x, None, mean, inv,
                                                  gamma, False, raw=True)
                for a, b in zip(d, ref):
                    worst["raw"] = max(worst["raw"], max_err(
                        torch, a, b, 1e-4, "epi_bwd_reduce raw " + tag))
                sums.append(d[3])
            bparts = torch.stack(sums)
            cb, cg = pk.epi_bwd_finish(bparts, r)
            want_b = pk.epi_bwd_reduce_reference(ct_whole, whole, None, mean,
                                                 inv, gamma, False)[3:]
            for name, a, b in zip(("cb", "cg"), (cb, cg), want_b):
                worst["epi_bwd_finish"] = max(worst["epi_bwd_finish"], max_err(
                    torch, a, b, 1e-4, "epi_bwd_finish %s %s" % (name, tag),
                    scale=1e-3))
            if dtype != "bfloat16" or label == "odd":
                continue
            x, ct = xs[0], cts[0]
            times = {
                "stats_raw": time_ms(torch, lambda: pk.epi_stats(
                    x, gamma, beta, EPI_EPS, False, raw=True), flush, 50),
                "stats": time_ms(torch, lambda: pk.epi_stats(
                    x, gamma, beta, EPI_EPS, False), flush, 50),
                "bwd_raw": time_ms(torch, lambda: pk.epi_bwd_reduce(
                    ct, x, None, mean, inv, gamma, False, raw=True), flush,
                    50),
                "bwd": time_ms(torch, lambda: pk.epi_bwd_reduce(
                    ct, x, None, mean, inv, gamma, False), flush, 50)}
            lay = pk._epi_layout(r, c, elem)
            row = {"case": label, "r": r, "c": c, "dtype": dtype,
                   "route": lay["route"],
                   "stats_bound_ms": epi_bound("epi_stats", r, c, elem, 1, 0,
                                               5)[0],
                   "bwd_bound_ms": epi_bound("epi_bwd_reduce", r, c, elem, 2,
                                             0, 7)[0]}
            row.update(times)
            raw_rows.append(row)
            log("  raw mode %s (%s): epi_stats %.4f ms (finished %.4f), "
                "epi_bwd_reduce %.4f ms (finished %.4f); bounds %.4f / %.4f "
                "ms (bytes)" % (tag, lay["route"], times["stats_raw"],
                                times["stats"], times["bwd_raw"],
                                times["bwd"], row["stats_bound_ms"],
                                row["bwd_bound_ms"]))
            if (label, dtype) != EPI_SYNC_ROW:
                continue
            for k, fn, plain, n_in, n_out in (
                    ("epi_stats_finish",
                     lambda: pk.epi_stats_finish(parts, r, gamma, beta,
                                                 EPI_EPS),
                     lambda: pk.epi_stats_finish_reference(
                         parts, r, gamma, beta, EPI_EPS, False), 3, 5),
                    ("epi_bwd_finish", lambda: pk.epi_bwd_finish(bparts, r),
                     lambda: pk.epi_bwd_finish_reference(bparts, r), 2, 2)):
                bound_ms, bound_by = finish_bound(2, c, n_in, n_out)
                out[k] = {"ms": time_ms(torch, fn, flush, 50),
                          "plain_ms": time_ms(torch, plain, flush, 50),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None}
                log("  %s 2 x (%d,) f32 sums: kernel %.4f ms plain %.4f ms "
                    "bound %.4f ms (bytes)" % (k, c, out[k]["ms"],
                                               out[k]["plain_ms"], bound_ms))
            torch.cuda.empty_cache()
    for k in EPI_SYNC_KERNELS:
        out[k]["max_abs_err"] = worst[k]
    log("conv epilogue over 2 ranks' halves: the reductions' raw sums agree "
        "with their plain versions (largest error %.3g) and repeat bit for "
        "bit; epi_stats_finish / epi_bwd_finish over the two ranks' sums "
        "agree with the whole batch's plain statistics and coefficients "
        "(largest errors %.3g / %.3g) at %d shapes x 2 dtypes"
        % (worst["raw"], worst["epi_stats_finish"], worst["epi_bwd_finish"],
           len(EPI_SYNC_SHAPES)))
    return out, raw_rows


# ---------------------------------------------------------------------------
# phase 18, pipeline: BERT-base through PipelineTrainer over a pp 1 mesh
# ---------------------------------------------------------------------------

PIPE_MICRO, PIPE_WARMUP, PIPE_STEPS = 4, 2, 8
PIPE_PARITY = (2, 128)
PIPE_TOL = 1e-4


def pipeline_phase(torch, pk, args):
    """`bert_12_768_12(dropout=0.0)` through `PipelineTrainer` over a pp 1
    mesh at 8 x 512 tokens, 4 microbatches, Adam 1e-4, bf16 over f32
    masters, an L2Loss on the pooled output against seeded targets; once
    with remat off and once on: tokens/s, ms a step, peak bytes; the loss
    finite and falling; the flash launches 12 x 4 x steps each (forward
    twice that under remat); 0 collectives and 0 host syncs a step. Then
    the pipeline's f32 pooled output at 2 x 128 tokens against the model's
    own forward. Returns the flash launches of the timed steps of both
    runs."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo import transformer as zoo

    model = zoo.bert_12_768_12(dropout=0.0, device="cuda")
    model.initialize(seed=args.seed + 80)
    rng = np.random.RandomState(args.seed + 81)
    tok = torch.from_numpy(rng.randint(0, BERT_VOCAB, (BERT_BATCH, BERT_SEQ))
                           ).cuda()
    target = torch.from_numpy(rng.uniform(-1, 1, (BERT_BATCH, 768))
                              .astype(np.float32)).cuda()
    mesh = parallel.make_mesh([("pp", 1)])
    total = dict.fromkeys(FLASH_KERNELS, 0)
    layers = len(model.encoder.cells)
    for remat in (False, True):
        trainer = parallel.PipelineTrainer(
            model, "adam", {"learning_rate": 1e-4}, loss=gloss.L2Loss(),
            mesh=mesh, num_microbatches=PIPE_MICRO, remat=remat,
            amp_dtype="bfloat16")
        losses = [trainer.step(tok, target)._data
                  for _ in range(PIPE_WARMUP)]
        torch.cuda.synchronize()
        step, syncs = count_host_syncs(torch,
                                       lambda: trainer.step(tok, target))
        losses.append(step._data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in FLASH_KERNELS:
            getattr(pk, k).launches = 0
        t0 = time.monotonic()
        with count_collectives() as calls:
            for _ in range(PIPE_STEPS):
                losses.append(trainer.step(tok, target)._data)
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: getattr(pk, k).launches for k in FLASH_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).cpu().numpy()
        per = layers * PIPE_MICRO * PIPE_STEPS
        want = {"flash_fwd": per * (2 if remat else 1),
                "flash_bwd_dq": per, "flash_bwd_dkv": per}
        if launches != want:
            raise AssertionError("pipeline remat=%s: flash launches %s, not "
                                 "%s" % (remat, launches, want))
        if calls.total or syncs:
            raise AssertionError("pipeline remat=%s at pp 1: collectives %s, "
                                 "host syncs %s" % (remat, calls.counts,
                                                    syncs))
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("pipeline remat=%s: losses not finite and "
                                 "falling: %s" % (remat, losses))
        for k, n in launches.items():
            total[k] += n
        log("pipeline: bert_12_768_12 over pp 1, %d x %d tokens, %d "
            "microbatches, Adam 1e-4 bf16, remat=%s: %d timed steps %.1f "
            "tokens/s, %.2f ms a step; peak allocated %d bytes; losses %s; "
            "flash launches %s (12 x %d x %d%s); 0 collectives, 0 host "
            "syncs a step"
            % (BERT_BATCH, BERT_SEQ, PIPE_MICRO, remat, PIPE_STEPS,
               BERT_BATCH * BERT_SEQ * PIPE_STEPS / wall,
               wall / PIPE_STEPS * 1e3, peak,
               ["%.5f" % v for v in losses], json.dumps(launches),
               PIPE_MICRO, PIPE_STEPS, ", forward twice" if remat else ""))
        trainer.sync_params()
    # a pipeline over the synced cells, in 2 microbatches of 1
    tok2 = tok[:PIPE_PARITY[0], :PIPE_PARITY[1]]
    trainer = parallel.PipelineTrainer(model, "sgd", {"learning_rate": 0.0},
                                       loss=gloss.L2Loss(), mesh=mesh,
                                       num_microbatches=PIPE_PARITY[0])
    with torch.no_grad():
        want = model(tok2)[1]
    err = max_err(torch, trainer.forward(tok2)._data, want, PIPE_TOL,
                  "pipeline pooled output")
    log("pipeline: the f32 pooled output at %d x %d tokens after "
        "sync_params equals the model's own forward (largest error %.3g, "
        "tolerance %g)" % (PIPE_PARITY + (err, PIPE_TOL)))
    del trainer, model
    return total


# ---------------------------------------------------------------------------
# phase 19, ranks2: two child processes of this script share the card over
# gloo (NCCL takes one rank a device)
# ---------------------------------------------------------------------------

RANKS2_TIMEOUT = 480
RANKS2_BATCH = 128            # global: 64 a rank over dp 2
RANKS2_WARMUP, RANKS2_STEPS = 2, 10
RANKS2_RTOL, RANKS2_ATOL = 1e-4, 1e-5
DIST_RTOL, DIST_ATOL = 2e-4, 2e-5
RING_SHAPE = (2, 8192, 12, 64)    # B, L, H, D over sp 2
MLP_STEPS, BERT_PP_STEPS = 5, 3


def sync_bn_net(mx, seed):
    """`tests/test_parallel.py`'s SyncBatchNorm net (NCHW: its BatchNorm
    moves the channels last for the kernels), f32 on the card, from
    ``seed``."""
    net = mx.gluon.nn.HybridSequential(prefix="syncbn_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, use_bias=False,
                                   in_channels=3),
                mx.gluon.contrib.nn.SyncBatchNorm(in_channels=4,
                                                  num_devices=2),
                mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(3, in_units=256))
    net.initialize(ctx=mx.gpu(0), seed=seed)
    return net


def sync_bn_batch(seed):
    """Shards of wildly different scales: per-shard statistics would be far
    from the global batch's."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.normal(loc=i - 1.5, scale=0.5 + i,
                                   size=(2, 3, 8, 8)) for i in range(4)])
    return x.astype(np.float32), rng.randint(0, 3, (8,)).astype(np.float32)


def dist_mlp(mx, seed):
    """examples/distributed/train_dist.py's net, f32 on the card."""
    net = mx.gluon.nn.HybridSequential(prefix="dist_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(256, activation="relu", in_units=100),
                mx.gluon.nn.Dense(256, activation="relu", in_units=256),
                mx.gluon.nn.Dense(10, in_units=256))
    net.initialize(ctx=mx.gpu(0), seed=seed)
    return net


def dist_batches(seed, n):
    """train_dist.py's batches: 64 x 100, labels the argmax of x W."""
    rng = np.random.RandomState(seed)
    w = rng.randn(100, 10).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(64, 100).astype(np.float32)
        out.append((x, (x @ w).argmax(1).astype(np.float32)))
    return out


def bert_pp_model(torch, seed):
    """A 4-layer BERT (width 256, 4 heads) f32 on the card for pp 2
    against pp 1."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer as zoo

    model = zoo.BERTModel(vocab_size=1000, units=256, hidden_size=1024,
                          num_layers=4, num_heads=4, max_length=128,
                          dropout=0.0, device="cuda", prefix="bertpp_")
    model.initialize(seed=seed)
    return model


def bert_pp_data(torch, seed):
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, 1000, (4, 128))).cuda()
    target = torch.from_numpy(rng.uniform(-1, 1, (4, 256))
                              .astype(np.float32)).cuda()
    return tok, target


def small_runs(torch, mx, seed, mesh_of):
    """The small f32 cases on the card, on meshes ``mesh_of(case)`` gives:
    a SyncBatchNorm step's losses and moving statistics (2 SGD steps), the
    train_dist.py MLP's losses and parameters (`MLP_STEPS` SGD momentum
    steps, under ``tp`` and ``fsdp`` rules), the BERT pipeline's forward,
    losses and parameters (`BERT_PP_STEPS` Adam steps). Returns numpy
    arrays by name."""
    from mxnet_tpu_torch.gluon import loss as gloss

    out = {}
    net = sync_bn_net(mx, seed + 1)
    x, y = sync_bn_batch(seed + 2)
    tr = mx.parallel.DistributedTrainer(
        net, "sgd", {"learning_rate": 0.1},
        loss=gloss.SoftmaxCrossEntropyLoss(), mesh=mesh_of("bn"))
    out["bn_losses"] = np.array([float(tr.step(x, y)._data)
                                 for _ in range(2)])
    tr.sync_params()
    for n, p in net.collect_params().items():
        out["bn:" + n] = p.data().asnumpy()
    for case, rules in (("tp", None), ("fsdp", mx.parallel.ShardingRules(
            fsdp_min_size=64))):
        net = dist_mlp(mx, seed + 3)
        tr = mx.parallel.DistributedTrainer(
            net, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
            loss=gloss.SoftmaxCrossEntropyLoss(), mesh=mesh_of(case),
            rules=rules)
        out[case + "_losses"] = np.array([
            float(tr.step(bx, by)._data)
            for bx, by in dist_batches(seed + 4, MLP_STEPS)])
        out[case + "_resident"] = np.array([a.numel() for a in tr._arrays])
        tr.sync_params()
        for n, p in net.collect_params().items():
            out[case + ":" + n] = p.data().asnumpy()
    model = bert_pp_model(torch, seed + 5)
    tok, target = bert_pp_data(torch, seed + 6)
    tr = mx.parallel.PipelineTrainer(
        model, "adam", {"learning_rate": 1e-3}, loss=gloss.L2Loss(),
        mesh=mesh_of("pp"), num_microbatches=2)
    out["pp_forward"] = tr.forward(tok).asnumpy()
    out["pp_losses"] = np.array([float(tr.step(tok, target)._data)
                                 for _ in range(BERT_PP_STEPS)])
    tr.sync_params()
    for n, p in model.collect_params().items():
        out["pp:" + n] = p.data().asnumpy()
    return out


def ring_case(torch, seed, causal, rank, n):
    """Ring attention over sp = n on rank ``rank``'s shard of the
    `RING_SHAPE` inputs, and the same rows of full attention in f32.
    Returns (largest error, largest magnitude)."""
    from mxnet_tpu_torch import parallel

    b, length, h, d = RING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    part = length // n
    rows = slice(rank * part, (rank + 1) * part)
    got = parallel.ring_attention(q[:, rows], k[:, rows], v[:, rows],
                                  axis_name="sp", causal=causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], k) / d ** 0.5
    if causal:
        qpos = torch.arange(rank * part, (rank + 1) * part,
                            device="cuda")[:, None]
        kpos = torch.arange(length, device="cuda")[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    del s
    err = max_err(torch, got, want, 1e-4, "ring attention causal=%s rank %d"
                  % (causal, rank))
    return err, float(want.abs().max())


def ranks2_child(rank, port, out_dir, seed):
    """One of `ranks2_phase`'s two ranks: gloo over localhost, the card
    shared. Writes ``<out_dir>/rank<r>.npz``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    parallel.init_process_group(
        num_processes=2, process_id=rank, backend="gloo",
        init_method="tcp://localhost:%d" % port, timeout=RANKS2_TIMEOUT)
    out = {}
    # full width: ResNet-50 v1 NHWC bf16 at 128 images over dp 2
    with gnn.layout_scope():
        net = resnet50_v1(classes=1000, fuse_epilogue=True, device="cuda")
    net.initialize(seed=seed)
    mesh = parallel.make_mesh([("dp", 2)])
    rng = np.random.RandomState(seed + 2)
    x = torch.from_numpy(rng.uniform(-1, 1, (RANKS2_BATCH, 224, 224, 3))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, RANKS2_BATCH)).cuda()
    trainer = parallel.DistributedTrainer(
        net, "sgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype="bfloat16",
        mesh=mesh)
    losses = [trainer.step(x, y)._data for _ in range(RANKS2_WARMUP)]
    torch.cuda.synchronize()
    kernels = EPI_KERNELS + EPI_SYNC_KERNELS
    for k in kernels:
        getattr(pk, k).launches = 0
    for k in ("epi_stats", "epi_bwd_reduce"):
        getattr(pk, k).routes = dict.fromkeys(getattr(pk, k).routes, 0)
    parallel.barrier()
    t0 = time.monotonic()
    for _ in range(RANKS2_STEPS):
        losses.append(trainer.step(x, y)._data)
    torch.cuda.synchronize()
    out["wall"] = np.array(time.monotonic() - t0)
    out["launches"] = np.array([getattr(pk, k).launches for k in kernels])
    out["routes"] = np.array([getattr(pk, k).routes[r]
                              for k in ("epi_stats", "epi_bwd_reduce")
                              for r in ("cluster", "streamed", "folded")])
    out["resnet_losses"] = torch.stack(losses).cpu().numpy()
    out["peak"] = np.array(torch.cuda.max_memory_allocated())
    # the raw mode on this rank's rows of the stage-1 output, bit for bit
    g = torch.Generator(device="cuda").manual_seed(seed + 3 + rank)
    xr = (torch.randn(200704, 256, generator=g, device="cuda") * 2
          + 3).to(torch.bfloat16)
    gamma = torch.rand(256, generator=g, device="cuda") + 0.5
    beta = torch.randn(256, generator=g, device="cuda")
    a = pk.epi_stats(xr, gamma, beta, EPI_EPS, False, raw=True)
    if not torch.equal(a, pk.epi_stats(xr, gamma, beta, EPI_EPS, False,
                                       raw=True)):
        raise AssertionError("rank %d: the raw mode's two runs differ" % rank)
    out["raw_err"] = np.array(max_err(torch, a, pk.epi_stats_reference(
        xr, gamma, beta, EPI_EPS, False, raw=True), 1e-4, "raw mode"))
    del trainer, net, x, xr
    torch.cuda.empty_cache()
    meshes = {"bn": [("dp", 2)], "tp": [("dp", 1), ("tp", 2)],
              "fsdp": [("fsdp", 2)], "pp": [("pp", 2)]}
    built = {k: parallel.make_mesh(v) for k, v in meshes.items()}
    out.update(small_runs(torch, mx, seed + 10, built.__getitem__))
    ring = parallel.make_mesh([("sp", 2)])
    with parallel.use_mesh(ring):
        for causal in (False, True):
            err, top = ring_case(torch, seed + 20, causal, rank, 2)
            out["ring_err_%d" % causal] = np.array([err, top])
    torch.cuda.synchronize()
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    parallel.barrier()
    torch.distributed.destroy_process_group()
    return 0


def ranks2_phase(torch, pk, args):
    """Phase 19: `ranks2_child` twice, ranks 0 and 1 of a gloo group on the
    one card, each killed at `RANKS2_TIMEOUT`; a child's failure fails the
    phase. The 1-rank references of the small cases run here meanwhile;
    then their results are held to them. Returns the epilogue's launches
    in the children's timed ResNet-50 steps (rank 0's)."""
    import subprocess

    from mxnet_tpu_torch import parallel

    torch.cuda.empty_cache()
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ranks2-") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed",
             str(args.seed), "--ranks2-child", str(r), str(port), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            one = {"pp": parallel.make_mesh([("pp", 1)])}
            dp1 = parallel.make_mesh([("dp", 1)])
            ref = small_runs(torch, __import__("mxnet_tpu_torch"),
                             args.seed + 10, lambda case: one.get(case, dp1))
            end = time.monotonic() + RANKS2_TIMEOUT
            logs = [p.communicate(timeout=max(1.0, end - time.monotonic()))[0]
                    for p in procs]
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        bad = [(r, p.returncode, log_[-3000:]) for r, (p, log_)
               in enumerate(zip(procs, logs)) if p.returncode]
        if bad:
            raise AssertionError("ranks2: a child failed: %s" % bad)
        got = [dict(np.load(os.path.join(tmp, "rank%d.npz" % r)))
               for r in range(2)]
    kernels = EPI_KERNELS + EPI_SYNC_KERNELS
    n_bn = 53
    for r, g in enumerate(got):
        launches = dict(zip(kernels, g["launches"].tolist()))
        if any(n != n_bn * RANKS2_STEPS for n in launches.values()):
            raise AssertionError("ranks2 rank %d: epilogue launches %s, not "
                                 "53 x %d each" % (r, launches, RANKS2_STEPS))
        losses = g["resnet_losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("ranks2 rank %d: ResNet-50 losses not finite "
                                 "and falling: %s" % (r, losses))
        np.testing.assert_array_equal(losses, got[0]["resnet_losses"])
        for key, want in ref.items():
            if key.endswith("_resident"):
                continue
            if key.endswith("_losses") and not key.startswith("bn"):
                np.testing.assert_allclose(g[key], want, rtol=1e-5, atol=0,
                                           err_msg="rank %d %s" % (r, key))
                continue
            rtol, atol = (RANKS2_RTOL, RANKS2_ATOL) \
                if key.startswith(("bn", "pp")) else (DIST_RTOL, DIST_ATOL)
            np.testing.assert_allclose(g[key], want, rtol=rtol, atol=atol,
                                       err_msg="rank %d %s" % (r, key))
        for case in ("tp", "fsdp"):
            if not (g[case + "_resident"] < ref[case + "_resident"]).any():
                raise AssertionError("ranks2 %s: no parameter is held as a "
                                     "block: %s" % (case,
                                                    g[case + "_resident"]))
    g0 = got[0]
    launches = dict(zip(kernels, g0["launches"].tolist()))
    routes = g0["routes"].reshape(2, 3).tolist()
    wall = max(float(g["wall"]) for g in got)
    log("ranks2: 2 gloo ranks sharing the card; resnet50_v1 NHWC bf16, %d "
        "images over dp 2 (64 a rank), SGD momentum, %d timed steps in %.3f "
        "s: %.1f images/s; losses %s (both ranks alike); peak allocated %d / "
        "%d bytes; epilogue launches a rank %s (53 x %d: every BatchNorm's "
        "statistics the global batch's); the raw reductions' routes "
        "(cluster, streamed, folded) stats %s, bwd %s; raw mode on (200704, "
        "256) bf16 equals its plain version (largest error %.3g) and "
        "repeats bit for bit"
        % (RANKS2_BATCH, RANKS2_STEPS, wall, RANKS2_BATCH * RANKS2_STEPS
           / wall, ["%.4f" % v for v in g0["resnet_losses"]],
           int(got[0]["peak"]), int(got[1]["peak"]), json.dumps(launches),
           RANKS2_STEPS, routes[0], routes[1],
           max(float(g["raw_err"]) for g in got)))
    log("ranks2: f32 on the card, 2 ranks against 1: SyncBatchNorm at dp 2 "
        "(2 SGD steps: losses, moving statistics, parameters within rtol "
        "%g, atol %g); train_dist.py's MLP at dp 1 x tp 2 and at fsdp 2 (%d "
        "steps: losses within 1e-5, parameters within rtol %g, atol %g; "
        "resident elements a rank %s / %s of %s); the 4-layer BERT "
        "pipeline at pp 2 against pp 1 (forward, %d Adam steps); ring "
        "attention over sp 2 at B, L, H, D = %s against full attention, "
        "largest errors %.3g (not causal) and %.3g (causal)"
        % (RANKS2_RTOL, RANKS2_ATOL, MLP_STEPS, DIST_RTOL, DIST_ATOL,
           g0["tp_resident"].sum(), g0["fsdp_resident"].sum(),
           ref["tp_resident"].sum(), BERT_PP_STEPS, RING_SHAPE,
           max(float(g["ring_err_0"][0]) for g in got),
           max(float(g["ring_err_1"][0]) for g in got)))
    return launches


# ---------------------------------------------------------------------------
# phase 20, dist_kv: data parallelism the reference's way, two ranks of the
# port's launcher sharing the card over gloo through the dist_sync kvstore
# ---------------------------------------------------------------------------

DIST_KV_TIMEOUT = 600
DIST_KV_BATCH = 64              # a rank; 128 over the two ranks
DIST_KV_WARMUP, DIST_KV_STEPS = 2, 10
DIST_KV_BN = 53                 # ResNet-50 v1's BatchNorms


def dist_kv_checks(mx, ctx):
    """The JAX package's tests/dist_sync_kvstore_worker.py, on ``ctx``'s
    arrays: a dense push, a list push, row_sparse_pull and 2-bit
    compression with error feedback across the ranks of a ``dist_sync``
    store; then an optimizer on the store (SGD on the ranks' summed push)
    and a barrier. Returns (rank, number of ranks)."""
    nd = mx.nd
    kv = mx.kv.create("dist_sync")
    n, r = kv.num_workers, kv.rank
    kv.init("dense", nd.zeros((4, 3), ctx=ctx))
    kv.push("dense", nd.full((4, 3), r + 1.0, ctx=ctx))
    out = nd.zeros((4, 3), ctx=ctx)
    kv.pull("dense", out=out)
    expect = sum(i + 1.0 for i in range(n))
    np.testing.assert_allclose(out.asnumpy(), expect, rtol=1e-6)
    kv.init("grp", nd.zeros((2,), ctx=ctx))
    kv.push("grp", [nd.full((2,), r + 1.0, ctx=ctx),
                    nd.full((2,), r + 1.0, ctx=ctx)])
    out = nd.zeros((2,), ctx=ctx)
    kv.pull("grp", out=out)
    np.testing.assert_allclose(out.asnumpy(), 2 * expect, rtol=1e-6)
    kv.init("rsp", nd.zeros((6, 2), ctx=ctx))
    grad = np.zeros((6, 2), np.float32)
    grad[r::2] = r + 1.0   # rows of their own a rank (2 ranks)
    kv.push("rsp", nd.array(grad, ctx=ctx))
    rows = nd.array(np.array([0, 1, 5], np.int64), ctx=ctx, dtype="int64")
    sparse_out = nd.zeros((3, 2), ctx=ctx)
    kv.row_sparse_pull("rsp", out=sparse_out, row_ids=rows)
    got = sparse_out.asnumpy()
    dense = np.zeros((6, 2), np.float32)
    for i in range(n):
        dense[i::2] += i + 1.0
    np.testing.assert_allclose(got[0], dense[0], rtol=1e-6)
    np.testing.assert_allclose(got[2], dense[5], rtol=1e-6)
    kv2 = mx.kv.create("dist_sync")
    kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv2.init("c", nd.zeros((3,), ctx=ctx))
    # 0.3 a rank: nothing sent at the first push; the residual makes 0.6
    # at the second, and 0.5 a rank is sent
    kv2.push("c", nd.full((3,), 0.3, ctx=ctx))
    out = nd.zeros((3,), ctx=ctx)
    kv2.pull("c", out=out)
    np.testing.assert_allclose(out.asnumpy(), 0.0, atol=1e-7)
    kv2.push("c", nd.full((3,), 0.3, ctx=ctx))
    kv2.pull("c", out=out)
    np.testing.assert_allclose(out.asnumpy(), 0.5 * n, rtol=1e-6)
    # the optimizer on the store updates with the sum over the ranks
    kv3 = mx.kv.create("dist_sync")
    kv3.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1))
    kv3.init("w", nd.ones((2,), ctx=ctx))
    kv3.push("w", nd.full((2,), r + 1.0, ctx=ctx))
    out = nd.zeros((2,), ctx=ctx)
    kv3.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), 1.0 - 0.1 * expect, rtol=1e-6)
    kv.barrier()
    return r, n


def dist_trainer_run(mx, ctx, steps=60):
    """The JAX package's tests/dist_trainer_worker.py on ``ctx``: linear
    regression through `gluon.Trainer` over a ``dist_sync`` store, one
    context a rank, each rank its own rows and its own initial draw (the
    store's `init` must make them rank 0's). Returns the weight and its
    distance from the true one."""
    from mxnet_tpu_torch import autograd, gluon

    kv = mx.kv.create("dist_sync")
    r, n = kv.rank, kv.num_workers
    rng = np.random.RandomState(42)   # the same data on every rank
    w_true = rng.normal(size=(8, 1)).astype(np.float32)
    x_all = rng.normal(size=(128, 8)).astype(np.float32)
    y_all = x_all @ w_true
    xr, yr = x_all[r::n], y_all[r::n]
    net = gluon.nn.Dense(1, in_units=8, use_bias=False)
    net.initialize(mx.init.Normal(0.5), ctx=ctx, seed=1000 + r)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=kv)
    loss_fn = gluon.loss.L2Loss()
    x, y = mx.nd.array(xr, ctx=ctx), mx.nd.array(yr, ctx=ctx)
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(len(xr) * n)
    w = net.weight.data().asnumpy()
    return w, float(np.abs(w.flatten() - w_true.flatten()).max())


def weight_digest(net):
    """The sha-256 of every trained parameter's bytes in name order (equal
    digests: equal weights bit for bit) and their sum. BatchNorm's moving
    statistics are left out: each rank keeps its own batch's, as in the
    reference's dist_sync training."""
    import hashlib

    h, total = hashlib.sha256(), 0.0
    for name, p in sorted(net.collect_params().items()):
        if p.grad_req == "null":
            continue
        a = np.ascontiguousarray(p.data().asnumpy())
        h.update(name.encode())
        h.update(a.tobytes())
        total += float(a.astype(np.float64).sum())
    return h.hexdigest(), total


def dist_kv_child(out_dir, seed):
    """One rank of `dist_kv_phase`, started by the port's launcher (which
    gives it its rank and the rendezvous): the JAX worker's kvstore checks
    on card arrays, then ResNet-50 v1 NHWC f32 at 64 images a rank through
    `gluon.Trainer(kvstore="dist_sync")`. Writes ``<out_dir>/rank<r>.npz``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    ctx = mx.gpu(0)
    rank, n = dist_kv_checks(mx, ctx)
    out = {"rank": np.array(rank), "n": np.array(n)}
    w, err = dist_trainer_run(mx, ctx)
    out["lin_w"], out["lin_err"] = w, np.array(err)
    torch.cuda.reset_peak_memory_stats()
    with gnn.layout_scope():
        net = resnet50_v1(classes=1000, fuse_epilogue=True)
    out["n_bn"] = np.array(sum(isinstance(m, gnn.BatchNorm)
                               for m in net.modules()))
    # the ranks draw apart: the store's init makes them rank 0's
    net.initialize(ctx=ctx, seed=seed + 100 + rank)
    rng = np.random.RandomState(seed + 2 + rank)
    x = mx.nd.array(rng.uniform(-1, 1, (DIST_KV_BATCH, 224, 224, 3)),
                    ctx=ctx)
    y = mx.nd.array(rng.randint(0, 1000, DIST_KV_BATCH), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9,
                             "wd": 1e-4}, kvstore="dist_sync")
    losses = []

    def forward_backward():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()   # the batch's sum; step(64) takes the mean
        losses.append(loss._data.detach().mean())

    for _ in range(DIST_KV_WARMUP):
        forward_backward()
        trainer.step(DIST_KV_BATCH)
    torch.cuda.synchronize()
    for k in EPI_KERNELS:
        getattr(pk, k).launches = 0
    kv = trainer._kvstore
    kv.barrier()
    push_pull = 0.0
    t0 = time.monotonic()
    with count_collectives() as calls:
        for _ in range(DIST_KV_STEPS):
            forward_backward()
            torch.cuda.synchronize()
            t1 = time.monotonic()
            trainer.allreduce_grads()
            torch.cuda.synchronize()
            push_pull += time.monotonic() - t1
            trainer.update(DIST_KV_BATCH)
        torch.cuda.synchronize()
    out["wall"] = np.array(time.monotonic() - t0)
    out["push_pull"] = np.array(push_pull)
    out["calls"] = np.array([calls.counts[c] for c in DIST_CALLS])
    out["launches"] = np.array([getattr(pk, k).launches
                                for k in EPI_KERNELS])
    out["losses"] = torch.stack(losses).cpu().numpy()
    out["peak"] = np.array(torch.cuda.max_memory_allocated())
    digest, total = weight_digest(net)
    out["digest"], out["wsum"] = np.array(digest), np.array(total)
    out["keys"] = np.array(sum(p.grad_req != "null"
                               for p in net.collect_params().values()))
    np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    kv.barrier()
    print("DIST_KV_OK rank=%d/%d" % (rank, n), flush=True)
    return 0


def dist_kv_phase(torch, pk, args):
    """Phase 20: `dist_kv_child` at two ranks through ``python -m
    mxnet_tpu_torch.launch -n 2 --launcher local`` on the one card (the
    ranks share it over gloo), the launcher stopped at `DIST_KV_TIMEOUT`.
    Gates: both ranks' ResNet-50 weights equal bit for bit after the last
    step; losses finite and falling; each epilogue kernel launched once a
    training BatchNorm a step (the net's BatchNorms counted: 53); the JAX
    kvstore worker's numerics and the dist Trainer's linear regression
    (rank-identical weights, within 0.05 of the truth). Returns the
    epilogue's launches in the timed steps (rank 0's)."""
    import signal
    import subprocess

    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dist_kv-") as tmp:
        env = dict(os.environ, MXTPU_RENDEZVOUS_TIMEOUT="120")
        launcher = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             "--launcher", "local", "--", sys.executable,
             os.path.abspath(__file__), "--seed", str(args.seed),
             "--dist-kv-child", tmp],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            logs = launcher.communicate(timeout=DIST_KV_TIMEOUT)[0]
        except BaseException:
            # the launcher takes its ranks down on SIGTERM
            launcher.send_signal(signal.SIGTERM)
            try:
                launcher.wait(timeout=30)
            except subprocess.TimeoutExpired:
                launcher.kill()
                launcher.wait()
            raise
        if launcher.returncode:
            raise AssertionError("dist_kv: the launch failed (rc %d): %s"
                                 % (launcher.returncode, logs[-4000:]))
        got = [dict(np.load(os.path.join(tmp, "rank%d.npz" % r)))
               for r in range(2)]
    for r, g in enumerate(got):
        if int(g["rank"]) != r or int(g["n"]) != 2:
            raise AssertionError("dist_kv: rank file %d says rank %s of %s"
                                 % (r, g["rank"], g["n"]))
        if int(g["n_bn"]) != DIST_KV_BN:
            raise AssertionError("dist_kv: resnet50_v1 has %d BatchNorms, "
                                 "not %d" % (int(g["n_bn"]), DIST_KV_BN))
        launches = dict(zip(EPI_KERNELS, g["launches"].tolist()))
        if any(v != DIST_KV_BN * DIST_KV_STEPS for v in launches.values()):
            raise AssertionError("dist_kv rank %d: epilogue launches %s, not "
                                 "%d x %d each" % (r, launches, DIST_KV_BN,
                                                   DIST_KV_STEPS))
        losses = g["losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError("dist_kv rank %d: losses not finite and "
                                 "falling: %s" % (r, losses))
        if float(g["lin_err"]) >= 0.05:
            raise AssertionError("dist_kv rank %d: the dist Trainer's "
                                 "regression did not converge: %g"
                                 % (r, float(g["lin_err"])))
    if str(got[0]["digest"]) != str(got[1]["digest"]):
        raise AssertionError("dist_kv: the ranks' ResNet-50 weights differ "
                             "(sums %r, %r)" % (float(got[0]["wsum"]),
                                                float(got[1]["wsum"])))
    np.testing.assert_array_equal(got[0]["lin_w"], got[1]["lin_w"])
    g0 = got[0]
    wall = max(float(g["wall"]) for g in got)
    calls = dict(zip(DIST_CALLS, (g0["calls"] // DIST_KV_STEPS).tolist()))
    card = smi_line()
    log("dist_kv: 2 ranks of `python -m mxnet_tpu_torch.launch -n 2` "
        "sharing the card over gloo; the JAX kvstore worker's dense, list, "
        "row_sparse and 2-bit numerics on card arrays hold; the dist "
        "Trainer's regression ranks equal, %.3g from the truth"
        % max(float(g["lin_err"]) for g in got))
    log("dist_kv: resnet50_v1 NHWC f32, %d images a rank (%d over 2), "
        "gluon.Trainer(kvstore='dist_sync'), SGD momentum 0.9, wd 1e-4, %d "
        "timed steps in %.3f s: %.1f images/s over the two ranks; push/pull "
        "%.1f ms a step (%d keys); collectives a step %s; peak allocated %d "
        "/ %d bytes a rank; losses %s; weights equal bit for bit (sha-256 "
        "%s...); epilogue launches a rank %s (53 x %d); card %s"
        % (DIST_KV_BATCH, 2 * DIST_KV_BATCH, DIST_KV_STEPS, wall,
           2 * DIST_KV_BATCH * DIST_KV_STEPS / wall,
           1e3 * max(float(g["push_pull"]) for g in got) / DIST_KV_STEPS,
           int(g0["keys"]), json.dumps(calls), int(got[0]["peak"]),
           int(got[1]["peak"]), ["%.4f" % v for v in g0["losses"]],
           str(g0["digest"])[:16],
           json.dumps(dict(zip(EPI_KERNELS, g0["launches"].tolist()))),
           DIST_KV_STEPS, card))
    return dict(zip(EPI_KERNELS, g0["launches"].tolist()))


# ---------------------------------------------------------------------------
# phase 23, resilience: checkpoints, preemption and elastic resume of the
# ResNet-50 trainer through the port's launcher, and checkpoints during the
# word LM's fit
# ---------------------------------------------------------------------------

RES_BATCH, RES_STEPS, RES_PREEMPT, RES_EVERY = 128, 8, 4, 2
RES_TIMED = 6                   # steps timed with and without saves
RES_TIMEOUT = 300               # each launch
RES_FSDP_BATCH, RES_FSDP_STEPS, RES_FSDP_PREEMPT = 32, 6, 3
RES_LM_PLAN = (35, 10, 20)      # an epoch's buckets, in order
RES_LM_EPOCHS = 2
RES_MON_TOL = 1e-5              # of each statistic's scale


def deterministic(torch):
    """Full-f32 products and cuDNN's deterministic algorithms: two runs of
    a step give the same bits, so a resumed run can be held to an
    uninterrupted one bit for bit. Returns the settings it replaced."""
    cud = torch.backends.cudnn
    prev = (torch.backends.cuda.matmul.allow_tf32, cud.allow_tf32,
            cud.benchmark, cud.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    cud.allow_tf32, cud.benchmark, cud.deterministic = False, False, True
    return prev


def restore_flags(torch, prev):
    cud = torch.backends.cudnn
    (torch.backends.cuda.matmul.allow_tf32, cud.allow_tf32, cud.benchmark,
     cud.deterministic) = prev


def resilience_trainer(torch, seed, batch=RES_BATCH, amp="bfloat16",
                       mesh=None):
    """ResNet-50 v1 NHWC with the fused epilogue on the card, initialised
    from ``seed``, trained by `DistributedTrainer` (SGD momentum 0.9, wd
    1e-4, lr 0.02, ``amp`` over f32 masters) on ``mesh``; and its batch of
    ``batch`` images from the seed. Returns (net, trainer, x, y)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    with gnn.layout_scope():
        net = resnet50_v1(classes=1000, fuse_epilogue=True, device="cuda")
    net.initialize(seed=seed)
    trainer = parallel.DistributedTrainer(
        net, "sgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(), amp_dtype=amp, mesh=mesh)
    rng = np.random.RandomState(seed + 2)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 224, 224, 3))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, batch)).cuda()
    return net, trainer, x, y


def model_arrays(net):
    """The block's parameters and buffers as host arrays by name."""
    return {"param:" + k: v.detach().float().cpu().numpy()
            for k, v in net.state_dict().items()}


def trained_arrays(net, trainer, workdir):
    """The block's parameters and buffers and the optimizer's states as
    host arrays by name (the states through `save_states`' blob)."""
    import pickle

    out = model_arrays(net)
    path = os.path.join(workdir, "states-%d.pkl" % os.getpid())
    trainer.save_states(path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    os.unlink(path)
    for i, st in enumerate(blob["states"]):
        leaves = st if isinstance(st, (list, tuple)) else [st]
        for j, leaf in enumerate(leaves):
            if leaf is not None:
                out["state:%d:%d" % (i, j)] = np.asarray(leaf)
    return out


def digest(arrays, prefix):
    """sha-256 over the arrays named ``prefix...``, in name order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        if k.startswith(prefix):
            h.update(k.encode())
            h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def max_diff(a, b):
    """The largest |a - b| over the arrays both hold."""
    return max(float(np.abs(a[k].astype(np.float64)
                            - b[k].astype(np.float64)).max()) for k in a)


def equal_or_within(what, got, ref, second_ref):
    """``got`` equal to ``ref`` bit for bit; else a second reference run
    (``second_ref()``) must differ from the first, and ``got`` must lie
    within that difference. Returns a description."""
    assert sorted(got) == sorted(ref), what
    bad = [k for k in ref if not np.array_equal(got[k], ref[k])]
    if not bad:
        return "bit for bit"
    spread = max_diff(second_ref(), ref)
    err = max_diff(got, ref)
    if spread == 0.0 or err > spread:
        raise AssertionError(
            "%s: %d arrays differ from the reference (largest %r) and two "
            "reference runs differ by %r" % (what, len(bad), err, spread))
    return "within two reference runs' difference (%r <= %r)" % (err, spread)


class LineLog:
    """A command's merged output, read line by line on a thread with the
    wall time each line arrived."""

    def __init__(self, argv, env):
        self.lines = []
        self.proc = subprocess.Popen(
            argv, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.time(), line.rstrip("\n")))

    def wait(self, timeout):
        try:
            self.proc.wait(timeout=timeout)
        except BaseException:
            # the launcher takes its workers down on SIGTERM
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            raise
        self._t.join(timeout=10)
        return self.proc.returncode

    def text(self):
        return "\n".join(line for _, line in self.lines)

    def first(self, pattern):
        """(time, match) of the first line matching ``pattern``."""
        for t, line in self.lines:
            m = re.search(pattern, line)
            if m:
                return t, m
        raise AssertionError("no line matches %r in:\n%s"
                             % (pattern, self.text()[-4000:]))


def resilience_launch(args, n, out_dir, mode, fault=None, restarts=0):
    """``python -m mxnet_tpu_torch.launch -n n`` of `resilience_child`."""
    env = dict(os.environ, MXTPU_RENDEZVOUS_TIMEOUT="120",
               MXTPU_TEARDOWN_GRACE="5")
    env.pop("MXTPU_FAULT_INJECT", None)
    if fault:
        env["MXTPU_FAULT_INJECT"] = fault
    if mode == "fsdp":
        # the periodic sharded saves are synchronous: a rank that dies
        # never leaves its peer's manifest unpublished
        env["MXTPU_CKPT_ASYNC"] = "0"
    argv = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
            "--launcher", "local"]
    if restarts:
        argv += ["--max-restarts", str(restarts), "--restart-backoff", "0"]
    return LineLog(argv + ["--", sys.executable, os.path.abspath(__file__),
                           "--seed", str(args.seed), "--resilience-child",
                           out_dir, "--resilience-mode", mode], env)


def resilience_child(out_dir, seed, mode):
    """One process of the resilience phase, started by the port's launcher.
    ``single``: ResNet-50 bf16 at 128 images, `RES_STEPS` steps, an async
    checkpoint every `RES_EVERY` (`CheckpointManager.maybe_save_async`),
    the preemption handler armed, a restore at start. ``fsdp``: ResNet-50
    f32 at `RES_FSDP_BATCH` images over ``fsdp`` = the world size (gloo
    ranks sharing the card), `RES_FSDP_STEPS` steps, a sharded checkpoint
    every `RES_EVERY`, the elastic restore at start; over two ranks, rank
    0 writes the whole model at the first checkpoint (`sync_params`), and
    a resumed process writes what it restored. Each process writes its
    epilogue launch counts and losses; the last generation's rank 0 its
    trained arrays."""
    import torch

    deterministic(torch)
    torch.cuda.set_device(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.parallel import resilience

    gen = resilience.restart_generation()
    fsdp = mode == "fsdp"
    if fsdp:
        parallel.init_process_group(backend="gloo")
        rank, world = parallel.rank(), parallel.num_workers()
        net, tr, x, y = resilience_trainer(
            torch, seed, RES_FSDP_BATCH, amp=None,
            mesh=parallel.make_mesh([("fsdp", world)]))
        steps = RES_FSDP_STEPS
    else:
        rank, world = 0, 1
        net, tr, x, y = resilience_trainer(torch, seed)
        steps = RES_STEPS
    tag = "%s-w%d-g%d-r%d" % (mode, world, gen, rank)
    kernels = EPI_KERNELS + EPI_SYNC_KERNELS
    for k in kernels:
        getattr(pk, k).launches = 0
    mgr = resilience.CheckpointManager(os.path.join(out_dir, "ckpt"),
                                       keep_last=3, save_every=RES_EVERY)
    resilience.install_preemption_handler()
    t0 = time.time()
    if fsdp:
        header = tr.restore_sharded_checkpoint(mgr)
    else:
        header = mgr.restore(load_params=tr.load_params,
                             load_states=tr.load_states)
    start = tr.step_count
    if header is not None and fsdp:
        if world > 1:
            tr.sync_params()
        np.savez(os.path.join(out_dir, "restored-%s.npz" % tag),
                 **model_arrays(net))
    if header is not None:
        print("RESILIENCE_RESUMED mode=%s gen=%d rank=%d/%d from_step=%d "
              "shards=%s restore_s=%.3f" % (
                  mode, gen, rank, world, start, header.get("shards"),
                  time.time() - t0), flush=True)

    def write(name, obj):
        with open(os.path.join(out_dir, "%s-%s.json" % (tag, name)),
                  "w") as f:
            json.dump(obj, f)

    def counts():
        torch.cuda.synchronize()
        return {k: getattr(pk, k).launches for k in kernels}

    losses = []

    def emergency():
        write("counts", counts())   # the exit follows the save
        write("losses", [float(v) for v in losses])
        if fsdp:
            tr.emergency_sharded_checkpoint(mgr)
        else:
            mgr.flush()
            mgr.save(tr.step_count, save_params=tr.save_params,
                     save_states=tr.save_states, meta={"preempt": True})
        print("RESILIENCE_EMERGENCY step=%d t=%.6f"
              % (tr.step_count, time.time()), flush=True)

    for step in range(start + 1, steps + 1):
        losses.append(tr.step(x, y)._data)
        if step == start + 1 and header is not None:
            torch.cuda.synchronize()
            print("RESILIENCE_FIRST_STEP step=%d t=%.6f"
                  % (step, time.time()), flush=True)
        if fsdp:
            if step % RES_EVERY == 0:
                tr.save_sharded_checkpoint(mgr)
            if world > 1 and step == RES_EVERY:
                # the whole model at the first checkpoint, for the check of
                # the elastic restore
                tr.sync_params()
                if rank == 0:
                    np.savez(os.path.join(out_dir, "at-ckpt-%s.npz" % tag),
                             **model_arrays(net))
        else:
            mgr.maybe_save_async(step, snapshot_params=tr.snapshot_params,
                                 snapshot_states=tr.snapshot_states)
        if resilience.preemption_requested():
            # the fault's SIGTERM lands at the end of the step's call
            print("RESILIENCE_SIGTERM step=%d t=%.6f" % (step, time.time()),
                  flush=True)
        resilience.maybe_preempt_exit(emergency_save=emergency, rank=rank)
    mgr.close()
    if fsdp:
        tr.sync_params()
    write("counts", counts())
    write("losses", [float(v) for v in losses])
    if rank == 0:
        arrays = trained_arrays(net, tr, out_dir)
        np.savez(os.path.join(out_dir, "final-%s.npz" % tag), **arrays)
        print("RESILIENCE_DONE mode=%s gen=%d steps=%d params=%s states=%s"
              % (mode, gen, tr.step_count, digest(arrays, "param:")[:16],
                 digest(arrays, "state:")[:16]), flush=True)
    if fsdp and world > 1:
        parallel.barrier()
        torch.distributed.destroy_process_group()
    return 0


def read_counts(out_dir, tag, what="counts"):
    with open(os.path.join(out_dir, "%s-%s.json" % (tag, what))) as f:
        return json.load(f)


class ListIter:
    """The same batches every epoch, in order (a fit's data that a resumed
    fit sees again exactly), with the first batch's descriptions."""

    def __init__(self, batches):
        self.batches = batches
        self.provide_data = batches[0].provide_data
        self.provide_label = batches[0].provide_label
        self.batch_size = LM_BATCH
        self._i = 0

    def reset(self):
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.batches):
            raise StopIteration
        self._i += 1
        return self.batches[self._i - 1]

    next = __next__


def resilience_lm(torch, pk, args, workdir):
    """Part (b): the word LM at bench_lstm's width as a `BucketingModule`
    (FusedRNNCell, f32, buckets 35 / 10 / 20, SGD lr 0.1 momentum 0.9)
    through ``fit(checkpoint_dir=, num_epoch=2)`` with a `Monitor`
    (interval 1, the largest |x| of each output) and `score` on one
    bucket-35 batch at each epoch's end, from one set of initial
    parameters (Xavier, drawn on the host). Then ``corrupt_ckpt`` flips a
    byte of the newest checkpoint, and a fresh module's ``fit(resume=
    "auto")`` falls back to the verified older one (epoch 0) and trains
    epoch 1 again. Gates: its parameters equal the uninterrupted fit's
    bit for bit (or within two uninterrupted fits' difference); the
    monitor's first row equals a CPU forward's within `RES_MON_TOL` of
    the statistic; lstm_fwd and lstm_bwd (training) and lstm_infer
    (scoring) launched. Returns the LSTM launches of the two fits."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.parallel import resilience
    from mxnet_tpu_torch.train_lstm_bucketing import lm_sym_gen

    dev = mx.gpu(0)
    gen = lm_sym_gen(LM_VOCAB, LM_UNITS, LM_UNITS, LM_LAYERS, fused=True,
                     layout="TNC")
    t0 = time.monotonic()
    with mx.context.scope(mx.cpu()):
        mx.random.seed(args.seed)
        it = bucket_iters(args.seed + 30, [RES_LM_PLAN])[0]
        it.reset()
        by_key = {}
        for b in it:
            by_key.setdefault(b.bucket_key, b)
        host = [by_key[k] for k in RES_LM_PLAN]
        cpu_mod = mx.mod.BucketingModule(gen, default_bucket_key=35,
                                         context=mx.cpu())
        cpu_mod.bind(host[0].provide_data, host[0].provide_label,
                     for_training=False)
        cpu_mod.init_params(mx.init.Xavier())
        arg0, aux0 = cpu_mod.get_params()
        cpu_rows = []

        def stat(a):
            return a.abs().max()

        mon = mx.monitor.Monitor(1, stat_func=stat)
        cpu_mod.install_monitor(mon)
        mon.tic()
        cpu_mod.forward(host[0], is_train=False)
        cpu_rows = mon.toc()
        del cpu_mod
    batches = [DataBatch([mx.nd.array(b.data[0].asnumpy(), ctx=dev)],
                         [mx.nd.array(b.label[0].asnumpy(), ctx=dev)],
                         bucket_key=b.bucket_key,
                         provide_data=b.provide_data,
                         provide_label=b.provide_label) for b in host]

    def fit(ckpt, resume=None, monitor=None):
        bm = mx.mod.BucketingModule(gen, default_bucket_key=35, context=dev)
        bm.fit(ListIter(batches), eval_data=ListIter(batches[:1]),
               eval_metric=mx.metric.Perplexity(SYM_INVALID),
               optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
               arg_params=arg0, aux_params=aux0, num_epoch=RES_LM_EPOCHS,
               checkpoint_dir=ckpt, resume=resume, monitor=monitor)
        torch.cuda.synchronize()
        return {k: v.asnumpy() for k, v in bm.get_params()[0].items()}

    for k in LSTM_KERNELS:
        getattr(pk, k).launches = 0
    card_rows = []
    mon = mx.monitor.Monitor(1, stat_func=stat)
    toc = mon.toc

    def keep_toc():
        rows = toc()
        card_rows.extend(rows)
        return rows

    mon.toc = keep_toc   # toc_print logs the rows and keeps them here
    ckpt = os.path.join(workdir, "lm")
    t_fit = time.monotonic()
    ref = fit(ckpt, monitor=mon)
    fit_s = time.monotonic() - t_fit
    if not all(np.isfinite(v).all() for v in ref.values()):
        raise AssertionError("resilience LM: non-finite parameters")
    mgr = resilience.CheckpointManager(ckpt)
    newest = mgr.latest()
    os.environ["MXTPU_FAULT_INJECT"] = "corrupt_ckpt@step=%d,dir=%s" % (
        RES_LM_EPOCHS, ckpt)
    # the spec is parsed once a process: parse this one afresh, and after
    resilience._fault_cache = resilience._UNPARSED
    try:
        resilience.maybe_inject_fault(RES_LM_EPOCHS)
    finally:
        del os.environ["MXTPU_FAULT_INJECT"]
        resilience._fault_cache = resilience._UNPARSED
    fallback = mgr.latest()
    if newest[0] != RES_LM_EPOCHS - 1 or fallback[0] != RES_LM_EPOCHS - 2:
        raise AssertionError("resilience LM: newest checkpoint %s, after "
                             "the corruption %s" % (newest, fallback))
    t_fit = time.monotonic()
    got = fit(ckpt, resume="auto")
    resume_s = time.monotonic() - t_fit
    how = equal_or_within("resilience LM", got, ref,
                          lambda: fit(os.path.join(workdir, "lm2")))
    launches = {k: getattr(pk, k).launches for k in LSTM_KERNELS}
    if min(launches.values()) < 1:
        raise AssertionError("resilience LM: LSTM launches %s" % launches)
    # the monitor: the default bucket's batches (the others' modules are
    # made after install_monitor, as in the JAX BucketingModule)
    names = [r[1] for r in card_rows]
    if not card_rows or names != ["softmax_output"] * len(names) \
            or [r[0] for r in card_rows] != list(range(
                1, RES_LM_EPOCHS * len(RES_LM_PLAN) + 1,
                len(RES_LM_PLAN))):
        raise AssertionError("resilience LM: monitor rows %s"
                             % [(r[0], r[1]) for r in card_rows])
    want = np.asarray(json.loads(cpu_rows[0][2]))
    have = np.asarray(json.loads(card_rows[0][2]))
    mon_err = float(np.abs(have - want).max())
    if cpu_rows[0][:2] != card_rows[0][:2] or \
            mon_err > RES_MON_TOL * float(np.abs(want).max()):
        raise AssertionError("resilience LM: the monitor's first row %s, "
                             "the CPU's %s" % (card_rows[0], cpu_rows[0]))
    log("resilience (b): word LM BucketingModule(FusedRNNCell(%d, %d "
        "layers)) f32 on the card, buckets %s an epoch, SGD momentum; "
        "fit(checkpoint_dir=, num_epoch=%d) with one score an epoch and a "
        "Monitor (%d rows, the "
        "first %s, the CPU's %s, error %.3g) in %.2f s; corrupt_ckpt on "
        "epoch %d, latest() falls back to epoch %d; a fresh module's "
        "fit(resume='auto') in %.2f s ends equal to the uninterrupted fit "
        "%s; LSTM launches %s; %.1f s in all"
        % (LM_UNITS, LM_LAYERS, list(RES_LM_PLAN), RES_LM_EPOCHS,
           len(card_rows), card_rows[0][2], cpu_rows[0][2], mon_err, fit_s,
           newest[0], fallback[0], resume_s, how, json.dumps(launches),
           time.monotonic() - t0))
    return launches


def resilience_phase(torch, pk, args):
    """Phase 23: (a) ResNet-50 bf16 at 128 images through
    `DistributedTrainer`, an async checkpoint every 2 steps, preempted at
    step 4 (``MXTPU_FAULT_INJECT=preempt@step=4,grace=60``) under ``python
    -m mxnet_tpu_torch.launch -n 1 --max-restarts 1``: the launcher's free
    restart, generation 0's emergency checkpoint at step 4, generation 1's
    resume to step 8, its parameters and states equal to an uninterrupted
    run in this process bit for bit (cuDNN's deterministic algorithms in
    both; else within two reference runs' difference), each generation's
    epilogue launches > 0. (b) `resilience_lm`. (c) ResNet-50 f32 at 32
    images over ``make_mesh([("fsdp", 2)])``, two gloo ranks of the
    launcher sharing the card, a sharded checkpoint every 2 steps, rank 1
    preempted at step 3: its shard alone cannot restore the model, so its
    emergency checkpoint is refused and it exits 84; then one rank
    restores the step-2 checkpoint elastically (both shards handed to the
    loader) and reaches step 6. Gates: what it restored equals the two
    ranks' model at the checkpoint bit for bit; the two ranks' first loss
    lies within ranks2's tolerance of losses (rtol 1e-5) of a one-rank
    run's in this process; the resumed rank ends equal, bit for bit, to
    one rank that restores the same checkpoint here. The weights' drift
    from the one-rank run is printed, not held: a deep ReLU + BatchNorm
    net's f32 gradients move with the summation order (one step moves a
    convolution's weights by up to 1.6 % of their magnitude,
    `tools/fsdp_rank_probe.py`). Prints the seconds from SIGTERM
    to rc 83 and from the restart to the first resumed step, one
    checkpoint's bytes and seconds (sync, and the async save's share on
    the training thread) and steps/s with and without saves. Returns the
    launch counts (the epilogue's of (a)'s two generations and (c)'s
    ranks, the LSTM's of (b))."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import resilience

    t_phase = time.monotonic()
    prev = deterministic(torch)
    card = smi_line()
    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-resil-") as tmp:
            a_dir = os.path.join(tmp, "a")
            os.makedirs(a_dir)
            launch_a = resilience_launch(
                args, 1, a_dir, "single", restarts=1,
                fault="preempt@step=%d,grace=60" % RES_PREEMPT)
            try:
                out.update(resilience_lm(torch, pk, args, tmp))
                torch.cuda.empty_cache()
            finally:
                rc = launch_a.wait(RES_TIMEOUT)
            text = launch_a.text()
            if rc:
                raise AssertionError("resilience (a): the launch failed (rc "
                                     "%d): %s" % (rc, text[-4000:]))
            t_pre, _ = launch_a.first(r"group preempted \(rc=83\).*restart "
                                      r"budget untouched: 0/1 used")
            t_sig = float(launch_a.first(
                r"RESILIENCE_SIGTERM step=%d t=(\S+)" % RES_PREEMPT)[1]
                .group(1))
            t_emg = float(launch_a.first(
                r"RESILIENCE_EMERGENCY step=%d t=(\S+)" % RES_PREEMPT)[1]
                .group(1))
            t_spawn, _ = launch_a.first(r"spawning generation 1")
            launch_a.first(r"RESILIENCE_RESUMED mode=single gen=1 rank=0/1 "
                           r"from_step=%d " % RES_PREEMPT)
            t_first = float(launch_a.first(
                r"RESILIENCE_FIRST_STEP step=%d t=(\S+)" % (RES_PREEMPT + 1))
                [1].group(1))
            launch_a.first(r"RESILIENCE_DONE mode=single gen=1 steps=%d "
                           % RES_STEPS)
            a_losses = read_counts(a_dir, "single-w1-g0-r0", "losses") \
                + read_counts(a_dir, "single-w1-g1-r0", "losses")
            if len(a_losses) != RES_STEPS or \
                    not np.isfinite(a_losses).all():
                raise AssertionError("resilience (a): losses %s" % a_losses)
            meta = resilience.CheckpointManager(
                os.path.join(a_dir, "ckpt")).read_meta(
                os.path.join(a_dir, "ckpt", "ckpt-%08d" % RES_PREEMPT))
            if meta["meta"] != {"preempt": True}:
                raise AssertionError("resilience (a): step %d's checkpoint "
                                     "is %s, not the emergency one"
                                     % (RES_PREEMPT, meta["meta"]))
            a_counts = [read_counts(a_dir, "single-w1-g%d-r0" % g)
                        for g in (0, 1)]
            for g, c in enumerate(a_counts):
                if any(c[k] < 1 for k in EPI_KERNELS):
                    raise AssertionError("resilience (a): generation %d's "
                                         "epilogue launches %s" % (g, c))
            got_a = dict(np.load(os.path.join(a_dir,
                                              "final-single-w1-g1-r0.npz")))
            out.update({k: sum(c[k] for c in a_counts) for k in EPI_KERNELS})

            def reference():
                net, tr, x, y = resilience_trainer(torch, args.seed)
                t0 = time.perf_counter()
                for _ in range(RES_STEPS):
                    tr.step(x, y)
                torch.cuda.synchronize()
                return net, tr, x, y, time.perf_counter() - t0

            def second():
                n2, t2 = reference()[:2]
                return trained_arrays(n2, t2, tmp)

            # (c): two gloo ranks over fsdp, rank 1 preempted; meanwhile the
            # references of (a) and (c) in this process
            c_dir = os.path.join(tmp, "c")
            os.makedirs(c_dir)
            launch_c = resilience_launch(
                args, 2, c_dir, "fsdp",
                fault="preempt@step=%d,rank=1,grace=60" % RES_FSDP_PREEMPT)
            one = parallel.make_mesh([("fsdp", 1)])
            try:
                net_a, tr_a, x_a, y_a, ref_s = reference()
                how_a = equal_or_within("resilience (a)", got_a,
                                        trained_arrays(net_a, tr_a, tmp),
                                        second)
                del got_a
                # the one-rank run of (c) from the start: its state at the
                # first checkpoint's step, and at the end
                net, tr, x, y = resilience_trainer(torch, args.seed,
                                                   RES_FSDP_BATCH, amp=None,
                                                   mesh=one)
                ref_losses = []
                for step in range(1, RES_FSDP_STEPS + 1):
                    ref_losses.append(float(tr.step(x, y)._data))
                    if step == RES_EVERY:
                        ref_ckpt = model_arrays(net)
                ref_end = trained_arrays(net, tr, tmp)
                del net, tr, x, y
                torch.cuda.empty_cache()
            finally:
                rc_c0 = launch_c.wait(RES_TIMEOUT)
            text = launch_c.text()
            if not rc_c0:
                raise AssertionError("resilience (c): the 2-rank launch "
                                     "ended 0: %s" % text[-4000:])
            launch_c.first(r"\[rank 1\].*emergency checkpoint FAILED; "
                           r"exiting rc=%d" % (
                               resilience.preempt_exit_code() + 1))
            c_mgr = resilience.CheckpointManager(os.path.join(c_dir, "ckpt"))
            step, path = c_mgr.latest()
            shards = c_mgr.read_meta(path)["shards"]
            if (step, shards) != (RES_EVERY, 2):
                raise AssertionError("resilience (c): the newest checkpoint "
                                     "is step %d with %d shards" % (step,
                                                                    shards))
            # the preempted rank's, written before its exit (rank 0 is torn
            # down)
            c0 = read_counts(c_dir, "fsdp-w2-g0-r1")
            c0_losses = read_counts(c_dir, "fsdp-w2-g0-r1", "losses")
            at_ckpt = dict(np.load(os.path.join(c_dir,
                                                "at-ckpt-fsdp-w2-g0-r0.npz")))
            launch_c1 = resilience_launch(args, 1, c_dir, "fsdp")
            try:
                # one rank restoring the same checkpoint in this process
                net, tr, x, y = resilience_trainer(torch, args.seed,
                                                   RES_FSDP_BATCH, amp=None,
                                                   mesh=one)
                tr.restore_sharded_checkpoint(c_mgr, step=RES_EVERY)
                for _ in range(RES_EVERY + 1, RES_FSDP_STEPS + 1):
                    tr.step(x, y)
                cont = trained_arrays(net, tr, tmp)
                del net, tr, x, y
                torch.cuda.empty_cache()
            finally:
                rc = launch_c1.wait(RES_TIMEOUT)
            if rc:
                raise AssertionError("resilience (c): the 1-rank launch "
                                     "failed (rc %d): %s"
                                     % (rc, launch_c1.text()[-4000:]))
            launch_c1.first(r"RESILIENCE_RESUMED mode=fsdp gen=0 rank=0/1 "
                            r"from_step=%d shards=2 " % RES_EVERY)
            launch_c1.first(r"RESILIENCE_DONE mode=fsdp gen=0 steps=%d "
                            % RES_FSDP_STEPS)
            c1 = read_counts(c_dir, "fsdp-w1-g0-r0")
            c1_losses = read_counts(c_dir, "fsdp-w1-g0-r0", "losses")
            restored = dict(np.load(os.path.join(
                c_dir, "restored-fsdp-w1-g0-r0.npz")))
            got = dict(np.load(os.path.join(c_dir,
                                            "final-fsdp-w1-g0-r0.npz")))
            # 1: the elastic restore gives one rank the two ranks' model at
            # the checkpoint, bit for bit
            assert sorted(restored) == sorted(at_ckpt)
            for k in at_ckpt:
                np.testing.assert_array_equal(restored[k], at_ckpt[k],
                                              err_msg=k)
            # 2: rank order alone: the first step's loss (the same weights,
            # the batch over two ranks or one) within ranks2's tolerance of
            # losses; the weights after it are not held elementwise (a deep
            # ReLU + BatchNorm net's f32 gradients move with the summation
            # order: tools/fsdp_rank_probe.py), their drift is printed
            np.testing.assert_allclose(c0_losses[0], ref_losses[0],
                                       rtol=1e-5, atol=0)
            worst = max(float(np.abs(at_ckpt[k] - ref_ckpt[k]).max()
                              / max(float(np.abs(ref_ckpt[k]).max()), 1e-30))
                        for k in ref_ckpt)
            # 3: the resumed rank ends where one rank restoring the same
            # checkpoint in this process ends, bit for bit
            bad = [k for k in cont if not np.array_equal(got[k], cont[k])]
            if sorted(got) != sorted(cont) or bad:
                raise AssertionError("resilience (c): the resumed rank's "
                                     "%s differ from one rank resuming here"
                                     % bad[:5])
            drift = max_diff(got, ref_end)
            losses = c0_losses[:RES_EVERY] + c1_losses
            if not np.isfinite(losses + ref_losses).all():
                raise AssertionError("resilience (c): losses %s, one rank "
                                     "%s" % (losses, ref_losses))
            for k in EPI_KERNELS:
                if c0[k] < 1 or c1[k] < 1:
                    raise AssertionError("resilience (c): epilogue launches "
                                         "%s, %s" % (c0, c1))
            out.update({k: c0[k] for k in EPI_SYNC_KERNELS if c0[k]})
            # (a)'s checkpoint costs on its trainer, no other process on
            # the card: one sync save, one async save with the writer idle
            # (the training thread's share: the snapshots and the submit;
            # then the writer's rest), steps/s without saves and with an
            # async save every RES_EVERY steps (a submit waits while the
            # writer's slot is taken; the last save's flush counts)
            mgr = resilience.CheckpointManager(os.path.join(tmp, "timing"),
                                               keep_last=2)
            t0 = time.perf_counter()
            path = mgr.save(tr_a.step_count, save_params=tr_a.save_params,
                            save_states=tr_a.save_states)
            sync_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(path, n))
                         for n in os.listdir(path))
            t0 = time.perf_counter()
            mgr.save_async(tr_a.step_count,
                           snapshot_params=tr_a.snapshot_params,
                           snapshot_states=tr_a.snapshot_states)
            async_share = time.perf_counter() - t0
            mgr.flush()
            async_rest = time.perf_counter() - t0 - async_share
            rates, stalls = {}, []
            for label, every in (("no saves", None),
                                 ("save_every=%d" % RES_EVERY, RES_EVERY)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(RES_TIMED):
                    tr_a.step(x_a, y_a)
                    if every and (i + 1) % every == 0:
                        t1 = time.perf_counter()
                        mgr.save_async(tr_a.step_count,
                                       snapshot_params=tr_a.snapshot_params,
                                       snapshot_states=tr_a.snapshot_states)
                        stalls.append(time.perf_counter() - t1)
                torch.cuda.synchronize()
                mgr.flush()
                rates[label] = RES_TIMED / (time.perf_counter() - t0)
            mgr.close()
            del net_a, tr_a, x_a, y_a
            torch.cuda.empty_cache()
            log("resilience (a): resnet50_v1 NHWC bf16, %d images, SGD "
                "momentum, %d steps, an async checkpoint every %d, "
                "preempted at step %d under `launch -n 1 --max-restarts 1`: "
                "free restart (budget untouched), emergency checkpoint at "
                "step %d, generation 1 resumed and reached step %d, equal "
                "to the uninterrupted run (%d steps in %.3f s in this "
                "process) %s; SIGTERM to the emergency checkpoint's end "
                "%.3f s, SIGTERM to the launcher's 'group preempted' (rc 83) "
                "%.3f s; restart spawned to the first resumed step done "
                "%.3f s; losses %s; epilogue launches gen 0 %s, gen 1 %s; "
                "card %s"
                % (RES_BATCH, RES_STEPS, RES_EVERY, RES_PREEMPT, RES_PREEMPT,
                   RES_STEPS, RES_STEPS, ref_s, how_a, t_emg - t_sig,
                   t_pre - t_sig, t_first - t_spawn,
                   ["%.4f" % v for v in a_losses],
                   json.dumps({k: a_counts[0][k] for k in EPI_KERNELS}),
                   json.dumps({k: a_counts[1][k] for k in EPI_KERNELS}),
                   card))
            log("resilience (a): one ResNet-50 checkpoint (parameters, "
                "buffers, momentum): %d bytes, sync save %.3f s; an async "
                "save with the writer idle: %.4f s on the training thread, "
                "%.3f s more on the writer; steps/s %s (the save_every "
                "run's save_async calls %s s, a submit waiting while the "
                "writer's slot is taken); card %s"
                % (nbytes, sync_s, async_share, async_rest,
                   json.dumps({k: round(v, 3) for k, v in rates.items()}),
                   ["%.4f" % s for s in stalls], card))
            log("resilience (c): resnet50_v1 NHWC f32, %d images over fsdp "
                "2 (two gloo ranks sharing the card), a sharded checkpoint "
                "every %d steps; rank 1 preempted at step %d: its shard alone "
                "cannot restore the model, so its emergency checkpoint is "
                "refused (it exits %d) and the launch ends rc %d; one rank "
                "restored step %d elastically (2 shards handed to the "
                "loader): the two ranks' model at that checkpoint bit for "
                "bit; step 1's loss of 2 ranks within rtol 1e-5 of one "
                "rank's; the two ranks' model at step %d against the one-rank "
                "run's: largest difference %.3g of a tensor's largest "
                "magnitude; the resumed rank reached step %d equal to one "
                "rank resuming the same checkpoint here, bit for bit "
                "(against the one-rank run from the start: largest "
                "difference %.3g); losses 2 ranks then 1 %s, one rank %s; "
                "epilogue launches at 2 ranks (rank 1, to its preemption) "
                "%s, at 1 rank %s; card %s"
                % (RES_FSDP_BATCH, RES_EVERY, RES_FSDP_PREEMPT,
                   resilience.preempt_exit_code() + 1, rc_c0, RES_EVERY,
                   RES_EVERY, worst, RES_FSDP_STEPS, drift,
                   ["%.4f" % v for v in losses],
                   ["%.4f" % v for v in ref_losses], json.dumps(c0),
                   json.dumps(c1), card))
    finally:
        restore_flags(torch, prev)
    log("resilience: the phase took %.1f s" % (time.monotonic() - t_phase))
    return out


# phase 24, interop: ONNX, the custom-op head, partitioning, the engine and
# runtime surface
INTEROP_BATCH = 32
INTEROP_CLASSES = 1000
INTEROP_STEPS = 3
INTEROP_TOL = 1e-4
INTEROP_HEAD_TOL = 1e-5
INTEROP_CALLS = 200
# the head's backward, p - onehot(label) (SoftmaxOutput's gradient): one
# block a row
INTEROP_CE_BWD = r"""
extern "C" __global__ void softmax_ce_bwd(const float *y, const float *label,
                                          float *dx, int n) {
    size_t off = (size_t)blockIdx.x * n;
    int l = (int)label[blockIdx.x];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        dx[off + i] = y[off + i] - (i == l ? 1.0f : 0.0f);
}
"""
INTEROP_CE_BLOCK = 256


def interop_register_head(mx, dev):
    """Register the custom op ``softmax_rtc``: SoftmaxOutput's forward and
    gradient as an `operator.CustomOp` whose calls launch NVRTC kernels on
    the op's own NDArrays, in place (the reference's custom op with rtc).
    Returns a dict counting the forward calls that found every input on
    ``dev``."""
    from mxnet_tpu_torch import rtc

    soft = rtc.CudaModule(RTC_SOFTMAX, exports=RTC_SOFTMAX_EXPORTS)
    fwd = rtc_kernels(soft, "float")["fwd"]
    bwd = rtc.CudaModule(INTEROP_CE_BWD).get_kernel(
        "softmax_ce_bwd", "const float *y, const float *label, float *dx, "
        "int n")
    seen = {"forward_on_card": 0}

    class SoftmaxRTC(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            for a in in_data + out_data:
                if a._data.device != dev:
                    raise AssertionError("softmax_rtc: an array on %s, not "
                                         "%s" % (a._data.device, dev))
            seen["forward_on_card"] += 1
            x, y = in_data[0], out_data[0]
            rows, n = x.shape
            fwd.launch([x, y, n], x.context, (rows,), (RTC_BLOCK,), 4 * n)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, label, dx = out_data[0], in_data[1], in_grad[0]
            rows, n = y.shape
            bwd.launch([y, label, dx, n], y.context, (rows,),
                       (INTEROP_CE_BLOCK,))

    @mx.operator.register("softmax_rtc")
    class SoftmaxRTCProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return ([in_shape[0], [in_shape[0][0]]], [in_shape[0]], [])

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxRTC()

    return seen


def interop_counts(pk):
    from mxnet_tpu_torch import rtc

    out = {k: getattr(pk, k).launches for k in EPI_KERNELS}
    out["rtc"] = rtc.CudaKernel.launches
    return out


def interop_zero(pk):
    from mxnet_tpu_torch import rtc

    for k in EPI_KERNELS:
        getattr(pk, k).launches = 0
    rtc.CudaKernel.launches = 0


def interop_fit(torch, pk, mx, sym, args, auxs, batches):
    """A `Module` of ``sym`` on the card, from ``args`` / ``auxs``, through
    ``len(batches)`` SGD steps (momentum 0.9); returns each step's loss
    (mean -log p[label], from the head's output), the first step's
    gradients, the final weights, the ms a step (the first excluded) and
    the launch counts of the run."""
    mod = mx.mod.Module(sym, data_names=["data"],
                        label_names=["softmax_label"], context=mx.gpu(0))
    mod.bind(data_shapes=[("data", batches[0][0].shape)],
             label_shapes=[("softmax_label", batches[0][1].shape)])
    mod.set_params({k: v.copy() for k, v in args.items()},
                   {k: v.copy() for k, v in auxs.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9})
    torch.cuda.synchronize()
    interop_zero(pk)
    losses, grads, times = [], None, []
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        mod.forward(mx.io.DataBatch([x], [y]), is_train=True)
        mod.backward()
        if i == 0:
            grads = {k: mod._exec.grad_dict[k]._data.clone() for k in args}
        mod.update()
        p = mod.get_outputs()[0]._data
        picked = p.gather(1, y._data.long().view(-1, 1))
        losses.append(float(-torch.log(picked).mean()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = interop_counts(pk)
    weights = {k: mod._exec.arg_dict[k]._data.clone() for k in args}
    return losses, grads, weights, 1e3 * sum(times[1:]) / (len(times) - 1), \
        counts


def interop_phase(torch, pk, args):
    """Phase 24 (see the module docstring). Returns the launch counts of
    part (c)'s partitioned and unpartitioned runs together."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine, runtime, subgraph, test_utils
    from mxnet_tpu_torch.contrib import onnx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    t_phase = time.monotonic()
    card = smi_line()
    dev = torch.device("cuda", 0)
    prev = deterministic(torch)
    rng = np.random.RandomState(args.seed)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke-interop-") as tmp:
            # (a) the ONNX round trip at full width
            mx.random.seed(args.seed)
            net = vision.resnet50_v1()
            net.initialize(mx.init.Xavier())
            x = mx.nd.array(rng.uniform(-1, 1, (INTEROP_BATCH, 3, 224, 224))
                            .astype(np.float32), ctx=mx.gpu(0))
            want = net(x).asnumpy()
            sym = net(mx.sym.var("data"))
            params = {k: v.data() for k, v in net.collect_params().items()}
            path = os.path.join(tmp, "resnet50_v1.onnx")
            t0 = time.monotonic()
            onnx.export_model(sym, params, (1, 3, 224, 224),
                              onnx_file_path=path)
            t_export = time.monotonic() - t0
            t0 = time.monotonic()
            isym, iargs, iauxs = onnx.import_model(path)
            t_import = time.monotonic() - t0
            meta = onnx.get_model_metadata(path)
            if meta["input_tensor_data"] != [("data", (1, 3, 224, 224))] or \
                    [n for n, _ in meta["output_tensor_data"]] != [sym.name]:
                raise AssertionError("interop (a): metadata %s, graph "
                                     "output %s" % (meta, sym.name))
            if len(iauxs) != 2 * 53 or any(
                    a._data.device != dev for a in iargs.values()):
                raise AssertionError("interop (a): %d aux states (want the "
                                     "53 BatchNorms' moving statistics)"
                                     % len(iauxs))
            got = isym.bind(mx.gpu(0), args={**iargs, "data": x},
                            grad_req="null", aux_states=iauxs).forward(
                is_train=False)[0].asnumpy()
            err = float(np.abs(got - want).max())
            np.testing.assert_allclose(got, want, rtol=INTEROP_TOL,
                                       atol=INTEROP_TOL,
                                       err_msg="interop (a): imported "
                                       "graph vs the gluon net")
            log("interop (a): resnet50_v1 -> ONNX %d bytes, export %.2f s, "
                "import %.2f s; metadata input %s, output %s (the exporter "
                "writes no output shape; the imported graph infers %s); 32 "
                "images' eval logits on the card within %g of the gluon "
                "net's (largest difference %.3g); %s"
                % (os.path.getsize(path), t_export, t_import,
                   meta["input_tensor_data"], meta["output_tensor_data"],
                   isym.infer_shape(data=(INTEROP_BATCH, 3, 224, 224))[1],
                   INTEROP_TOL, err, card))
            del net, x, params, want, got

            # (b) the custom-op head
            seen = interop_register_head(mx, dev)
            xh = rng.randn(INTEROP_BATCH, INTEROP_CLASSES).astype(
                np.float32) * 3
            lab = rng.randint(0, INTEROP_CLASSES, INTEROP_BATCH).astype(
                np.float32)
            loc = {"data": xh, "label": lab}
            ref = mx.sym.SoftmaxOutput(mx.sym.var("data"),
                                       mx.sym.var("label"))
            rexe = ref.bind(mx.gpu(0), args={
                "data": mx.nd.array(xh, ctx=mx.gpu(0)),
                "label": mx.nd.array(lab, ctx=mx.gpu(0))},
                grad_req={"data": "write", "label": "null"})
            rout = rexe.forward(is_train=True)[0].asnumpy()
            rexe.backward()
            rgrad = rexe.grad_dict["data"].asnumpy()
            head = mx.sym.Custom(mx.sym.var("data"), mx.sym.var("label"),
                                 op_type="softmax_rtc")
            test_utils.check_symbolic_forward(
                head, loc, [rout], rtol=INTEROP_HEAD_TOL,
                atol=INTEROP_HEAD_TOL, ctx=mx.gpu(0))
            test_utils.check_symbolic_backward(
                head, loc, [np.ones_like(xh)], {"data": rgrad},
                rtol=INTEROP_HEAD_TOL, atol=INTEROP_HEAD_TOL,
                ctx=mx.gpu(0))
            if seen["forward_on_card"] < 2:
                raise AssertionError("interop (b): the head's forward ran "
                                     "%d times" % seen["forward_on_card"])
            xn = mx.nd.array(xh, ctx=mx.gpu(0))
            ln = mx.nd.array(lab, ctx=mx.gpu(0))
            mx.nd.Custom(xn, ln, op_type="softmax_rtc").wait_to_read()
            t0 = time.perf_counter()
            for _ in range(INTEROP_CALLS):
                out = mx.nd.Custom(xn, ln, op_type="softmax_rtc")
            host_us = 1e6 * (time.perf_counter() - t0) / INTEROP_CALLS
            out.wait_to_read()
            log("interop (b): softmax_rtc (NVRTC softmax_fwd<float> / "
                "softmax_ce_bwd on the op's arrays) = SoftmaxOutput within "
                "%g at (%d, %d), forward and backward; every forward found "
                "its inputs on %s; %.1f host µs a call (mean of %d "
                "mx.nd.Custom calls); %s"
                % (INTEROP_HEAD_TOL, INTEROP_BATCH, INTEROP_CLASSES, dev,
                   host_us, INTEROP_CALLS, card))

            # (c) training through the imported, partitioned graph
            label = mx.sym.var("softmax_label")
            custom = mx.sym.Custom(isym, label, op_type="softmax_rtc",
                                   name="softmax")
            part = subgraph.partition(custom, "default")
            ops = [n.op for n in part._topo() if not n.is_var]
            fused = sum(op.startswith("_subgraph_") for op in ops)
            if "Convolution" in ops or ops.count("BatchNorm") != 53 or \
                    ops[-1] != "Custom":
                raise AssertionError("interop (c): partitioned ops %s"
                                     % sorted(set(ops)))
            builtin = mx.sym.SoftmaxOutput(isym, label, name="softmax")
            batches = [(mx.nd.array(rng.uniform(-1, 1, (
                INTEROP_BATCH, 3, 224, 224)).astype(np.float32),
                ctx=mx.gpu(0)),
                mx.nd.array(rng.randint(0, INTEROP_CLASSES, INTEROP_BATCH)
                            .astype(np.float32), ctx=mx.gpu(0)))
                for _ in range(INTEROP_STEPS)]
            runs = {name: interop_fit(torch, pk, mx, s, iargs, iauxs, batches)
                    for name, s in (("plain", custom), ("partitioned", part),
                                    ("builtin", builtin))}
            plain, parted = runs["plain"], runs["partitioned"]
            same = plain[0] == parted[0] and all(
                torch.equal(plain[2][k], parted[2][k]) for k in iargs)
            if not same:
                again = interop_fit(torch, pk, mx, custom, iargs, iauxs,
                                    batches)
                for k in iargs:
                    room = float((again[2][k] - plain[2][k]).abs().max())
                    gap = float((parted[2][k] - plain[2][k]).abs().max())
                    if gap > room:
                        raise AssertionError(
                            "interop (c): %s differs by %g partitioned, "
                            "two plain runs by %g" % (k, gap, room))
            worst = (-1.0, "")
            for k in iargs:
                g, r = plain[1][k], runs["builtin"][1][k]
                scale = float(r.abs().max())
                diff = float((g - r).abs().max())
                if diff > INTEROP_TOL * max(scale, 1e-30):
                    raise AssertionError("interop (c): %s's gradient %g "
                                         "from SoftmaxOutput's (scale %g)"
                                         % (k, diff, scale))
                worst = max(worst, (diff / max(scale, 1e-30), k))
            for name in ("plain", "partitioned"):
                if min(runs[name][4].values()) < 1:
                    raise AssertionError("interop (c): %s launches %s"
                                         % (name, runs[name][4]))
            if plain[4] != parted[4]:
                raise AssertionError("interop (c): launches %s unpartitioned, "
                                     "%s partitioned" % (plain[4], parted[4]))
            if runs["builtin"][4]["rtc"]:
                raise AssertionError("interop (c): the built-in head "
                                     "launched rtc kernels")
            log("interop (c): the imported resnet50_v1 + softmax_rtc head, "
                "%d fused subgraph nodes beside 53 BatchNorms and the head; "
                "%d SGD steps at %d x 224^2: losses %s, %s the unpartitioned "
                "run's (weights %s); first-step gradients within %.3g of "
                "SoftmaxOutput's scale (largest: %s); launches a run %s; ms a "
                "step "
                "(steps 2-%d) unpartitioned %.2f, partitioned %.2f, "
                "SoftmaxOutput %.2f; %s"
                % (fused, INTEROP_STEPS, INTEROP_BATCH,
                   ["%.6f" % v for v in parted[0]],
                   "equal to" if same else "within a second run of",
                   "bit for bit" if same else "within that run's spread",
                   worst[0], worst[1], plain[4], INTEROP_STEPS, plain[3],
                   parted[3],
                   runs["builtin"][3], card))
            counts = {k: plain[4][k] + parted[4][k] for k in plain[4]}
            del runs, batches, iargs, iauxs
            torch.cuda.empty_cache()

            # (d) the runtime and engine surface on the card
            feats = runtime.Features()
            on = {n for n, f in feats.items() if f.enabled}
            if not {"GPU", "CUDA", "CUDNN", "NCCL", "CUDA_RTC"} <= on or \
                    {"TPU", "PALLAS"} & on:
                raise AssertionError("interop (d): features %r" % feats)
            cache = os.path.join(tmp, "topology.json")
            old = os.environ.get("MXTPU_TOPOLOGY_CACHE")
            os.environ["MXTPU_TOPOLOGY_CACHE"] = cache
            try:
                t0 = time.monotonic()
                devs = runtime.dial_devices(timeout_s=60)
                t_dial = time.monotonic() - t0
                topo = runtime.cached_topology()
            finally:
                if old is None:
                    os.environ.pop("MXTPU_TOPOLOGY_CACHE")
                else:
                    os.environ["MXTPU_TOPOLOGY_CACHE"] = old
            if devs[0] != dev or topo["device_kind"] != \
                    torch.cuda.get_device_name(0) or \
                    topo["device_count"] != torch.cuda.device_count():
                raise AssertionError("interop (d): dial %s, cache %s"
                                     % (devs, topo))
            if test_utils.default_context() != mx.gpu(0):
                raise AssertionError("interop (d): default_context %s"
                                     % test_utils.default_context())
            ev = torch.cuda.Event()
            torch.cuda._sleep(50 * TIMING_SLEEP_CYCLES)
            ev.record()
            before = ev.query()
            engine.wait_all()
            if before or not ev.query():
                raise AssertionError("interop (d): wait_all: the event was "
                                     "%s before and %s after"
                                     % (before, ev.query()))
            a = mx.nd.ones((1024,), ctx=mx.gpu(0))
            idle = {}
            for naive in (False, True):
                with engine.naive_engine(naive):
                    torch.cuda._sleep(50 * TIMING_SLEEP_CYCLES)
                    (a + 1).sqrt()
                    idle[naive] = torch.cuda.current_stream().query()
                torch.cuda.synchronize()
            if idle != {False: False, True: True}:
                raise AssertionError("interop (d): the stream idle after "
                                     "an op %s (naive: True)" % idle)
            log("interop (d): features on %s; dial_devices %s in %.3f s, "
                "cache %s; default_context %s; wait_all waited for a queued "
                "sleep; under naive_engine the stream is idle after each "
                "mx.nd op (busy without)"
                % (sorted(on), [str(d) for d in devs], t_dial,
                   topo["device_kind"], test_utils.default_context()))
    finally:
        restore_flags(torch, prev)
    log("interop: phase %.1f s; launches (unpartitioned + partitioned) %s; "
        "%s" % (time.monotonic() - t_phase, counts, card))
    return counts


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
    # rank, port, output directory: one of the ranks2 phase's children
    p.add_argument("--ranks2-child", nargs=3, default=None,
                   help=argparse.SUPPRESS)
    # output directory: one of the dist_kv phase's ranks (the launcher
    # gives the rank)
    p.add_argument("--dist-kv-child", default=None, help=argparse.SUPPRESS)
    # output directory: a process of the resilience phase (the launcher
    # gives its rank and generation); its mode, single or fsdp
    p.add_argument("--resilience-child", default=None,
                   help="run one process of the resilience phase into DIR")
    p.add_argument("--resilience-mode", default="single",
                   choices=("single", "fsdp"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.ranks2_child:
        rank, port, out_dir = args.ranks2_child
        return ranks2_child(int(rank), int(port), out_dir, args.seed)
    if args.dist_kv_child:
        return dist_kv_child(args.dist_kv_child, args.seed)
    if args.resilience_child:
        return resilience_child(args.resilience_child, args.seed,
                                args.resilience_mode)
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import pallas_kernels as pk
    from mxnet_tpu_torch.telemetry import recorder

    # the flight recorder's SIGUSR1 dump handler installs from the main
    # thread only: before any thread starts
    recorder.install_signal_handler()

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
    sync_rows, raw_rows = check_epilogue_sync(torch, pk, args.seed, flush)
    rows.update(sync_rows)
    for k in ("epi_stats", "epi_bwd_reduce"):
        rows[k]["raw_mode"] = raw_rows
    rows.update(check_flash(torch, pk, args.seed, flush))
    rows.update(check_lstm(torch, pk, args.seed, flush))
    rows["rtc"], rtc_launches = rtc_phase(torch, args.seed, flush)
    del flush
    torch.cuda.empty_cache()
    random_phase(torch, args)
    launches = serve(torch, pk, args)
    launches["rtc"] = rtc_launches
    f1_scope_check(torch)
    # the serving phases' models registered SLO objectives, which started
    # the process-wide SLO evaluator thread; it is no pipeline thread, and
    # train_rec's thread checks start from none
    from mxnet_tpu_torch.telemetry import slo
    slo.stop()
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
    extra = {"rnn_cells": rnn_cells_phase(torch, pk, args)}
    torch.cuda.empty_cache()
    extra.update({"ctc_ocr": {}, "dropout": {}, "predict_vision": {},
             "replica_pool": {}, "autoscale": {}, "detection": {},
             "profiler": {},
             "sparse": {}, "mesh": {}, "pipeline": {}, "ranks2": {},
             "dist_kv": {}, "resilience": {}, "interop": {}})
    for part in ctc_ocr(torch, pk, args):
        for k, n in part.items():
            extra["ctc_ocr"][k] = extra["ctc_ocr"].get(k, 0) + n
    torch.cuda.empty_cache()
    extra["dropout"] = dropout_phase(torch, pk, args)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as ckpt:
        prefix = symbolic_word_lm(torch, pk, args, ckpt)[2]
        torch.cuda.empty_cache()
        extra["profiler"] = profiler_phase(torch, pk, args)
        torch.cuda.empty_cache()
        predict_serving(torch, pk, args, prefix)
        torch.cuda.empty_cache()
        extra["predict_vision"] = predict_vision(torch, pk, args, ckpt)
        torch.cuda.empty_cache()
        extra["replica_pool"], lm_run = replica_pool_phase(torch, args,
                                                            ckpt)
        torch.cuda.empty_cache()
        extra["autoscale"] = autoscale_phase(torch, args, lm_run)
        del lm_run
    torch.cuda.empty_cache()
    quantization_phase(torch, args)
    torch.cuda.empty_cache()
    extra["detection"] = detection_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["sparse"] = sparse_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["mesh"] = mesh_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["pipeline"] = pipeline_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["ranks2"] = ranks2_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["dist_kv"] = dist_kv_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["resilience"] = resilience_phase(torch, pk, args)
    torch.cuda.empty_cache()
    extra["interop"] = interop_phase(torch, pk, args)
    torch.cuda.empty_cache()
    # the finishing kernels' path is the ranks2 phase's (a batch over dp)
    for k in EPI_SYNC_KERNELS:
        launches[k] = extra["ranks2"].pop(k)
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
        for phase, counts in extra.items():
            if counts.get(k["name"]):
                # later slices' paths: rnn_cells (the fused side of the
                # cells' checks), ctc_ocr (training + decode), the
                # dropout runs, the training run behind predict_vision,
                # the replica_pool phase's generation replicas (their own
                # processes' counts, read from each replica's stats), the
                # autoscale phase's added replica (its own count since it
                # reported ready), the SSD training of the detection phase, the profiler
                # phase's three fits, the sparse phase's SyncBatchNorm,
                # the mesh phase's train_imagenet.py, the pipeline phase's
                # BERT-base, the ranks2 phase's ResNet-50 over dp 2, the
                # dist_kv phase's ResNet-50 through the dist_sync kvstore,
                # the resilience phase's preempted ResNet-50 (both
                # generations), its fsdp ranks' finishing kernels and its
                # checkpointed word LM fits, the interop phase's imported
                # ResNet-50 with the custom-op head, partitioned and not
                row["launches_" + phase] = counts[k["name"]]
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
