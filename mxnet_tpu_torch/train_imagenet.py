"""ImageNet training with the port: the counterpart of the JAX package's
``examples/image_classification/train_imagenet.py``, with its argument
names and defaults for the subset ported so far.

    python -m mxnet_tpu_torch.train_imagenet [--network resnet50_v1]
        [--batch-size 32] [--dtype bfloat16] [--layout NHWC]
        [--image-shape 3,224,224] ...
        [--data-train T.rec] [--data-val V.rec] [--top-k 5]
        [--data-nthreads 4] [--random-crop 1] [--random-mirror 1]
        [--rgb-mean 123.68,116.779,103.939] [--rgb-std 58.393,57.12,57.375]
        [--device cuda|cpu] [--seed 0]

It builds the model-zoo network ``--network`` names (any factory of
`gluon.model_zoo.vision.get_model`: ResNet v1 and v2, AlexNet, VGG,
SqueezeNet, DenseNet, Inception V3 with ``--image-shape 3,299,299``,
MobileNet v1 and v2; under `gluon.nn.layout_scope` for NHWC), initializes
it with Xavier from ``--seed`` (`build_network`: a net whose shapes are
deferred takes them from one forward of a zero image, which also checks
that ``--image-shape`` fits it), and trains it with
`parallel.DistributedTrainer` (SGD with momentum, softmax cross-entropy,
bf16 compute over f32 master weights by default). Dropout layers drop
(in training mode) with this thread's generator for the card.

With ``--data-train`` the batches come from a RecordIO file through
`io.ImageRecordIter` (``--data-nthreads`` decode threads; shuffled by a
`np.random.RandomState` of ``--seed``; the augmentations of the
reference's common/data.py arguments, all off by default as in the JAX
script), then `data.DevicePrefetcher` (pinned staging and the copy to the
card ahead of the step), then the NHWC transpose on the card. The padded
last batch still trains at the static batch shape; only the sample count
leaves its padding out. Without it the batches are synthetic, drawn with
numpy from ``--seed``. With ``--data-val`` each epoch ends with a
validation pass in inference mode (running statistics, no gradients),
scored by `metric.Accuracy` (and `metric.TopKAccuracy` with ``--top-k``)
on every sample but the padding. ``--device`` defaults to the card; a run
on the host must ask for ``--device cpu``. ``--model-prefix`` (export) is
not ported (a net other than ResNet v1 is a `HybridBlock`, which
``export`` writes; ROADMAP queue 1 item 9).

`main` returns the last training loss. ``batch_end_callback`` is called
after every training step and ``eval_end_callback`` after every
validation pass, each with a `model.BatchEndParam`. The seconds the loop
waited for its training batches are counted in
``mxtpu_data_wait_seconds_total{src="train_imagenet"}``.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

__all__ = ["add_fit_args", "build_network", "main"]


def add_fit_args(parser):
    """The JAX script's training arguments (subset), the reference's data
    arguments that the record path takes, plus --device and --seed."""
    t = parser.add_argument_group("Training")
    t.add_argument("--network", type=str, default="resnet50_v1",
                   help="model zoo name (gluon.model_zoo.vision.get_model: "
                        "resnet18_v1 ... resnet152_v2, alexnet, vgg11 ... "
                        "vgg19_bn, squeezenet1_0/1_1, densenet121 ... 201, "
                        "inception_v3, mobilenet1_0 ... "
                        "mobilenet_v2_0_25)")
    t.add_argument("--num-epochs", type=int, default=1)
    t.add_argument("--lr", type=float, default=0.1)
    t.add_argument("--lr-factor", type=float, default=0.1)
    t.add_argument("--lr-step-epochs", type=str, default="30,60")
    t.add_argument("--optimizer", type=str, default="sgd")
    t.add_argument("--mom", type=float, default=0.9)
    t.add_argument("--wd", type=float, default=1e-4)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--disp-batches", type=int, default=20)
    t.add_argument("--top-k", type=int, default=0,
                   help="also score top-k accuracy in validation")
    t.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    t.add_argument("--layout", type=str, default="NCHW",
                   choices=["NCHW", "NHWC"])
    t.add_argument("--num-classes", type=int, default=1000)
    t.add_argument("--image-shape", type=str, default="3,224,224")
    t.add_argument("--data-train", type=str, default=None,
                   help="RecordIO file (recordio.pack_img); synthetic if "
                        "unset")
    t.add_argument("--data-val", type=str, default=None,
                   help="RecordIO file scored after each epoch")
    t.add_argument("--num-batches", type=int, default=10,
                   help="synthetic-data batches per epoch")
    t.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    t.add_argument("--seed", type=int, default=0,
                   help="seed of the weights, the synthetic batches and "
                        "the record shuffle and augmentation")
    d = parser.add_argument_group("Data (reference: common/data.py)")
    d.add_argument("--data-nthreads", type=int, default=4,
                   help="decode and augmentation threads")
    d.add_argument("--random-crop", type=int, default=0,
                   help="1: random crops in training (else center)")
    d.add_argument("--random-mirror", type=int, default=0,
                   help="1: random horizontal flips in training")
    d.add_argument("--rgb-mean", type=str, default="0,0,0",
                   help="per-channel mean subtracted, in [0, 255]")
    d.add_argument("--rgb-std", type=str, default="1,1,1",
                   help="per-channel std divided by, in [0, 255]")
    return parser


def _synthetic_batches(args, shape, rng):
    for _ in range(args.num_batches):
        x = rng.uniform(-1, 1, (args.batch_size,) + shape).astype(np.float32)
        y = rng.randint(0, args.num_classes, (args.batch_size,))
        yield x, y, 0


def _floats(text):
    vals = [float(v) for v in text.split(",")]
    if len(vals) != 3:
        raise ValueError("expected 3 comma-separated values, got %r" % text)
    return vals


def _rec_iter(args, path, train, rng):
    """`io.ImageRecordIter` over ``path``: shuffled and augmented as asked
    when ``train``, in record order with center crops otherwise."""
    from . import io

    mean, std = _floats(args.rgb_mean), _floats(args.rgb_std)
    c, h, w = (int(s) for s in args.image_shape.split(","))
    return io.ImageRecordIter(
        path_imgrec=path, data_shape=(c, h, w), batch_size=args.batch_size,
        shuffle=train, rand_crop=train and bool(args.random_crop),
        rand_mirror=train and bool(args.random_mirror),
        mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
        std_r=std[0], std_g=std[1], std_b=std[2],
        preprocess_threads=args.data_nthreads, rng=rng)


def _rec_batches(args, it, device, nhwc):
    """(data, label, pad) tensors on ``device`` from a record iterator,
    through a `data.DevicePrefetcher`; NHWC transposed on the device."""
    from . import ndarray as nd
    from .data import DevicePrefetcher

    prefetcher = DevicePrefetcher(it, mesh=device, src="train_imagenet")
    try:
        for b in prefetcher:
            xb = b.data[0]
            if nhwc:
                xb = nd.transpose(xb, axes=(0, 2, 3, 1))
            yield xb._data, b.label[0]._data, b.pad or 0
    finally:
        prefetcher.close()


# the input side a family's fixed final pool is built for (the
# reference's training rows): Inception's AvgPool2D(8) takes the 8 x 8 map
# of a 299 x 299 image, DenseNet's AvgPool2D(7) and SqueezeNet's
# AvgPool2D(13) those of a 224 x 224 one
_IMAGE_SIDE = {"inception": 299, "densenet": 224, "squeezenet": 224}


def build_network(network, classes, image_shape, layout, device, seed):
    """The zoo net ``network`` for ``classes`` and an image of
    ``image_shape`` (C, H, W) in ``layout`` (NCHW or NHWC), its parameters
    on ``device``, filled with Xavier from ``seed``. A net whose shapes are
    deferred (every family but ResNet v1) runs one inference-mode forward
    of a zero image, which makes its parameters and checks that the image
    fits it: a shape it cannot take raises `MXNetError`, naming the side
    the family's final pool is built for."""
    import torch

    from . import gluon
    from .base import MXNetError
    from .gluon.model_zoo import vision

    c, h, w = image_shape
    nhwc = layout == "NHWC"
    with gluon.nn.layout_scope(nhwc):
        net = vision.get_model(network, classes=classes, in_channels=c,
                               device=device)
    net.initialize("xavier", seed=seed)
    if isinstance(net, gluon.Block) and any(
            p.var is None for p in net.collect_params().values()):
        shape = (1, h, w, c) if nhwc else (1, c, h, w)
        side = [v for k, v in _IMAGE_SIDE.items()
                if network.lower().startswith(k)]
        was = net.training
        net.eval()
        try:
            with torch.no_grad():
                out = net(torch.zeros(shape, device=device))
        except RuntimeError as e:
            raise MXNetError(
                "--image-shape %s does not fit %s%s: %s"
                % (",".join(map(str, image_shape)), network,
                   " (built for %d x %d images)" % (side[0], side[0])
                   if side else "", e)) from None
        finally:
            net.train(was)
        if tuple(out.shape) != (1, classes):
            raise MXNetError("--image-shape %s gives %s an output of shape "
                             "%s, not (1, %d)%s"
                             % (",".join(map(str, image_shape)), network,
                                tuple(out.shape), classes,
                                "; it is built for %d x %d images"
                                % (side[0], side[0]) if side else ""))
    return net


def main(argv=None, batch_end_callback=None, eval_end_callback=None):
    args = add_fit_args(argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)).parse_args(
            argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from . import autograd, gluon, telemetry
    from . import metric as mx_metric
    from .context import resolve_device
    from .model import BatchEndParam
    from .parallel import DistributedTrainer

    device = resolve_device(args.device)
    c, h, w = (int(s) for s in args.image_shape.split(","))
    nhwc = args.layout == "NHWC"
    shape = (h, w, c) if nhwc else (c, h, w)
    net = build_network(args.network, args.num_classes, (c, h, w),
                        args.layout, device, args.seed)
    opt_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer == "sgd":
        opt_params["momentum"] = args.mom
    trainer = DistributedTrainer(
        net, args.optimizer, opt_params,
        loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        amp_dtype=None if args.dtype == "float32" else args.dtype)

    lr_steps = [int(e) for e in args.lr_step_epochs.split(",") if e]
    metric = mx_metric.Accuracy()
    if args.top_k:
        metric = mx_metric.CompositeEvalMetric(
            [metric, mx_metric.TopKAccuracy(args.top_k)])
    rng = np.random.RandomState(args.seed)
    data_rng = np.random.RandomState(args.seed)
    tm_wait = telemetry.counter("mxtpu_data_wait_seconds_total",
                                {"src": "train_imagenet"})

    def evaluate(epoch):
        metric.reset()
        it = _rec_iter(args, args.data_val, False, data_rng)
        batches = _rec_batches(args, it, device, nhwc)
        nbatch = 0
        try:
            with autograd.predict_mode():
                for xb, yb, pad in batches:
                    out = trainer.forward(xb, is_train=False)
                    keep = xb.shape[0] - pad   # the padding is not scored
                    metric.update([yb[:keep]], [out[:keep]])
                    nbatch += 1
        finally:
            batches.close()   # the prefetcher's thread before the reader's
            it.close()
        for name, val in metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
        if eval_end_callback is not None:
            eval_end_callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                            eval_metric=metric,
                                            locals=locals()))

    loss = None
    for epoch in range(args.num_epochs):
        if epoch in lr_steps:
            trainer.set_learning_rate(trainer.learning_rate * args.lr_factor)
        it = None
        if args.data_train:
            it = _rec_iter(args, args.data_train, True, data_rng)
            batches = _rec_batches(args, it, device, nhwc)
        else:
            batches = _synthetic_batches(args, shape, rng)
        tic = win_tic = time.time()
        n = win_n = i = 0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    xb, yb, pad = next(batches)
                except StopIteration:
                    break
                tm_wait.inc(time.perf_counter() - t0)
                loss = trainer.step(xb, yb)
                n += xb.shape[0] - pad
                win_n += xb.shape[0] - pad
                i += 1
                if batch_end_callback is not None:
                    batch_end_callback(BatchEndParam(
                        epoch=epoch, nbatch=i - 1, eval_metric=None,
                        locals=locals()))
                if i % args.disp_batches == 0:
                    value = float(loss)   # host sync: the window's end
                    logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec\tloss=%.4f", epoch, i,
                                 win_n / (time.time() - win_tic), value)
                    win_tic, win_n = time.time(), 0
        finally:
            batches.close()   # the prefetcher's thread before the reader's
            if it is not None:
                it.close()
        if isinstance(loss, torch.Tensor):
            loss = float(loss)
        logging.info("Epoch[%d] Train-samples/sec=%f", epoch,
                     n / (time.time() - tic))
        logging.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
        if args.data_val:
            evaluate(epoch)
    print("done: trained %s %s %s on %s, last loss %s" % (
        args.network, args.dtype, args.layout, device, loss))
    return loss


if __name__ == "__main__":
    main()
