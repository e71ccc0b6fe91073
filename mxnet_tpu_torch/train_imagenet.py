"""ImageNet training with the port: the counterpart of the JAX package's
``examples/image_classification/train_imagenet.py``, with its argument
names and defaults for the subset ported so far.

    python -m mxnet_tpu_torch.train_imagenet [--network resnet50_v1]
        [--batch-size 32] [--dtype bfloat16] [--layout NHWC] ...
        [--device cuda|cpu] [--seed 0]

It builds a model-zoo ResNet v1 (under `gluon.nn.layout_scope` for NHWC),
initializes it with Xavier from ``--seed``, and trains it with
`parallel.DistributedTrainer` (SGD with momentum, softmax cross-entropy,
bf16 compute over f32 master weights by default) on synthetic batches
drawn with numpy from ``--seed``. RecordIO input (``--data-train``,
``--data-val``) is not ported yet. ``--device`` defaults to the card; a
run on the host must ask for ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

__all__ = ["add_fit_args", "main"]


def add_fit_args(parser):
    """The JAX script's training arguments (subset), plus --device and
    --seed."""
    t = parser.add_argument_group("Training")
    t.add_argument("--network", type=str, default="resnet50_v1",
                   help="model zoo factory name (resnet18_v1 ... "
                        "resnet152_v1)")
    t.add_argument("--num-epochs", type=int, default=1)
    t.add_argument("--lr", type=float, default=0.1)
    t.add_argument("--lr-factor", type=float, default=0.1)
    t.add_argument("--lr-step-epochs", type=str, default="30,60")
    t.add_argument("--optimizer", type=str, default="sgd")
    t.add_argument("--mom", type=float, default=0.9)
    t.add_argument("--wd", type=float, default=1e-4)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--disp-batches", type=int, default=20)
    t.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    t.add_argument("--layout", type=str, default="NCHW",
                   choices=["NCHW", "NHWC"])
    t.add_argument("--num-classes", type=int, default=1000)
    t.add_argument("--image-shape", type=str, default="3,224,224")
    t.add_argument("--data-train", type=str, default=None,
                   help="RecordIO input: not ported yet")
    t.add_argument("--data-val", type=str, default=None,
                   help="RecordIO input: not ported yet")
    t.add_argument("--num-batches", type=int, default=10,
                   help="synthetic-data batches per epoch")
    t.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    t.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the synthetic batches")
    return parser


def _synthetic_batches(args, shape, rng):
    for _ in range(args.num_batches):
        x = rng.uniform(-1, 1, (args.batch_size,) + shape).astype(np.float32)
        y = rng.randint(0, args.num_classes, (args.batch_size,))
        yield x, y


def main(argv=None):
    args = add_fit_args(argparse.ArgumentParser(
        description="train imagenet-1k",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)).parse_args(
            argv)
    logging.basicConfig(level=logging.INFO)

    from . import gluon
    from .base import MXNetError
    from .context import resolve_device
    from .gluon.model_zoo import vision
    from .parallel import DistributedTrainer

    if args.data_train or args.data_val:
        raise MXNetError("--data-train / --data-val (RecordIO) are not "
                         "ported yet; run without them on synthetic data")
    device = resolve_device(args.device)
    c, h, w = (int(s) for s in args.image_shape.split(","))
    nhwc = args.layout == "NHWC"
    shape = (h, w, c) if nhwc else (c, h, w)
    fac = getattr(vision, args.network, None)
    if fac is None:
        raise MXNetError("unknown --network %r" % args.network)
    if nhwc:
        with gluon.nn.layout_scope():
            net = fac(classes=args.num_classes, in_channels=c, device=device)
    else:
        net = fac(classes=args.num_classes, in_channels=c, device=device)
    net.initialize("xavier", seed=args.seed)
    opt_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer == "sgd":
        opt_params["momentum"] = args.mom
    trainer = DistributedTrainer(
        net, args.optimizer, opt_params,
        loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        amp_dtype=None if args.dtype == "float32" else args.dtype)

    lr_steps = [int(e) for e in args.lr_step_epochs.split(",") if e]
    rng = np.random.RandomState(args.seed)
    loss = None
    for epoch in range(args.num_epochs):
        if epoch in lr_steps:
            trainer.set_learning_rate(trainer.learning_rate * args.lr_factor)
        tic = win_tic = time.time()
        n = win_n = 0
        for i, (xb, yb) in enumerate(_synthetic_batches(args, shape, rng)):
            loss = trainer.step(xb, yb)
            n += xb.shape[0]
            win_n += xb.shape[0]
            if (i + 1) % args.disp_batches == 0:
                value = float(loss)   # host sync: the window's end
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                             "\tloss=%.4f", epoch, i + 1,
                             win_n / (time.time() - win_tic), value)
                win_tic, win_n = time.time(), 0
        if loss is not None:
            loss = float(loss)
        logging.info("Epoch[%d] Train-samples/sec=%f", epoch,
                     n / (time.time() - tic))
        logging.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
    print("done: trained %s %s %s on %s, last loss %s" % (
        args.network, args.dtype, args.layout, device, loss))
    return loss


if __name__ == "__main__":
    main()
