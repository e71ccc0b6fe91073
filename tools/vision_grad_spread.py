#!/usr/bin/env python3
"""How far a vision net's f32 training gradients move when only the
summation order changes: the same step of the same net, weights and batch
on the CPU at 1 thread and at N threads (PyTorch splits its convolutions'
and reductions' sums by thread), compared tensor by tensor.

    python tools/vision_grad_spread.py [--network inception_v3]
        [--side 299] [--batch 2] [--threads 8] [--seed 0]

Prints the loss and the output at both thread counts, then the tensors
whose gradients differ most, by max|a - b| / max|a| and by
||a - b|| / ||a||, and the medians over all tensors. Deep ReLU +
BatchNorm nets carry a rounding apart in the forward into ReLUs taking
the other branch, after which the gradients below differ far beyond the
rounding; this is the yardstick for holding a step on another device
(the card) against the CPU's.
"""
import argparse
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--network", default="inception_v3")
    p.add_argument("--side", type=int, default=299)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch import train_imagenet

    rng = np.random.RandomState(args.seed + 9)
    x = torch.from_numpy(rng.uniform(-1, 1, (args.batch, args.side,
                                             args.side, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, args.batch))
    runs = {}
    for threads in (1, args.threads):
        torch.set_num_threads(threads)
        net = train_imagenet.build_network(
            args.network, 1000, (3, args.side, args.side), "NHWC", "cpu",
            args.seed)
        for m in net.modules():
            if type(m).__name__ == "Dropout":
                m._rate = 0.0
        net.train()
        out = net(x)
        loss = F.cross_entropy(out, y)
        names, params = zip(*net.named_parameters())
        grads = torch.autograd.grad(loss, params)
        runs[threads] = (float(loss.detach()), out.detach(), grads, names)
    (la, oa, ga, names), (lb, ob, gb, _) = runs[1], runs[args.threads]
    print("%s batch %d at %d x %d: loss %.7f at 1 thread, %.7f at %d; "
          "output max|diff| / max|output| %.3g"
          % (args.network, args.batch, args.side, args.side, la, lb,
             args.threads, float((oa - ob).abs().max() / oa.abs().max())))
    rows = []
    for n, a, b in zip(names, ga, gb):
        rows.append((float((a - b).abs().max() / a.abs().max()
                           .clamp_min(1e-30)),
                     float((a - b).norm() / a.norm().clamp_min(1e-30)), n))
    rows.sort(reverse=True)
    for r in rows[:8]:
        print("  max-rel %.3g  l2-rel %.3g  %s" % r)
    print("  medians over %d tensors: max-rel %.3g, l2-rel %.3g"
          % (len(rows), float(np.median([r[0] for r in rows])),
             float(np.median([r[1] for r in rows]))))


if __name__ == "__main__":
    main()
