#!/usr/bin/env python3
"""The smoke's symbolic phase at several learning rates, and its CPU
rehearsal at full width.

Runs ``chip_smoke.symbolic_word_lm`` (the 2 x 650 word LM as a
``BucketingModule`` over ``FusedRNNCell``, f32, batch 32, buckets 10 / 20 /
35: 2 warm-up and 12 timed ``fit`` batches, a 4-batch ``score``, the
checkpoint reload) once for each ``--lr`` on the CUDA card, with TF32 off,
printing each run's perplexities, tokens/s and launch counts, or the gate
it failed. ``--cpu-rehearsal LR`` then runs the same phase, at the same
width, on the host: the plain versions of the kernels, so the perplexities
it prints are what the card's run should reproduce; the launch counts are
counted at the wrappers instead of the kernels.

    python3 tools/symbolic_probe.py [--lr 0.5,1.0] [--cpu-rehearsal 1.0]
                                    [--seed 0] [--profile]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
"""
import argparse
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def counted(f):
    """``f`` counting its calls on tensors that are not meta (shape
    inference) in ``launches``, as the kernel wrappers count launches."""
    def wrapper(*a, **kw):
        wrapper.launches += a[0].device.type != "meta"
        return f(*a, **kw)

    wrapper.launches = 0
    return wrapper


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lr", default="1.0",
                   help="comma-separated SGD learning rates for the card")
    p.add_argument("--cpu-rehearsal", type=float, default=None,
                   help="also run the phase on the host at this lr")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="profile a bucket-35 batch of the first card run")
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t0 = time.monotonic()
    _build.build_all(["lstm"])
    print("lstm.cu built in %.1f s" % (time.monotonic() - t0), flush=True)
    run = types.SimpleNamespace(seed=args.seed, profile=args.profile)
    for lr in [float(x) for x in args.lr.split(",")]:
        cs.SYM_LR = lr
        try:
            cs.symbolic_word_lm(torch, pk, run)
        except AssertionError as e:
            print("lr %g: %s" % (lr, e), flush=True)
        run.profile = False
        torch.cuda.empty_cache()
    if args.cpu_rehearsal is None:
        return 0
    # the same phase on the host: the device, the card's clocks and its
    # memory statistics stand in for the CPU's
    cs.SYM_LR = args.cpu_rehearsal
    mx.gpu = lambda i=0: torch.device("cpu")
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    cs.smi_line = lambda: "on the host's CPU, not the card"
    for k in cs.LSTM_KERNELS:
        setattr(pk, k, counted(getattr(pk, k)))
    print("CPU rehearsal at full width, lr %g" % cs.SYM_LR, flush=True)
    t0 = time.monotonic()
    try:
        cs.symbolic_word_lm(torch, pk, run)
    except AssertionError as e:
        print("CPU rehearsal: %s" % e, flush=True)
        return 1
    print("CPU rehearsal took %.1f s" % (time.monotonic() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
