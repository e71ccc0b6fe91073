"""Run `chip_smoke.py`'s training-telemetry phases alone on the card.

    python3 tools/train_telemetry_probe.py [--profile] [PHASE ...]

PHASE is any of ``rnn_cells`` (the Gluon cells against the fused LSTM,
its unfuse and a Conv2DLSTMCell card against CPU), ``train`` (ResNet-50
bf16, 128 x 224^2), ``bert`` (BERT-base bf16, 8 x 512) and ``lm`` (the 2 x
650 word LM bf16, 35 x 32, then its evaluation); all four by default.
Each training phase prints the automatic step FLOPs against PERF.md's hand
count, the ``mxtpu_step_mfu`` gauge against the MFU of the phase's own
throughput, goodput's compute share, the host syncs a step with telemetry
on and off and the instrumentation's host cost; ``--profile`` adds the
`torch.profiler` busy share beside goodput's compute share. The kernels
are built from the checkout first (``conv_epilogue``, ``flash_attention``,
``lstm``), TF32 off as `chip_smoke.main` sets it. Needs one CUDA card.
"""
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("train_telemetry_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    _build.build_all(["conv_epilogue", "flash_attention", "lstm"])
    cs.log("kernels built in %.1f s; %s" % (time.monotonic() - t0,
                                             cs.smi_line()))
    args = types.SimpleNamespace(seed=0, profile="--profile" in argv)
    phases = [a for a in argv if not a.startswith("--")] or \
        ["rnn_cells", "train", "bert", "lm"]
    for phase in phases:
        t0 = time.monotonic()
        if phase == "rnn_cells":
            cs.rnn_cells_phase(torch, pk, args)
        elif phase == "train":
            cs.train(torch, pk, args)
        elif phase == "bert":
            cs.train_bert(torch, pk, args)
        elif phase == "lm":
            net = cs.train_word_lm(torch, pk, args)[1]
            cs.eval_word_lm(torch, pk, args, net)
        else:
            raise SystemExit("unknown phase %r" % phase)
        torch.cuda.empty_cache()
        cs.log("phase %s: %.1f s" % (phase, time.monotonic() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
