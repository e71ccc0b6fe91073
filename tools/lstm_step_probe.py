#!/usr/bin/env python3
"""Where an LSTM kernel's time goes, from outside the kernel.

Times `lstm_infer`, `lstm_fwd` and `lstm_bwd` (``mxnet_tpu_torch/csrc/
lstm.cu``) on one CUDA card at several sequence lengths T for each (B, H),
the way ``chip_smoke.py`` times kernels (CUDA events, the L2 cache
overwritten and the card kept busy before each call), and fits ms = fixed
+ T x step by least squares: ``step`` is the cost of one time step (its
barriers included), ``fixed`` the launch, the prologue (w_hh's slice staged
into shared memory from a cold cache) and the wrapper's set-up. Sweeping B
and H shows how the step cost follows the bytes every block stages (B x H
of h in the forward, B x 4H / Q of dgx in the backward) and the block's
product. Also times one grid barrier (``lstm_barrier_probe``), the
backward's own grid barrier and cluster barrier (``lstm_cluster_probe``),
and the forward wrapper's set-up alone.

``--trace`` instead builds ``csrc/lstm.cu`` once more with ``-DLSTM_TRACE``
(into the package's git-ignored ``_build/trace``; the port never loads that
library), runs each kernel at the word LM's layer (T 35, B 32, H 650) in
bf16 and f32, and reads the SM clock that block 0 recorded at fixed points
of every step: the median time of each phase of a step, the prologue and
the whole launch. Forward: the copies issued, each commit group landed,
the product, the cell update, the grid barrier. Backward: the cell update,
the grid barrier, the copies of its share of dgx[t] issued, the share
landed, the product, the partial sums sent to their owners (the wait for
the peers' sums falls in the next step's cell update).

``--word-lm N`` instead runs ``chip_smoke.py``'s word-LM training phase
(bench_lstm's 2 x 650 model, bf16, 35 x 32 tokens: 3 warm-up and 10 timed
steps) N times and prints each run's tokens/s, so that two checkouts'
steps can be compared on one card in turns.

    python3 tools/lstm_step_probe.py [--out lstm_probe.json]
                                     [--root DIR] [--trace | --word-lm N]

Run on a machine with a CUDA card and nvcc. ``--root`` takes the package
and ``chip_smoke.py`` from another checkout (default: this one), so two
versions of the kernels can be timed by one card in turns.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H) layers; each at the sequence lengths below
SHAPES = [(32, 650), (8, 650), (16, 650), (64, 650), (32, 130), (32, 260),
          (32, 1300)]
LENGTHS = (1, 2, 4, 8, 16, 35, 70)


PHASES = [("copies issued", 1, 2), ("group 0 landed", 2, 3),
          ("group 1 landed", 3, 4), ("product", 4, 5),
          ("cell update", 5, 6)]
# the backward's points (csrc/lstm.cu, LSTM_TRACE_POINT), step t from
# point 1 to point 7; the next step (t - 1) begins after point 7
BWD_PHASES = [("sums arrived and cell update", 1, 2), ("grid barrier", 2, 3),
              ("copies issued", 3, 4), ("share landed", 4, 5),
              ("product", 5, 6), ("sums sent", 6, 7)]


def _trace_call(torch, pk, lib, name, args, t, b, h, tdt, stream):
    """One traced launch of kernel ``name`` of the -DLSTM_TRACE library
    on the card tensors ``args`` (gx, wh, h0, c0, dy, dcT)."""
    gx, wh, h0, c0, dy, dct = args
    fn = getattr(lib, name)
    fn.argtypes = pk._LSTM_ARGTYPES[name] + [ctypes.c_void_p]
    if name == "lstm_bwd":
        _, c_all, gates = pk.lstm_fwd_reference(gx, wh, h0, c0)
        xb = pk._lstm_xb(dy)
        outs = [torch.empty_like(gates), torch.empty_like(c0),
                torch.empty_like(c0)]
        ptrs = [x.data_ptr() for x in (dy, gates, c_all, c0, dct, wh,
                                        outs[0])]
        ptrs += [None if xb is None else xb.data_ptr(), outs[1].data_ptr(),
                 outs[2].data_ptr()]
    else:
        outs = [torch.empty((t, b, h), dtype=tdt, device="cuda"),
                pk._lstm_hx(h0)]
        outs += ([torch.empty((b, h), dtype=tdt, device="cuda")]
                 if name == "lstm_infer" else
                 [torch.empty((t, b, h), device="cuda"),
                  torch.empty_like(gx)])
        ptrs = [x.data_ptr() for x in (gx, wh, h0, c0, outs[1], outs[0])
                ] + [x.data_ptr() for x in outs[2:]]
    for _ in range(2):   # the second launch's points are read
        rc = fn(*ptrs, pk._LSTM_DTYPES[tdt], t, b, h, stream)
        if rc != 0:
            raise RuntimeError("%s: CUDA error %d" % (name, rc))
    torch.cuda.synchronize()
    return outs


def trace(torch, cs, pk, seed, card):
    """Phase times of the three kernels from a -DLSTM_TRACE build."""
    from mxnet_tpu_torch.ops import _build

    out_dir = os.path.join(os.path.dirname(_build.source_path("lstm")),
                           os.pardir, "_build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "lstm_trace.so")
    subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS,
                    "-DLSTM_TRACE", "-o", lib_path,
                    _build.source_path("lstm")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    steps, points = 128, 8
    clk = (ctypes.c_longlong * ((steps + 1) * points))()
    ns = (ctypes.c_longlong * ((steps + 1) * points))()
    stream = torch.cuda.current_stream().cuda_stream
    t, b, h = cs.LSTM_PATH
    results = {"card": card, "trace": []}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        args = cs.lstm_inputs(torch, seed, cs.LSTM_PATH, tdt)
        for name in ("lstm_infer", "lstm_fwd", "lstm_bwd"):
            _trace_call(torch, pk, lib, name, args, t, b, h, tdt, stream)
            if lib.lstm_trace_read(clk, ns) != 0:
                raise RuntimeError("lstm_trace_read failed")
            c = np.array(clk, dtype=np.float64).reshape(steps + 1, points)
            n = np.array(ns, dtype=np.float64).reshape(steps + 1, points)
            per_cycle = (n[t, 0] - n[0, 0]) / (c[t, 0] - c[0, 0])
            mid = slice(1, t - 1)
            row = {"dtype": dtype, "kernel": name,
                   "launch_us": (n[t, 0] - n[0, 0]) / 1e3,
                   "sm_ghz": 1.0 / per_cycle}
            if name == "lstm_bwd":   # steps run from t - 1 down to 0
                row["prologue_us"] = (c[t - 1, 1] - c[0, 0]) * per_cycle / 1e3
                for label, a, z in BWD_PHASES:
                    row[label + " us"] = float(np.median(
                        c[mid, z] - c[mid, a])) * per_cycle / 1e3
                row["to next step us"] = float(np.median(
                    c[0:t - 2, 1] - c[1:t - 1, 7])) * per_cycle / 1e3
                row["step us"] = float(np.median(
                    c[0:t - 2, 1] - c[1:t - 1, 1])) * per_cycle / 1e3
            else:
                row["prologue_us"] = (c[0, 1] - c[0, 0]) * per_cycle / 1e3
                for label, a, z in PHASES:
                    row[label + " us"] = float(np.median(
                        c[mid, z] - c[mid, a])) * per_cycle / 1e3
                row["barrier us"] = float(np.median(
                    c[2:t, 1] - c[1:t - 1, 6])) * per_cycle / 1e3
                row["step us"] = float(np.median(
                    c[2:t, 1] - c[1:t - 1, 1])) * per_cycle / 1e3
            results["trace"].append(row)
            print("trace %s %s %s: launch %.2f us (SM %.3f GHz), prologue "
                  "%.2f us; a step (median) %.3f us: %s"
                  % (name, cs.LSTM_PATH, dtype, row["launch_us"],
                     row["sm_ghz"], row["prologue_us"], row["step us"],
                     ", ".join("%s %.3f" % (k[:-3], v) for k, v in row.items()
                               if k.endswith(" us") and k != "step us")),
                  flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the results as JSON")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", default=ROOT,
                   help="checkout whose kernels are timed")
    p.add_argument("--trace", action="store_true",
                   help="phase times inside the kernels instead")
    p.add_argument("--word-lm", type=int, default=0, metavar="N",
                   help="time the word-LM training phase N times instead")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lstm_step_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    card = cs.smi_line()
    print("card:", card, "kernels of", os.path.abspath(args.root))
    if args.word_lm:
        # as chip_smoke.main sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for _ in range(args.word_lm):
            cs.train_word_lm(torch, pk, argparse.Namespace(seed=args.seed,
                                                           profile=False))
            torch.cuda.empty_cache()
        return 0
    if args.trace:
        results = trace(torch, cs, pk, args.seed, card)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return 0
    setup = getattr(pk, "_lstm_hx", None)  # absent before the hx buffer
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {"card": card, "root": os.path.abspath(args.root),
               "layers": []}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        for b, h in SHAPES:
            if not pk.lstm_layer_fits(b, h, tdt):
                print("%s (B %d, H %d): does not fit a block" % (dtype, b, h))
                continue
            gx, wh, h0, c0, _, _ = cs.lstm_inputs(
                torch, args.seed, (max(LENGTHS), b, h), tdt)
            row = {"dtype": dtype, "B": b, "H": h,
                   "barrier_us": cs.barrier_ms(torch, h)[0] * 1e3,
                   "setup_ms": cs.time_ms(torch, lambda: setup(h0), flush,
                                          reps=50) if setup else 0.0}
            if hasattr(cs, "cluster_barriers_us"):
                row["bwd_barriers"] = cs.cluster_barriers_us(torch, h)
            dy, dct = cs.lstm_inputs(torch, args.seed + 1,
                                     (max(LENGTHS), b, h), tdt)[4:]
            _, c_all, gates = pk.lstm_fwd(gx, wh, h0, c0)
            calls = {"lstm_infer": lambda t: pk.lstm_infer(gx[:t], wh, h0,
                                                           c0),
                     "lstm_fwd": lambda t: pk.lstm_fwd(gx[:t], wh, h0, c0),
                     "lstm_bwd": lambda t: pk.lstm_bwd(
                         dy[:t], gates[:t], c_all[:t], c0, dct, wh)}
            for name, fn in calls.items():
                ms = [cs.time_ms(torch, lambda t=t: fn(t), flush, reps=30)
                      for t in LENGTHS]
                step, fixed = np.polyfit(LENGTHS, ms, 1)
                row[name] = {"ms": dict(zip(LENGTHS, ms)),
                             "step_us": float(step) * 1e3,
                             "fixed_ms": float(fixed)}
            results["layers"].append(row)
            print("%s B %3d H %4d: barrier %.3f us, set-up %.4f ms%s; %s"
                  % (dtype, b, h, row["barrier_us"], row["setup_ms"],
                     ", backward's barriers %s" % json.dumps(
                         row["bwd_barriers"]) if "bwd_barriers" in row
                     else "",
                     "; ".join("%s step %.3f us fixed %.4f ms (T=35 %.4f ms)"
                               % (n, row[n]["step_us"], row[n]["fixed_ms"],
                                  row[n]["ms"][35]) for n in calls)),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
