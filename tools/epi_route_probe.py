"""Time the conv epilogue's two reductions (`epi_stats`, `epi_bwd_reduce`
with the ReLU mask) at small-R and wide shapes, in variants of
``csrc/conv_epilogue.cu`` built side by side: the source as it is, and
copies with one layout constant changed (clusters of 8 only, cluster tiles
of 8 packs only, the streamed route only). With ``--parent DIR`` a second
checkout's source (a parent unpacked by ``git archive``) is built and timed
through its C interface in the same process, right after the variants at
each shape.

Every variant is checked against the plain versions before it is timed.
Run on the card's machine, from the repo root:

    python3 tools/epi_route_probe.py [--parent _checkout/parent]

Prints one line a (shape, dtype): ms of stats / bwd for each variant, the
route ("C" cluster, "S" streamed), the cluster size K and the tiles.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "conv_epilogue.cu")
VARIANTS = {
    "built": [],
    "k8": [("constexpr int kClusterWideTiles = 8;",
            "constexpr int kClusterWideTiles = 0;")],
    "tile8": [("twc < 32 &&", "twc < 8 &&")],
    "streamed": [("constexpr long long kClusterBytesPerBlock = 400 * 1024;",
                  "constexpr long long kClusterBytesPerBlock = 0;")],
}
SHAPES = [(8192, 448), (8192, 192), (6272, 2048), (6272, 1024), (6272, 512),
          (25088, 256), (25088, 1024), (36992, 192), (16384, 64), (1003, 3),
          (6422528, 3), (401408, 256), (2765952, 64)]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def build(src_text, out_dir, tag):
    from mxnet_tpu_torch.ops import _build

    path = os.path.join(out_dir, tag + ".cu")
    with open(path, "w") as f:
        f.write(src_text)
    lib = os.path.join(out_dir, "lib%s.so" % tag)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    return subprocess.Popen([_build.cuda_tool("nvcc"), *flags, "-o", lib,
                             path]), lib


def bind(lib):
    lib.epi_stats.argtypes = [_P, _I, _L, _I, _P, _P, _I, _F, _I, _P, _I] \
        + [_P] * 6
    lib.epi_bwd_reduce.argtypes = [_P, _P, _P, _I, _L, _I, _P, _P, _P, _I,
                                   _I, _P, _I] + [_P] * 6
    if hasattr(lib, "epi_layout_query"):
        lib.epi_layout_query.argtypes = [_I, _L, _I, _I, _P]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose conv_epilogue.cu is timed too")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch.ops import pallas_kernels as pk

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(cs.smi_line(), flush=True)
    src = open(SRC).read()
    with tempfile.TemporaryDirectory(prefix="epi_probe_") as out_dir:
        run(args, src, out_dir, torch, cs, pk)


def run(args, src, out_dir, torch, cs, pk):
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit("variant %s: %r not in the source"
                                 % (name, a))
            text = text.replace(a, b)
        procs[name] = build(text, out_dir, name)
    if args.parent:
        procs["parent"] = build(open(os.path.join(
            args.parent, "mxnet_tpu_torch", "csrc",
            "conv_epilogue.cu")).read(), out_dir, "parent")
    libs = {}
    for name, (proc, lib) in procs.items():
        if proc.wait() != 0:
            raise SystemExit("nvcc failed for " + name)
        libs[name] = bind(ctypes.CDLL(lib))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for r, c in SHAPES:
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            code = 1 if dtype == "bfloat16" else 0
            g = torch.Generator(device="cuda").manual_seed(1)
            x = (torch.randn(r, c, generator=g, device="cuda") * 2 + 3) \
                .to(tdt)
            ct = torch.randn(r, c, generator=g, device="cuda").to(tdt)
            out = torch.relu(x)
            gamma = torch.rand(c, generator=g, device="cuda") + 0.5
            beta = torch.randn(c, generator=g, device="cuda")
            want = pk.epi_stats_reference(x, gamma, beta, 1e-5, False)
            mean, inv = want[0], want[2]
            vecs = torch.empty((5, c), dtype=torch.float32, device="cuda")
            grads = torch.empty((2, c), dtype=torch.float32, device="cuda")
            line = []
            for name, lib in libs.items():
                q = (ctypes.c_int * 9)()
                if name == "parent":   # the two-pass kernels: part (2, n, C)
                    n = max(1, min(1024, -(-r // 128)))
                    q[3], q[7], q[8], q[6] = 0, n, 0, 0
                else:
                    lib.epi_layout_query(code, r, c, 1, q)
                part = None if q[3] else torch.empty(
                    (2, q[7], c), dtype=torch.float32, device="cuda")
                pptr = None if part is None else part.data_ptr()

                def stats(lib=lib, pptr=pptr, n=q[7]):
                    rc = lib.epi_stats(x.data_ptr(), code, r, c,
                                       gamma.data_ptr(), beta.data_ptr(), 0,
                                       1e-5, 0, pptr, n,
                                       *(v.data_ptr() for v in vecs), stream)
                    assert rc == 0, rc

                def bwd(lib=lib, pptr=pptr, n=q[7]):
                    rc = lib.epi_bwd_reduce(
                        ct.data_ptr(), x.data_ptr(), out.data_ptr(), code, r,
                        c, mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
                        0, 0, pptr, n, grads[0].data_ptr(),
                        grads[1].data_ptr(),
                        *(v.data_ptr() for v in vecs[:3]), stream)
                    assert rc == 0, rc

                stats()
                torch.cuda.synchronize()
                cs.max_err(torch, vecs[0], want[0], 1e-4, name + " mean")
                cs.max_err(torch, vecs[1], want[1], 1e-4, name + " var")
                line.append("%s %s K%d tiles%d %.4f / %.4f" % (
                    name, "C" if q[3] else "S", q[8], q[6],
                    cs.time_ms(torch, stats, flush, 50),
                    cs.time_ms(torch, bwd, flush, 50)))
            print("(%d, %d) %s | %s" % (r, c, dtype, " | ".join(line)),
                  flush=True)
            del x, ct, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
