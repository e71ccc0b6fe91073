"""How far one training step of a deep ReLU + BatchNorm net moves with the
number of ranks: ResNet-50 v1 NHWC (fused epilogue) f32 at 32 images 224²,
SGD lr 0.02 momentum 0.9, cuDNN's deterministic algorithms and no TF32,
one `DistributedTrainer` step at one rank, and at two gloo ranks sharing
the card over ``fsdp`` 2 (76 parameters held as a rank's block), ``dp`` 2,
and ``fsdp`` 2 with no parameter split. Prints each run's loss and the
largest parameter differences from the one-rank step by name (absolute,
beside the tensor's largest magnitude).

    python3 tools/fsdp_rank_probe.py        # on the card; ~170 s

It builds the conv-epilogue kernels, then launches this script with
``--child AXIS OUT`` through the port's launcher (``python -m
mxnet_tpu_torch.launch -n N``) once a run."""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # repo
sys.path.insert(0, ROOT)


def child(axis, out):
    import torch

    import chip_smoke as cs
    from mxnet_tpu_torch import parallel

    cs.deterministic(torch)
    torch.cuda.set_device(0)
    parallel.init_process_group(backend="gloo")
    n = parallel.num_workers()
    rules = None
    if axis == "fsdp_nobn":
        rules = parallel.ShardingRules(fsdp_min_size=10 ** 9)
        axis = "fsdp"
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    with gnn.layout_scope():
        net = resnet50_v1(classes=1000, fuse_epilogue=True, device="cuda")
    net.initialize(seed=0)
    tr = parallel.DistributedTrainer(
        net, "sgd", {"learning_rate": 0.02, "momentum": 0.9, "wd": 1e-4},
        loss=gloss.SoftmaxCrossEntropyLoss(),
        mesh=parallel.make_mesh([(axis, n)]), rules=rules)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (32, 224, 224, 3))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, 32)).cuda()
    loss = float(tr.step(x, y)._data)
    tr.sync_params()
    if parallel.rank() == 0:
        np.savez(out, loss=np.array(loss), **{
            k: v.detach().float().cpu().numpy()
            for k, v in net.state_dict().items()})
    print("PROBE", axis, n, loss, len(tr._sharded), flush=True)


def main():
    import tempfile

    from mxnet_tpu_torch.ops import _build

    _build.build_all(["conv_epilogue"])
    tmp = tempfile.mkdtemp()
    runs = {}
    for name, n in (("one", 1), ("fsdp", 2), ("dp", 2), ("fsdp_nobn", 2)):
        axis = "fsdp" if name == "one" else name
        out = os.path.join(tmp, name + ".npz")
        r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch",
                            "-n", str(n), "--", sys.executable,
                            os.path.abspath(__file__), "--child", axis, out],
                           cwd=ROOT, capture_output=True, text=True)
        print(name, "rc", r.returncode,
              [ln for ln in r.stdout.splitlines() if "PROBE" in ln],
              r.stderr[-1500:] if r.returncode else "", flush=True)
        runs[name] = dict(np.load(out))
    ref = runs["one"]
    for name in ("fsdp", "dp", "fsdp_nobn"):
        got = runs[name]
        diffs = sorted(((float(np.abs(got[k] - ref[k]).max()),
                         float(np.abs(ref[k]).max()), k) for k in ref),
                       reverse=True)
        print(name, "loss", float(got["loss"]), "vs", float(ref["loss"]))
        print(name, "largest", diffs[:8])
        conv = [d for d in diffs if d[2].endswith("weight")
                and ref[d[2]].ndim == 4]
        print(name, "conv weights largest", conv[:4], "smallest", conv[-2:])


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
    else:
        main()
