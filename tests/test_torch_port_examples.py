"""Ten of the JAX package's examples run through the port, and the port's
``train_imagenet --model-prefix`` export served by both packages, on the
CPU.

1. ``examples/ctc/lstm_ocr.py --steps 2 --batch 4`` (its short-run exit:
   the accuracy gate applies from 300 steps),
   ``examples/serving/generate_lm.py --requests 2 --max-new 2``,
   ``examples/ssd/train.py --epochs 1 --batch-size 4 --samples 16``,
   ``examples/rcnn/train.py --steps 8 --image-size 48`` (the arguments
   tests/test_examples.py gives them),
   ``examples/quantization/quantize_lenet.py --smoke`` (its own gate: the
   int8 accuracy within 6 % of the f32 one, after entropy calibration),
   ``examples/profiler/profile_training.py --steps 2`` (its trace
   written under the test's temporary directory) and
   ``examples/sparse/linear_classification.py`` at its own 150 steps (its
   own gate: accuracy above 0.8),
   ``examples/image_classification/train_imagenet.py`` (resnet18_v1,
   NHWC, 4 x 3 x 32 x 32), ``examples/moe/train_moe.py --steps 8`` and
   ``examples/distributed/train_dist.py --steps 4`` (its ``--tp 2`` needs
   two ranks and a ``tp`` axis: ROADMAP queue 1 item 11 part 2) end with
   rc 0 with ``mxnet_tpu`` aliased to ``mxnet_tpu_torch`` by an import
   hook, under ``context.scope(cpu())``, in a process of their own.
   ``import jax`` is answered by `chip_smoke.jax_standin` (the last three
   call ``jax.devices()`` themselves; the stand-in gives the port's
   `parallel.devices()`), and the hook checks that no real jax was
   imported. ``JAX_PLATFORMS`` is left out of their environment: scripts
   import jax when it is set, and the port must run them without it.
2. ``python -m mxnet_tpu_torch.train_imagenet --device cpu --model-prefix
   P`` (resnet18_v1, 2 steps, 32 x 32 images, 10 classes) writes
   ``P-symbol.json`` and ``P-0000.params``; the port's ``Predictor`` and
   ``mxnet_tpu.predict.Predictor`` load them and agree within 1e-4 of the
   logits' largest magnitude (two convolution stacks summing in other
   orders; two steps at lr 0.1 leave the logits large).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx_j
import mxnet_tpu.predict  # noqa: F401
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import train_imagenet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs argv[1] as __main__ with every ``mxnet_tpu`` import answered by the
# port's module of the same path
_ALIASED = r"""
import importlib, importlib.abc, importlib.util, runpy, sys


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


sys.meta_path.insert(0, Alias())
import mxnet_tpu_torch as mx
import chip_smoke

standin = sys.modules["jax"] = chip_smoke.jax_standin()

script, sys.argv = sys.argv[1], sys.argv[1:]
try:
    with mx.context.scope(mx.cpu()):
        runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
assert sys.modules["jax"] is standin, "a real jax was imported"
assert not [m for m in sys.modules if m.startswith("jax.")], "jax imported"
"""


@pytest.mark.parametrize("script,args", [
    ("ctc/lstm_ocr.py", ["--steps", "2", "--batch", "4"]),
    ("serving/generate_lm.py", ["--requests", "2", "--max-new", "2"]),
    ("ssd/train.py", ["--epochs", "1", "--batch-size", "4", "--samples",
                      "16"]),
    ("rcnn/train.py", ["--steps", "8", "--image-size", "48"]),
    ("quantization/quantize_lenet.py", ["--smoke"]),
    ("profiler/profile_training.py", ["--steps", "2"]),
    ("sparse/linear_classification.py", []),
    ("image_classification/train_imagenet.py",
     ["--network", "resnet18_v1", "--batch-size", "4", "--num-batches", "4",
      "--num-classes", "10", "--image-shape", "3,32,32", "--layout",
      "NHWC"]),
    ("moe/train_moe.py", ["--steps", "8"]),
    ("distributed/train_dist.py", ["--steps", "4"]),
])
def test_example_runs_through_the_port(script, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT,
               MXTPU_PROFILE_OUT=str(tmp_path / "profile.json"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _ALIASED,
         os.path.join(ROOT, "examples", script)] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


def test_train_imagenet_model_prefix_serves_in_both_packages(tmp_path):
    prefix = str(tmp_path / "r18")
    train_imagenet.main(["--device", "cpu", "--network", "resnet18_v1",
                         "--batch-size", "2", "--image-shape", "3,32,32",
                         "--num-classes", "10", "--num-batches", "2",
                         "--dtype", "float32", "--model-prefix", prefix])
    sym_file, params = prefix + "-symbol.json", prefix + "-0000.params"
    assert os.path.exists(sym_file) and os.path.exists(params)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    ours = mx.predict.Predictor(sym_file, params, ctx=mx.cpu(),
                                input_shapes={"data": x.shape})
    ours.forward(data=x)
    got = ours.get_output(0).asnumpy()
    ref = mx_j.predict.Predictor(sym_file, params,
                                 input_shapes={"data": x.shape})
    ref.forward(data=x)
    want = np.asarray(ref.get_output(0))
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
