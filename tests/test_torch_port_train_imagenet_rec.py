"""The slice as a whole on the CPU: `python -m
mxnet_tpu_torch.train_imagenet --data-train ... --data-val ...` against the
JAX package's `io.ImageRecordIter` and `parallel.DistributedTrainer`.

* The first batch the port's script feeds its trainer (ImageRecordIter ->
  DevicePrefetcher -> the NHWC transpose) equals the JAX iterator's first
  batch from the same seed, transposed to NHWC, exactly.
* One f32 `resnet18_v1` step at 32 x 32 and 10 classes, from the JAX net's
  Xavier weights carried by `convert.resnet_params_from_jax`, gives the
  JAX step's loss within 1e-4 (both compute in f32 and sum in other
  orders). The JAX side runs its Pallas conv-epilogue kernels in
  interpret mode, with MXTPU_PALLAS_CONV_EPILOGUE=1 (which also makes the
  port build the same fused graph).
* Validation scores every sample but the padding, and leaves no pipeline
  thread running.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision

from mxnet_tpu_torch import convert, train_imagenet
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.parallel import DistributedTrainer

SEED = 3


def _leftover(before, timeout=5.0):
    """Names of the ``mxtpu-`` threads started since ``before`` (a
    `threading.enumerate()` snapshot) still alive after up to ``timeout``
    s of joining: a thread that delivered its end takes a moment to
    return; one left blocked does not."""
    deadline = time.monotonic() + timeout
    left = []
    for t in threading.enumerate():
        if t in before or not t.name.startswith("mxtpu-"):
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    return left


def _records(tmp_path, name, n, seed):
    prefix = str(tmp_path / name)
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, (rng.randint(34, 44), rng.randint(34, 44),
                                   3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(rng.randint(10)),
                                                   i, 0), img,
                                     img_fmt=".png"))
    w.close()
    return prefix + ".rec"


def _argv(train, val=None, extra=()):
    argv = ["--device", "cpu", "--network", "resnet18_v1", "--batch-size",
            "4", "--image-shape", "3,32,32", "--layout", "NHWC",
            "--num-classes", "10", "--dtype", "float32", "--seed", str(SEED),
            "--data-train", train, "--disp-batches", "1"]
    if val:
        argv += ["--data-val", val]
    return argv + list(extra)


@pytest.fixture
def captured(monkeypatch):
    """Every (data, label) the script hands `DistributedTrainer.step`."""
    seen = []
    step = DistributedTrainer.step

    def spy(self, data, label=None):
        seen.append((data.detach().clone(), label.detach().clone()))
        return step(self, data, label)

    monkeypatch.setattr(DistributedTrainer, "step", spy)
    return seen


def test_first_batch_and_first_step_loss_match_jax(tmp_path, monkeypatch,
                                                   captured):
    monkeypatch.setenv("MXTPU_PALLAS_CONV_EPILOGUE", "1")
    rec = _records(tmp_path, "train", 9, seed=1)

    # the JAX side: its iterator's first batch and one trainer step
    np.random.seed(SEED)
    jit = jmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                 batch_size=4, shuffle=True)
    jb = jit.next()
    jit.reset()   # joins the JAX iterator's pipeline threads
    jx = jmx.nd.transpose(jb.data[0], axes=(0, 2, 3, 1))
    jy = jb.label[0]
    np.random.seed(0)
    with jgluon.nn.layout_scope():
        jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((4, 32, 32, 3)))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    from mxnet_tpu.parallel import DistributedTrainer as JTrainer
    from mxnet_tpu.parallel import make_mesh

    jtr = JTrainer(jnet, "sgd", {"learning_rate": 0.1, "wd": 1e-4,
                                 "momentum": 0.9},
                   loss=jgluon.loss.SoftmaxCrossEntropyLoss(),
                   mesh=make_mesh([("dp", 1)], devices=jax.devices()[:1]))
    jloss = float(jtr.step(jx, jy.astype("float32")).asnumpy())

    # the port's script, its net initialised with the JAX net's weights
    state = convert.resnet_params_from_jax(params)

    def load_jax_weights(self, *args, **kwargs):
        self.load_state_dict(state, strict=True)

    monkeypatch.setattr(tresnet.ResNetV1, "initialize", load_jax_weights)
    losses = []
    train_imagenet.main(_argv(rec), batch_end_callback=lambda p:
                        losses.append(float(p.locals["loss"])))
    x0, y0 = captured[0]
    assert x0.shape == (4, 32, 32, 3) and x0.dtype == torch.float32
    np.testing.assert_array_equal(x0.numpy(), jx.asnumpy())
    np.testing.assert_array_equal(y0.numpy(), jy.asnumpy())
    assert len(captured) == len(losses) == 3   # 9 records, the last padded
    np.testing.assert_allclose(losses[0], jloss, rtol=1e-4, atol=1e-4)


def test_validation_scores_all_but_the_padding(tmp_path, captured):
    before = set(threading.enumerate())
    train = _records(tmp_path, "train", 6, seed=2)
    val = _records(tmp_path, "val", 7, seed=3)
    scored = []

    def on_eval(p):
        scored.append((p.nbatch, p.eval_metric.metrics[0].num_inst,
                       dict(p.eval_metric.get_name_value())))

    loss = train_imagenet.main(
        _argv(train, val, ["--top-k", "3", "--random-crop", "1",
                           "--random-mirror", "1", "--rgb-mean",
                           "123.68,116.779,103.939", "--rgb-std",
                           "58.393,57.12,57.375", "--data-nthreads", "2",
                           "--dtype", "bfloat16"]),
        eval_end_callback=on_eval)
    assert np.isfinite(loss)
    assert scored[0][:2] == (2, 7)   # 2 batches of 4, 1 padded sample
    assert set(scored[0][2]) == {"accuracy", "top_k_accuracy_3"}
    assert len(captured) == 2
    x = captured[0][0]
    assert abs(float(x.mean())) < 3.0 and float(x.abs().max()) < 3.0
    assert _leftover(before) == []


def test_record_paths_must_exist_and_the_card_is_the_default(tmp_path):
    with pytest.raises(MXNetError, match="no CUDA device"):
        train_imagenet.main(["--data-train", str(tmp_path / "t.rec")])
    with pytest.raises(MXNetError, match="missing.rec"):
        train_imagenet.main(["--device", "cpu", "--network", "resnet18_v1",
                             "--image-shape", "3,32,32", "--data-train",
                             str(tmp_path / "missing.rec")])
