"""The port's SSD family, detection pipeline and SSD weight carry against
the JAX package's, on the CPU.

1. ``ssd_test_tiny`` at 2 x 3 x 64 x 64 with the JAX net's weights carried
   by `convert.vision_params_from_jax`: the forward's three outputs within
   1e-4 (a ResNet-18 of f32 convolutions and BatchNorms summing in other
   orders); ``training_targets`` (``cls_target`` and ``loc_mask``
   exactly, ``loc_target`` within 1e-5); the loss, and one Adam step's
   parameter changes, within 1e-4 relative to each array's largest
   magnitude; ``detections`` exactly in ids and kept set, 1e-5 in scores
   and boxes.
2. The JAX package's tests/test_ssd.py cases restated against the port:
   shapes, the target encoding's inverse, the mining ratio, hybridize and
   symbol-trace parity, the augmenters, an ImageDetIter training step.
3. ``ssd_512_resnet50_v1``'s parameter names and shapes against the JAX
   symbol's shape inference at 512 x 512 (nothing is computed), its 61
   BatchNorms and 6,140 anchors; the base cut by role in both graphs; the
   conv epilogue's route at the card phase's SSD BatchNorm shapes.
4. ``ImageDetIter`` and every ``Det*`` augmenter under one numpy seed: the
   labels and the random draws exactly, the images exactly where the
   resize is nearest (``inter_method=0``) and within one uint8 level with
   bilinear resizes (the JAX package calls Pillow's BILINEAR, the port
   `torch.nn.functional.interpolate`, tests/test_torch_port_image.py).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import image as jimage
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, recordio
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import nn as tnn_ops
from mxnet_tpu_torch.ops import pallas_kernels as tpk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

LABELS = np.array([[[0, 0.1, 0.12, 0.45, 0.5], [2, 0.55, 0.5, 0.95, 0.9]],
                   [[1, 0.2, 0.3, 0.7, 0.8], [-1, 0, 0, 0, 0]]], np.float32)


def _close(got, want, rtol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    bad = np.abs(got - want) > rtol * np.abs(want) + floor
    assert not bad.any(), "%s: off by %g" % (what, np.abs(got - want).max())


def _to_jax(tnames, jnames):
    """Port parameter name -> the JAX net's: the top blocks matched by
    alias (`convert._net_prefixes`)."""
    tp = convert._net_prefixes(tnames)
    jp = convert._net_prefixes(jnames)
    assert sorted(tp) == sorted(jp)
    heads = {tp[a]: jp[a] for a in tp}

    def name(n):
        head, rest = n.split("_", 1)
        return heads.get(head + "_", head + "_") + rest

    return name


# the margin kept between every ReLU's input and the kink, as in
# tests/test_torch_port_vision_nets.py: the packages' f32 forwards differ
# by about 1e-6 there, and an input closer to 0 may take the other branch
# in one of them, where the gradient jumps by the whole cotangent
KINK = 2e-6


def _nets(num_classes=3):
    """The JAX ``ssd_test_tiny`` (Xavier, numpy seed 7), the port's with its
    weights, and an input of 2 x 3 x 64 x 64."""
    np.random.seed(7)
    jnet = jvision.ssd_test_tiny(num_classes=num_classes)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(0).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    jnet(jmx.nd.array(x))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tvision.ssd_test_tiny(num_classes=num_classes)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with torch.no_grad():
        tnet(torch.from_numpy(x))
    tnet.load_state_dict(convert.vision_params_from_jax(params, tnet))
    return jnet, tnet, x


def _kink_free(tnet, shape):
    """The first input of ``shape`` drawn from seeds 0, 1, ... on whose
    training forward every ReLU's input lies at least `KINK` from 0 (the
    running statistics restored after each try)."""
    closest = []
    relu = tnn_ops._ACTIVATIONS["relu"]

    def recording(x):
        closest.append(float(x.detach().abs().min()))
        return relu(x)

    tnn_ops._ACTIVATIONS["relu"] = recording
    try:
        for seed in range(100):
            x = np.random.RandomState(seed).uniform(0, 1, shape)
            x = x.astype(np.float32)
            state = {k: v.clone() for k, v in tnet.state_dict().items()}
            closest.clear()
            tnet.train()
            with torch.no_grad():
                tnet(torch.from_numpy(x))
            tnet.load_state_dict(state)
            tnet.eval()
            if min(closest) >= KINK:
                return x
    finally:
        tnn_ops._ACTIVATIONS["relu"] = relu
    raise AssertionError("no input keeps the ReLUs %g from the kink" % KINK)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs: the suite runs its files in
    parallel worker processes, where more threads a worker only contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return _nets()


def test_ssd_test_tiny_step_matches_jax(nets):
    """Forward, targets, loss, gradients, one Adam step and the detections
    of the carried net, in training mode (BatchNorm on batch statistics),
    at batch 8: at 64 x 64 the last two scales are 1 x 1 maps, so at batch
    2 their BatchNorms normalize 2 rows, where ``d / sqrt(d^2 + eps)``
    magnifies a rounding of d up to 1 / sqrt(eps) ~ 316 times (the
    inference forward at batch 2 is held below). The gradients within
    1e-4; Adam's first step is ``s(g) = lr g' / (|g'| + eps')``, g' = g /
    batch, eps' = eps / sqrt(1 - beta2) ~ 3.2e-7, steep where |g'| is
    near eps', so each element's step is held to the range s takes over
    its gradient's tolerance, beside 1e-4 of itself and one f32 rounding
    of the weight."""
    jnet, tnet, _ = nets
    jsaved = {k: p.data().copy() for k, p in jnet.collect_params().items()}
    tsaved = {k: v.clone() for k, v in tnet.state_dict().items()}
    try:
        _tiny_step(jnet, tnet)
    finally:     # the other tests take the nets as built
        for k, p in jnet.collect_params().items():
            p.set_data(jsaved[k])
        tnet.load_state_dict(tsaved)


def _tiny_step(jnet, tnet):
    x = _kink_free(tnet, (8, 3, 64, 64))
    labels = np.concatenate([LABELS] * 4)
    lr = 2e-3
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", {"learning_rate": lr})
    ttr = gluon.Trainer(tnet.collect_params(), "adam", {"learning_rate": lr})
    before = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()
              if p.grad_req != "null"}
    with jautograd.record():
        jout = jnet(jmx.nd.array(x))
        jt = jnet.training_targets(jout[2], jout[0], jmx.nd.array(labels))
        jloss = jvision.SSDMultiBoxLoss()(jout[0], jout[1], *jt)
    jloss.backward()
    with mx.cpu():
        with autograd.record():
            tout = tnet(mx.nd.array(x))
            tt = tnet.training_targets(tout[2], tout[0],
                                       mx.nd.array(labels))
            tloss = tvision.SSDMultiBoxLoss()(tout[0], tout[1], *tt)
        tloss.backward()
    for name, a, b in zip(("cls_preds", "loc_preds", "anchors"), tout, jout):
        _close(a.asnumpy(), b.asnumpy(), 1e-4, name)
    np.testing.assert_array_equal(tt[0].asnumpy(), jt[0].asnumpy())
    np.testing.assert_array_equal(tt[2].asnumpy(), jt[2].asnumpy())
    _close(tt[1].asnumpy(), jt[1].asnumpy(), 1e-5, "loc_target")
    assert (tt[0].asnumpy() > 0).any() and (tt[0].asnumpy() < 0).any()
    _close(float(tloss.asnumpy()), float(jloss.asnumpy()), 1e-4, "loss")
    name = _to_jax(list(tnet.collect_params()), list(before))
    tparams = {name(k): p for k, p in tnet.collect_params().items()}
    assert set(before) <= set(tparams)
    grads = {k: jnet.collect_params()[k].grad().asnumpy() for k in before}
    for k, g in grads.items():
        _close(tparams[k].grad().asnumpy(), g, 1e-4, "d" + k)
    jtr.step(8)
    with mx.cpu():
        ttr.step(8)
    eps = 1e-8 / np.sqrt(1 - 0.999)

    def adam(g):
        g = g / x.shape[0]
        return lr * g / (np.abs(g) + eps)

    for k, b0 in before.items():
        g = grads[k].astype(np.float64)
        tol_g = 1e-4 * (np.abs(g) + np.abs(g).max())
        reach = np.maximum(np.abs(adam(g + tol_g) - adam(g)),
                           np.abs(adam(g - tol_g) - adam(g)))
        jdelta = jnet.collect_params()[k].data().asnumpy() - b0
        tdelta = tparams[k].data().asnumpy() - b0
        err = np.abs(tdelta.astype(np.float64) - jdelta)
        bound = reach + 1e-4 * np.abs(jdelta) + 2.0 ** -23 * np.abs(b0).max()
        assert (err <= bound).all(), "%s: step off by %g beyond" % (
            k, (err - bound).max())
        assert np.abs(tdelta).max() <= lr * (1 + 1e-4)
    jdet = jnet.detections(*jout).asnumpy()
    tdet = tnet.detections(*tout).asnumpy()
    np.testing.assert_array_equal(tdet[..., 0], jdet[..., 0])
    _close(tdet[..., 1:], jdet[..., 1:], 1e-5, "detections")
    assert 0 < (tdet[..., 0] >= 0).sum() < tdet[..., 0].size


def test_ssd_forward_shapes_and_inference_detections(nets):
    """test_ssd.py's forward shapes, and the carried net's inference
    forward (moving statistics) and detections against JAX."""
    jnet, tnet, x = nets
    jout = jnet(jmx.nd.array(x))
    with mx.cpu():
        tout = tnet(mx.nd.array(x))
    a = tout[2].shape[1]
    assert tout[2].shape == (1, a, 4) and tout[0].shape == (2, a, 4)
    assert tout[1].shape == (2, 4 * a)
    anc = tout[2].asnumpy()
    assert (anc[..., 2] > anc[..., 0]).all() and \
        (anc[..., 3] > anc[..., 1]).all()
    for g, w in zip(tout, jout):
        _close(g.asnumpy(), w.asnumpy(), 1e-4)
    tdet = tnet.detections(*tout, nms_thresh=0.3,
                           force_suppress=True).asnumpy()
    jdet = jnet.detections(*jout, nms_thresh=0.3,
                           force_suppress=True).asnumpy()
    np.testing.assert_array_equal(tdet[..., 0], jdet[..., 0])
    _close(tdet[..., 1:], jdet[..., 1:], 1e-5)
    # tensors in, tensors out
    with torch.no_grad():
        raw = tnet(torch.from_numpy(x))
    t = tnet.training_targets(raw[2], raw[0], torch.from_numpy(LABELS))
    assert all(torch.is_tensor(v) for v in t)


def test_ssd_target_encode_decode_roundtrip(nets):
    """test_ssd.py: a matched anchor predicted with certainty decodes back
    to its ground truth (MultiBoxDetection inverts MultiBoxTarget)."""
    _, tnet, x = nets
    with mx.cpu():
        cls_preds, loc_preds, anchors = tnet(mx.nd.array(x[:1]))
        a = anchors.shape[1]
        gt = np.array([[[1, 0.22, 0.25, 0.58, 0.63]]], np.float32)
        cls_t, loc_t, _ = tnet.training_targets(anchors, cls_preds,
                                                mx.nd.array(gt))
        matched = cls_t.asnumpy()[0] == 2.0
        assert matched.sum() >= 1
        probs = np.zeros((1, 4, a), np.float32)
        probs[0, 2, matched] = 1.0
        probs[0, 0, ~matched] = 1.0
        det = mx.nd.contrib.MultiBoxDetection(
            mx.nd.array(probs), loc_t, anchors, nms_threshold=0.45)
    d = det.asnumpy()[0]
    kept = d[d[:, 0] == 1.0]
    best = kept[np.argmax(kept[:, 1])]
    np.testing.assert_allclose(best[2:6], gt[0, 0, 1:], atol=2e-2)


def test_ssd_hard_negative_mining_ratio(nets):
    """test_ssd.py: with ratio 3 each sample keeps 3 negatives a positive
    and ignores the rest; ratio -1 keeps every unmatched anchor."""
    _, tnet, x = nets
    with mx.cpu():
        cls_preds, _, anchors = tnet(mx.nd.array(x))
        labels = mx.nd.array(LABELS)
        ct = tnet.training_targets(anchors, cls_preds, labels,
                                   negative_mining_ratio=3)[0].asnumpy()
        ct2 = tnet.training_targets(anchors, cls_preds, labels,
                                    negative_mining_ratio=-1)[0].asnumpy()
    for b in range(2):
        pos, neg = (ct[b] > 0).sum(), (ct[b] == 0).sum()
        assert neg == 3 * pos and (ct[b] < 0).sum() == ct.shape[1] - 4 * pos
    assert (ct2 >= 0).all()


def test_ssd_hybridize_and_symbol_trace_parity(nets):
    """test_ssd.py: the outputs equal after ``hybridize()`` and through
    ``mx.sym`` (`Symbol.eval_with` over the parameters), where the
    anchors come from ``MultiBoxPrior`` reading each feature's H and W."""
    _, tnet, x = nets
    with mx.cpu():
        eager = [o.asnumpy() for o in tnet(mx.nd.array(x[:1]))]
        tnet.hybridize()
        again = [o.asnumpy() for o in tnet(mx.nd.array(x[:1]))]
        tnet.hybridize(False)
        outs = tnet(mx.sym.var("data", shape=(1, 3, 64, 64)))
        g = mx.sym.Group(list(outs))
        vals = {"data": mx.nd.array(x[:1])}
        vals.update({k: p.data() for k, p in
                     tnet.collect_params().items()})
        res = g.eval_with(vals)
    _, out_shapes, _ = g.infer_shape(data=(1, 3, 64, 64))
    assert out_shapes == [e.shape for e in eager]
    for e, a, r in zip(eager, again, res):
        np.testing.assert_array_equal(a, e)
        np.testing.assert_allclose(r.asnumpy(), e, rtol=1e-5, atol=1e-5)


# name: (image side, anchors, BatchNorms, parameter arrays incl. running
# statistics, trainable values) of the JAX package's nets
_FULL = {"ssd_512_resnet50_v1": (512, 6140, 61, 329, 31268704)}


def test_ssd_512_resnet50_v1_matches_jax_shape_inference():
    """Names and shapes of every parameter against the JAX symbol's
    `infer_shape` at 512 x 512 (both nets composed as symbols: nothing is
    computed), the anchors' count, the BatchNorms (53 in ResNet-50 v1
    through stage 4, 8 in the extras) and `get_model`."""
    side, anchors, n_bn, n_arrays, n_values = _FULL["ssd_512_resnet50_v1"]
    jnet = jvision.get_model("ssd_512_resnet50_v1")
    jsym = jmx.sym.Group(list(jnet(jmx.sym.var("data"))))
    arg, jout, aux = jsym.infer_shape(data=(1, 3, side, side))
    want = dict(zip(jsym.list_arguments(), arg))
    want.update(zip(jsym.list_auxiliary_states(), aux))
    tnet = tvision.get_model("ssd_512_resnet50_v1")
    tsym = mx.sym.Group(list(tnet(mx.sym.var("data"))))
    targ, tout, taux = tsym.infer_shape(data=(1, 3, side, side))
    got = dict(zip(tsym.list_arguments(), targ))
    got.update(zip(tsym.list_auxiliary_states(), taux))
    assert sorted(convert._net_prefixes(got)) == ["data", "resnetv", "ssd"]
    as_jax = _to_jax(list(got), list(want))
    assert {as_jax(k): tuple(v) for k, v in got.items() if k != "data"} \
        == {k: tuple(v) for k, v in want.items() if k != "data"}
    assert len(want) - 1 == n_arrays
    assert [tuple(s) for s in tout] == [tuple(s) for s in jout] == [
        (1, anchors, 21), (1, 4 * anchors), (1, anchors, 4)]
    assert sum(isinstance(m, tnn.BatchNorm) for m in tnet.modules()) == n_bn
    assert sum(int(np.prod(s)) for k, s in got.items()
               if k != "data" and not k.endswith(("running_mean",
                                                  "running_var"))) \
        == n_values


@pytest.mark.parametrize("label,r,c", chip_smoke.EPI_SSD_SHAPES)
def test_epilogue_layout_at_the_ssd_shapes(label, r, c):
    """The route each SSD BatchNorm shape of the card's epilogue cases
    takes in both dtypes: the extras' small maps the cluster route (R 32
    and 128), the stem and stage 4 the streamed one; none folds."""
    small = {"ssd-extra4-mid", "ssd-extra3-out", "ssd-extra4-out"}
    for itemsize in (2, 4):
        lay = tpk._epi_layout(r, c, itemsize)
        assert lay["route"] == ("cluster" if label in small
                                else "streamed"), (label, itemsize, lay)
        assert lay["l"] == 1 and lay["tx"] * lay["ty"] <= 256


@pytest.mark.parametrize("fused", [False, True])
def test_resnet_base_cut_by_role(fused):
    """The base is [stem .. stage 3] and [stage 4] in both ResNet graphs;
    in the reference graph the JAX package's index-7 cut holds the same
    children (by parameter names)."""
    blocks = tvision.ssd._resnet_base(1, 18, fuse_epilogue=fused)
    first, second = (list(b._children.values()) for b in blocks)
    assert first[-1].prefix.endswith("stage3_")
    assert [c.prefix[-7:] for c in second] == ["stage4_"]
    assert len(first) == (6 if fused else 7)
    if not fused:
        jblocks = jvision.ssd._resnet_base(1, 18)

        def tails(b):
            return [k.split("_", 1)[1] for k in b.collect_params()]

        assert [tails(b) for b in blocks] == [tails(b) for b in jblocks]


def test_convert_refuses_two_backbones():
    _, tnet, _ = _nets()
    params = {k: p.data().asnumpy() for k, p in
              tnet.collect_params().items()}
    params["resnetv19_x_weight"] = np.zeros(1, np.float32)
    with pytest.raises(MXNetError, match="not one network"):
        convert.vision_params_from_jax(params, tnet)


def test_ssd_factories_build():
    for name in ("ssd_300_resnet50_v1", "ssd_512_mobilenet1_0"):
        net = tvision.get_model(name, num_classes=4)
        jnet = jvision.get_model(name, num_classes=4)
        assert [k.split("_", 1)[1] for k in net.collect_params()] == \
            [k.split("_", 1)[1] for k in jnet.collect_params()]
    with pytest.raises(MXNetError, match="unsupported SSD base"):
        tvision.get_ssd("vgg16")
    with tnn.layout_scope():
        with pytest.raises(ValueError, match="channels-last"):
            tvision.ssd_test_tiny()


# ---------------------------------------------------------------------------
# the detection pipeline
# ---------------------------------------------------------------------------

def _img(seed, h=48, w=64):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


def _det_items(n):
    """im2rec detection labels [2, 5, obj...]: one or two boxes, one
    degenerate box now and then (dropped), one sample with none (skipped)."""
    items = []
    for i in range(n):
        boxes = [[i % 3, 0.2, 0.25, 0.6, 0.7]]
        if i % 2:
            boxes.append([(i + 1) % 3, 0.5, 0.5, 0.9, 0.95])
        if i % 4 == 3:
            boxes.append([1, 0.5, 0.5, 0.5, 0.9])
        if i == 2:
            boxes = [[0, 0.4, 0.4, 0.3, 0.5]]
        items.append([2.0, 5.0] + [v for b in boxes for v in b])
    return items


def _write_images(tmp_path, n):
    items = []
    for i, label in enumerate(_det_items(n)):
        p = tmp_path / ("img%d.png" % i)
        p.write_bytes(timage.imencode(_img(i, 40 + 4 * i, 64), fmt=".png"))
        items.append(label + [str(p)])
    return items


def _write_rec(tmp_path, items, index=True):
    rec = str(tmp_path / "det.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "det.idx"), rec, "w") \
        if index else recordio.MXRecordIO(rec, "w")
    for i, it in enumerate(items):
        with open(it[-1], "rb") as f:
            img = timage.imdecode(f.read(), to_ndarray=False)
        s = recordio.pack_img(recordio.IRHeader(0, np.asarray(
            it[:-1], np.float32), i, 0), img, img_fmt=".png")
        if index:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return rec


def _batches(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))


def _same(tb, jb, levels=0):
    assert len(tb) == len(jb) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert td.shape == jd.shape and tp == jp
        np.testing.assert_array_equal(tl, jl)
        assert np.abs(td - jd).max() <= levels


_AUG = dict(rand_crop=0.7, rand_pad=0.5, rand_mirror=True, brightness=0.2,
            mean=True, std=True)


@pytest.mark.parametrize("source", ["imglist", "rec", "rec-sequential"])
def test_image_det_iter_matches_jax(tmp_path, source):
    """ImageDetIter over an image list, an indexed .rec and one without
    an index, with random crop, pad, mirror and color jitter, numpy seeded
    alike: the same labels and draws, images exact with nearest resizes
    and within one level with bilinear ones; the label shape from the
    labels alone; the last batch padded."""
    items = _write_images(tmp_path, 7)
    src = {"imglist": items, "path_root": ""} if source == "imglist" else \
        {"path_imgrec": _write_rec(tmp_path, items,
                                   index=source == "rec")}
    for interp, levels in ((0, 0), (2, 1)):
        its = []
        for pkg in (timage, jimage):
            np.random.seed(5)
            its.append(pkg.ImageDetIter(3, (3, 32, 32), inter_method=interp,
                                        **_AUG, **src))
        tit, jit = its
        assert tit.label_shape == jit.label_shape == (2, 5)
        assert tit.provide_label[0].shape == (3, 2, 5)
        np.random.seed(6)
        tb = _batches(tit)
        np.random.seed(6)
        jb = _batches(jit)
        _same(tb, jb, levels)
        assert tb[-1][2] == 3 * len(tb) - 6     # 7 samples, 1 skipped
        tit.reset()
        jit.reset()
        np.random.seed(8)
        tb = _batches(tit)
        np.random.seed(8)
        _same(tb, _batches(jit), levels)


def test_det_augmenters_match_jax():
    """Each Det* augmenter alone, numpy seeded alike, 20 calls: the same
    images and labels."""
    lab = np.array([[1, 0.3, 0.3, 0.7, 0.7], [0, 0.05, 0.6, 0.3, 0.95]],
                   np.float32)
    cases = [
        ("DetHorizontalFlipAug", (0.5,), {}),
        ("DetRandomCropAug", (), {"min_object_covered": 0.5,
                                  "area_range": (0.3, 1.0)}),
        ("DetRandomPadAug", (), {"area_range": (1.0, 2.5)}),
        ("DetResizeAug", ((20, 30), 0), {}),
        ("CreateMultiRandCropAugmenter", (),
         {"min_object_covered": [0.1, 0.5, 0.9],
          "area_range": [(0.1, 1.0), (0.5, 1.0)], "skip_prob": 0.2}),
    ]
    for name, args, kwargs in cases:
        taug = getattr(timage, name)(*args, **kwargs)
        jaug = getattr(jimage, name)(*args, **kwargs)
        np.random.seed(9)
        tout = [taug(_img(i), lab) for i in range(20)]
        np.random.seed(9)
        jout = [jaug(_img(i), lab) for i in range(20)]
        for (ti, tl), (ji, jl) in zip(tout, jout):
            np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
            np.testing.assert_array_equal(tl, jl)
        assert json_kind(taug) == json_kind(jaug)
    borrow = timage.DetBorrowAug(timage.CastAug())
    out, same = borrow(_img(1), lab)
    assert out.dtype == np.float32 and same is lab
    rng = np.random.RandomState(3)
    flips = [timage.DetHorizontalFlipAug(0.5, rng=rng)(_img(2), lab)[1][0, 1]
             for _ in range(8)]
    np.random.seed(3)
    want = [0.3 if np.random.random_sample() >= 0.5 else
            np.float32(1.0) - np.float32(0.7) for _ in range(8)]
    np.testing.assert_array_equal(flips, np.asarray(want, np.float32))


def json_kind(aug):
    import json

    return json.loads(aug.dumps())[0]


def test_create_det_augmenter_chain_matches_jax():
    """CreateDetAugmenter's chain, augmenter by augmenter, and its output
    on one image under one seed."""
    kw = dict(resize=40, rand_crop=0.5, rand_pad=0.5, rand_gray=0.3,
              rand_mirror=True, mean=True, std=True, brightness=0.1,
              contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.05,
              inter_method=0)
    tchain = timage.CreateDetAugmenter((3, 24, 24), **kw)
    jchain = jimage.CreateDetAugmenter((3, 24, 24), **kw)
    assert [json_kind(a) for a in tchain] == [json_kind(a) for a in jchain]
    lab = np.array([[1, 0.3, 0.3, 0.7, 0.7]], np.float32)
    for seed in range(4):
        outs = []
        for chain in (tchain, jchain):
            np.random.seed(seed)
            img, lb = _img(seed), lab
            for aug in chain:
                img, lb = aug(img, lb)
            outs.append((np.asarray(img.asnumpy() if hasattr(img, "asnumpy")
                                    else img), lb))
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5,
                                   atol=1e-4)


def test_ssd_trains_from_det_iter(tmp_path):
    """test_ssd.py: iterator -> targets -> loss -> Trainer.step on the
    port."""
    it = timage.ImageDetIter(2, (3, 64, 64), imglist=_write_images(tmp_path,
                                                                   4),
                             path_root="", rand_mirror=True)
    net = tvision.ssd_test_tiny(num_classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-2})
    batch = it.next()
    with mx.cpu():
        with autograd.record():
            cls_preds, loc_preds, anchors = net(batch.data[0])
            t = net.training_targets(anchors, cls_preds, batch.label[0])
            loss = tvision.SSDMultiBoxLoss()(cls_preds, loc_preds, *t)
        loss.backward()
        trainer.step(2)
    assert np.isfinite(float(loss.asnumpy()))


def test_image_det_iter_reads_labels_without_decoding(tmp_path,
                                                      monkeypatch):
    """The label shape comes from the record headers: no image is decoded
    at construction."""
    rec = _write_rec(tmp_path, _write_images(tmp_path, 5))
    calls = []
    real = timage.imdecode
    monkeypatch.setattr(timage, "imdecode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    it = timage.ImageDetIter(2, (3, 16, 16), path_imgrec=rec)
    assert it.label_shape == (2, 5) and not calls
    it.next()
    assert len(calls) >= 2
    assert os.path.exists(rec[:-4] + ".idx")
