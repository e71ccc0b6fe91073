"""The port's contrib ops (`mxnet_tpu_torch/ops/contrib.py`) against the
JAX package's (`mxnet_tpu/ops/contrib.py`), on the CPU.

The same numpy inputs, made from a seed, go through both; the JAX op runs
under ``jax.jit`` with its gradients by ``jax.vjp``, the port's eagerly
with autograd. Tolerances, and why:

* Every f32 value and gradient: 1e-5 relative to the element and to the
  array's largest magnitude (`chip_smoke.compare_runs`): XLA and PyTorch
  evaluate exp, log and the sums of the means and contractions in their
  own orders and approximations, a few ulps apart.
* The discrete outputs exactly: ``MultiBoxTarget``'s ``cls_target`` and
  ``loc_mask`` (which anchors match, which negatives the mining keeps),
  the ids of ``MultiBoxDetection`` (its kept set: -1 for the rest) and of
  ``box_nms``, ``Proposal``'s ROI order (its boxes within the tolerance:
  a reordering moves whole boxes), ``index_array``, ``arange_like``,
  ``boolean_mask``, ``index_copy``.
* One recorded exception: ``MultiBoxTarget``'s forced match. The JAX op
  scatters ``valid`` to each ground truth's best anchor and keeps the last
  write, so a padded label row (whose best anchor is anchor 0) after a
  valid box whose best anchor is anchor 0 unmatches it; the port takes
  the OR, the reference's meaning. A test pins the port's answer and the
  JAX package's at that input; every other case is held exactly.

The cases of the first test are the card phase's (`chip_smoke.py`
``detection``), at the small SSD and examples/rcnn/train.py's shapes.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx_j
from mxnet_tpu import ops as jops
from mxnet_tpu.ops import contrib as jc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.ops import contrib as tc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TOL = chip_smoke.DET_TOL


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs (the suite's workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_run(cases, seed):
    """`chip_smoke.detection_op_run`'s counterpart over the JAX ops: the
    outputs, then the gradients for the same random cotangents."""
    rng = np.random.RandomState(seed)
    out = []
    for label, op, args, attrs, grad, _exact in cases:
        fn = getattr(jc, op)
        names = [n for n, _ in args]
        at = [i for i, n in enumerate(names) if n in grad]
        vals = [jnp.asarray(a) for _, a in args]

        def f(*g, fn=fn, vals=vals, at=at, attrs=attrs):
            v = list(vals)
            for i, x in zip(at, g):
                v[i] = x
            r = fn(*v, **attrs)
            return tuple(r) if isinstance(r, (tuple, list)) else (r,)

        res, vjp = jax.vjp(jax.jit(f), *[vals[i] for i in at])
        arrays = [np.asarray(r) for r in res]
        if grad:
            cot = tuple(jnp.asarray(rng.randn(*r.shape).astype(np.float32))
                        for r in res)
            arrays += [np.asarray(g) for g in vjp(cot)]
        out.append((label, arrays))
    return out


def test_detection_ops_match_jax():
    """MultiBoxTarget (hard-negative mining 3), MultiBoxDetection,
    box_nms, Proposal (output_score), ROIAlign and ROIPooling (ReLU zeros,
    so bins tie) at the card phase's small shapes: values, gradients and
    the discrete parts."""
    cases = chip_smoke.detection_op_cases(0, full=False)
    got, _ = chip_smoke.detection_op_run(torch, "cpu", cases, 1)
    want = jax_run(cases, 1)
    chip_smoke.compare_detection("port vs JAX", cases, got, want)
    target = dict(got)["MultiBoxTarget"]
    cls_t = target[2]
    assert (cls_t > 0).any() and (cls_t == 0).any() and (cls_t < 0).any()
    for b in range(cls_t.shape[0]):
        assert (cls_t[b] == 0).sum() == 3 * (cls_t[b] > 0).sum()
    kept = dict(got)["MultiBoxDetection"][0][..., 0]
    assert 0 < (kept >= 0).sum() < kept.size
    assert (dict(got)["box_nms"][0][..., 1] == -1).any()


def test_multibox_target_forced_match_at_anchor_zero():
    """A valid box whose best anchor is anchor 0, then a padded row: the
    port keeps the forced match (the OR over valid boxes); the JAX
    package's last write drops it. Without the padded row both match."""
    anchors = np.array([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                         [0.4, 0.0, 0.9, 0.3]]], np.float32)
    labels = np.array([[[1, 0.0, 0.0, 0.12, 0.12],
                        [-1, 0, 0, 0, 0]]], np.float32)
    cls_pred = np.zeros((1, 3, 3), np.float32)
    port = tc.multibox_target(torch.from_numpy(anchors),
                              torch.from_numpy(labels),
                              torch.from_numpy(cls_pred))
    jtarget = jax.jit(jc.multibox_target)
    ref = jtarget(jnp.asarray(anchors), jnp.asarray(labels),
                  jnp.asarray(cls_pred))
    np.testing.assert_array_equal(port[2].numpy(), [[2.0, 0.0, 0.0]])
    np.testing.assert_array_equal(np.asarray(ref[2]), [[0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(port[1].numpy()[0, :4], 1.0)
    one = labels[:, :1]
    port1 = tc.multibox_target(torch.from_numpy(anchors),
                               torch.from_numpy(one),
                               torch.from_numpy(cls_pred))
    ref1 = jtarget(jnp.asarray(anchors), jnp.asarray(one),
                   jnp.asarray(cls_pred))
    for a, b in zip(port1, ref1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(port1[2].numpy(), [[2.0, 0.0, 0.0]])


def _nms_loop(boxes, alive, thresh, ids):
    """The greedy pass one box at a time over the port's f32 IoUs."""
    alive = alive.copy()
    iou = tc._box_iou_corner(torch.from_numpy(boxes[:, None]),
                             torch.from_numpy(boxes[None])).numpy()
    for i in range(len(boxes)):
        if alive[i]:
            kill = iou[i] > thresh
            if ids is not None:
                kill &= ids == ids[i]
            kill[:i + 1] = False
            alive &= ~kill
    return alive


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_greedy_nms_packs_words_at_every_boundary(n):
    """`_greedy_nms` (the suppression matrix packed 32 columns a word, one
    host sweep over the batch) against the loop, with and without ids,
    across word boundaries, in blocks of a few rows."""
    rng = np.random.RandomState(n)
    b = 3
    boxes = chip_smoke.det_labels_boxes(rng, b, n).astype(np.float32)
    alive = rng.rand(b, n) > 0.2
    ids = rng.randint(0, 2, (b, n)).astype(np.float32)
    old = tc._NMS_BLOCK
    tc._NMS_BLOCK = 7 * b * n     # 7 rows a block
    try:
        for use_ids in (False, True):
            got = tc._greedy_nms(torch.from_numpy(boxes),
                                 torch.from_numpy(alive), 0.3,
                                 torch.from_numpy(ids) if use_ids else None)
            for k in range(b):
                want = _nms_loop(boxes[k], alive[k], 0.3,
                                 ids[k] if use_ids else None)
                np.testing.assert_array_equal(got[k].numpy(), want)
    finally:
        tc._NMS_BLOCK = old


def test_roi_pooling_splits_tied_gradients_evenly():
    """A bin of equal maxima passes its gradient in equal shares, as the
    JAX op's scatter-max does."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 0, 1] = 2.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    x = torch.tensor(data, requires_grad=True)
    out = tc.roi_pooling(x, torch.from_numpy(rois), pooled_size=(2, 2))
    out.sum().backward()
    f = lambda d: jc.roi_pooling(d, jnp.asarray(rois),  # noqa: E731
                                 pooled_size=(2, 2)).sum()
    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(data)))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy()[0, 0, 2:, 2:], 0.25)


def _run_both(op, arrays, attrs, grad=()):
    """One op on both packages: (port outputs + grads, JAX outputs +
    grads, the JAX op under ``jax.jit``) as numpy, the gradients for one
    random cotangent a float output."""
    tfn, jfn = tops.get(op).fn, jops.get(op).fn
    ts = [torch.tensor(a, requires_grad=i in grad)
          for i, a in enumerate(arrays)]
    res = tfn(*ts, **attrs)
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    got = [r.detach().numpy() for r in res]
    rng = np.random.RandomState(3)
    cots = [rng.randn(*r.shape).astype(np.float32) for r in res]
    if grad:
        loss = sum((r * torch.from_numpy(c)).sum()
                   for r, c in zip(res, cots))
        got += [g.numpy() for g in torch.autograd.grad(
            loss, [ts[i] for i in grad])]
    vals = [jnp.asarray(a) for a in arrays]

    def f(*g):
        v = list(vals)
        for i, x in zip(grad, g):
            v[i] = x
        r = jfn(*v, **attrs)
        return tuple(r) if isinstance(r, (tuple, list)) else (r,)

    out, vjp = jax.vjp(jax.jit(f), *[vals[i] for i in grad])
    want = [np.asarray(o) for o in out]
    if grad:
        want += [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                                  for c in cots))]
    return got, want


_R = np.random.RandomState(11)
_X = _R.randn(2, 3, 6, 8).astype(np.float32)
# deformable offsets (N, dg x 2 x kh x kw, OH, OW): one group at stride 1,
# two at stride 2, dilation (1, 2) and pad (1, 2) of a 6 x 8 input
_OFF1 = (0.7 * _R.randn(2, 2 * 3 * 3, 6, 8)).astype(np.float32)
_OFF2 = (0.7 * _R.randn(2, 2 * 2 * 3 * 3, 3, 4)).astype(np.float32)
# the other registrations: (op, inputs, attrs, arguments with gradients,
# exact)
_SIMPLE = [
    ("_contrib_div_sqrt_dim", [_X], {}, (0,), False),
    ("_contrib_quadratic", [_X], {"a": 0.5, "b": -2.0, "c": 1.5}, (0,),
     False),
    ("_contrib_arange_like", [_X], {"start": 1.0, "step": 0.5}, (), True),
    ("_contrib_arange_like", [_X], {"axis": 2}, (), True),
    ("_contrib_BilinearResize2D", [_X], {"height": 11, "width": 5}, (0,),
     False),
    ("_contrib_BilinearResize2D", [_X], {"scale_height": 2.0}, (0,), False),
    ("_contrib_BilinearResize2D", [_X],
     {"height": 9, "width": 13, "align_corners": False}, (0,), False),
    ("_contrib_BilinearResize2D", [_X],
     {"height": 3, "width": 4, "align_corners": False}, (0,), False),
    ("_contrib_AdaptiveAvgPooling2D", [_X], {"output_size": (3, 4)}, (0,),
     False),
    ("_contrib_AdaptiveAvgPooling2D", [_X], {"output_size": 5}, (0,),
     False),
    ("_contrib_boolean_mask", [_X[0, 0], np.array([1, 0, 1, 1, 0, 0],
                                                  np.float32)], {}, (0,),
     True),
    ("_contrib_index_copy", [_X[0, 0], np.array([4, 1], np.float32),
                             _X[1, 0, :2]], {}, (0, 2), True),
    ("_contrib_index_array", [_X], {}, (), True),
    ("_contrib_index_array", [_X], {"axes": (1, 3)}, (), True),
    ("_contrib_fft", [_X[0, 0]], {}, (), False),
    ("_contrib_ifft", [_X[0, 0]], {}, (), False),
    ("_contrib_count_sketch",
     [_X[0, 0], np.array([3, 0, 1, 3, 2, 1, 0, 3], np.float32),
      np.array([1, -1, 1, 1, -1, 1, -1, 1], np.float32)],
     {"out_dim": 4}, (0,), False),
    ("SVMOutput", [_X[0, 0], np.array([1, 7, 0, 3, 3, 5], np.float32)],
     {"margin": 1.5, "regularization_coefficient": 0.5}, (0,), False),
    ("SVMOutput", [_X[0, 0], np.array([1, 7, 0, 3, 3, 5], np.float32)],
     {"use_linear": True}, (0,), False),
    ("_contrib_box_iou", [chip_smoke.det_labels_boxes(_R, 2, 5)
                          .astype(np.float32),
                          chip_smoke.det_labels_boxes(_R, 2, 4)
                          .astype(np.float32)], {}, (0, 1), False),
    ("_contrib_MultiBoxPrior", [_X], {"sizes": (0.3, 0.6),
                                      "ratios": (1, 2, 0.5), "clip": True},
     (), False),
    ("_contrib_DeformableConvolution",
     [_X, _OFF1, (0.3 * _R.randn(4, 3, 3, 3)).astype(np.float32),
      _R.randn(4).astype(np.float32)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4,
      "num_deformable_group": 1}, (0, 1, 2, 3), False),
    ("_contrib_DeformableConvolution",
     [_X[:, :2], _OFF2, (0.3 * _R.randn(4, 1, 3, 3)).astype(np.float32)],
     {"kernel": (3, 3), "stride": (2, 2), "dilate": (1, 2), "pad": (1, 2),
      "num_filter": 4, "num_group": 2, "num_deformable_group": 2,
      "no_bias": True}, (0, 1, 2), False),
]


@pytest.mark.parametrize("op,arrays,attrs,grad,exact", _SIMPLE,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_SIMPLE)])
def test_contrib_op_matches_jax(op, arrays, attrs, grad, exact):
    """Each other ported contrib op's values, and its gradients where the
    JAX op has them, within 1e-5; the integer-valued ones exactly."""
    got, want = _run_both(op, arrays, attrs, grad)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL,
                                       atol=TOL * max(np.abs(w).max(), 1))


def test_registered_names_are_the_jax_packages():
    """Every registration of the JAX contrib module (the two MoE ops
    too), under its name and aliases, one op each, in ``mx.nd.contrib`` /
    ``mx.sym.contrib`` (or at the top for ``ROIPooling`` /
    ``SVMOutput``); ``Proposal``'s output count follows
    ``output_score``."""
    names = {}
    for name in jops.list_ops():
        op = jops.get(name)
        if op.fn.__module__ == jc.__name__:
            names.setdefault(op.name, set()).add(name)
    assert {n for n in names if "moe" in n} == {"_contrib_switch_moe",
                                                "_contrib_topk_moe"}
    ported = names
    assert len(ported) == 24
    for name, aliases in ported.items():
        op = tops.get(name)
        assert op.fn.__module__ == tc.__name__, name
        for a in aliases:
            assert tops.get(a) is op, a
        short = name[len("_contrib_"):] if name.startswith("_contrib_") \
            else name
        nd_space = mx.nd.contrib if name.startswith("_contrib_") else mx.nd
        sym_space = mx.sym.contrib if name.startswith("_contrib_") \
            else mx.sym
        assert callable(getattr(nd_space, short)), name
        assert callable(getattr(sym_space, short)), name
        assert op.num_outputs == jops.get(name).num_outputs
    p = tops.get("_contrib_Proposal")
    assert p.num_outputs_fn({"output_score": True}) == 2
    assert p.num_outputs_fn({}) == 1


def test_nd_and_sym_forms():
    """``mx.nd.contrib.MultiBoxTarget`` returns its three outputs,
    ``mx.nd.contrib.MultiProposal(output_score=True)`` two, and
    ``mx.sym.contrib.MultiBoxPrior`` infers the anchors' shape and values
    from its input's."""
    cases = chip_smoke.detection_op_cases(2, full=False)
    with mx.cpu():
        args = dict(cases[0][2])
        outs = mx.nd.contrib.MultiBoxTarget(
            mx.nd.array(args["anchor"]), mx.nd.array(args["label"]),
            mx.nd.array(args["cls_pred"]), negative_mining_ratio=3)
        assert [o.shape for o in outs] == [
            (2, 4 * 352), (2, 4 * 352), (2, 352)]
        prop = dict(cases[3][2])
        rois, scores = mx.nd.contrib.MultiProposal(
            mx.nd.array(prop["cls_prob"]), mx.nd.array(prop["bbox_pred"]),
            mx.nd.array(prop["im_info"]), rpn_pre_nms_top_n=48,
            rpn_post_nms_top_n=12, rpn_min_size=4, scales=(2.0, 4.0),
            ratios=(1.0,), feature_stride=8, output_score=True)
        assert rois.shape == (24, 5) and scores.shape == (24, 1)
        x = mx.nd.array(_X)
        want = mx.nd.contrib.MultiBoxPrior(x, sizes=(0.3, 0.6),
                                           ratios=(1, 2)).asnumpy()
    s = mx.sym.contrib.MultiBoxPrior(mx.sym.var("x"), sizes=(0.3, 0.6),
                                     ratios=(1, 2))
    _, out_shapes, _ = s.infer_shape(x=_X.shape)
    assert out_shapes == [(1, 6 * 8 * 3, 4)]
    got = s.eval(ctx=mx.cpu(), x=mx.nd.array(_X, ctx=mx.cpu()))[0]
    np.testing.assert_array_equal(got.asnumpy(), want)
    jwant = mx_j.nd.contrib.MultiBoxPrior(mx_j.nd.array(_X),
                                          sizes=(0.3, 0.6), ratios=(1, 2))
    np.testing.assert_array_equal(want, jwant.asnumpy())
