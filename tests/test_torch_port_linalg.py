"""``mx.nd.linalg`` and the control-flow ops of ``mx.nd.contrib`` in the
port against the JAX package, on the CPU.

1. `chip_smoke.linalg_run` through each package: the 15 ``_linalg_*`` ops
   (``trsm`` and ``trmm`` in each side and transpose, ``syrk`` both ways)
   on batched f32 inputs, their outputs and the gradients of every input
   under ``autograd.record()`` for a random cotangent. ``gelqf`` and
   ``syevd`` are compared as their reconstructions (L Q, V^T diag(w) V)
   and as sign-aligned factors (L's diagonal positive; each eigenvector's
   largest component positive), their gradients through L^2, Q^2 and w,
   which the signs leave alone. rtol 1e-4 over a floor of 1e-4 x the
   largest magnitude: LAPACK through PyTorch and XLA factor in other
   orders.
2. `chip_smoke.control_flow_run` through each package: ``foreach`` (a tanh
   recurrence), ``while_loop`` (4 iterations of at most 4, and of at most
   7 with the outputs zero-padded) and ``cond`` (both branches), outputs
   and gradients within 1e-5. The gradient of ``foreach``'s data is left
   out: the JAX package's NDArray indexing is not on its tape.
3. Single ops through ``mx.nd`` (``linalg_gemm2`` at the top level, the
   output order of ``gelqf`` / ``syevd`` / ``slogdet``) and through
   ``mx.sym.linalg``.
"""
import os
import sys

import numpy as np

import mxnet_tpu as mx_j
import mxnet_tpu_torch as mx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CPU = mx.cpu()


def test_linalg_values_and_grads_match_jax():
    got = chip_smoke.linalg_run(mx, CPU, seed=0)
    want = chip_smoke.linalg_run(mx_j, mx_j.cpu(), seed=0)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len({g[0].split()[0] for g in got}) == 15
    chip_smoke.compare_runs("linalg", got, want, chip_smoke.LINALG_RTOL)


def test_control_flow_values_and_grads_match_jax():
    got = chip_smoke.control_flow_run(mx, CPU, seed=0)
    want = chip_smoke.control_flow_run(mx_j, mx_j.cpu(), seed=0)
    chip_smoke.compare_runs("control flow", got, want,
                            chip_smoke.CONTROL_FLOW_TOL)
    padded = dict(got)["while_loop max 7"][0]
    assert padded.shape[0] == 7 and not padded[4:].any()


def test_linalg_output_conventions():
    data = chip_smoke.linalg_inputs(1)
    w = mx.nd.array(data["W"], ctx=CPU)
    low, q = mx.nd.linalg.gelqf(w)
    assert low.shape == (2, 3, 3) and q.shape == (2, 3, 5)
    np.testing.assert_allclose(np.triu(low.asnumpy(), 1), 0.0, atol=1e-6)
    np.testing.assert_allclose(
        np.matmul(q.asnumpy(), q.asnumpy().transpose(0, 2, 1)),
        np.broadcast_to(np.eye(3), (2, 3, 3)), atol=1e-5)
    vt, ev = mx.nd.linalg.syevd(mx.nd.array(data["Y"], ctx=CPU))
    assert (np.diff(ev.asnumpy(), axis=-1) >= 0).all()
    sign, logdet = mx.nd.linalg.slogdet(mx.nd.array(data["A"], ctx=CPU))
    np.testing.assert_allclose(
        sign.asnumpy() * np.exp(logdet.asnumpy()),
        np.linalg.det(data["A"]), rtol=1e-4)
    a, b = (mx.nd.array(data[k], ctx=CPU) for k in "AB")
    np.testing.assert_allclose(
        mx.nd.linalg_gemm2(a, b, transpose_a=True).asnumpy(),
        np.matmul(data["A"].transpose(0, 2, 1), data["B"]), rtol=1e-5,
        atol=1e-5)


def test_symbol_linalg_matches_nd():
    data = chip_smoke.linalg_inputs(2)
    s = mx.sym.linalg.potrf(mx.sym.var("s"))
    got = s.eval(ctx=CPU, s=mx.nd.array(data["S"], ctx=CPU))[0].asnumpy()
    want = mx_j.nd.linalg.potrf(mx_j.nd.array(data["S"])).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
