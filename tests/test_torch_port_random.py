"""The random ops of the port against the JAX package, on the CPU.

Threefry and Philox cannot give the same bits (ROADMAP, the RNG contract),
so draws are compared by distribution:

1. `chip_smoke.check_random` on the host, the check the card's ``random``
   phase runs at 2^20 draws, here at 2^14 through ``mx.nd.random`` with
   ``ctx=mx.cpu()``: every drawing op's moments within 5 standard errors of
   its scipy distribution, a KS test for the continuous ones, each likely
   value's frequency for the discrete ones, ranges and dtypes, ``shuffle``
   a permutation, the multinomial's frequencies and ``get_prob``, the
   zipfian's unique rows; one seed twice gives the same bits, the next
   seed other draws.
2. Each drawing op against the JAX op at 2^14 draws from each side: the
   two samples' means within 5 standard errors of each other, a two-sample
   KS test for continuous draws, each value's frequency for discrete ones.
3. ``GridGenerator``, ``BilinearSampler`` and ``SpatialTransformer``
   (deterministic) against the JAX ops: values and ``jax.vjp`` gradients
   at rtol 1e-5.
4. The registrations: every JAX name and alias of the random, linalg and
   CTC ops exists in the port, and ``mx.nd`` / ``mx.sym`` have the JAX
   package's ``random``, ``linalg`` and ``contrib`` names; ``mx.random``
   gains ``seed(ctx=)``, ``get_state`` / ``set_state`` and the draws; a
   random op in a bound graph draws on the bound device.
5. ``context``'s ``num_gpus``, ``gpu_memory_info`` and ``cpu_pinned``, as
   the JAX package names them.
"""
import os
import sys

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

import mxnet_tpu as mx_j
import mxnet_tpu.ops as jops
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import ops as tops

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CPU = mx.cpu()
N = 1 << 14
SE = 5.0


def test_check_random_on_the_host():
    report = chip_smoke.check_random(mx, CPU, N, seed=3)
    assert len(report) == 19
    assert all(p is None or p > chip_smoke.RANDOM_KS_P
               for p in report.values())


# op -> (array parameters, attrs, continuous); each draws N values a
# distribution
TWO_SAMPLE = {
    "_random_uniform": ([], {"low": -1.0, "high": 3.0, "shape": (N,)}, True),
    "_random_normal": ([], {"loc": 1.0, "scale": 2.0, "shape": (N,)}, True),
    "_random_gamma": ([], {"alpha": 0.5, "beta": 2.0, "shape": (N,)}, True),
    "_random_exponential": ([], {"lam": 2.0, "shape": (N,)}, True),
    "_random_poisson": ([], {"lam": 4.0, "shape": (N,)}, False),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.4, "shape": (N,)},
                                  False),
    "_random_generalized_negative_binomial": (
        [], {"mu": 2.0, "alpha": 0.5, "shape": (N,)}, False),
    "_random_randint": ([], {"low": -3, "high": 7, "shape": (N,)}, False),
    "_sample_uniform": ([[0.0, -2.0], [1.0, 5.0]], {"shape": (N,)}, True),
    "_sample_normal": ([[0.0, 3.0], [1.0, 0.5]], {"shape": (N,)}, True),
    "_sample_gamma": ([[0.5, 3.0], [1.0, 2.0]], {"shape": (N,)}, True),
    "_sample_exponential": ([[1.0, 4.0]], {"shape": (N,)}, True),
    "_sample_poisson": ([[0.5, 10.0]], {"shape": (N,)}, False),
    "_sample_negative_binomial": ([[2.0, 5.0], [0.3, 0.7]], {"shape": (N,)},
                                  False),
    "_sample_generalized_negative_binomial": (
        [[1.0, 4.0], [0.5, 1.0]], {"shape": (N,)}, False),
    "_sample_multinomial": ([[[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]],
                            {"shape": (N,)}, False),
    "_sample_token": ([np.tile(chip_smoke.RANDOM_LOGITS, (N, 1))],
                      {"temperature": 0.7, "top_k": 5}, False),
}


def _rows(x):
    x = np.asarray(x, np.float64)
    return x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None]


@pytest.mark.parametrize("op", sorted(TWO_SAMPLE))
def test_draws_match_jax_in_distribution(op):
    params, attrs, continuous = TWO_SAMPLE[op]
    arrays = [np.asarray(p, np.float32) for p in params]
    want = jops.get(op).fn(jax.random.PRNGKey(11),
                           *[jnp.asarray(a) for a in arrays], **attrs)
    got = tops.get(op).fn(*[torch.tensor(a) for a in arrays], **attrs,
                          generator=torch.Generator().manual_seed(11))
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if op == "_sample_token":
        got, want = got.reshape(1, -1), np.asarray(want).reshape(1, -1)
    for g, w in zip(_rows(got.numpy()), _rows(want)):
        se = (g.var() / g.size + w.var() / w.size) ** 0.5
        assert abs(g.mean() - w.mean()) <= SE * max(se, 1e-12), op
        if continuous:
            assert stats.ks_2samp(g, w).pvalue > 1e-4, op
            continue
        for v in np.unique(w):
            pw, pg = (w == v).mean(), (g == v).mean()
            if pw >= 1e-3:
                se = (pw * (1 - pw) * 2 / w.size) ** 0.5
                assert abs(pg - pw) <= SE * se, (op, v)


def test_unique_zipfian_matches_jax():
    want = np.asarray(jops.get("_sample_unique_zipfian").fn(
        jax.random.PRNGKey(2), range_max=40, shape=(4096, 6)))
    got = tops.get("_sample_unique_zipfian").fn(
        range_max=40, shape=(4096, 6),
        generator=torch.Generator().manual_seed(2)).numpy()
    assert got.dtype == want.dtype == np.int32
    assert (np.sort(got, 1)[:, 1:] != np.sort(got, 1)[:, :-1]).all()
    for k in range(40):
        pw, pg = (want == k).any(1).mean(), (got == k).any(1).mean()
        se = max((pw * (1 - pw) * 2 / want.shape[0]) ** 0.5, 1e-3)
        assert abs(pg - pw) <= SE * se, k
    # the oversampled path of a huge range: unique rows within range
    big = tops.get("_sample_unique_zipfian").fn(
        range_max=1 << 24, shape=(2, 8),
        generator=torch.Generator().manual_seed(3)).numpy()
    assert big.shape == (2, 8) and big.min() >= 0 and big.max() < 1 << 24
    assert all(len(set(r)) == 8 for r in big)


def test_shuffle_is_a_permutation_of_rows():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = mx.nd.shuffle(mx.nd.array(x, ctx=CPU)).asnumpy()
    want = np.asarray(mx_j.nd.shuffle(mx_j.nd.array(x)).asnumpy())
    for out in (got, want):
        assert np.array_equal(out[np.argsort(out[:, 0])], x)


def _grid_inputs(seed=0):
    rng = np.random.RandomState(seed)
    theta = (np.tile([[0.9, 0.1, 0.05, -0.2, 1.1, 0.1]], (2, 1))
             + 0.1 * rng.randn(2, 6)).astype(np.float32)
    data = rng.randn(2, 3, 7, 9).astype(np.float32)
    flow = (2.0 * rng.randn(2, 2, 5, 6)).astype(np.float32)
    return theta, data, flow


DETERMINISTIC = {
    "GridGenerator affine": ("GridGenerator", ("theta",),
                             {"transform_type": "affine",
                              "target_shape": (5, 6)}),
    "GridGenerator warp": ("GridGenerator", ("flow",),
                           {"transform_type": "warp", "target_shape": (5, 6)}),
    "BilinearSampler": ("BilinearSampler", ("data", "grid"), {}),
    "SpatialTransformer": ("SpatialTransformer", ("data", "theta"),
                           {"target_shape": (5, 6)}),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_spatial_ops_match_jax_values_and_grads(case):
    op, names, attrs = DETERMINISTIC[case]
    theta, data, flow = _grid_inputs()
    grid = np.asarray(jops.get("GridGenerator").fn(
        jnp.asarray(theta), target_shape=(5, 6)))
    grid = (grid * 1.3).astype(np.float32)    # corners fall outside too
    inputs = [{"theta": theta, "data": data, "flow": flow,
               "grid": grid}[n] for n in names]
    want, vjp = jax.vjp(lambda *a: jops.get(op).fn(*a, **attrs),
                        *[jnp.asarray(a) for a in inputs])
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = tops.get(op).fn(*ts, **attrs)
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def _jax_names(modules):
    return sorted(n for n, op in jops._REGISTRY.items()
                  if op.fn.__module__ in modules)


def test_every_jax_name_is_registered():
    names = _jax_names(("mxnet_tpu.ops.random_ops", "mxnet_tpu.ops.linalg"))
    names += ["CTCLoss", "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss",
              "_contrib_flash_attention"]
    missing = [n for n in names if n not in tops.list_ops()]
    assert not missing
    canon = {op.name for n, op in jops._REGISTRY.items()
             if op.fn.__module__ == "mxnet_tpu.ops.random_ops"}
    assert len(canon) == 22
    assert len({op.name for n, op in jops._REGISTRY.items()
                if op.fn.__module__ == "mxnet_tpu.ops.linalg"}) == 15


@pytest.mark.parametrize("space", ["random", "linalg", "contrib"])
@pytest.mark.parametrize("pkg", ["nd", "sym"])
def test_namespaces_hold_the_jax_names(space, pkg):
    want = {n for n in dir(getattr(getattr(mx_j, pkg), space))
            if not n.startswith("_")}
    have = set(dir(getattr(getattr(mx, pkg), space)))
    ported = {"random": want, "linalg": want,
              "contrib": {"CTCLoss", "ctc_loss", "flash_attention",
                          "BatchNormRelu", "BatchNormAddRelu",
                          "adamw_update"}}[space]
    if pkg == "nd" and space == "contrib":
        ported |= {"foreach", "while_loop", "cond"}
    assert ported <= want
    assert ported <= have


def test_seed_state_and_draws_of_mx_random():
    mx.random.seed(5)
    a = mx.random.uniform(shape=(6,), ctx=CPU).asnumpy()
    state = mx.random.get_state()
    b = mx.random.normal(shape=(6,), ctx=CPU).asnumpy()
    mx.random.set_state(state)
    np.testing.assert_array_equal(
        mx.random.normal(shape=(6,), ctx=CPU).asnumpy(), b)
    mx.random.seed(5)
    np.testing.assert_array_equal(
        mx.nd.random.uniform(shape=(6,), ctx=CPU).asnumpy(), a)
    # a seed for one device leaves the others' streams alone
    mx.random.seed(5)
    mx.random.uniform(shape=(6,), ctx=CPU)
    mx.random.seed(9, ctx=CPU)
    c = mx.random.uniform(shape=(6,), ctx=CPU).asnumpy()
    mx.random.seed(9)
    np.testing.assert_array_equal(
        mx.random.uniform(shape=(6,), ctx=CPU).asnumpy(), c)
    assert mx.random.normal(shape=(2, 3), ctx=CPU).shape == (2, 3)
    assert mx.random.randint(0, 4, shape=(5,), ctx=CPU).dtype == np.int32
    assert sorted(mx.random.shuffle(
        mx.nd.arange(5, ctx=CPU)).asnumpy()) == [0, 1, 2, 3, 4]
    assert mx.random.multinomial(mx.nd.array([0.0, 1.0], ctx=CPU),
                                 shape=(3,)).asnumpy().tolist() == [1, 1, 1]


def test_symbol_random_op_draws_on_the_bound_device():
    s = mx.sym.random.uniform(low=2.0, high=3.0, shape=(4, 5))
    out = s.eval(ctx=CPU)[0].asnumpy()
    assert out.shape == (4, 5) and (out >= 2.0).all() and (out < 3.0).all()


def test_context_functions():
    assert mx.num_gpus() == mx.context.num_gpus() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert mx.cpu_pinned() == mx.cpu_pinned(0) != mx.cpu()
    assert mx.context.resolve_device(mx.cpu_pinned()) == torch.device("cpu")
    if torch.cuda.is_available():
        free, total = mx.context.gpu_memory_info(0)
        assert 0 < free <= total
    else:
        with pytest.raises(mx.MXNetError, match="no CUDA device"):
            mx.context.gpu_memory_info(0)
    for name in ("num_gpus", "gpu_memory_info", "cpu_pinned"):
        assert hasattr(mx_j.context, name) and hasattr(mx.context, name)
