"""The port's Gluon recurrent cells against the JAX package's.

Each cell of `gluon.rnn` (RNN, LSTM and GRU cells, the sequential stack,
the dropout, zoneout and residual modifiers, the bidirectional cell) and
of `gluon.contrib.rnn` (`VariationalDropoutCell`, `LSTMPCell`,
`dynamic_unroll`, the nine convolutional cells) runs in both packages on
one numpy input with the JAX cell's weights, carried over by
`convert.gluon_cell_params_from_jax`: a step, `unroll` in NTC (merged) and
TNC (a list of steps), with ``valid_length``, and the gradients of a
random linear loss. Random masks are compared by their rate, never bit
for bit (threefry against Philox). A stack of `LSTMCell`s unrolled equals
the fused `gluon.rnn.LSTM` holding its weights
(`convert.fused_rnn_params_from_cells`), the JAX package's LSTM run by its
Pallas kernel in interpret mode, as its own tests run it. Also
`gluon.contrib.data` (`IntervalSampler`'s order exactly, `WikiText2` over
a tiny token file), and `mx.rnn`'s new cells and `FusedRNNCell.unfuse`
(bidirectional, with dropout) against the JAX package's graphs.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import data as jdata
from mxnet_tpu.gluon.contrib import rnn as jcrnn
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import rnn as prnn
from mxnet_tpu_torch.gluon.contrib import data as pdata
from mxnet_tpu_torch.gluon.contrib import rnn as pcrnn

import chip_smoke

# f32 on both sides, in other summation orders
TOL = 1e-5
T, B, C, H = 4, 3, 5, 6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.context.scope(mx.cpu()):
        yield


def _close(got, want, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got,
                     np.float64)
    want = np.asarray(want.asnumpy() if hasattr(want, "asnumpy") else want,
                      np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def _carry(jcell, pcell):
    """The JAX cell's initialized weights onto the port cell."""
    params = {n: p.data().asnumpy()
              for n, p in jcell.collect_params().items()}
    ours = pcell.collect_params()
    for n, a in convert.gluon_cell_params_from_jax(params, pcell).items():
        p = ours[n]
        if p._nd is None:
            p.shape = a.shape
            p.initialize(ctx=mx.cpu())
        p.set_data(mx.nd.array(a))


def _rand(seed, *shape, scale=1.0):
    return np.random.RandomState(seed).uniform(
        -scale, scale, shape).astype(np.float32)


def _both(make, seed=0):
    """A JAX cell and its port twin with the JAX cell's weights."""
    jcell = make(jrnn, jcrnn)
    jcell.initialize(jmx.init.Uniform(0.5))
    pcell = make(prnn, pcrnn)
    pcell.initialize()
    _carry(jcell, pcell)
    return jcell, pcell


def _unroll_grads(pkg, cell, x, layout, merge, valid_length=None, seed=7):
    """``cell.unroll`` over ``x`` with the gradient of a random linear loss
    of its outputs and states: (outputs, states, the input's gradient,
    [(the parameter's field, gradient)])."""
    xx = pkg.nd.array(x)
    xx.attach_grad()
    length = x.shape[layout.find("T")]
    vl = None if valid_length is None else pkg.nd.array(valid_length)
    with pkg.autograd.record(train_mode=False):
        out, states = cell.unroll(length, xx, layout=layout,
                                  merge_outputs=merge, valid_length=vl)
        outs = out if isinstance(out, list) else [out]
        loss = None
        for k, o in enumerate(outs + list(states)):
            term = (o * pkg.nd.array(_rand(seed + k, *o.shape))).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    # in registration order: auto-named children's names follow each
    # package's counters
    grads = [(n.rsplit("_", 2)[-2:], p.grad().asnumpy())
             for n, p in cell.collect_params().items()
             if p.grad_req != "null"]
    return outs, states, xx.grad, grads


def _check_unroll(jcell, pcell, x, layout, merge, valid_length=None):
    jo, js, jdx, jg = _unroll_grads(jmx, jcell, x, layout, merge,
                                    valid_length)
    po, ps, pdx, pg = _unroll_grads(mx, pcell, x, layout, merge,
                                    valid_length)
    assert len(po) == len(jo) and len(ps) == len(js)
    for k, (a, b) in enumerate(zip(po, jo)):
        _close(a, b, "output %d" % k)
    for k, (a, b) in enumerate(zip(ps, js)):
        _close(a, b, "state %d" % k)
    _close(pdx, jdx, "input gradient")
    assert [f for f, _ in pg] == [f for f, _ in jg]
    for (f, a), (_, b) in zip(pg, jg):
        _close(a, b, "_".join(f))


CELLS = {
    "rnn_tanh": lambda r, c: r.RNNCell(H, input_size=C),
    "rnn_relu": lambda r, c: r.RNNCell(H, activation="relu", input_size=C),
    "lstm": lambda r, c: r.LSTMCell(H, input_size=C),
    "gru": lambda r, c: r.GRUCell(H, input_size=C),
}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_step_matches_jax(kind):
    jcell, pcell = _both(CELLS[kind])
    x = _rand(1, B, C)
    states = [_rand(2 + k, B, H, scale=0.5)
              for k in range(len(jcell.state_info(B)))]
    jo, js = jcell(jmx.nd.array(x), [jmx.nd.array(s) for s in states])
    po, ps = pcell(mx.nd.array(x), [mx.nd.array(s) for s in states])
    _close(po, jo)
    for a, b in zip(ps, js):
        _close(a, b)
    assert [i["shape"] for i in pcell.state_info(B)] == \
        [i["shape"] for i in jcell.state_info(B)]


@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", False)])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_unroll_and_gradients_match_jax(kind, layout, merge):
    jcell, pcell = _both(CELLS[kind])
    shape = (B, T, C) if layout == "NTC" else (T, B, C)
    _check_unroll(jcell, pcell, _rand(3, *shape), layout, merge)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_unroll_valid_length_matches_jax(layout):
    jcell, pcell = _both(CELLS["lstm"])
    shape = (B, T, C) if layout == "NTC" else (T, B, C)
    _check_unroll(jcell, pcell, _rand(4, *shape), layout, True,
                  valid_length=np.array([4, 2, 3], np.float32))


def test_deferred_input_size_takes_the_first_input():
    cell = prnn.LSTMCell(H)
    cell.initialize()
    out, _ = cell.unroll(T, mx.nd.array(_rand(5, B, T, C)), layout="NTC")
    assert out.shape == (B, T, H)
    assert cell.i2h_weight.shape == (4 * H, C)


def _stack(r, c):
    s = r.SequentialRNNCell()
    with s.name_scope():
        s.add(r.LSTMCell(H, input_size=C))
        s.add(r.DropoutCell(0.5))
        s.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
        s.add(r.ZoneoutCell(r.RNNCell(H, input_size=H), 0.3, 0.3))
    return s


MODIFIED = {
    "sequential_dropout_residual_zoneout": _stack,
    "bidirectional": lambda r, c: r.BidirectionalCell(
        r.LSTMCell(H, input_size=C), r.GRUCell(H, input_size=C)),
    "residual": lambda r, c: r.ResidualCell(r.GRUCell(C, input_size=C)),
}


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", sorted(MODIFIED))
def test_stacks_and_modifiers_match_jax(kind, layout):
    """Outside training the dropout and zoneout masks keep every unit, so
    the stacks are deterministic and must agree."""
    jcell, pcell = _both(MODIFIED[kind])
    shape = (B, T, C) if layout == "NTC" else (T, B, C)
    _check_unroll(jcell, pcell, _rand(6, *shape), layout,
                  layout == "NTC")
    assert len(pcell.state_info(B)) == len(jcell.state_info(B))


def test_bidirectional_cell_cannot_be_stepped():
    cell = prnn.BidirectionalCell(prnn.LSTMCell(H), prnn.LSTMCell(H))
    with pytest.raises(mx.MXNetError):
        cell(mx.nd.zeros((B, C)), [])


def _drop_rate(pkg, cell, x):
    with pkg.autograd.record(train_mode=True):
        out, _ = cell.unroll(x.shape[1], pkg.nd.array(x), layout="NTC")
    return float((out.asnumpy() == 0).mean())


def test_dropout_cell_drops_at_its_rate_in_both():
    """Training-mode masks: the dropped share of 500 x 2 x 200 units is
    the rate in both packages, within 5 standard deviations."""
    x = np.ones((500, 2, 200), np.float32)
    p = 0.3
    sd = np.sqrt(p * (1 - p) / x.size)
    mx.random.seed(1)
    jmx.random.seed(1)
    for pkg, r in ((jmx, jrnn), (mx, prnn)):
        rate = _drop_rate(pkg, r.DropoutCell(p), x)
        assert abs(rate - p) < 5 * sd, (pkg.__name__, rate)


def test_zoneout_keeps_previous_units_at_its_rate_in_both():
    """A zoneout of 0.4 over a cell whose output moves every step: the
    share of output units equal to the previous step's is about 0.4 in
    both packages."""
    x = np.random.RandomState(8).uniform(0.5, 1.0, (64, 3, 40)).astype(
        np.float32)
    rates = []
    for pkg, r in ((jmx, jrnn), (mx, prnn)):
        cell = r.ZoneoutCell(r.RNNCell(40, input_size=40, activation="relu"),
                             zoneout_outputs=0.4)
        cell.initialize(pkg.init.One())
        with pkg.autograd.record(train_mode=True):
            out, _ = cell.unroll(3, pkg.nd.array(x), layout="NTC")
        o = out.asnumpy()
        rates.append(float((o[:, 1:] == o[:, :-1]).mean()))
    sd = np.sqrt(0.4 * 0.6 / (64 * 2 * 40))
    for rate in rates:
        assert abs(rate - 0.4) < 5 * sd, rates


def test_stack_equals_the_fused_lstm_and_jax_pallas(monkeypatch):
    """An unrolled stack of 2 LSTMCells equals the fused gluon.rnn.LSTM
    with its weights (the port's, and the JAX package's Pallas kernel in
    interpret mode), outputs and states; with a gradient too
    (`chip_smoke.cells_vs_fused`, the card phase's check)."""
    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")

    def stack(r):
        s = r.SequentialRNNCell()
        with s.name_scope():
            s.add(r.LSTMCell(H, input_size=C))
            s.add(r.LSTMCell(H, input_size=H))
        return s

    jcell = stack(jrnn)
    jcell.initialize(jmx.init.Uniform(0.5))
    pcell = stack(prnn)
    pcell.initialize()
    _carry(jcell, pcell)
    jfused = jrnn.LSTM(H, 2, input_size=C)
    jfused.initialize()
    cells = {n: p.data().asnumpy()
             for n, p in pcell.collect_params().items()}
    pfused = prnn.LSTM(H, 2, input_size=C)
    pfused.initialize()
    weights = convert.fused_rnn_params_from_cells(cells, pfused)
    for n, p in pfused.collect_params().items():
        p.set_data(mx.nd.array(weights[n]))
    for n, p in jfused.collect_params().items():
        p.set_data(jmx.nd.array(weights[pfused.prefix + n[len(
            jfused.prefix):]]))
    x = _rand(9, T, B, C)
    begin = [_rand(10 + k, B, H, scale=0.5) for k in range(4)]
    out, states = pcell.unroll(T, mx.nd.array(x),
                               begin_state=[mx.nd.array(s) for s in begin],
                               layout="TNC")
    fused_begin = [np.stack(begin[0::2]), np.stack(begin[1::2])]
    pout, pst = pfused(mx.nd.array(x), [mx.nd.array(s)
                                        for s in fused_begin])
    jout, jst = jfused(jmx.nd.array(x), [jmx.nd.array(s)
                                         for s in fused_begin])
    _close(out, jout, "cells vs JAX fused")
    _close(pout, jout, "port fused vs JAX fused")
    for k in range(2):
        _close(states[2 * k], jst[0].asnumpy()[k], "h%d" % k)
        _close(states[2 * k + 1], jst[1].asnumpy()[k], "c%d" % k)
        _close(pst[0].asnumpy()[k], jst[0].asnumpy()[k])
    for grad in (False, True):
        errs = chip_smoke.cells_vs_fused(mx, mx.cpu(), 3, T, B, H, 2, grad)
        assert all(e <= TOL * ref for e, ref in errs.values()), errs


def test_lstmp_cell_and_dynamic_unroll_match_jax():
    make = lambda r, c: c.LSTMPCell(H, 3, input_size=C)  # noqa: E731
    jcell, pcell = _both(make)
    _check_unroll(jcell, pcell, _rand(11, B, T, C), "NTC", True)
    x = _rand(12, T, B, C)
    vl = np.array([4, 1, 3], np.float32)
    begin = [_rand(13, B, 3, scale=0.5), _rand(14, B, H, scale=0.5)]
    jo, js = jcrnn.dynamic_unroll(jcell, jmx.nd.array(x),
                                  [jmx.nd.array(s) for s in begin],
                                  valid_length=jmx.nd.array(vl))
    po, ps = pcrnn.dynamic_unroll(pcell, mx.nd.array(x),
                                  [mx.nd.array(s) for s in begin],
                                  valid_length=mx.nd.array(vl))
    _close(po, jo)
    for a, b in zip(ps, js):
        _close(a, b)


def test_variational_dropout_keeps_one_mask_a_sequence():
    """The variational masks (``mode="always"``) are drawn once a sequence
    and drop at their rate, in both packages: the input mask holds 0 or
    1 / (1 - p) a unit."""
    x = np.ones((64, 5, 50), np.float32)
    for pkg, r, c in ((jmx, jrnn, jcrnn), (mx, prnn, pcrnn)):
        pkg.random.seed(2)
        cell = c.VariationalDropoutCell(r.RNNCell(50, input_size=50),
                                        drop_inputs=0.5, drop_outputs=0.5)
        cell.initialize(pkg.init.One())
        out, _ = cell.unroll(5, pkg.nd.array(x), layout="NTC")
        mask = cell._input_mask.asnumpy()
        assert set(np.unique(mask)) <= {0.0, 2.0}
        rate = float((mask == 0).mean())
        assert abs(rate - 0.5) < 5 * np.sqrt(0.25 / mask.size), rate
        # one output mask for every step: a unit dropped at one step is
        # dropped at all
        o = out.asnumpy()
        dropped = o[:, 0] == 0
        assert (o[:, 1:][np.broadcast_to(dropped[:, None], o[:, 1:].shape)]
                == 0).all()


CONV = [(dims, kind) for dims in (1, 2, 3) for kind in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("dims,kind", CONV)
def test_conv_cells_match_jax(dims, kind):
    name = "Conv%dD%sCell" % (dims, kind)
    in_shape = (2,) + (5,) * dims
    make = lambda r, c: getattr(c, name)(  # noqa: E731
        in_shape, 3, 3, 3, i2h_pad=1)
    jcell, pcell = _both(make)
    assert [i["shape"] for i in pcell.state_info(B)] == \
        [i["shape"] for i in jcell.state_info(B)]
    seq = _rand(20 + dims, B, 2, 2, *((5,) * dims))
    _check_unroll(jcell, pcell, seq, "NTC", True)


def test_conv_cell_rejects_an_even_h2h_kernel():
    with pytest.raises(mx.MXNetError):
        pcrnn.Conv2DLSTMCell((2, 5, 5), 3, 3, 2)


@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (7, 7, True),
                          (12, 4, True), (5, 1, False)])
def test_interval_sampler_order_equals_jax(length, interval, rollover):
    got = pdata.IntervalSampler(length, interval, rollover)
    want = jdata.IntervalSampler(length, interval, rollover)
    assert list(got) == list(want)
    assert len(got) == len(want)
    with pytest.raises(mx.MXNetError):
        pdata.IntervalSampler(length, length + 1)


def test_wikitext2_over_a_token_file_equals_jax(tmp_path):
    text = ("= Valkyria =\n\n the game began development in 2010 , "
            "carrying over a large portion\n of the work done on "
            "Valkyria Chronicles II .\n\n it met with positive sales "
            "in Japan , and was praised\n")
    (tmp_path / "wiki.train.tokens").write_text(text, encoding="utf8")
    got = pdata.WikiText2(root=str(tmp_path), segment="train", seq_len=5)
    want = jdata.WikiText2(root=str(tmp_path), segment="train", seq_len=5)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        gd, gl = got[i]
        wd, wl = want[i]
        np.testing.assert_array_equal(gd.asnumpy(), np.asarray(wd))
        np.testing.assert_array_equal(gl.asnumpy(), np.asarray(wl))
    assert got.vocabulary.idx_to_token == want.vocabulary.idx_to_token
    with pytest.raises(mx.MXNetError, match="wiki.valid.tokens"):
        pdata.WikiText2(root=str(tmp_path), segment="validation")


def _graph(pkg, make, length=3):
    cell = make(pkg)
    out, states = cell.unroll(length, pkg.sym.var("data"), layout="NTC",
                              merge_outputs=True)
    return cell, out, states


SYM_CELLS = {
    "dropout": lambda m: m.rnn.SequentialRNNCell(),
    "zoneout": lambda m: m.rnn.ZoneoutCell(
        m.rnn.LSTMCell(4, prefix="z_"), 0.2, 0.3),
    "residual": lambda m: m.rnn.ResidualCell(m.rnn.GRUCell(3, prefix="r_")),
    "bidirectional": lambda m: m.rnn.BidirectionalCell(
        m.rnn.LSTMCell(4, prefix="bl_"), m.rnn.GRUCell(4, prefix="br_")),
    "unfuse_bi_dropout": lambda m: m.rnn.FusedRNNCell(
        4, num_layers=2, mode="lstm", bidirectional=True, dropout=0.3,
        prefix="f_").unfuse(),
    "unfuse_gru": lambda m: m.rnn.FusedRNNCell(
        4, num_layers=2, mode="gru", prefix="g_").unfuse(),
}


def _with_dropout(m):
    s = m.rnn.SequentialRNNCell()
    s.add(m.rnn.LSTMCell(3, prefix="a_"))
    s.add(m.rnn.DropoutCell(0.5, prefix="d_"))
    s.add(m.rnn.LSTMCell(3, prefix="b_"))
    return s


SYM_CELLS["dropout"] = _with_dropout


@pytest.mark.parametrize("kind", sorted(SYM_CELLS))
def test_mx_rnn_cells_graphs_and_outputs_match_jax(kind):
    """The graph's arguments and inferred shapes equal the JAX package's,
    and its inference output on one set of weights too (the dropout
    inside is the identity outside training)."""
    jcell, jout, _ = _graph(jmx, SYM_CELLS[kind])
    pcell, pout, _ = _graph(mx, SYM_CELLS[kind])
    assert pout.list_arguments() == jout.list_arguments()
    data = (2, 3, 3) if kind == "residual" else (2, 3, 5)
    jshapes = jout.infer_shape(data=data)
    pshapes = pout.infer_shape(data=data)
    assert [tuple(s) for s in pshapes[0]] == [tuple(s) for s in jshapes[0]]
    assert [tuple(s) for s in pshapes[1]] == [tuple(s) for s in jshapes[1]]
    args = {n: _rand(30 + k, *s, scale=0.5) for k, (n, s) in enumerate(
        zip(jout.list_arguments(), jshapes[0]))}
    got = pout.eval(ctx=mx.cpu(), **{n: mx.nd.array(a)
                                     for n, a in args.items()})[0]
    want = jout.eval(ctx=jmx.cpu(), **{n: jmx.nd.array(a)
                                       for n, a in args.items()})[0]
    _close(got, want)


def test_unfuse_equals_the_fused_cell():
    """A bidirectional 2-layer FusedRNNCell against its unfuse(), one
    parameter vector (the card phase's check, `chip_smoke.unfuse_vs_fused`)
    ; and the JAX package's unfuse() names the same cells."""
    errs = chip_smoke.unfuse_vs_fused(mx, mx.cpu(), 0, T, B, H, 2)
    assert all(e <= TOL * ref for e, ref in errs.values()), errs
    p = mx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True,
                            dropout=0.2, prefix="u_").unfuse()
    j = jmx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True,
                             dropout=0.2, prefix="u_").unfuse()
    assert [type(c).__name__ for c in p._cells] == \
        [type(c).__name__ for c in j._cells]


def test_cell_params_convert_refuses_a_mismatch():
    jcell = jrnn.LSTMCell(H, input_size=C)
    jcell.initialize()
    params = {n: p.data().asnumpy()
              for n, p in jcell.collect_params().items()}
    with pytest.raises(mx.MXNetError):
        convert.gluon_cell_params_from_jax(params, prnn.GRUCell(H))
    with pytest.raises(mx.MXNetError):
        convert.gluon_cell_params_from_jax(
            params, prnn.LSTMCell(H + 1, input_size=C))
    with pytest.raises(mx.MXNetError):
        convert.fused_rnn_params_from_cells(params, prnn.LSTM(H, 2))
