"""The port's mesh layer and expert-parallel MoE against the JAX package.

Single process: `make_mesh` shapes and errors and `ShardingRules.spec_for`
(`tests/test_parallel.py`'s cases and more) against the JAX functions;
`switch_moe` / `topk_moe` outputs and input gradients at k = 1, 2, 3,
with ties in the router probabilities and with capacity drops, within
1e-5 of the outputs' largest magnitude (1e-6 relative on lb / z);
`MoEFFN`'s ``aux_loss`` and ``return_aux``; the trainer's refusals.

Several processes: children of this file (``python
tests/test_torch_port_parallel.py --child ...``, spawned, never forked),
gloo ranks that rendezvous through a ``file://`` under the test's
temporary directory, each with a hard timeout. They import only the port
and write ``.npz`` files that the parent holds against the JAX package's
`DistributedTrainer` on the same mesh shape (``make_mesh(...,
devices=jax.devices()[:4])``), from the same weights and batches:

* 4 ranks: the collectives over both axes of a dp 2 x ep 2 mesh against
  numpy; `test_distributed_trainer_dp_matches_local`'s MLP at dp = 4;
  `test_moe_expert_parallel_training`'s net at dp 2 x ep 2, each rank
  holding E/ep rows of the expert tables and of their Adam states;
  `test_moe_aux_loss_in_distributed_trainer`'s plain-callable loss. Per
  step losses within 1e-5 relative, parameters after 3 steps within
  ``rtol=2e-4, atol=2e-5`` (`tests/test_parallel.py`'s own tolerance);
* 2 ranks: an MoE layer routed over the global batch inside a trainer's
  step scope equals the JAX layer on the whole batch, and the same layer
  routing each rank's shard alone differs (the global capacity and queue
  order are what is held); a BatchNorm net's step at dp = 2 and the MoE
  layer's over tp = 2 equal the JAX trainer's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
OUT_TOL = 1e-5
AUX_TOL = 1e-6
RTOL, ATOL = 2e-4, 2e-5
STEPS = 3
VOCAB_SEED = 5


# -- shared by the parent and the children

def _port_net(kind, gluon, MoEFFN):
    """The port's copy of the JAX tests' nets, prefixes fixed so both
    packages name every parameter alike."""
    nn = gluon.nn
    if kind == "mlp":
        net = nn.HybridSequential(prefix="dpmlp_")
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", prefix="d1_"))
            net.add(nn.Dense(10, prefix="d2_"))
        return net
    aux = kind == "moe_aux"

    class Net(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = nn.Dense(16, flatten=False)
                self.moe = MoEFFN(
                    units=16, hidden_size=32, num_experts=4,
                    capacity_factor=2.0, return_aux=aux,
                    num_experts_per_token=2 if aux else 1,
                    z_loss_coef=1e-3 if aux else 0.0)
                self.out = nn.Dense(4, flatten=False)

        def hybrid_forward(self, F, x):
            if aux:
                h, a = self.moe(self.embed(x))
                return self.out(h), a
            return self.out(self.moe(self.embed(x)))

    return Net(prefix=kind + "net_")


def _aux_loss(gluon):
    sce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        logits, aux = out
        return sce(logits, label) + 0.01 * aux

    return loss_fn


# -- the children (the port only)

def _child_collectives(rank, world, mx, torch):
    from mxnet_tpu_torch.parallel import collectives as C

    mesh = mx.parallel.make_mesh([("dp", 2), ("ep", 2)])
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100.0 * rank
    out = {}
    with mx.parallel.use_mesh(mesh):
        for ax in ("dp", "ep"):
            out[ax + "_psum"] = C.psum(x, ax)
            out[ax + "_pmean"] = C.pmean(x, ax)
            out[ax + "_pmax"] = C.pmax(x, ax)
            out[ax + "_pmin"] = C.pmin(x, ax)
            out[ax + "_gather"] = C.all_gather(x, ax)
            out[ax + "_gather_stack"] = C.all_gather(x, ax, axis=1,
                                                     tiled=False)
            out[ax + "_rs"] = C.reduce_scatter(x, ax)
            out[ax + "_perm"] = C.ppermute(x, ax, [(0, 1)])
            out[ax + "_a2a"] = C.all_to_all(x, ax, 0, 1)
            out[ax + "_index"] = torch.tensor(C.axis_index(ax))
            out[ax + "_size"] = torch.tensor(C.axis_size(ax))
            w = torch.ones(4, 6, requires_grad=True)
            (C.psum(w * x, ax) * 2.0).sum().backward()
            out[ax + "_psum_grad"] = w.grad
            w = torch.ones(4, 6, requires_grad=True)
            (C.pbroadcast(w, ax) * x).sum().backward()
            out[ax + "_pbroadcast_grad"] = w.grad
            w = x.clone().requires_grad_(True)
            (C.all_to_all(w, ax, 0, 1) * out[ax + "_a2a"]).sum().backward()
            out[ax + "_a2a_grad"] = w.grad
    out["all_reduce_arrays"] = C.all_reduce_arrays([x, x * 2.0])[0]
    return {k: v.detach().numpy() for k, v in out.items()}


def _child_train(kind, rank, world, mx, torch, init):
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN

    gluon = mx.gluon
    net = _port_net(kind, gluon, MoEFFN)
    net.initialize(ctx=mx.cpu())
    x, y = init["x"], init["y"]
    with mx.cpu():
        net(mx.nd.array(x))
    params = net.collect_params()
    for name, p in params.items():
        p.set_data(init["param:" + name])
    if kind == "mlp":
        mesh = mx.parallel.make_mesh([("dp", 4)])
        trainer = mx.parallel.DistributedTrainer(
            net, "sgd", {"learning_rate": 0.1},
            loss=gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh)
    else:
        mesh = mx.parallel.make_mesh([("dp", 2), ("ep", 2)])
        loss = gluon.loss.SoftmaxCrossEntropyLoss() if kind == "moe" \
            else _aux_loss(gluon)
        trainer = mx.parallel.DistributedTrainer(
            net, "adam", {"learning_rate": 1e-3}, loss=loss, mesh=mesh)
    losses = [float(trainer.step(x, y).asnumpy()) for _ in range(STEPS)]
    out = {"losses": np.array(losses)}
    for i in trainer._experts:
        name = trainer._param_names[i]
        out["shard:" + name] = trainer._arrays[i].detach().numpy()
        for j, s in enumerate(trainer._states[i]):
            out["state%d:%s" % (j, name)] = s.numpy()
    trainer.sync_params()
    for name, p in params.items():
        out["param:" + name] = p.data().asnumpy()
    return out


def _child_control(rank, world, mx, torch, init):
    """An MoE layer on this rank's dp shard, routed over the global batch
    (inside a trainer's step scope) and alone; then a trainer's step of a
    BatchNorm net at dp 2 and of the MoE layer over tp 2."""
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN
    from mxnet_tpu_torch.parallel.mesh import step_scope

    mesh = mx.parallel.make_mesh([("dp", 2)])
    moe = MoEFFN(units=8, hidden_size=16, num_experts=4,
                 num_experts_per_token=2, capacity_factor=1.0,
                 z_loss_coef=1e-3, return_aux=True, prefix="ctl_")
    moe.initialize(ctx=mx.cpu())
    for name, p in moe.collect_params().items():
        p.set_data(init["param:" + name])
    x = torch.from_numpy(init["x"])
    shard = x[rank * 2:(rank + 1) * 2]
    with torch.no_grad():
        with step_scope(mesh):
            glob, glob_aux = moe(shard)
        alone, alone_aux = moe(shard)
    out = {"global": glob.numpy(), "global_aux": glob_aux.numpy(),
           "alone": alone.numpy(), "alone_aux": alone_aux.numpy()}
    from mxnet_tpu_torch.data import DevicePrefetcher
    from mxnet_tpu_torch.parallel.mesh import is_shard

    (placed,) = list(DevicePrefetcher(iter([init["x"]]), depth=1,
                                      mesh=mesh))
    assert is_shard(placed)
    out["prefetched"] = placed.numpy()
    bn = _control_bn(mx.gluon)
    bn.initialize(ctx=mx.cpu())
    for name, p in bn.collect_params().items():
        p.set_data(init["bn:" + name])
    for what, net, axes, x in (("bn", bn, [("dp", 2)], init["x_bn"]),
                               ("tp", moe, [("tp", 2)], init["x"])):
        trainer = mx.parallel.DistributedTrainer(
            net, "sgd", mesh=mx.parallel.make_mesh(axes))
        out["loss_" + what] = np.array(float(trainer.step(x).asnumpy()))
        trainer.sync_params()
        for name, p in net.collect_params().items():
            out[what + ":" + name] = p.data().asnumpy()
    return out


def _control_bn(gluon):
    """A Dense + BatchNorm net, prefixes fixed, in either package."""
    net = gluon.nn.HybridSequential(prefix="ctlbn_")
    with net.name_scope():
        net.add(gluon.nn.Dense(4, in_units=3, prefix="d_"),
                gluon.nn.BatchNorm(in_channels=4, prefix="bn_"))
    return net


def _child_main(argv):
    group, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx

    mx.parallel.init_process_group(
        num_processes=world, process_id=rank, backend="gloo",
        init_method="file://" + init_file, timeout=TIMEOUT)
    if group == "four":
        runs = [("collectives", lambda: _child_collectives(rank, world, mx,
                                                           torch))]
        for kind in ("mlp", "moe", "moe_aux"):
            init = dict(np.load(os.path.join(out_dir, "init_%s.npz" % kind)))
            runs.append((kind, lambda kind=kind, init=init: _child_train(
                kind, rank, world, mx, torch, init)))
    else:
        init = dict(np.load(os.path.join(out_dir, "init_control.npz")))
        runs = [("control", lambda: _child_control(rank, world, mx, torch,
                                                   init))]
    for name, run in runs:
        np.savez(os.path.join(out_dir, "%s_%d.npz" % (name, rank)), **run())
        mx.parallel.barrier()
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "mxnet_tpu"))
    assert not imported, imported
    torch.distributed.destroy_process_group()


def _spawn(group, world, tmp):
    """``world`` children of this file, each killed at `TIMEOUT`: a hung
    collective fails the test and never hangs the suite."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init_file = os.path.join(tmp, "rendezvous_" + group)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", group,
         str(r), str(world), init_file, tmp], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs


def _join(procs):
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a rank did not finish within %d s (a hung collective)"
                    % TIMEOUT)
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child_main(sys.argv[2:])
    sys.exit(0)


# -- the parent

def _jax():
    import jax

    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.contrib.moe import MoEFFN

    return jax, jmx, MoEFFN


def _jax_net(kind, seed):
    jax, jmx, MoEFFN = _jax()
    jmx.random.seed(seed)
    net = _port_net(kind, jmx.gluon, MoEFFN)
    net.initialize(jmx.init.Xavier())
    return net


def _batch(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        x = rng.randn(16, 20).astype(np.float32)
        y = rng.randint(0, 10, (16,)).astype(np.float32)
    else:
        x = rng.normal(size=(8, 6, 12)).astype(np.float32)
        y = rng.randint(0, 4, (8, 6)).astype(np.float32)
    return x, y


def _jax_train(kind, net, x, y):
    jax, jmx, _ = _jax()
    gluon = jmx.gluon
    if kind == "mlp":
        mesh = jmx.parallel.make_mesh([("dp", 4)], devices=jax.devices()[:4])
        tr = jmx.parallel.DistributedTrainer(
            net, "sgd", {"learning_rate": 0.1},
            loss=gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh)
    else:
        mesh = jmx.parallel.make_mesh([("dp", 2), ("ep", 2)],
                                      devices=jax.devices()[:4])
        loss = gluon.loss.SoftmaxCrossEntropyLoss() if kind == "moe" \
            else _aux_loss(gluon)
        tr = jmx.parallel.DistributedTrainer(
            net, "adam", {"learning_rate": 1e-3}, loss=loss, mesh=mesh)
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(STEPS)]
    states = {}
    for k, i in enumerate(tr._trainable):
        st = tr._states[k]
        if st is not None:
            states[tr._param_names[i]] = [np.asarray(s) for s in st]
    tr.sync_params()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return np.array(losses), params, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the 4-rank and 2-rank groups, compute the JAX references
    meanwhile, and wait."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    _, jmx, MoEFFN = _jax()
    ref = {}
    nets = {}
    for kind, seed in (("mlp", 11), ("moe", 12), ("moe_aux", 13)):
        net = _jax_net(kind, seed)
        x, y = _batch(kind, seed)
        net(jmx.nd.array(x))
        nets[kind] = (net, x, y)
        init = {"param:" + n: p.data().asnumpy()
                for n, p in net.collect_params().items()}
        np.savez(os.path.join(tmp, "init_%s.npz" % kind), x=x, y=y, **init)
    jmx.random.seed(14)
    ctl = MoEFFN(units=8, hidden_size=16, num_experts=4,
                 num_experts_per_token=2, capacity_factor=1.0,
                 z_loss_coef=1e-3, return_aux=True, prefix="ctl_")
    ctl.initialize(jmx.init.Xavier())
    xc = np.random.RandomState(15).normal(size=(4, 8, 8)).astype(np.float32)
    out, aux = ctl(jmx.nd.array(xc))
    ref["control"] = (np.array(out.asnumpy()), float(aux.asnumpy()))
    ref["control_x"] = xc
    jmx.random.seed(16)
    jbn = _control_bn(jmx.gluon)
    jbn.initialize(jmx.init.Xavier())
    x_bn = np.random.RandomState(17).normal(size=(4, 3)).astype(np.float32)
    jbn(jmx.nd.array(x_bn))
    init_bn = {"bn:" + n: p.data().asnumpy()
               for n, p in jbn.collect_params().items()}
    np.savez(os.path.join(tmp, "init_control.npz"), x=xc, x_bn=x_bn,
             **{"param:" + n: p.data().asnumpy()
                for n, p in ctl.collect_params().items()}, **init_bn)
    four = _spawn("four", 4, tmp)
    two = _spawn("two", 2, tmp)
    try:
        for kind, (net, x, y) in nets.items():
            ref[kind] = _jax_train(kind, net, x, y)
        jax = _jax()[0]
        for what, net, axes, x in (("bn", jbn, [("dp", 2)], x_bn),
                                   ("tp", ctl, [("tp", 2)], xc)):
            tr = jmx.parallel.DistributedTrainer(
                net, "sgd", mesh=jmx.parallel.make_mesh(
                    axes, devices=jax.devices()[:2]))
            loss = float(tr.step(x).asnumpy())
            tr.sync_params()
            ref["control_" + what] = (loss, {
                n: p.data().asnumpy()
                for n, p in net.collect_params().items()})
    finally:
        _join(four)
        _join(two)

    def load(name, world):
        return [dict(np.load(os.path.join(tmp, "%s_%d.npz" % (name, r))))
                for r in range(world)]

    got = {k: load(k, 4) for k in ("collectives", "mlp", "moe", "moe_aux")}
    got["control"] = load("control", 2)
    return ref, got


def test_collectives_over_each_axis_of_a_4_rank_mesh(runs):
    """Every in-graph collective over dp and over ep of a dp 2 x ep 2 mesh
    (rank r at (r // 2, r % 2)), and the gradients of psum (passed
    through), pbroadcast (summed over the axis) and all_to_all (its
    inverse), against numpy."""
    _, got = runs
    xs = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100.0 * r
          for r in range(4)]
    for r in range(4):
        g = got["collectives"][r]
        groups = {"dp": [r % 2, r % 2 + 2], "ep": [r - r % 2, r - r % 2 + 1]}
        for ax, ranks in groups.items():
            parts = [xs[q] for q in ranks]
            me = ranks.index(r)
            total = parts[0] + parts[1]
            np.testing.assert_array_equal(g[ax + "_psum"], total)
            np.testing.assert_array_equal(g[ax + "_pmean"], total / 2)
            np.testing.assert_array_equal(g[ax + "_pmax"],
                                          np.maximum(*parts))
            np.testing.assert_array_equal(g[ax + "_pmin"],
                                          np.minimum(*parts))
            np.testing.assert_array_equal(g[ax + "_gather"],
                                          np.concatenate(parts))
            np.testing.assert_array_equal(g[ax + "_gather_stack"],
                                          np.stack(parts, axis=1))
            np.testing.assert_array_equal(g[ax + "_rs"],
                                          total[me * 2:(me + 1) * 2])
            np.testing.assert_array_equal(
                g[ax + "_perm"], parts[0] if me == 1 else 0 * parts[0])
            np.testing.assert_array_equal(
                g[ax + "_a2a"], np.concatenate(
                    [p[me * 2:(me + 1) * 2] for p in parts], axis=1))
            assert int(g[ax + "_index"]) == me and int(g[ax + "_size"]) == 2
            np.testing.assert_array_equal(g[ax + "_psum_grad"], 2 * xs[r])
            np.testing.assert_array_equal(g[ax + "_pbroadcast_grad"], total)
            # all_to_all's backward sends each block back to its source:
            # the cotangent the forward's own output gives back x
            np.testing.assert_array_equal(g[ax + "_a2a_grad"], xs[r])
        np.testing.assert_array_equal(g["all_reduce_arrays"],
                                      3 * sum(xs))


def _close_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["mlp", "moe", "moe_aux"])
def test_distributed_trainer_over_4_ranks_matches_jax(runs, kind):
    """The port's trainer at dp = 4 (the MLP) or dp 2 x ep 2 (the MoE
    nets) on 4 gloo ranks against the JAX package's on the same mesh
    shape: every step's loss on every rank, and every parameter after
    `sync_params` on every rank."""
    ref, got = runs
    losses, params, _ = ref[kind]
    for r in range(4):
        g = got[kind][r]
        _close_losses(g["losses"], losses)
        for name, want in params.items():
            np.testing.assert_allclose(g["param:" + name], want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kind", ["moe", "moe_aux"])
def test_each_rank_holds_its_expert_rows_and_their_adam_states(runs, kind):
    """Over ep = 2 rank r holds rows [q E/2, (q+1) E/2) (q = r % 2) of each
    expert table and of its Adam mean and variance, equal to those rows
    of the JAX trainer's; the gate and the dense layers are replicated."""
    ref, got = runs
    _, params, states = ref[kind]
    experts = sorted(n for n in params if "expert" in n)
    assert len(experts) == 2
    for r in range(4):
        g = got[kind][r]
        q = r % 2
        assert sorted(k[len("shard:"):] for k in g
                      if k.startswith("shard:")) == experts
        for name in experts:
            rows = params[name].shape[0] // 2
            sl = slice(q * rows, (q + 1) * rows)
            np.testing.assert_allclose(g["shard:" + name], params[name][sl],
                                       rtol=RTOL, atol=ATOL)
            for j in range(2):
                st = g["state%d:%s" % (j, name)]
                assert st.shape == params[name][sl].shape
                np.testing.assert_allclose(st, states[name][j][sl],
                                           rtol=RTOL, atol=ATOL * 1e-2)


def test_global_routing_is_held_and_per_shard_routing_differs(runs):
    """2 ranks, dp = 2, top-2 at capacity factor 1.0 (a global capacity of
    16 slots, 8 a shard): routed over the global batch inside a trainer's
    step scope, the two shards' outputs and the aux loss equal the JAX
    layer's on the whole batch; routed alone they differ."""
    ref, got = runs
    want, want_aux = ref["control"]
    glob = np.concatenate([g["global"] for g in got["control"]])
    alone = np.concatenate([g["alone"] for g in got["control"]])
    scale = np.abs(want).max()
    np.testing.assert_allclose(glob, want, rtol=0, atol=OUT_TOL * scale)
    for g in got["control"]:
        np.testing.assert_allclose(float(g["global_aux"]), want_aux,
                                   rtol=AUX_TOL)
    assert np.abs(alone - want).max() > 1e-2 * scale
    assert all(abs(float(g["alone_aux"]) - want_aux) > 1e-4
               for g in got["control"])


def test_batchnorm_at_dp2_and_a_tp_axis_raise(runs):
    """BatchNorm at dp = 2 and a tp axis no longer raise: a trainer's step
    of a BatchNorm net at dp 2 (statistics over the global batch) and of
    the MoE layer over tp 2 give the JAX trainer's loss and parameters on
    the same mesh shape; and a `DevicePrefetcher` bound to the dp = 2 mesh
    places each rank's rows."""
    ref, got = runs
    for r, g in enumerate(got["control"]):
        np.testing.assert_array_equal(g["prefetched"],
                                      ref["control_x"][r * 2:(r + 1) * 2])
        for what in ("bn", "tp"):
            loss, params = ref["control_" + what]
            np.testing.assert_allclose(float(g["loss_" + what]), loss,
                                       rtol=1e-5, atol=1e-7)
            for name, want in params.items():
                np.testing.assert_allclose(g[what + ":" + name], want,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=name)


# -- single process

def _records(n):
    from mxnet_tpu_torch.parallel.mesh import Device

    return [Device(r, "cpu") for r in range(n)]


def _raises_alike(fn_t, fn_j):
    with pytest.raises(ValueError) as et:
        fn_t()
    with pytest.raises(ValueError) as ej:
        fn_j()
    assert str(et.value) == str(ej.value)


def test_make_mesh_shapes_and_errors_match_jax():
    """`tests/test_parallel.py::test_make_mesh_shapes` on 8 device records
    against the JAX function on its 8 CPU devices: shapes, names, -1 and
    the same error messages."""
    jax, jmx, _ = _jax()
    import mxnet_tpu_torch as mx

    recs, jdev = _records(8), jax.devices()
    for axes in (None, [("dp", 2), ("tp", -1)], {"dp": 2, "ep": 4},
                 [("dp", -1), ("fsdp", 2), ("tp", 2)]):
        m = mx.parallel.make_mesh(axes, devices=recs)
        j = jmx.parallel.make_mesh(axes, devices=jdev)
        assert m.axis_names == j.axis_names
        assert m.devices.shape == j.devices.shape
        assert [d.rank for d in m.devices.flat] == list(range(8))
    for axes in ([("dp", 3)], [("dp", -1), ("tp", -1)], [("dp", 3),
                                                         ("tp", -1)]):
        _raises_alike(lambda: mx.parallel.make_mesh(axes, devices=recs),
                      lambda: jmx.parallel.make_mesh(axes, devices=jdev))
    one = mx.parallel.make_mesh()
    assert one.devices.shape == (1,) and one.axis_names == ("dp",)
    assert one.devices.flat[0].platform in ("cpu", "gpu")
    assert mx.parallel.mesh_fingerprint(one).endswith("|procs=1")


@pytest.mark.parametrize("axes", [
    [("dp", 2), ("tp", 4)], [("dp", 2), ("ep", 4)], [("fsdp", 8)],
    [("ep", 2), ("tp", 4)], [("dp", 8)], [("dp", 2), ("fsdp", 2),
                                          ("tp", 2)]])
def test_sharding_rules_match_jax(axes):
    """`ShardingRules.spec_for` (heuristics, explicit and regex rules,
    "auto", scalars) and `batch_spec` against the JAX package's, on the
    same mesh shapes."""
    jax, jmx, _ = _jax()
    import mxnet_tpu_torch as mx

    m = mx.parallel.make_mesh(axes, devices=_records(8))
    j = jmx.parallel.make_mesh(axes, devices=jax.devices())
    cases = [("dense0_weight", (16, 8)), ("dense0_bias", (16,)),
             ("gamma", ()), ("moe_expert_w_in", (4, 16, 32)),
             ("moe_expert_w_out", (6, 32, 16)), ("moe_gate_weight", (4, 16)),
             ("embed_weight", (64, 32)), ("tiny", (3, 5))]
    for rules in (None, {r".*_bias": (None,)}, {"dense0_weight": "auto"},
                  {r"moe_.*": ("ep", None)}, {"tiny": (None, "tp")}):
        tr, jr = (mx.parallel.ShardingRules(rules, fsdp_min_size=64),
                  jmx.parallel.ShardingRules(rules, fsdp_min_size=64))
        for name, shape in cases:
            assert tuple(tr.spec_for(name, shape, m)) == \
                tuple(jr.spec_for(name, shape, j)), (rules, name)
    for nd in (None, 1, 3):
        assert tuple(mx.parallel.batch_spec(m, nd)) == \
            tuple(jmx.parallel.batch_spec(j, nd))


def _moe_inputs(seed, t, d, h, e, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(2, t // 2, d)).astype(np.float32)
    gate = rng.normal(size=(e, d)).astype(np.float32)
    if ties:
        # multiples of 1/2 and 1/4: every logit is exact in any summation
        # order, so the tied experts' probabilities are equal bit for bit
        # in both packages
        x = (rng.randint(-2, 3, x.shape) * 0.5).astype(np.float32)
        gate = (rng.randint(-2, 3, gate.shape) * 0.25).astype(np.float32)
        gate[2] = gate[1]   # experts 1 and 2 tie for every token
        gate[3] = gate[0]
    w_in = (rng.normal(size=(e, d, h)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.normal(size=(e, h, d)) / np.sqrt(h)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    return x, gate, w_in, w_out, cot


def _moe_both(k, cf, inputs, switch):
    """(outputs, gradients) of the port's and the JAX op on the same
    inputs; the scalar differentiated is sum(out * cot) + 0.3 lb + 0.7 z
    (lb alone for switch_moe)."""
    import jax
    import jax.numpy as jnp
    import torch

    from mxnet_tpu.ops import contrib as jc
    from mxnet_tpu_torch.ops import contrib as tc

    x, gate, w_in, w_out, cot = inputs

    def jfn(*args):
        if switch:
            out, lb = jc.switch_moe(*args, capacity_factor=cf)
            return (out * cot).sum() + 0.3 * lb, (out, lb, lb)
        out, lb, z = jc.topk_moe(*args, k=k, capacity_factor=cf)
        return (out * cot).sum() + 0.3 * lb + 0.7 * z, (out, lb, z)

    jargs = [jnp.asarray(a) for a in (x, gate, w_in, w_out)]
    (_, jouts), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (x, gate, w_in, w_out)]
    if switch:
        out, lb = tc.switch_moe(*targs, capacity_factor=cf)
        z = lb
        obj = (out * torch.from_numpy(cot)).sum() + 0.3 * lb
    else:
        out, lb, z = tc.topk_moe(*targs, k=k, capacity_factor=cf)
        obj = (out * torch.from_numpy(cot)).sum() + 0.3 * lb + 0.7 * z
    obj.backward()
    touts = [out.detach().numpy(), lb.detach().numpy(), z.detach().numpy()]
    return ([np.asarray(a) for a in jouts], [np.asarray(g) for g in jgrads],
            touts, [a.grad.numpy() for a in targs])


@pytest.mark.parametrize("case", [
    ("switch", 1, 1.25, False), ("top1", 1, 1.25, False),
    ("top2", 2, 1.25, False), ("top3", 3, 2.0, False),
    ("top2_ties", 2, 1.25, True), ("top1_ties_drops", 1, 0.5, True),
    ("top2_drops", 2, 0.5, False), ("top3_drops", 3, 0.75, False)],
    ids=lambda c: c[0])
def test_moe_ops_match_jax(case):
    """`switch_moe` / `topk_moe` outputs, lb / z and the gradients of every
    input against the JAX ops: ties in the router probabilities (two pairs
    of identical gate rows: the lower expert first, as ``lax.top_k``) and
    capacity factors that drop token choices."""
    name, k, cf, ties = case
    inputs = _moe_inputs(sum(map(ord, name)), 24, 8, 12, 4, ties)
    jouts, jgrads, touts, tgrads = _moe_both(k, cf, inputs,
                                             name == "switch")
    scale = np.abs(jouts[0]).max()
    np.testing.assert_allclose(touts[0], jouts[0], rtol=0,
                               atol=OUT_TOL * scale)
    np.testing.assert_allclose(touts[1], jouts[1], rtol=AUX_TOL)
    np.testing.assert_allclose(touts[2], jouts[2], rtol=AUX_TOL)
    for what, t, j in zip(("data", "gate", "w_in", "w_out"), tgrads,
                          jgrads):
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=OUT_TOL * max(np.abs(j).max(), 1e-6),
                                   err_msg=what)
    if "drops" in name:
        # fewer slots than choices: some choice is dropped
        cap = max(1, int(cf * k * 24 / 4))
        assert cap * 4 < 24 * k
    if ties:
        x, gate = inputs[:2]
        import torch

        probs = torch.softmax(torch.from_numpy(x.reshape(-1, 8))
                              @ torch.from_numpy(gate).t(), -1)
        assert torch.equal(probs[:, 1], probs[:, 2])


def test_moe_ops_registered_under_the_jax_names():
    import mxnet_tpu_torch as mx
    from mxnet_tpu import ops as jops
    from mxnet_tpu_torch import ops as tops

    for name, alias in (("_contrib_switch_moe", "switch_moe"),
                        ("_contrib_topk_moe", "topk_moe")):
        op = tops.get(name)
        assert tops.get(alias) is op
        assert op.num_outputs == jops.get(name).num_outputs
        assert callable(getattr(mx.nd.contrib, alias))
    x, gate, w_in, w_out, _ = _moe_inputs(3, 8, 4, 6, 2)
    with mx.cpu():
        args = [mx.nd.array(a) for a in (x, gate, w_in, w_out)]
        out, lb, z = mx.nd.contrib.topk_moe(*args, k=2)
        out1, aux1 = mx.nd.contrib.switch_moe(*args)
    assert out.shape == x.shape and lb.shape == () and z.shape == ()
    assert out1.shape == x.shape and aux1.shape == ()


def _moe_pair(seed, **kw):
    _, jmx, JMoE = _jax()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN

    jmx.random.seed(seed)
    jm = JMoE(units=16, hidden_size=8, **kw)
    jm.initialize(jmx.init.Xavier())
    tm = MoEFFN(units=16, hidden_size=8, **kw)
    tm.initialize(ctx=mx.cpu())
    for (_, a), (_, b) in zip(sorted(jm.collect_params().items()),
                              sorted(tm.collect_params().items())):
        b.set_data(a.data().asnumpy())
    x = np.random.RandomState(seed).normal(size=(2, 6, 16)).astype(
        np.float32)
    return jm, tm, x


def test_moeffn_aux_loss_channels_match_jax():
    """`test_moe_aux_loss_channels`: eager ``aux_loss`` (>= 1) with the
    gradient of out^2 + 0.01 aux reaching every table, and ``return_aux``
    after ``hybridize()``, both equal to the JAX layer's on the same
    weights."""
    _, jmx, _ = _jax()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    jm, tm, x = _moe_pair(0, num_experts=2)
    with mx.cpu():
        xt = mx.nd.array(x)
        with autograd.record():
            out = tm(xt)
            L = (out * out).mean() + 0.01 * tm.aux_loss
        L.backward()
    with jmx.autograd.record():
        jout = jm(jmx.nd.array(x))
        jL = (jout * jout).mean() + 0.01 * jm.aux_loss
    jL.backward()
    assert float(tm.aux_loss.asnumpy()) >= 1.0 - 1e-5
    np.testing.assert_allclose(float(tm.aux_loss.asnumpy()),
                               float(jm.aux_loss.asnumpy()), rtol=AUX_TOL)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=OUT_TOL * np.abs(jout.asnumpy()).max())
    for (n, a), (_, b) in zip(sorted(jm.collect_params().items()),
                              sorted(tm.collect_params().items())):
        ga, gb = a.grad().asnumpy(), b.grad().asnumpy()
        np.testing.assert_allclose(gb, ga, rtol=0,
                                   atol=OUT_TOL * np.abs(ga).max(),
                                   err_msg=n)
    jm2, tm2, _ = _moe_pair(0, num_experts=2, return_aux=True)
    tm2.hybridize()
    with mx.cpu():
        out2, aux2 = tm2(mx.nd.array(x))
    jout2, jaux2 = jm2(jmx.nd.array(x))
    assert out2.shape == x.shape and aux2.shape == ()
    assert tm2.aux_loss is None
    np.testing.assert_allclose(float(aux2.asnumpy()),
                               float(jaux2.asnumpy()), rtol=AUX_TOL)


def test_moeffn_topk_routing_matches_jax():
    """`test_moe_topk_routing`: top-2 with the z-loss differs from top-1
    on the same weights, folds z into aux, and reaches every table; each
    equal to the JAX layer's."""
    _, jmx, _ = _jax()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd

    kw = dict(num_experts=4, return_aux=True)
    j1, t1, x = _moe_pair(1, **kw)
    j2, t2, _ = _moe_pair(1, num_experts_per_token=2, z_loss_coef=1e-3,
                          capacity_factor=4.0, **kw)
    j3, t3, _ = _moe_pair(1, num_experts_per_token=2, capacity_factor=4.0,
                          **kw)
    for t in (t2, t3):
        for a, b in zip(t1.collect_params().values(),
                        t.collect_params().values()):
            b.set_data(a.data())
    for j in (j2, j3):
        for a, b in zip(j1.collect_params().values(),
                        j.collect_params().values()):
            b.set_data(a.data())
    with mx.cpu():
        xt = mx.nd.array(x)
        o1, a1 = t1(xt)
        with autograd.record():
            o2, a2 = t2(xt)
            L = (o2 * o2).mean() + 0.01 * a2
        L.backward()
        _, a3 = t3(xt)
    jo2, ja2 = j2(jmx.nd.array(x))
    assert not np.allclose(o1.asnumpy(), o2.asnumpy(), atol=1e-5)
    assert float(a2.asnumpy()) > float(a3.asnumpy())
    np.testing.assert_allclose(o2.asnumpy(), jo2.asnumpy(), rtol=0,
                               atol=OUT_TOL * np.abs(jo2.asnumpy()).max())
    np.testing.assert_allclose(float(a2.asnumpy()), float(ja2.asnumpy()),
                               rtol=AUX_TOL)
    for p in t2.collect_params().values():
        g = p.grad().asnumpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0


def test_trainer_refuses_a_mesh_larger_than_the_world():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError

    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    mesh = mx.parallel.make_mesh([("dp", 2)], devices=_records(2))
    with pytest.raises(MXNetError, match="a mesh of 2 devices over a world "
                                         "of 1"):
        mx.parallel.DistributedTrainer(net, "sgd", mesh=mesh)


def test_convert_places_a_moe_nets_jax_parameters_by_name():
    """`convert.vision_params_from_jax` carries a JAX Gluon net holding an
    `MoEFFN` (``train_moe.py``'s structure) into the port's, by name; the
    expert tables keep their (E, d, h) / (E, h, d) layout and the two
    forwards agree within 1e-5 of the largest magnitude."""
    _, jmx, JMoE = _jax()
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.contrib.moe import MoEFFN

    def build(gluon, moe_cls):
        class MoELM(gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.embed = gluon.nn.Embedding(20, 8)
                    self.mix = gluon.nn.Dense(8, flatten=False,
                                              activation="relu")
                    self.moe = moe_cls(units=8, hidden_size=16,
                                       num_experts=4,
                                       num_experts_per_token=2,
                                       return_aux=True)
                    self.head = gluon.nn.Dense(20, flatten=False)

            def hybrid_forward(self, F, tokens):
                h = self.embed(tokens)
                h = h + self.mix(h)
                ffn, aux = self.moe(h)
                return self.head(h + ffn), aux

        return MoELM()

    tokens = np.random.RandomState(4).randint(0, 20, (2, 6)).astype(
        np.float32)
    jmx.random.seed(4)
    jnet = build(jmx.gluon, JMoE)
    jnet.initialize(jmx.init.Xavier())
    want, want_aux = jnet(jmx.nd.array(tokens))
    tnet = build(mx.gluon, MoEFFN)
    tnet.initialize(ctx=mx.cpu())
    with mx.cpu():
        tnet(mx.nd.array(tokens))
    state = convert.vision_params_from_jax(
        {k: p.data().asnumpy() for k, p in jnet.collect_params().items()},
        tnet)
    assert tuple(state["moe.expert_w_in"].shape) == (4, 8, 16)
    assert tuple(state["moe.expert_w_out"].shape) == (4, 16, 8)
    assert tuple(state["moe.gate_weight"].shape) == (4, 8)
    tnet.load_state_dict(state)
    with torch.no_grad():
        got, got_aux = tnet(torch.from_numpy(tokens))
    w = want.asnumpy()
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=OUT_TOL * np.abs(w).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux.asnumpy()),
                               rtol=AUX_TOL)
