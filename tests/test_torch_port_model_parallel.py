"""The port's model-parallel axes (tp, fsdp, sp, pp) and BatchNorm over dp
against the JAX package, on the CPU.

Children of this file (``python tests/test_torch_port_model_parallel.py
--child four|two RANK WORLD RENDEZVOUS_FILE OUT_DIR``, spawned, never
forked) are gloo ranks that rendezvous through a ``file://`` under the
test's temporary directory, each killed at `TIMEOUT`. They import only the
port and write ``.npz`` files that the parent holds against the JAX
package on ``jax.devices()[:4]`` (or [:2]), from the same weights and
batches:

* 4 ranks: `DistributedTrainer` at dp 2 x tp 2 (`tests/test_parallel.py`'s
  MLP, Adam) and at fsdp 4 (its fsdp net, SGD with momentum), each rank
  holding 1/tp or 1/fsdp of each split parameter and of its optimizer
  states; BatchNorm (its aux-state net) and `SyncBatchNorm` (its
  sync-BN net, shards of wildly different scales) at dp 4 against the
  JAX trainer at dp 4 and on one device over the whole batch, and the
  same net with per-shard statistics (a mutation: the step scope hidden
  from the epilogue) differing from them; `ring_attention_sharded` over
  sp 4, causal and not; `pipeline_apply` at pp 4 against the stages run
  in sequence, forward and gradients; `PipelineTrainer` over BERT at pp 4
  (unmasked, masked by ``valid_length``, 8 microbatches, remat) against
  the JAX model's forward, its validation errors, and at dp 2 x pp 2
  (forward, and a step) against the JAX `PipelineTrainer`;
* 2 ranks: `pipeline_apply` at 2, 3 and 6 microbatches; `PipelineTrainer`
  at pp 2 trained 3 steps (SGD with momentum, remat) against the JAX
  trainer.

Tolerances: per-step losses within 1e-5 relative, parameters after the
steps within ``rtol=2e-4, atol=2e-5`` (`tests/test_parallel.py`'s);
BatchNorm's losses and moving statistics within ``rtol=1e-4, atol=1e-5``
(its sync-BN test's); the pipeline's outputs within ``rtol=1e-4,
atol=1e-5`` (`tests/test_pipeline_trainer.py`'s); ring attention within
1e-5 of the reference. Also the census: ``examples/distributed/
train_dist.py --tp 2`` at 2 gloo ranks through the import hook and the
``jax`` stand-in, ``jax.devices()`` giving the world's two.
"""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5
BN_RTOL, BN_ATOL = 1e-4, 1e-5
PIPE_RTOL, PIPE_ATOL = 1e-4, 1e-5
STEPS = 3
BERT = dict(vocab_size=50, units=32, hidden_size=64, num_heads=4,
            max_length=32, dropout=0.0)
VLEN = np.array([16, 12, 8, 4, 16, 3, 9, 16], np.float32)
# the pp 2 training's optimizer: SGD, not the JAX test's Adam, because the
# parameters are compared. Attention's key bias has a zero gradient (the
# softmax does not see a shift of every score of a row), and Adam turns
# its rounding noise into steps of the whole learning rate in either
# direction, so two correct implementations part there by ~lr.
PP2_SGD = {"learning_rate": 0.1, "momentum": 0.9}


# -- shared by the parent and the children

def _net(kind, pkg):
    """The JAX tests' nets in ``pkg`` (either package), prefixes fixed so
    both name every parameter alike."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=kind + "_")
    with net.name_scope():
        if kind == "tp":
            net.add(nn.Dense(32, activation="relu", prefix="d1_"),
                    nn.Dense(10, prefix="d2_"))
        elif kind == "fsdp":
            net.add(nn.Dense(64, activation="relu", prefix="d1_"),
                    nn.Dense(4, prefix="d2_"))
        elif kind == "bn":
            net.add(nn.Dense(16, prefix="d1_"),
                    nn.BatchNorm(in_channels=16, prefix="bn_"),
                    nn.Dense(3, prefix="d2_"))
        else:
            net.add(nn.Conv2D(4, 3, padding=1, use_bias=False, in_channels=3,
                              prefix="c_"),
                    pkg.gluon.contrib.nn.SyncBatchNorm(in_channels=4,
                                                       prefix="sbn_"),
                    nn.Flatten(), nn.Dense(3, prefix="d_"))
    return net


def _batch(kind):
    rng = np.random.RandomState({"tp": 1, "fsdp": 2, "bn": 3}.get(kind, 5))
    if kind == "tp":
        return (rng.randn(16, 20).astype(np.float32),
                rng.randint(0, 10, (16,)).astype(np.float32))
    if kind == "fsdp":
        return (rng.randn(8, 16).astype(np.float32),
                rng.randint(0, 4, (8,)).astype(np.float32))
    if kind == "bn":
        return (rng.randn(32, 8).astype(np.float32),
                rng.randint(0, 3, (32,)).astype(np.float32))
    # shards 0..3 at different scales: per-shard statistics would be far
    # from the global batch's
    x = np.concatenate([rng.normal(loc=i - 1.5, scale=0.5 + i,
                                   size=(2, 3, 8, 8)) for i in range(4)])
    return x.astype(np.float32), rng.randint(0, 3, (8,)).astype(np.float32)


def _trainer_args(kind, pkg, mesh):
    """(optimizer, params, rules) of each net's trainer."""
    if kind == "tp":
        return "adam", {"learning_rate": 0.01}, None
    if kind == "fsdp":
        return ("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                pkg.parallel.ShardingRules(fsdp_min_size=8))
    return "sgd", {"learning_rate": 0.1}, None


MESHES = {"tp": [("dp", 2), ("tp", 2)], "fsdp": [("fsdp", 4)],
          "bn": [("dp", 4)], "syncbn": [("dp", 4)], "mutant": [("dp", 4)]}


def _tokens():
    return np.random.RandomState(0).randint(0, 50, (8, 16)).astype(np.int32)


def _target():
    return np.random.RandomState(3).uniform(-1, 1, (8, 32)).astype(
        np.float32)


def _pipe_params(rng, d, n):
    return [{"w": rng.normal(0, 0.5, (d, d)).astype(np.float32),
             "b": rng.normal(0, 0.1, (d,)).astype(np.float32)}
            for _ in range(n)]


# -- the children (the port only)

def _set_params(net, init):
    """The JAX net's parameters placed by name (`convert`)."""
    from mxnet_tpu_torch import convert

    net.load_state_dict(convert.vision_params_from_jax(
        {k[len("param:"):]: v for k, v in init.items()
         if k.startswith("param:")}, net))


def _child_train(kind, mx, torch, init):
    gluon = mx.gluon
    net = _net("syncbn" if kind == "mutant" else kind, mx)
    net.initialize(ctx=mx.cpu())
    x, y = init["x"], init["y"]
    with mx.cpu():
        net(mx.nd.array(x))
    _set_params(net, init)
    mesh = mx.parallel.make_mesh(MESHES[kind])
    opt, params, rules = _trainer_args(kind, mx, mesh)
    trainer = mx.parallel.DistributedTrainer(
        net, opt, params, loss=gluon.loss.SoftmaxCrossEntropyLoss(),
        mesh=mesh, rules=rules)
    if kind == "mutant":
        from mxnet_tpu_torch.ops import nn as ops_nn

        ops_nn._batch_axis = lambda: None   # per-shard statistics
    losses = [float(trainer.step(x, y).asnumpy()) for _ in range(STEPS)]
    out = {"losses": np.array(losses)}
    for i in trainer._sharded:
        name = trainer._param_names[i]
        out["shard:" + name] = trainer._arrays[i].detach().numpy()
        state = trainer._states[i]
        if state is not None:
            for j, s in enumerate(state if isinstance(state, (list, tuple))
                                  else [state]):
                out["state%d:%s" % (j, name)] = s.asnumpy() \
                    if hasattr(s, "asnumpy") else s.detach().numpy()
    trainer.sync_params()
    for name, p in net.collect_params().items():
        out["param:" + name] = p.data().asnumpy()
    return out


def _child_ring(mx, torch, init):
    mesh = mx.parallel.make_mesh([("sp", 4)])
    q, k, v = (torch.from_numpy(init[n]) for n in "qkv")
    return {"causal%d" % c: mx.parallel.ring_attention_sharded(
        q, k, v, mesh=mesh, causal=bool(c)).numpy() for c in (0, 1)}


def _stage(torch):
    return lambda p, a: torch.tanh(a @ p["w"] + p["b"])


def _child_pipe(mx, torch, init, world):
    from mxnet_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                   pipeline_stack_params)

    n = world
    params = [{"w": torch.from_numpy(init["w%d" % i]),
               "b": torch.from_numpy(init["b%d" % i])} for i in range(n)]
    stacked = {k: v.requires_grad_(True)
               for k, v in pipeline_stack_params(params).items()}
    x = torch.from_numpy(init["x"]).requires_grad_(True)
    mesh = mx.parallel.make_mesh([("pp", n)])
    stage = _stage(torch)
    out = {}
    if n == 4:
        o = pipeline_apply(stage, stacked, x, num_microbatches=4, mesh=mesh)
        (o ** 2).sum().backward()
        out.update(out=o.detach().numpy(), gw=stacked["w"].grad.numpy(),
                   gb=stacked["b"].grad.numpy(), gx=x.grad.numpy())
        with torch.no_grad():
            out["remat"] = pipeline_apply(stage, stacked, x, 2, mesh=mesh,
                                          remat=True).numpy()
    else:
        with torch.no_grad():
            for m in (2, 3, 6):
                out["m%d" % m] = pipeline_apply(
                    stage, stacked, x, num_microbatches=m, mesh=mesh).numpy()
    return out


def _bert_port(mx, init, layers=4):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import BERTModel

    model = BERTModel(num_layers=layers, prefix="bert_", **BERT)
    model.initialize(ctx=mx.cpu())
    if layers == 4:
        _set_params(model, init)
    return model


def _child_pipeline_trainer(mx, torch, init, world):
    from mxnet_tpu_torch.base import MXNetError

    gluon = mx.gluon
    tok, target = init["tokens"], init["target"]
    out = {}
    model = _bert_port(mx, init)
    l2 = gluon.loss.L2Loss()
    if world == 4:
        mesh = mx.parallel.make_mesh([("pp", 4)])
        for name, kw in (("fwd", {}), ("micro8", {"num_microbatches": 8}),
                         ("remat", {"remat": True})):
            tr = mx.parallel.PipelineTrainer(
                model, "sgd", {"learning_rate": 0.0}, loss=l2, mesh=mesh,
                **kw)
            out[name] = tr.forward(tok).asnumpy()
        pre, cells, post = model.pipeline_stages()
        tr = mx.parallel.PipelineTrainer(
            model, "sgd", {"learning_rate": 0.0}, loss=l2, mesh=mesh,
            cells=cells, prelude=lambda t, v: pre(t, None, v), postlude=post)
        out["masked"] = tr.forward(tok, VLEN).asnumpy()
        dp = mx.parallel.make_mesh([("dp", 2), ("pp", 2)])
        tr = mx.parallel.PipelineTrainer(
            model, "sgd", {"learning_rate": 0.0}, loss=l2, mesh=dp,
            num_microbatches=2)
        out["dp_fwd"] = tr.forward(tok).asnumpy()
        out["dp_loss"] = np.array(float(tr.step(
            tok, np.zeros((8, 32), np.float32)).asnumpy()))
        # the JAX package's validation errors
        errs = []
        three = _bert_port(mx, init, layers=3)
        nopp = mx.parallel.make_mesh([("dp", 4)])
        cells = [gluon.nn.Dense(8, flatten=False, in_units=8, prefix="a_"),
                 gluon.nn.Dense(9, flatten=False, in_units=8, prefix="b_")]
        host = gluon.nn.HybridSequential()
        for c in cells:
            c.initialize(ctx=mx.cpu())
            host.register_child(c)
        for make in (
                lambda: mx.parallel.PipelineTrainer(three, "sgd", mesh=mesh),
                lambda: mx.parallel.PipelineTrainer(model, "sgd", mesh=nopp),
                lambda: mx.parallel.PipelineTrainer(
                    host, "sgd", mesh=dp, cells=cells, prelude=lambda a: a,
                    postlude=lambda a: a)):
            try:
                make()
                errs.append("")
            except MXNetError as e:
                errs.append(str(e))
        out["errors"] = np.array(errs)
    else:
        mesh = mx.parallel.make_mesh([("pp", 2)])
        tr = mx.parallel.PipelineTrainer(
            model, "sgd", PP2_SGD, loss=l2, mesh=mesh, remat=True)
        out["losses"] = np.array([float(tr.step(tok, target).asnumpy())
                                  for _ in range(STEPS)])
        out["leaf_shapes"] = np.array([tuple(a.shape)[:1] for a in
                                       tr._leaves])
        tr.sync_params()
        for name, p in model.collect_params().items():
            out["param:" + name] = p.data().asnumpy()
    return out


def _child_main(argv):
    group, rank, world, init_file, out_dir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx

    mx.parallel.init_process_group(
        num_processes=world, process_id=rank, backend="gloo",
        init_method="file://" + init_file, timeout=TIMEOUT)

    def init(name):
        return dict(np.load(os.path.join(out_dir, "init_%s.npz" % name)))

    if group == "four":
        runs = [(k, lambda k=k: _child_train(k, mx, torch, init(k)))
                for k in ("tp", "fsdp", "bn", "syncbn", "mutant")]
        runs += [("ring", lambda: _child_ring(mx, torch, init("ring"))),
                 ("pipe", lambda: _child_pipe(mx, torch, init("pipe4"), 4)),
                 ("ptrainer", lambda: _child_pipeline_trainer(
                     mx, torch, init("bert"), 4))]
    else:
        runs = [("pipe", lambda: _child_pipe(mx, torch, init("pipe2"), 2)),
                ("ptrainer", lambda: _child_pipeline_trainer(
                    mx, torch, init("bert"), 2))]
    with mx.cpu():
        for name, run in runs:
            np.savez(os.path.join(out_dir, "%s_%s_%d.npz"
                                  % (group, name, rank)), **run())
            mx.parallel.barrier()
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "mxnet_tpu"))
    assert not imported, imported
    torch.distributed.destroy_process_group()


def _spawn(group, world, tmp):
    """``world`` children of this file, each killed at `TIMEOUT`."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init_file = os.path.join(tmp, "rendezvous_" + group)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", group,
         str(r), str(world), init_file, tmp], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
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

def _jmx():
    import jax

    import mxnet_tpu as jmx

    return jax, jmx


def _jax_net(kind, seed):
    _, jmx = _jmx()
    jmx.random.seed(seed)
    net = _net(kind, jmx)
    net.initialize(jmx.init.Xavier())
    return net


def _jax_train(kind, net, x, y, ndev):
    jax, jmx = _jmx()
    axes = MESHES[kind] if ndev > 1 else [("dp", 1)]
    mesh = jmx.parallel.make_mesh(axes, devices=jax.devices()[:ndev])
    opt, params, rules = _trainer_args(kind, jmx, mesh)
    tr = jmx.parallel.DistributedTrainer(
        net, opt, params, loss=jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        mesh=mesh, rules=rules)
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(STEPS)]
    states = {}
    for k, i in enumerate(tr._trainable):
        st = tr._states[k]
        if st is not None:
            leaves = st if isinstance(st, (list, tuple)) else [st]
            states[tr._param_names[i]] = [np.asarray(s) for s in leaves]
    specs = {n: tuple(s.spec) for n, s in zip(tr._param_names,
                                              tr._shardings)}
    tr.sync_params()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return np.array(losses), params, states, specs


def _ref_attention(q, k, v, causal):
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        length = q.shape[1]
        s = np.where(np.tril(np.ones((length, length), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


def _jax_bert(layers=4):
    _, jmx = _jmx()
    from mxnet_tpu.gluon.model_zoo.transformer import BERTModel

    jmx.random.seed(7)
    model = BERTModel(num_layers=layers, prefix="bert_", **BERT)
    model.initialize(jmx.init.Xavier())
    model(jmx.nd.array(_tokens(), dtype=np.int32))
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, spawn the 4-rank and 2-rank groups, compute the
    JAX references meanwhile, and wait; at the module's end, collect."""
    tmp = str(tmp_path_factory.mktemp("model_parallel"))
    jax, jmx = _jmx()
    nets = {}
    for seed, kind in enumerate(("tp", "fsdp", "bn", "syncbn"), start=21):
        net = _jax_net(kind, seed)
        x, y = _batch(kind)
        net(jmx.nd.array(x))
        nets[kind] = (net, x, y)
        init = {"param:" + n: p.data().asnumpy()
                for n, p in net.collect_params().items()}
        np.savez(os.path.join(tmp, "init_%s.npz" % kind), x=x, y=y, **init)
        if kind == "syncbn":
            np.savez(os.path.join(tmp, "init_mutant.npz"), x=x, y=y, **init)
    rng = np.random.RandomState(4)
    qkv = {n: rng.randn(2, 32, 2, 8).astype(np.float32) for n in "qkv"}
    np.savez(os.path.join(tmp, "init_ring.npz"), **qkv)
    pipes = {}
    for n, (d, b) in ((4, (16, 8)), (2, (8, 12))):
        params = _pipe_params(np.random.RandomState(n), d, n)
        x = np.random.RandomState(n + 10).normal(size=(b, d)).astype(
            np.float32)
        pipes[n] = (params, x)
        np.savez(os.path.join(tmp, "init_pipe%d.npz" % n), x=x,
                 **{"%s%d" % (k, i): p[k] for i, p in enumerate(params)
                    for k in "wb"})
    bert = _jax_bert()
    np.savez(os.path.join(tmp, "init_bert.npz"), tokens=_tokens(),
             target=_target(), **{"param:" + n: p.data().asnumpy()
                                  for n, p in bert.collect_params().items()})
    four = _spawn("four", 4, tmp)
    two = _spawn("two", 2, tmp)
    ref = {}
    try:
        for kind, (net, x, y) in nets.items():
            init = {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}
            ref[kind] = _jax_train(kind, net, x, y, 4)
            if kind in ("bn", "syncbn"):
                for n, p in net.collect_params().items():
                    p.set_data(jmx.nd.array(init[n]))
                ref[kind + "_one"] = _jax_train(kind, net, x, y, 1)
        ref["ring"] = {c: np.asarray(jmx.parallel.ring_attention_sharded(
            qkv["q"], qkv["k"], qkv["v"], causal=bool(c),
            mesh=jmx.parallel.make_mesh([("sp", 4)],
                                        devices=jax.devices()[:4])))
            for c in (0, 1)}
        ref["pipe4"], ref["pipe2"] = _jax_pipelines(pipes)
        ref["bert"] = _jax_bert_refs(bert)
    finally:
        _join(four)
        _join(two)

    def load(group, name, world):
        return [dict(np.load(os.path.join(tmp, "%s_%s_%d.npz"
                                          % (group, name, r))))
                for r in range(world)]

    got = {k: load("four", k, 4) for k in ("tp", "fsdp", "bn", "syncbn",
                                           "mutant", "ring", "pipe",
                                           "ptrainer")}
    got["pipe2"] = load("two", "pipe", 2)
    got["ptrainer2"] = load("two", "ptrainer", 2)
    del nets, bert
    yield ref, got, qkv
    # the JAX nets and trainers left in reference cycles go now, not in a
    # collection during a later file's test (the JAX package's NDArray
    # live counts see it)
    gc.collect()


def _jax_pipelines(pipes):
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.parallel.mesh import make_mesh
    from mxnet_tpu.parallel.pipeline import (pipeline_apply,
                                             pipeline_stack_params)

    def stage(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    params, x = pipes[4]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    stacked = pipeline_stack_params(jp)
    mesh = make_mesh([("pp", 4)], devices=jax.devices()[:4])

    def seq(ps, a):
        for p in ps:
            a = stage(p, a)
        return a

    out = np.asarray(pipeline_apply(stage, stacked, jnp.asarray(x),
                                    num_microbatches=4, mesh=mesh))
    gs, gx = jax.grad(lambda s, xx: (pipeline_apply(
        stage, s, xx, num_microbatches=4, mesh=mesh) ** 2).sum(),
        argnums=(0, 1))(stacked, jnp.asarray(x))
    g_seq = jax.grad(lambda ps, xx: (seq(ps, xx) ** 2).sum(),
                     argnums=(0, 1))(jp, jnp.asarray(x))
    four = {"out": out, "seq": np.asarray(seq(jp, jnp.asarray(x))),
            "gw": np.asarray(gs["w"]), "gb": np.asarray(gs["b"]),
            "gx": np.asarray(gx),
            "seq_gw": np.stack([np.asarray(g["w"]) for g in g_seq[0]]),
            "seq_gx": np.asarray(g_seq[1])}
    params, x = pipes[2]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    mesh2 = make_mesh([("pp", 2)], devices=jax.devices()[:2])
    two = {"m%d" % m: np.asarray(pipeline_apply(
        stage, pipeline_stack_params(jp), jnp.asarray(x),
        num_microbatches=m, mesh=mesh2)) for m in (2, 3, 6)}
    two["seq"] = np.asarray(seq(jp, jnp.asarray(x)))
    return four, two


def _jax_bert_refs(bert):
    jax, jmx = _jmx()
    from mxnet_tpu.parallel import PipelineTrainer

    tok = jmx.nd.array(_tokens(), dtype=np.int32)
    out = {"pooled": bert(tok)[1].asnumpy(),
           "masked": bert(tok, None, jmx.nd.array(VLEN))[1].asnumpy()}
    init = {n: p.data().asnumpy() for n, p in bert.collect_params().items()}
    l2 = jmx.gluon.loss.L2Loss()
    dp = jmx.parallel.make_mesh([("dp", 2), ("pp", 2)],
                                devices=jax.devices()[:4])
    tr = PipelineTrainer(bert, "sgd", {"learning_rate": 0.0}, loss=l2,
                         mesh=dp, num_microbatches=2)
    out["dp_fwd"] = tr.forward(tok).asnumpy()
    out["dp_loss"] = float(tr.step(tok, jmx.nd.zeros((8, 32))).asnumpy())
    pp2 = jmx.parallel.make_mesh([("pp", 2)], devices=jax.devices()[:2])
    tr = PipelineTrainer(bert, "sgd", PP2_SGD, loss=l2, mesh=pp2,
                         remat=True)
    target = jmx.nd.array(_target())
    out["losses"] = np.array([float(tr.step(tok, target).asnumpy())
                              for _ in range(STEPS)])
    tr.sync_params()
    out["params"] = {n: p.data().asnumpy()
                     for n, p in bert.collect_params().items()}
    for n, p in bert.collect_params().items():
        p.set_data(jmx.nd.array(init[n]))
    return out


def _close_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _block(full, spec, coords):
    """The block of ``full`` that mesh coordinates ``coords`` ({axis:
    (index, size)}) hold under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = coords[entry]
        k = full.shape[dim] // n
        full = full.take(np.arange(i * k, (i + 1) * k), axis=dim)
    return full


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_trainer_over_tp_and_fsdp_matches_jax(runs, kind):
    """dp 2 x tp 2 (Adam) and fsdp 4 (SGD with momentum) on 4 gloo ranks
    against the JAX trainer on the same mesh shape: every step's loss and
    every parameter after `sync_params`, on every rank."""
    ref, got, _ = runs
    losses, params, _, _ = ref[kind]
    for r in range(4):
        g = got[kind][r]
        _close_losses(g["losses"], losses)
        for name, want in params.items():
            np.testing.assert_allclose(g["param:" + name], want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_each_rank_holds_its_block_and_its_states(runs, kind):
    """Each parameter the JAX rules split over tp or fsdp lives on rank r
    as its block (1/tp or 1/fsdp of it), and so do its optimizer states
    (Adam's mean and variance, SGD's momentum), equal to that block of the
    JAX trainer's; the port splits exactly the parameters JAX splits."""
    ref, got, _ = runs
    _, params, states, specs = ref[kind]
    split = sorted(n for n, s in specs.items() if any(e for e in s))
    assert split
    for r in range(4):
        g = got[kind][r]
        coords = {"dp": (r // 2, 2), "tp": (r % 2, 2)} if kind == "tp" \
            else {"fsdp": (r, 4)}
        held = sorted(k[len("shard:"):] for k in g if k.startswith("shard:"))
        assert held == split
        for name in split:
            block = _block(params[name], specs[name], coords)
            n = {"tp": 2, "fsdp": 4}[kind]
            assert g["shard:" + name].size * n == params[name].size
            np.testing.assert_allclose(g["shard:" + name], block, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            for j, st in enumerate(states[name]):
                want = _block(st, specs[name], coords)
                np.testing.assert_allclose(g["state%d:%s" % (j, name)], want,
                                           rtol=RTOL, atol=ATOL,
                                           err_msg="state %d %s" % (j, name))


@pytest.mark.parametrize("kind", ["bn", "syncbn"])
def test_batchnorm_over_dp_matches_the_global_batch(runs, kind):
    """BatchNorm and SyncBatchNorm at dp 4: the statistics are the global
    batch's, so every step's loss, the moving statistics and the
    parameters equal the JAX trainer's at dp 4 and on one device over the
    whole batch."""
    ref, got, _ = runs
    for which in (kind, kind + "_one"):
        losses, params, _, _ = ref[which]
        for r in range(4):
            g = got[kind][r]
            np.testing.assert_allclose(g["losses"], losses, rtol=BN_RTOL)
            for name, want in params.items():
                tol = (BN_RTOL, BN_ATOL) if "running" in name \
                    else (RTOL, ATOL)
                np.testing.assert_allclose(g["param:" + name], want,
                                           rtol=tol[0], atol=tol[1],
                                           err_msg="%s %s" % (which, name))
        moved = [n for n in params if "running_mean" in n]
        assert moved and not np.allclose(params[moved[0]], 0.0)


def test_per_shard_batchnorm_statistics_fail_the_comparison(runs):
    """The mutation: the same sync-BN net with each rank's statistics its
    own shard's (the step scope hidden from the epilogue) does not equal
    the global batch's, in the loss or in the moving statistics."""
    ref, got, _ = runs
    losses, params, _, _ = ref["syncbn_one"]
    g = got["mutant"][0]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(g["losses"], losses, rtol=BN_RTOL)
    name = [n for n in params if "running_var" in n][0]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(g["param:" + name], params[name],
                                   rtol=BN_RTOL, atol=BN_ATOL)


@pytest.mark.parametrize("causal", [0, 1])
def test_ring_attention_over_sp4_matches_jax(runs, causal):
    """`ring_attention_sharded` over sp 4 (K/V around the ring by
    point-to-point hops) on every rank against the JAX function over sp 4
    and numpy's full attention."""
    ref, got, qkv = runs
    want = _ref_attention(qkv["q"], qkv["k"], qkv["v"], bool(causal))
    np.testing.assert_allclose(ref["ring"][causal], want, rtol=1e-4,
                               atol=1e-5)
    for r in range(4):
        np.testing.assert_allclose(got["ring"][r]["causal%d" % causal],
                                   ref["ring"][causal], rtol=1e-5, atol=1e-5)


def test_pipeline_apply_pp4_forward_and_gradients(runs):
    """`pipeline_apply` at pp 4, 4 microbatches: the output on every rank
    equals the JAX pipeline's and the stages run in sequence; rank r's
    gradient of its stage's parameters equals row r of the JAX gradient
    (and the sequential one); the input's gradient is every rank's; remat
    at 2 microbatches gives the same output."""
    ref, got, _ = runs
    want = ref["pipe4"]
    np.testing.assert_allclose(want["out"], want["seq"], atol=1e-5)
    for r in range(4):
        g = got["pipe"][r]
        np.testing.assert_allclose(g["out"], want["out"], atol=1e-5)
        np.testing.assert_allclose(g["remat"], want["out"], atol=1e-5)
        np.testing.assert_allclose(g["gw"][r], want["gw"][r], atol=1e-4)
        np.testing.assert_allclose(g["gw"][r], want["seq_gw"][r], atol=1e-4)
        np.testing.assert_allclose(g["gb"][r], want["gb"][r], atol=1e-4)
        np.testing.assert_allclose(g["gx"], want["gx"], atol=1e-4)
        np.testing.assert_allclose(g["gx"], want["seq_gx"], atol=1e-4)
        others = [i for i in range(4) if i != r]
        assert not g["gw"][others].any()


def test_pipeline_microbatch_count_independent_at_pp2(runs):
    """2, 3 and 6 microbatches at pp 2 give one output, the JAX
    pipeline's."""
    ref, got, _ = runs
    for r in range(2):
        g = got["pipe2"][r]
        for m in (2, 3, 6):
            np.testing.assert_allclose(g["m%d" % m], ref["pipe2"]["m%d" % m],
                                       atol=1e-6)
            np.testing.assert_allclose(g["m%d" % m], ref["pipe2"]["seq"],
                                       atol=1e-5)


@pytest.mark.parametrize("which", ["fwd", "micro8", "remat", "masked"])
def test_bert_pipeline_forward_at_pp4_matches_jax(runs, which):
    """`PipelineTrainer` over BERT's stages at pp 4 (default microbatches,
    8 microbatches, remat; masked by ``valid_length`` riding with its
    microbatch) on every rank against the JAX model's own forward."""
    ref, got, _ = runs
    want = ref["bert"]["masked" if which == "masked" else "pooled"]
    for r in range(4):
        np.testing.assert_allclose(got["ptrainer"][r][which], want,
                                   rtol=PIPE_RTOL, atol=PIPE_ATOL)


def test_bert_pipeline_dp2_pp2_matches_jax(runs):
    """dp 2 x pp 2, 2 microbatches: the forward and a step's loss against
    the JAX `PipelineTrainer` on the same mesh shape."""
    ref, got, _ = runs
    for r in range(4):
        g = got["ptrainer"][r]
        np.testing.assert_allclose(g["dp_fwd"], ref["bert"]["dp_fwd"],
                                   rtol=PIPE_RTOL, atol=PIPE_ATOL)
        np.testing.assert_allclose(float(g["dp_loss"]),
                                   ref["bert"]["dp_loss"], rtol=1e-5)


def test_bert_pipeline_training_at_pp2_matches_jax(runs):
    """pp 2, SGD with momentum (`PP2_SGD`), remat: 3 steps' losses and
    every parameter after `sync_params` against the JAX `PipelineTrainer`;
    each rank holds its stage's 2 cells."""
    ref, got, _ = runs
    want = ref["bert"]
    for r in range(2):
        g = got["ptrainer2"][r]
        _close_losses(g["losses"], want["losses"])
        assert (g["leaf_shapes"] == 2).all()
        for name, p in want["params"].items():
            np.testing.assert_allclose(g["param:" + name], p, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    assert want["losses"][-1] < want["losses"][0]


def test_pipeline_trainer_validation_errors_match_jax(runs):
    """`tests/test_pipeline_trainer.py`'s refusals: 3 cells over pp 4, a
    mesh without pp, heterogeneous cells."""
    _, got, _ = runs
    for r in range(4):
        errs = [str(e) for e in got["ptrainer"][r]["errors"]]
        assert "divisible" in errs[0]
        assert "no 'pp' axis" in errs[1]
        assert "homogeneous" in errs[2]


# -- the census: train_dist.py --tp 2 at 2 ranks

_CENSUS = r"""
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

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mx.parallel.init_process_group(num_processes=world, process_id=rank,
                               backend="gloo", init_method="file://" + init)
standin = sys.modules["jax"] = chip_smoke.jax_standin()
assert len(standin.devices()) == world
script, sys.argv = sys.argv[4], sys.argv[4:]
with mx.context.scope(mx.cpu()):
    runpy.run_path(script, run_name="__main__")
assert sys.modules["jax"] is standin, "a real jax was imported"
assert not [m for m in sys.modules if m.startswith("jax.")], "jax imported"
"""


def test_train_dist_tp2_runs_at_two_ranks(tmp_path):
    """``examples/distributed/train_dist.py --tp 2 --steps 30`` (its own
    gate: the loss below 1.5 at 30 steps) at 2 gloo ranks through the
    import hook: ``jax.devices()`` gives the two ranks, the mesh is dp 1 x
    tp 2, and both ranks print the same losses."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CENSUS, str(r), "2", init,
         os.path.join(ROOT, "examples", "distributed", "train_dist.py"),
         "--tp", "2", "--steps", "30"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("train_dist.py --tp 2 did not finish in %d s" % TIMEOUT)
    assert all(p.returncode == 0 for p in procs), [lg[-3000:] for lg in logs]
    assert "mesh: {'dp': 1, 'tp': 2}" in logs[0], logs[0][-2000:]
    steps = [[ln for ln in lg.splitlines() if ln.startswith("step")]
             for lg in logs]
    assert len(steps[0]) == 4 and steps[0] == steps[1]
