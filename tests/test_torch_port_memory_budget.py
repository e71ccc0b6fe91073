"""The port's memory figures and serving memory budget against the JAX
package's.

The figures' arithmetic (`sum_figures`, `bucket_figures`,
`footprint_bytes`, `model_footprint`, `parse_bytes`,
`serve_memory_budget` with its ``warn:`` posture) on the same inputs; the
same stub models in both packages' repositories for the 507
`MemoryBudgetError` breakdown and `reclaim_memory`'s order (a cold pool
shrinks before an idle model is evicted, a pinned one never); a port
`ServedModel`'s ``bucket_memory["arguments"]``, its parameter bytes
exactly; and ``bucket_flops`` of a Dense stack, counted by
`FlopCounterMode` in the port and by XLA's cost analysis in the JAX
package, within 5 % of each other (measured on this stack: 0.9903 at
every bucket, the JAX figure counting the bias adds and ReLUs the
counter leaves out).
"""
import os
import subprocess
import sys
import time

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.serving import MemoryBudgetError as JaxBudgetError
from mxnet_tpu.serving import ModelRepository as JaxRepository
from mxnet_tpu.telemetry import memory as jmemory
from mxnet_tpu_torch import telemetry as ptelemetry
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.serving import MemoryBudgetError as PortBudgetError
from mxnet_tpu_torch.serving import ModelRepository as PortRepository
from mxnet_tpu_torch.telemetry import memory as pmemory

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": (JaxRepository, JaxBudgetError, JaxError, jtelemetry),
    "port": (PortRepository, PortBudgetError, PortError, ptelemetry),
}


@pytest.fixture(autouse=True)
def no_slo_threads(monkeypatch):
    # the batchers would start both packages' SLO evaluators
    monkeypatch.setenv("MXTPU_SLO", "0")


# ---------------------------------------------------------------------------
# the figures' arithmetic
# ---------------------------------------------------------------------------

_FIGS = [
    {"arguments": 1000, "outputs": 40, "temp": 300},
    {"arguments": 1000, "outputs": 80, "temp": 500, "generated_code": 7},
    {"arguments": 900, "outputs": 20, "temp": 0, "alias": 100},
    {"outputs": 5},
    {},
]


def test_figure_arithmetic_equals_jax():
    for mod in (jmemory, pmemory):
        assert mod.footprint_bytes(None) == 0
    assert pmemory.sum_figures(_FIGS) == jmemory.sum_figures(_FIGS)
    for f in _FIGS:
        assert pmemory.footprint_bytes(f) == jmemory.footprint_bytes(f)
    per_bucket = {1: _FIGS[0], 2: _FIGS[1], 4: _FIGS[2]}
    assert pmemory.model_footprint(per_bucket) \
        == jmemory.model_footprint(per_bucket) == 1000 + 340 + 587 + 20
    assert pmemory.model_footprint({}) is jmemory.model_footprint({}) is None
    # bucket_figures: entries a warm recorded, plus table entries of keys
    # it only touched, each counted once
    got = []
    for mod in (jmemory, pmemory):
        mark = mod.recorded_mark()
        mod.record_executable("fwd", "b1", "d-one", _FIGS[0], key=("k", 1))
        mod.record_executable("fwd", "b2", "d-two", _FIGS[1], key=("k", 2))
        entries = mod.recorded_since(mark)
        got.append((mod.bucket_figures([("k", 1)], entries[1:]),
                    mod.bucket_figures([("k", 2), ("nope",)], entries),
                    mod.lookup_key(("k", 2))["label"]))
    assert got[1] == got[0]


@pytest.mark.parametrize("text", ["1073741824", "512M", "1.5G", "24g", "2k",
                                  "3T", " 7 ", "", "lots", "1.5X", "-4K"])
def test_parse_bytes_equals_jax(text):
    assert pmemory.parse_bytes(text) == jmemory.parse_bytes(text)


@pytest.mark.parametrize("raw", [None, "", "24G", "warn:24G", "WARN:1000",
                                 "warn:", "junk", "warn:junk", "2500"])
def test_serve_memory_budget_equals_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("MXTPU_SERVE_MEMORY_BUDGET", raising=False)
    else:
        monkeypatch.setenv("MXTPU_SERVE_MEMORY_BUDGET", raw)
    assert pmemory.serve_memory_budget() == jmemory.serve_memory_budget()


# ---------------------------------------------------------------------------
# the same stub models in both repositories
# ---------------------------------------------------------------------------

class _Pool:
    def __init__(self, size, error):
        self.size = size
        self._error = error

    def add_replica(self):
        self.size += 1
        return self.size - 1

    def remove_replica(self, replica_id=None, drain=True, timeout=None,
                       floor=1):
        assert drain
        if self.size <= max(1, floor):
            raise self._error("cannot shrink below floor")
        self.size -= 1
        return self.size


class _Model:
    """The duck type both repositories and autoscalers read."""

    def __init__(self, error, name, size=1, memory_bytes=None, pooled=True,
                 min_replicas=None, max_replicas=None, pinned=False,
                 idle_s=0.0):
        self.name, self.version = name, 1
        self.pool = _Pool(size, error) if pooled else None
        self.memory_bytes = memory_bytes
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.pinned = pinned
        self.loaded_at = time.time() - idle_s
        self.closed = False

    @property
    def resident_copies(self):
        return self.pool.size if self.pool is not None else 1

    @property
    def effective_memory_bytes(self):
        if not self.memory_bytes:
            return None
        return self.memory_bytes * self.resident_copies

    def pending(self):
        return 0

    def close(self, drain=True, timeout=None):
        self.closed = True
        return True

    def describe(self):
        return {"name": self.name, "version": self.version}


def _decisions(tm, names, since):
    return [(e["event"], e["fields"]["model"], e["fields"].get("reason"),
             e["fields"].get("freed_bytes"), e["fields"].get("size"))
            for e in tm.events()
            if e["event"].startswith("autoscale_") and e["ts"] >= since
            and e["fields"].get("model") in names]


def test_507_breakdown_equals_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_MEMORY_BUDGET", "3000")
    out = {}
    for key, (repo_cls, budget_err, err, _) in PACKAGES.items():
        repo = repo_cls()
        repo.add(_Model(err, "old", size=2, memory_bytes=1000))
        repo.add(_Model(err, "pin", pooled=False, memory_bytes=500,
                        pinned=True))
        with pytest.raises(budget_err) as ei:
            repo.add(_Model(err, "new", memory_bytes=2000))
        assert ei.value.status == 507
        out[key] = (str(ei.value), ei.value.details, repo.names())
    assert out["port"] == out["jax"]
    msg, details, names = out["port"]
    assert details["shortfall_bytes"] == 1500 and names == ["old", "pin"]
    assert "old/1=2000 bytes (x2)" in msg and ", pinned" in msg
    # warn: publishes anyway
    monkeypatch.setenv("MXTPU_SERVE_MEMORY_BUDGET", "warn:10")
    for _, (repo_cls, _, err, _) in PACKAGES.items():
        repo = repo_cls()
        repo.add(_Model(err, "a", memory_bytes=100))
        repo.add(_Model(err, "b", memory_bytes=100))
        assert repo.names() == ["a", "b"]


def test_reclaim_order_equals_jax(monkeypatch):
    """A cold pool shrinks to its floor first; then idle unpinned models
    are evicted coldest first; a pinned model never goes; a hot pool
    keeps its replicas."""
    monkeypatch.delenv("MXTPU_SERVE_MEMORY_BUDGET", raising=False)
    monkeypatch.setenv("MXTPU_AUTOSCALE_IDLE_S", "5")
    monkeypatch.setenv("MXTPU_AUTOSCALE_EVICT_TTL_S", "50")
    names = ["rc-pool", "rc-idle", "rc-colder", "rc-pinned", "rc-hot"]
    out = {}
    for key, (repo_cls, _, err, tm) in PACKAGES.items():
        since = time.time()
        repo = repo_cls()
        repo.add(_Model(err, "rc-pool", size=3, memory_bytes=100,
                        min_replicas=1, idle_s=20))
        repo.add(_Model(err, "rc-idle", pooled=False, memory_bytes=300,
                        idle_s=100))
        repo.add(_Model(err, "rc-colder", pooled=False, memory_bytes=50,
                        idle_s=400))
        repo.add(_Model(err, "rc-pinned", pooled=False, memory_bytes=700,
                        pinned=True, idle_s=1000))
        hot = _Model(err, "rc-hot", size=2, memory_bytes=10, idle_s=1)
        repo.add(hot)
        first = repo.reclaim_memory(150, exclude="other/1")
        second = repo.reclaim_memory(10000, exclude="other/1")
        out[key] = (first, second, repo.names(), hot.pool.size,
                    _decisions(tm, ["%s/1" % n for n in names], since))
    assert out["port"] == out["jax"]
    first, second, left, hot_size, trail = out["port"]
    assert (first, second) == (200, 350)
    assert left == ["rc-hot", "rc-pinned", "rc-pool"] and hot_size == 2
    assert [t[:2] for t in trail] == [
        ("autoscale_down", "rc-pool/1"), ("autoscale_down", "rc-pool/1"),
        ("autoscale_evict", "rc-colder/1"), ("autoscale_evict", "rc-idle/1")]


def test_load_reclaims_before_507_as_jax_does(monkeypatch):
    """`_add_with_reclaim`: a load short of room evicts an idle model and
    publishes; when only fresh residency is left it records `blocked` and
    507s."""
    monkeypatch.setenv("MXTPU_SERVE_MEMORY_BUDGET", "1000")
    monkeypatch.setenv("MXTPU_AUTOSCALE_EVICT_TTL_S", "10")
    out = {}
    for key, (repo_cls, budget_err, err, tm) in PACKAGES.items():
        since = time.time()
        repo = repo_cls()
        repo.add(_Model(err, "ld-cold", pooled=False, memory_bytes=600,
                        idle_s=100))
        repo._add_with_reclaim(_Model(err, "ld-new", pooled=False,
                                      memory_bytes=700))
        with pytest.raises(budget_err):
            repo._add_with_reclaim(_Model(err, "ld-pin", pooled=False,
                                          memory_bytes=400, pinned=True))
        out[key] = (repo.names(), _decisions(
            tm, ["ld-cold/1", "ld-new/1", "ld-pin/1"], since))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["ld-new"]
    assert [t[0] for t in out["port"][1]] == ["autoscale_evict",
                                              "autoscale_blocked"]


# ---------------------------------------------------------------------------
# a real export: parameter bytes and FLOPs
# ---------------------------------------------------------------------------

WIDTHS = (64, 128, 64)


@pytest.fixture(scope="module")
def dense_export(tmp_path_factory):
    jmx.random.seed(7)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(WIDTHS[1], activation="relu"), jnn.Dense(WIDTHS[2]))
    net.initialize()
    net(jmx.nd.zeros((2, WIDTHS[0])))
    prefix = str(tmp_path_factory.mktemp("dense") / "mlp")
    net.export(prefix, epoch=0)
    return prefix


def test_bucket_memory_arguments_are_the_parameter_bytes(dense_export):
    a, b, c = WIDTHS
    params = (a * b + b + b * c + c) * 4
    repo = PortRepository()
    model = repo.load("mlp", dense_export, input_shapes={"data": (a,)},
                      max_batch=4, device="cpu")
    try:
        assert sorted(model.bucket_memory) == [1, 2, 4]
        for bucket, fig in model.bucket_memory.items():
            assert fig["arguments"] == params
            assert fig["outputs"] == bucket * c * 4
            assert fig["temp"] == 0   # the host keeps no allocator peak
        assert model.memory_bytes == params + 7 * c * 4
        assert model.effective_memory_bytes == model.memory_bytes
        assert model.describe()["memory"]["per_bucket"]["4"] \
            == model.bucket_memory[4]
        warm = [e for e in ptelemetry.events()
                if e["event"] == "serve_bucket_warm"
                and e["fields"]["model"] == "mlp"]
        assert [e["fields"]["bucket"] for e in warm[-3:]] == [1, 2, 4]
    finally:
        repo.unload("mlp", timeout=10)


def test_bucket_flops_within_5_percent_of_jax(dense_export):
    a, b, c = WIDTHS
    shapes = {"data": (a,)}
    jrepo, prepo = JaxRepository(), PortRepository()
    jm = jrepo.load("mlp", dense_export, input_shapes=shapes, max_batch=4)
    pm = prepo.load("mlp", dense_export, input_shapes=shapes, max_batch=4,
                    device="cpu")
    try:
        assert sorted(pm.bucket_flops) == sorted(jm.bucket_flops) == [1, 2, 4]
        for bucket in (1, 2, 4):
            # the matrix products: 2 * bucket * (a*b + b*c)
            assert pm.bucket_flops[bucket] == 2 * bucket * (a * b + b * c)
            ratio = pm.bucket_flops[bucket] / jm.bucket_flops[bucket]
            assert 0.95 <= ratio <= 1.05, (bucket, ratio)
    finally:
        jrepo.unload("mlp", timeout=10)
        prepo.unload("mlp", timeout=10)


def test_counting_leaves_torch_dynamo_unimported():
    """A process's first counted call does not import ``torch._dynamo``
    (seconds of every replica's warm-up)."""
    code = ("import sys, torch\n"
            "from mxnet_tpu_torch.telemetry import flops\n"
            "_, f = flops.counted_call(torch.mm, torch.ones(8, 16),\n"
            "                          torch.ones(16, 4))\n"
            "assert f == 1024.0, f\n"
            "assert 'torch._dynamo' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
