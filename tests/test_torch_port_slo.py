"""The port's telemetry windows and SLO engine against the JAX package's.

One seeded observation stream (numpy) on a virtual clock goes into both
packages' registries: request latencies, admissions and rejections, queue
depth, KV occupancy, and a counter that stops moving. Both must then give
the same windowed deltas, rates, quantiles and staleness, the same
verdicts for every objective kind (burn rates included), the same errors
for each malformed spec, the same Prometheus text line for line, and the
same ``/statusz`` payload keys and verdict entries. Each test swaps in
fresh registries and engine state in both packages, and no evaluator
thread runs (``MXTPU_SLO_EVAL_MS`` far away): nothing here sleeps to move
a window. Also: a flight-recorder dump holds the JAX dump's keys, the
``MXTPU_TELEMETRY=0`` null metric, and the port's ``/metrics`` and
``/statusz`` endpoint.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest

from mxnet_tpu.telemetry import core as jcore
from mxnet_tpu.telemetry import goodput as jgoodput
from mxnet_tpu.telemetry import recorder as jrecorder
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu_torch.telemetry import core as pcore
from mxnet_tpu_torch.telemetry import goodput as pgoodput
from mxnet_tpu_torch.telemetry import recorder as precorder
from mxnet_tpu_torch.telemetry import slo as pslo

T0 = 1.0e6          # the virtual clock's origin, far from the wall clock
MODEL = "m/1"
WINDOWS = (10.0, 30.0, 120.0)


class _Clock:
    """Stand-in for a module's ``time``: a fixed virtual wall clock."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def no_first_step(monkeypatch):
    """The goodput block names the first training step's start-up cost
    once a trainer of this process has stepped; an earlier test file's
    JAX training must not put the key on one side only."""
    for goodput in (jgoodput, pgoodput):
        monkeypatch.setattr(goodput, "_FIRST_STEP_TS", None)


@pytest.fixture
def both(monkeypatch):
    """Fresh registries and SLO state in both packages, a 1 s window
    resolution, fast windows 10 s / 30 s, a 120 s slow window."""
    monkeypatch.setenv("MXTPU_SLO_WINDOW_MS", "1000")
    monkeypatch.setenv("MXTPU_SLO_EVAL_MS", "1e9")
    monkeypatch.setenv("MXTPU_SLO_FAST_WINDOWS", "10,30")
    monkeypatch.setenv("MXTPU_SLO_SLOW_WINDOW_S", "120")
    monkeypatch.delenv("MXTPU_SLO_SPEC", raising=False)
    for core, slo in ((jcore, jslo), (pcore, pslo)):
        slo.stop()
        monkeypatch.setattr(core, "_REGISTRY", core.Registry())
        monkeypatch.setattr(core, "_STATE", core._State())
        monkeypatch.setattr(slo, "_STATE", slo._SLOState())
    yield (jcore, jslo), (pcore, pslo)
    for _, slo in ((jcore, jslo), (pcore, pslo)):
        slo.stop()


def _feed(core, seed=0, steps=90):
    """The seeded stream, one virtual second a step, a roll each step.
    Returns the virtual times rolled."""
    rng = np.random.RandomState(seed)
    lab = {"model": MODEL}
    hist = core.histogram("mxtpu_serve_request_seconds", lab)
    reqs = core.counter("mxtpu_serve_requests_total", lab)
    rej = {r: core.counter("mxtpu_serve_rejected_total",
                           {"model": MODEL, "reason": r})
           for r in ("queue_full", "deadline", "shed")}
    queue = core.gauge("mxtpu_serve_queue_depth", lab)
    occ = core.gauge("mxtpu_serve_kv_occupancy", lab)
    steps_c = core.counter("mxtpu_steps_total", {"kind": "train"})
    times = []
    for i in range(steps):
        # a calm first half, then a surge: slower requests, sheds, a
        # fuller queue; the step counter stops at 2/3
        surge = i >= steps // 2
        n = int(rng.randint(5, 15))
        scale = 1.5 if surge else 0.05
        for v in rng.exponential(scale, n):
            hist.observe(float(v), exemplar="t%03d" % i)
        reqs.inc(n)
        if surge:
            rej["queue_full"].inc(int(rng.randint(0, 4)))
            rej["deadline"].inc(int(rng.randint(0, 2)))
        queue.set(float(rng.randint(40, 64) if surge else rng.randint(0, 8)))
        occ.set(float(rng.uniform(0.9, 1.0) if surge
                      else rng.uniform(0.1, 0.5)))
        if i < 2 * steps // 3:
            steps_c.inc()
        t = T0 + i
        assert core.roll_windows(now=t) > 0
        times.append(t)
    return times


def _objectives(slo):
    lab = {"model": MODEL}
    return [
        slo.Objective("p99", "latency_quantile",
                      metric="mxtpu_serve_request_seconds", labels=lab,
                      quantile=0.99, threshold=1.0),
        slo.Objective("p50", "latency_quantile",
                      metric="mxtpu_serve_request_seconds", labels=lab,
                      quantile=0.5, threshold=0.25, budget=0.2),
        slo.Objective("avail", "error_rate",
                      bad=[("mxtpu_serve_rejected_total", lab)],
                      total=[("mxtpu_serve_requests_total", lab),
                             ("mxtpu_serve_rejected_total",
                              dict(lab, reason="queue_full"))],
                      budget=0.01, labels=lab),
        slo.Objective("queue", "gauge_ceiling",
                      metric="mxtpu_serve_queue_depth", labels=lab,
                      threshold=32.0),
        slo.Objective("kv-floor", "gauge_floor",
                      metric="mxtpu_serve_kv_occupancy", labels=lab,
                      threshold=0.3, budget=0.5),
        slo.Objective("stale", "staleness", metric="mxtpu_steps_total",
                      labels={"kind": "train"}, threshold=15.0),
    ]


def _windowed(core, now):
    """Every windowed view of the stream's series at ``now``."""
    out = {}
    for m in core.get_registry().metrics():
        key = m.name + core._render_labels(m.labels)
        row = {}
        for w in WINDOWS:
            if m.kind == "counter":
                row[w] = (m.windowed_delta(w, now), m.windowed_rate(w, now))
            elif m.kind == "gauge":
                row[w] = (m.windowed_values(w, now),
                          m.windowed_stats(w, now))
            else:
                win = dict(m.windowed(w, now))
                win["bounds"] = list(win["bounds"])
                row[w] = (win, [m.windowed_quantile(q, w, now)
                                for q in (0.5, 0.9, 0.99)])
        if m.kind == "counter":
            row["since_change"] = m.seconds_since_change(now)
        if m.kind == "histogram":
            row["exemplars"] = {le: (e["value"], e["trace"])
                                for le, e in m.exemplars().items()}
        out[key] = row
    return out


def test_windowed_views_equal_jax(both):
    (jc, _), (pc, _) = both
    times = _feed(jc)
    assert _feed(pc) == times
    for now in (times[5] + 0.4, times[44], times[60] + 0.5, times[-1] + 3):
        assert _windowed(pc, now) == _windowed(jc, now), now
    # before a first roll there is no window (None / [] in both)
    for core in (jc, pc):
        fresh = core.counter("mxtpu_fresh_total")
        fresh.inc(3)
        assert fresh.windowed_delta(10, T0) is None
        assert fresh.seconds_since_change(T0) is None
    assert pc.quantile_from_deltas((1.0, 2.0, 4.0), [1, 2, 3, 0], 6, 0.7) \
        == jc.quantile_from_deltas((1.0, 2.0, 4.0), [1, 2, 3, 0], 6, 0.7)


def test_verdicts_and_burn_rates_equal_jax(both):
    (jc, js), (pc, ps) = both
    _feed(jc)
    _feed(pc)
    for slo in (js, ps):
        for obj in _objectives(slo):
            slo.register(obj)   # its evaluator parks (MXTPU_SLO_EVAL_MS)
    kinds = set()
    pages = set()
    for now in (T0 + 20, T0 + 50, T0 + 75, T0 + 95):
        want = js.compute_verdicts(now=now)
        got = ps.compute_verdicts(now=now)
        assert got == want, now
        kinds.update(v["kind"] for v in got)
        pages.update(v["slo"] for v in got if v["page"])
        for v in got:
            assert set(v["windows"]) == {"10s", "30s", "120s"}
    assert kinds == {"latency_quantile", "error_rate", "gauge_ceiling",
                     "gauge_floor", "staleness"}
    # the surge pages every objective at some point
    assert pages == {"p99", "p50", "avail", "queue", "stale"} | (
        pages & {"kv-floor"})
    # the built-in serving and generation objectives, and their removal
    for slo in (js, ps):
        slo.clear()
    monkey = pytest.MonkeyPatch()
    monkey.setenv("MXTPU_SLO", "1")
    try:
        for slo in (js, ps):
            slo.wire_serving_objectives(MODEL, queue_depth=64)
            slo.wire_generate_objectives(MODEL, queue_depth=64)
            slo.wire_training("train")
        assert [o.to_dict() for o in ps.objectives()] \
            == [o.to_dict() for o in js.objectives()]
        assert ps.compute_verdicts(now=T0 + 80) \
            == js.compute_verdicts(now=T0 + 80)
        for slo in (js, ps):
            slo.unregister_model(MODEL)
            assert slo.objectives() == []
    finally:
        for slo in (js, ps):
            slo.stop()
        monkey.undo()


_BAD_SPECS = [
    "not json",
    json.dumps([]),
    json.dumps({"objectives": {}}),
    json.dumps({"objectives": ["p99"]}),
    json.dumps({"objectives": [{"name": "x", "kind": "latency"}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "latency_quantile",
                                "metric": "mxtpu_nope_seconds",
                                "threshold": 1}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "latency_quantile",
                                "metric": "mxtpu_serve_request_seconds",
                                "treshold_ms": 5}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "latency_quantile",
                                "metric": "mxtpu_serve_request_seconds",
                                "threshold": 1, "threshold_ms": 5}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "error_rate",
                                "bad": ["mxtpu_serve_rejected_total"],
                                "total": ["mxtpu_serve_requests_total"]}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "error_rate",
                                "bad": ["mxtpu_serve_rejected_total"],
                                "total": ["mxtpu_serve_requests_total"],
                                "availability": 1.5}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "gauge_ceiling",
                                "metric": "mxtpu_serve_queue_depth"}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "latency_quantile",
                                "metric": "mxtpu_serve_request_seconds",
                                "threshold": 1, "quantile": 1.5}]}),
    json.dumps({"objectives": [{"name": "x", "kind": "gauge_ceiling",
                                "metric": "Bad-Name", "threshold": 1}]}),
]


@pytest.mark.parametrize("i", range(len(_BAD_SPECS)))
def test_spec_loader_errors_equal_jax(both, tmp_path, i):
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        f.write(_BAD_SPECS[i])
    msgs = []
    for _, slo in both:
        with pytest.raises(slo.SLOSpecError) as ei:
            slo.load_spec(path)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    missing = str(tmp_path / "none.json")
    errs = []
    for _, slo in both:
        with pytest.raises(slo.SLOSpecError) as ei:
            slo.load_spec(missing)
        errs.append(str(ei.value))
    assert errs[1] == errs[0]


def test_spec_file_objectives_register_and_survive_reload(both, tmp_path,
                                                          monkeypatch):
    spec = {"objectives": [
        {"name": "serve-p99:%s" % MODEL, "kind": "latency_quantile",
         "metric": "mxtpu_serve_request_seconds", "labels": {"model": MODEL},
         "threshold_ms": 300},
        {"name": "avail", "kind": "error_rate", "availability": 0.99,
         "bad": [{"metric": "mxtpu_serve_rejected_total",
                  "labels": {"model": MODEL}}],
         "total": [["mxtpu_serve_requests_total", {"model": MODEL}]],
         "labels": {"model": MODEL}}]}
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    monkeypatch.setenv("MXTPU_SLO", "1")
    monkeypatch.setenv("MXTPU_SLO_SPEC", path)
    got = []
    for _, slo in both:
        try:
            slo.wire_serving_objectives(MODEL, queue_depth=8)
            slo.unregister_model(MODEL)
            slo.wire_serving_objectives(MODEL, queue_depth=8)
            got.append(sorted((o.name, o.threshold, o.budget)
                              for o in slo.objectives()))
        finally:
            slo.stop()
    assert got[1] == got[0]
    assert ("serve-p99:%s" % MODEL, 0.3, pytest.approx(0.01)) in got[1]


def test_prometheus_text_equal_jax(both):
    (jc, _), (pc, _) = both
    _feed(jc, seed=3, steps=12)
    _feed(pc, seed=3, steps=12)
    jc.gauge("mxtpu_serve_pool_size", {"model": 'quo"te'}).set(2)
    pc.gauge("mxtpu_serve_pool_size", {"model": 'quo"te'}).set(2)
    want = jc.prometheus_text().splitlines()
    got = pc.prometheus_text().splitlines()
    assert len(got) > 30
    assert got == want


def test_statusz_payload_equals_jax(both, no_first_step, monkeypatch):
    (jc, js), (pc, ps) = both
    _feed(jc)
    _feed(pc)
    for slo in (js, ps):
        for obj in _objectives(slo):
            slo.register(obj)
        monkeypatch.setattr(slo, "time", _Clock(T0 + 92))
    jc.gauge("mxtpu_serve_pool_healthy", {"model": MODEL}).set(2)
    pc.gauge("mxtpu_serve_pool_healthy", {"model": MODEL}).set(2)
    want = js.statusz_payload(extra={"server": {"port": 1}})
    got = ps.statusz_payload(extra={"server": {"port": 1}})
    assert set(got) == set(want)
    assert set(got["slo"]) == set(want["slo"])
    assert got["slo"]["verdicts"] == want["slo"]["verdicts"]
    for key in ("rates", "pools", "server", "ts", "utc", "rank",
                "generation"):
        assert got[key] == want[key], key
    # an exemplar's own timestamp is the wall clock of its observation
    assert [dict(e, ts=None) for e in got["slowest_exemplars"]] \
        == [dict(e, ts=None) for e in want["slowest_exemplars"]]
    assert set(got["training"]) == set(want["training"])
    assert set(got["memory"]) == set(want["memory"])
    ctype, body = ps.render_statusz("text")
    assert ctype.startswith("text/plain") and b"BREACH" in body
    ctype, body = ps.render_statusz("json")
    assert json.loads(body)["slo"]["objectives"] == 6


def test_recorder_dump_holds_the_jax_dump_keys(no_first_step, tmp_path):
    paths = []
    for rec, name in ((jrecorder, "jax"), (precorder, "port")):
        rec.record_event("parity_probe", n=1)
        rec.record_alert("slo_breach", {"slo": "x"})
        paths.append(rec.dump("parity", path=str(tmp_path / name)))
    want, got = (json.load(open(p)) for p in paths)
    assert set(got) == set(want)
    assert set(got["memory"]) == set(want["memory"])
    assert set(got["goodput"]) == set(want["goodput"])
    assert got["reason"] == "parity"
    assert got["events"][-1]["event"] == "parity_probe"
    assert got["alerts"][-1]["fields"] == {"slo": "x"}
    assert got["threads"][0]["name"] == "MainThread"


def test_disabled_telemetry_hands_out_the_null_metric(monkeypatch):
    for core in (jcore, pcore):
        monkeypatch.setattr(core, "_STATE", core._State())
        core.set_enabled(False)
        m = core.counter("mxtpu_off_total")
        m.inc(5)
        assert m.snapshot() == {"type": "null"}
        assert m.windowed_delta(10) is None
        assert core.histogram("mxtpu_off_seconds").windowed_quantile(
            0.5, 10) is None
        assert core.roll_windows(now=T0) == 0


def test_metrics_and_statusz_endpoint(both):
    _, (pc, ps) = both
    pc.counter("mxtpu_serve_requests_total", {"model": MODEL}).inc(3)
    port = pc.start_http_server(port=0, addr="127.0.0.1")
    try:
        url = "http://127.0.0.1:%d" % port
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'mxtpu_serve_requests_total{model="m/1"} 3' in text
        assert "mxtpu_process_rss_bytes" in text
        with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["pid"] == os.getpid() and "verdicts" in doc["slo"]
        with urllib.request.urlopen(url + "/statusz?format=text",
                                    timeout=10) as r:
            assert r.read().startswith(b"statusz @")
    finally:
        assert pc.stop_http_server()
    assert not pc.stop_http_server()
