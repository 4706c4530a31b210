"""The port's ``obs/`` and ``sim/metrics.py`` copies against the JAX
package's, and the vectorized engine's registry, tracer and trace record.

The same calls go to both packages' registries, sinks and tracers and must
give the same outputs (snapshots, quantiles, merges, JSONL lines, trace
events up to their clock readings, validation verdicts, coverage);
``summarize`` and its helpers on the same round log give the same
numbers. The engine: for the same run both packages count the same
dispatches and host syncs and record the same spans (names, categories,
arguments) and the same event trace.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.configs.base import FLConfig as JFL
from repro.data.synthetic import ClientDataset as JData
from repro.sim import metrics as jmetrics
from repro.sim.engine import run_vectorized as j_run
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.data.synthetic import ClientDataset as TData
from repro_torch.obs import trace as ttrace
from repro_torch.sim import metrics as tmetrics
from repro_torch.sim.engine import run_vectorized as t_run
from repro_torch.sim.scenarios import get_scenario as t_scenario

FL = dict(num_clients=6, buffer_size=3, local_steps=2, local_lr=0.05,
          batch_size=8, max_staleness=4)


def _drive_registry(obs):
    reg = obs.MetricsRegistry()
    reg.counter("uploads_total", route="fold").inc(3)
    reg.counter("uploads_total", route="drop").inc()
    reg.gauge("queue_depth").set(7)
    reg.gauge("queue_depth").inc(2)
    h = reg.histogram("latency_seconds", stage="apply")
    for x in np.random.default_rng(0).lognormal(-5, 1.5, 500):
        h.observe(float(x))
    reg.histogram("tiny", buckets=(1.0, 2.0)).observe(5.0)
    return reg, h


def test_registry_matches_jax():
    (jreg, jh), (treg, th) = _drive_registry(jobs), _drive_registry(tobs)
    assert treg.snapshot() == jreg.snapshot()
    assert list(treg.snapshot()) == list(jreg.snapshot())  # sorted keys
    assert treg.gauge_keys() == jreg.gauge_keys()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert math.isnan(tobs.Histogram("e").quantile(0.5))
    snaps = [treg.snapshot(), {"uploads_total{route=fold}": 2.0,
                               "queue_depth": 1.0}]
    assert tobs.merge_snapshots(snaps, treg.gauge_keys()) == \
        jobs.merge_snapshots(snaps, jreg.gauge_keys())
    assert tobs.export_snapshot(treg) == treg.snapshot()  # process 0
    assert tobs.export_snapshot(treg, gate=lambda: False) is None
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    for obs in (jobs, tobs):
        reg = obs.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("x").inc(-1)
        with pytest.raises(ValueError, match="strictly increasing"):
            obs.Histogram("h", buckets=(2.0, 1.0))
        with pytest.raises(ValueError):
            obs.Histogram("h").quantile(1.5)


def test_sinks_match_jax(tmp_path):
    events = [{"event": "a", "n": 1}, {"event": "b", "x": [1.5, 2.0]}]
    out = {}
    for name, obs in (("jax", jobs), ("torch", tobs)):
        path = tmp_path / f"{name}.jsonl"
        sink = obs.JsonlSink(str(path), stamp=False)
        for e in events:
            sink.emit(e)
        reg, _ = _drive_registry(obs)
        obs.emit_snapshot(sink, reg, round=3)
        sink.flush()
        sink.close()
        out[name] = path.read_text()
        mem = obs.InMemorySink()
        for e in events:
            mem.emit(e)
        assert mem.events == events
        gated = tmp_path / f"{name}_gated.jsonl"
        off = obs.JsonlSink(str(gated), gate=lambda: False)
        off.emit({"event": "never"})
        off.close()
        assert not gated.exists()  # a gated-out process never opens it
    assert out["torch"] == out["jax"]
    assert [json.loads(line)["event"] for line in out["torch"].splitlines()] \
        == ["a", "b", "metrics_snapshot"]
    stamped = tobs.JsonlSink(str(tmp_path / "t.jsonl"))
    stamped.emit({"event": "s"})
    stamped.close()
    assert "t" in json.loads((tmp_path / "t.jsonl").read_text())
    assert tobs.configure_logging("warning").name == "repro_torch"
    with pytest.raises(ValueError):
        tobs.configure_logging("loud")


def _strip_clock(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
            for e in doc["traceEvents"]]


def test_tracer_matches_jax(tmp_path):
    docs = {}
    for name, obs in (("jax", jobs), ("torch", tobs)):
        tr = obs.Tracer(annotate=False, tid=2)
        with tr.span(obs.SPAN_COLLECT, rounds=2, version=0):
            pass
        with tr.span(obs.SPAN_APPLY, cat="round"):
            pass
        tr.complete("contribute", tr.now(), 0.25, uploads=3)
        tr.instant("marker", why="x")
        docs[name] = tr.to_json()
        assert obs.Tracer(enabled=False).span("apply") is \
            obs.NULL_TRACER.span("collect_window")  # one shared no-op
        path = tr.write(str(tmp_path / f"{name}.json"))
        assert obs.validate_trace(json.load(open(path))) == 4
    assert _strip_clock(docs["torch"]) == _strip_clock(docs["jax"])
    assert tobs.SPAN_NAMES == jobs.SPAN_NAMES
    bad = [{"x": 1}, {"traceEvents": {}},
           {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0}]},
           {"traceEvents": [{"name": "a", "ph": "X", "ts": "0", "pid": 0,
                             "tid": 0}]},
           {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0,
                             "tid": 0, "dur": -1}]}]
    for doc in bad:
        for obs in (jobs, tobs):
            with pytest.raises(ValueError):
                obs.validate_trace(doc)
    doc = {"traceEvents": [
        {"name": "collect_window", "cat": "round", "ph": "X", "ts": 0,
         "dur": 10, "pid": 0, "tid": 0},
        {"name": "apply", "cat": "round", "ph": "X", "ts": 5, "dur": 10,
         "pid": 0, "tid": 0},
        {"name": "apply", "cat": "round", "ph": "X", "ts": 30, "dur": 10,
         "pid": 0, "tid": 0}]}
    assert tobs.span_coverage(doc) == jobs.span_coverage(doc) == 0.625


def test_tracer_spans_open_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span(tobs.SPAN_APPLY):
            torch.ones(4).sum()
    assert "apply" in {e.key for e in prof.key_averages()}


def test_windowed_profiler_exports_chrome_traces(tmp_path):
    prof = tobs.WindowedProfiler(str(tmp_path), every=2, window=1)
    for r in range(4):
        torch.ones(8).mul(2)
        prof.on_round(r)
    prof.close()
    for r in (0, 2):
        doc = json.load(open(tmp_path / f"round_{r}" / "trace.json"))
        assert "traceEvents" in doc
    assert not (tmp_path / "round_1").exists()
    assert tobs.WindowedProfiler(None, every=2).every == 0
    with pytest.raises(ValueError):
        tobs.WindowedProfiler(str(tmp_path), every=1, window=0)


def test_summarize_matches_jax():
    rng = np.random.default_rng(5)
    log = [{"version": v + 1, "clients": rng.integers(0, 9, 4).tolist(),
            "tau": rng.integers(0, 6, 4).tolist(),
            "staleness_deg": rng.uniform(0.01, 1.0, 4).tolist(),
            "weights": rng.normal(1.0, 0.5, 4).tolist(), "k": 4}
           for v in range(12)]
    assert tmetrics.summarize(log, 10) == jmetrics.summarize(log, 10)
    assert tmetrics.per_round(log) == jmetrics.per_round(log)
    assert tmetrics.summarize([], 10) == jmetrics.summarize([], 10)
    np.testing.assert_array_equal(tmetrics.participation_counts(log, 10),
                                  jmetrics.participation_counts(log, 10))
    for w in ([0.0, 0.0], [1.0, 1.0, 1.0, 1.0], [3.0, -1.0, 0.0]):
        assert tmetrics.weight_entropy(w) == jmetrics.weight_entropy(w)
    for v in ([], [0, 0], [1, 5, 9, 0]):
        assert tmetrics.gini(np.asarray(v)) == jmetrics.gini(np.asarray(v))


def _j_quad(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2), {}


def _t_quad(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _quad_clients(cls, n=6, size=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.arange(1.0, d + 1.0)
    return [cls(x=(x := rng.normal(size=(size, d)).astype(np.float32)),
                y=(x @ w_true + 0.05 * rng.normal(size=size))
                .astype(np.float32), seed=seed + 10 + i) for i in range(n)]


ENGINE_SERIES = ("engine_dispatches_total", "engine_host_syncs_total",
                 "engine_launch_seconds_count")


@pytest.mark.parametrize("capture", [False, True])
def test_engine_registry_and_spans_match_jax(capture):
    sc = "dropout-bernoulli"
    kw = dict(eval_every=3, seed=3, rounds_per_launch=2,
              capture_state=capture, record_trace=True)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jtr, ttr = jobs.Tracer(annotate=False), tobs.Tracer()
    jr = j_run(_j_quad, {"w": jnp.zeros(4)}, _quad_clients(JData), JFL(**FL),
               7, eval_fn=lambda p: {"n": float(jnp.sum(p["w"]))},
               scenario=j_scenario(sc), registry=jreg, tracer=jtr, **kw)
    tr = t_run(_t_quad, {"w": torch.zeros(4)}, _quad_clients(TData),
               TFL(**FL), 7, eval_fn=lambda p: {"n": float(torch.sum(p["w"]))},
               scenario=t_scenario(sc), registry=treg, tracer=ttr,
               device="cpu", **kw)
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    for key in ENGINE_SERIES:
        assert tsnap[key] == jsnap[key], key
    assert tsnap["engine_dispatches_total"] == tr.num_launches == \
        jr.num_launches == 5  # chunks of 2 clipped to evals: 2+1+2+1+1
    assert tsnap["engine_host_syncs_total"] == 1 + capture
    assert _strip_clock(ttr.to_json()) == _strip_clock(jtr.to_json())
    names = [e["name"] for e in ttr.to_json()["traceEvents"]]
    assert set(names) == {"collect_window", "apply", "host_sync"} | (
        {"checkpoint"} if capture else set())
    assert tr.trace.to_json() == jr.trace.to_json()
    assert tr.trace.events and tr.trace.drops


def test_engine_refuses_to_record_a_resumed_run():
    with pytest.raises(ValueError, match="record_trace"):
        t_run(_t_quad, {"w": torch.zeros(4)}, _quad_clients(TData),
              TFL(**FL), 2, init_state=object(), record_trace=True,
              device="cpu")


def test_engine_default_registry_counts_dispatches():
    reg = tobs.default_registry()
    before = reg.counter("engine_dispatches_total").value
    res = t_run(_t_quad, {"w": torch.zeros(4)}, _quad_clients(TData),
                TFL(**FL), 3, seed=0, device="cpu")
    assert reg.counter("engine_dispatches_total").value - before == \
        res.num_launches == 1
    assert ttrace.NULL_TRACER.events == []
