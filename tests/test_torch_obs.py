"""The port's metrics registry (``repro_torch.obs.metrics``) against the JAX
package's (``repro.obs.metrics``): the registry cases of tests/test_obs.py,
each run on both packages with the same inputs, then both packages' JSON
snapshots and Prometheus text compared for equality on one workload.

Tolerance: exact (the registry is plain Python arithmetic in both)."""

import importlib
import json

import numpy as np
import pytest

PACKAGES = ("repro.obs", "repro_torch.obs")


@pytest.fixture(params=PACKAGES)
def M(request):
    return importlib.import_module(request.param + ".metrics")


def test_counter_monotone(M):
    c = M.Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.value == 3.5


def test_gauge_last_write_wins(M):
    g = M.Gauge()
    g.set(5)
    g.inc(-2)
    assert g.value == 3.0


def test_histogram_bucket_boundaries(M):
    h = M.Histogram(edges=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 9.0):
        h.observe(v)
    # cumulative-le semantics: an observation exactly on an edge lands in
    # that edge's bucket, not the next one
    assert h.counts == [2, 2, 1, 1]       # (<=1, <=2, <=4, +Inf]
    assert h.count == 6
    assert h.sum == pytest.approx(18.0)
    assert h.vmin == 0.5 and h.vmax == 9.0


def test_histogram_rejects_bad_edges(M):
    for edges in ((), (2.0, 1.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            M.Histogram(edges=edges)


def test_histogram_quantile_bounded_and_ordered(M):
    h = M.Histogram(edges=(1e-3, 1e-2, 1e-1, 1.0))
    vals = np.random.default_rng(0).uniform(0.002, 0.5, size=500)
    for v in vals:
        h.observe(v)
    qs = [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)]
    assert all(a <= b + 1e-12 for a, b in zip(qs, qs[1:]))
    assert all(h.vmin <= q <= h.vmax for q in qs)
    assert abs(h.quantile(0.5) - np.percentile(vals, 50)) <= 0.1
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_histogram_single_bucket_and_empty(M):
    h = M.Histogram(edges=(1e-3, 1.0, 100.0))
    for v in (0.4, 0.5, 0.6):
        h.observe(v)
    # all mass in one bucket: the estimate stays inside the observed range
    assert 0.4 <= h.quantile(0.5) <= 0.6
    assert M.Histogram(edges=(1.0,)).quantile(0.5) == 0.0
    assert M.Histogram(edges=(1.0,)).mean == 0.0


def test_registry_labels_and_memoization(M):
    reg = M.MetricsRegistry()
    fam = reg.counter("steps_total", labels=("kind",))
    a1, a2 = fam.labels("prefill"), fam.labels("prefill")
    assert a1 is a2
    fam.labels("decode").inc(3)
    a1.inc()
    assert reg.snapshot()["steps_total"] == {"kind=prefill": 1.0,
                                             "kind=decode": 3.0}
    with pytest.raises(ValueError):
        fam.labels("a", "b")          # arity mismatch
    assert reg.counter("steps_total", labels=("kind",)) is fam
    with pytest.raises(ValueError):
        reg.gauge("steps_total")


def test_prometheus_exposition(M):
    reg = M.MetricsRegistry()
    reg.counter("reqs_total", help="requests").inc(2)
    h = reg.histogram("lat_seconds", edges=(0.1, 1.0), labels=("phase",))
    h.labels("decode").observe(0.05)
    h.labels("decode").observe(0.5)
    text = reg.to_prometheus()
    assert "# TYPE reqs_total counter" in text
    assert "reqs_total 2" in text
    assert 'lat_seconds_bucket{phase="decode",le="0.1"} 1' in text
    assert 'lat_seconds_bucket{phase="decode",le="+Inf"} 2' in text
    assert 'lat_seconds_count{phase="decode"} 2' in text


def _scrape(text, name):
    """One histogram family parsed back out of the exposition text:
    {labelset: {"buckets": [(le, cum), ...], "sum": x, "count": n}}."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.startswith(name):
            continue
        metric, val = line.rsplit(" ", 1)
        series, _, rest = metric.partition("{")
        labels = dict(p.split("=", 1) for p in rest[:-1].split(",") if p)
        labels = {k: v.strip('"') for k, v in labels.items()}
        le = labels.pop("le", None)
        child = out.setdefault(tuple(sorted(labels.items())),
                               {"buckets": [], "sum": None, "count": None})
        if series == f"{name}_bucket":
            child["buckets"].append((le, float(val)))
        elif series == f"{name}_sum":
            child["sum"] = float(val)
        elif series == f"{name}_count":
            child["count"] = float(val)
    return out


def _cums(child, edges):
    les = [le for le, _ in child["buckets"]]
    cums = [c for _, c in child["buckets"]]
    assert les == [f"{e:g}" for e in edges] + ["+Inf"]
    assert all(a <= b for a, b in zip(cums, cums[1:]))
    assert cums[-1] == child["count"]
    return cums


def test_prometheus_histogram_roundtrip_unlabeled(M):
    reg = M.MetricsRegistry()
    edges = (0.01, 0.1, 1.0, 10.0)
    h = reg.histogram("step_seconds", edges=edges, help="step wall")
    vals = [0.005, 0.05, 0.05, 0.5, 5.0, 50.0]   # one past the top edge
    for v in vals:
        h.observe(v)
    parsed = _scrape(reg.to_prometheus(), "step_seconds")
    assert set(parsed) == {()}
    assert _cums(parsed[()], edges) == [1, 3, 4, 5, 6]
    assert parsed[()]["sum"] == pytest.approx(sum(vals))


def test_prometheus_histogram_roundtrip_labeled(M):
    reg = M.MetricsRegistry()
    edges = (0.1, 1.0)
    fam = reg.histogram("lat_seconds", edges=edges, labels=("phase",))
    for v in (0.05, 0.5, 5.0):
        fam.labels("decode").observe(v)
    fam.labels("prefill").observe(0.5)
    parsed = _scrape(reg.to_prometheus(), "lat_seconds")
    assert set(parsed) == {(("phase", "decode"),), (("phase", "prefill"),)}
    assert _cums(parsed[(("phase", "decode"),)], edges) == [1, 2, 3]
    assert _cums(parsed[(("phase", "prefill"),)], edges) == [0, 1, 1]
    assert parsed[(("phase", "decode"),)]["sum"] == pytest.approx(5.55)


def _workload(M):
    """One registry fed the same mix in either package: labeled and plain
    counters, a gauge, labeled and plain histograms with random samples."""
    reg = M.MetricsRegistry()
    rng = np.random.default_rng(11)
    steps = reg.counter("engine_steps_total", help="steps", labels=("kind",))
    for kind, n in (("mixed", 7), ("prefill", 2), ("spec", 0)):
        steps.labels(kind).inc(n)
    reg.counter("engine_generated_tokens_total", help="tokens",
                unit="tokens").inc(123.5)
    reg.gauge("kv_util", help="arena utilization").set(0.375)
    ph = reg.histogram("engine_phase_seconds", edges=(1e-5, 1e-3, 0.1),
                       help="phase wall", unit="s", labels=("phase",))
    for name in ("schedule", "mixed", "sync"):
        for v in rng.exponential(1e-3, 17):
            ph.labels(name).observe(float(v))
    lat = reg.histogram("engine_request_latency_seconds")
    for v in rng.exponential(0.5, 9):
        lat.observe(float(v))
    return reg


def test_snapshots_equal_across_packages():
    a, b = (_workload(importlib.import_module(p + ".metrics"))
            for p in PACKAGES)
    assert json.dumps(a.snapshot(), sort_keys=True) == \
        json.dumps(b.snapshot(), sort_keys=True)


def test_prometheus_text_equal_across_packages():
    a, b = (_workload(importlib.import_module(p + ".metrics"))
            for p in PACKAGES)
    assert a.to_prometheus() == b.to_prometheus()
