"""Lightweight serving-metrics registry (the port's copy of
``repro/obs/metrics.py``, which imports no framework).

Three instrument kinds, Prometheus-shaped but dependency-free:

  * Counter   -- monotone float; inc() rejects negative deltas.
  * Gauge     -- last-write-wins float.
  * Histogram -- fixed bucket edges chosen at registration; observe() is a
                 bisect + two adds, and quantile(q) returns a streaming
                 estimate by linear interpolation inside the target bucket
                 (bounded by the observed min/max, so single-bucket
                 distributions do not smear across the whole edge span).

Instruments register by name once; re-registering returns the same object
(so engine re-instantiation in tests/benchmarks cannot double-register) and
re-registering under a different kind raises. A registration with
`labels=(...)` returns a _Family whose `.labels(v1, v2, ...)` children are
memoized by value tuple -- resolve children once outside the hot path and
the per-event cost is one float add; even unresolved, a labels() call is a
single dict lookup.

`snapshot()` renders everything to plain JSON-serializable dicts;
`to_prometheus()` renders the standard text exposition format (counters get
the `_total` convention from their registered name, histograms emit
cumulative `_bucket{le=...}` rows plus `_sum`/`_count`).
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

# default latency-style edges (seconds): 100us .. ~100s, x4 per bucket
DEFAULT_TIME_EDGES = (1e-4, 4e-4, 1.6e-3, 6.4e-3, 2.56e-2, 0.1024, 0.4096,
                      1.6384, 6.5536, 26.2144, 104.8576)


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with cumulative-`le` semantics: bucket i
    counts observations v <= edges[i]; everything above the last edge lands
    in the implicit +Inf bucket."""

    __slots__ = ("edges", "counts", "sum", "count", "vmin", "vmax")

    def __init__(self, edges: Sequence[float]) -> None:
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram edges must be non-empty and strictly "
                f"increasing, got {edges}")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # [..., +Inf]
        self.sum = 0.0
        self.count = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Streaming quantile estimate from the bucket counts.

        Finds the bucket holding the q-th observation and interpolates
        linearly inside it; the first/last populated buckets interpolate
        from the observed min / toward the observed max instead of the raw
        edge span, so estimates never leave [vmin, vmax]."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else self.vmin
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                frac = (target - cum) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += c
        return self.vmax   # pragma: no cover - unreachable (cum == count)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A labeled metric: children memoized by label-value tuple."""

    __slots__ = ("name", "kind", "label_names", "_edges", "_children")

    def __init__(self, name: str, kind: str, label_names: Tuple[str, ...],
                 edges: Optional[Sequence[float]] = None) -> None:
        self.name = name
        self.kind = kind
        self.label_names = label_names
        self._edges = edges
        self._children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, *values: Any):
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            if len(key) != len(self.label_names):
                raise ValueError(
                    f"{self.name} takes labels {self.label_names}, "
                    f"got {key}")
            child = (Histogram(self._edges) if self.kind == "histogram"
                     else _KINDS[self.kind]())
            self._children[key] = child
        return child

    def items(self):
        return self._children.items()


class MetricsRegistry:
    """Name -> instrument map with typed registration and exposition."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._meta: Dict[str, Tuple[str, str, str]] = {}  # kind, help, unit

    # -- registration -------------------------------------------------------

    def _register(self, name: str, kind: str, help: str, unit: str,
                  labels: Tuple[str, ...],
                  edges: Optional[Sequence[float]]):
        m = self._metrics.get(name)
        if m is not None:
            if self._meta[name][0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._meta[name][0]}, cannot re-register as {kind}")
            return m
        if labels:
            m = _Family(name, kind, tuple(labels), edges)
        elif kind == "histogram":
            m = Histogram(edges)
        else:
            m = _KINDS[kind]()
        self._metrics[name] = m
        self._meta[name] = (kind, help, unit)
        return m

    def counter(self, name: str, help: str = "", unit: str = "",
                labels: Sequence[str] = ()):
        return self._register(name, "counter", help, unit, tuple(labels),
                              None)

    def gauge(self, name: str, help: str = "", unit: str = "",
              labels: Sequence[str] = ()):
        return self._register(name, "gauge", help, unit, tuple(labels), None)

    def histogram(self, name: str, edges: Sequence[float] = DEFAULT_TIME_EDGES,
                  help: str = "", unit: str = "",
                  labels: Sequence[str] = ()):
        return self._register(name, "histogram", help, unit, tuple(labels),
                              edges)

    def get(self, name: str):
        return self._metrics.get(name)

    # -- exposition ---------------------------------------------------------

    @staticmethod
    def _render(kind: str, m) -> Any:
        if kind == "histogram":
            cum, buckets = 0, {}
            for e, c in zip(m.edges, m.counts):
                cum += c
                buckets[f"{e:g}"] = cum
            buckets["+Inf"] = m.count
            return {"count": m.count, "sum": m.sum, "mean": m.mean,
                    "p50": m.quantile(0.5), "p99": m.quantile(0.99),
                    "buckets": buckets}
        return m.value

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: scalar for unlabeled counters/gauges, nested
        dicts keyed "k=v,..." for families, bucket/summary dicts for
        histograms. JSON-serializable."""
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            kind = self._meta[name][0]
            if isinstance(m, _Family):
                out[name] = {
                    ",".join(f"{k}={v}" for k, v in zip(m.label_names, key)):
                    self._render(kind, child) for key, child in m.items()}
            else:
                out[name] = self._render(kind, m)
        return out

    def to_prometheus(self) -> str:
        """Standard text exposition format."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            kind, help, unit = self._meta[name]
            if help:
                lines.append(f"# HELP {name} {help}"
                             + (f" ({unit})" if unit else ""))
            lines.append(f"# TYPE {name} {kind}")
            fams = m.items() if isinstance(m, _Family) else [((), m)]
            names = m.label_names if isinstance(m, _Family) else ()
            for key, child in fams:
                lbl = ",".join(f'{k}="{v}"' for k, v in zip(names, key))
                if kind == "histogram":
                    cum = 0
                    for e, c in zip(child.edges, child.counts):
                        cum += c
                        le = (lbl + "," if lbl else "") + f'le="{e:g}"'
                        lines.append(f"{name}_bucket{{{le}}} {cum}")
                    le = (lbl + "," if lbl else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{le}}} {child.count}")
                    sfx = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{sfx} {child.sum:g}")
                    lines.append(f"{name}_count{sfx} {child.count}")
                else:
                    sfx = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}{sfx} {child.value:g}")
        return "\n".join(lines) + "\n"
