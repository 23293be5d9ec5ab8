"""Serving observability: metrics registry + step-phase tracing (the port's
copy of ``repro/obs/__init__.py``; the reference's modules import no
framework, so the port keeps its own).

LAMP's accuracy/throughput trade is steered by *telemetry* -- the recompute
rate is the paper's control variable -- so the serving stack treats
observability as a first-class subsystem rather than a pile of ad-hoc
counters:

  metrics.py  -- Counter / Gauge / Histogram registry with labeled children,
                 dict snapshots and Prometheus text exposition. The engine's
                 `stats()` is a view over one of these.
  tracing.py  -- ring-buffered step-phase span tracer exporting Chrome trace
                 format JSON (chrome://tracing / Perfetto loadable).

`Observability` bundles both behind a single injectable clock: every span it
opens is timed into a per-phase duration histogram (always on -- a dict
lookup and two float adds) and, when `ObsConfig.trace` is set, also recorded
as a trace event. Compile events are logged with their bucket shape and
wall time; the port has no jit cache, and its engine records the first run
in the process of a (step function, bucket) key instead
(``serving.engine.reset_step_caches``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

from .metrics import (Counter, DEFAULT_TIME_EDGES, Gauge, Histogram,
                      MetricsRegistry)
from .tracing import NULL_TRACER, NullTracer, StepTracer

# per-phase duration edges (seconds): 10us .. 10s, ~x3 per bucket
PHASE_EDGES = (1e-5, 3.16e-5, 1e-4, 3.16e-4, 1e-3, 3.16e-3, 1e-2, 3.16e-2,
               1e-1, 3.16e-1, 1.0, 3.16, 10.0)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (hashable: lives inside frozen EngineConfig).

    The metrics registry and per-phase duration histograms are always on
    (their hot-path cost is a cached dict lookup plus float adds);
    `trace` additionally records every phase span into the ring buffer for
    Chrome-trace export."""
    trace: bool = False             # record step-phase spans
    trace_capacity: int = 8192      # ring-buffer size (events)
    trace_path: str = ""            # default write_trace() destination
    series_capacity: int = 512      # per-layer recompute-rate series length
    compile_log_capacity: int = 256  # compile_events retained
    torch_profile_dir: str = ""     # opt-in torch.profiler passthrough


class _ObsSpan:
    """Times one engine phase: always observes the per-phase histogram,
    and records a trace span when tracing is enabled."""

    __slots__ = ("_obs", "name", "args", "t0")

    def __init__(self, obs: "Observability", name: str,
                 args: Optional[Dict[str, Any]]):
        self._obs = obs
        self.name = name
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_ObsSpan":
        self.t0 = self._obs.now()
        return self

    def __exit__(self, *exc) -> None:
        obs = self._obs
        dt = obs.now() - self.t0
        obs.phase_hist(self.name).observe(dt)
        if obs.tracer.enabled:
            obs.tracer._record(("X", self.name, "step", self.t0, dt,
                                self.args))

    @property
    def elapsed(self) -> float:
        return self._obs.now() - self.t0


class Observability:
    """One engine's observability bundle: registry + tracer + clock."""

    def __init__(self, config: ObsConfig = ObsConfig(),
                 clock: Optional[Callable[[], float]] = None):
        self.config = config
        self.now: Callable[[], float] = clock or time.monotonic
        self.registry = MetricsRegistry()
        self.tracer = (StepTracer(config.trace_capacity, clock=self.now)
                       if config.trace else NULL_TRACER)
        self._phase_fam = self.registry.histogram(
            "engine_phase_seconds", edges=PHASE_EDGES,
            help="wall time per engine step phase", unit="s",
            labels=("phase",))
        self._phase_children: Dict[str, Histogram] = {}
        self._compile_counter = self.registry.counter(
            "engine_compiles_total", help="jit compiles by step kind",
            labels=("kind",))
        self.compile_events: Deque[Dict[str, Any]] = deque(
            maxlen=config.compile_log_capacity)

    # -- phase spans --------------------------------------------------------

    def phase_hist(self, name: str) -> Histogram:
        h = self._phase_children.get(name)
        if h is None:
            h = self._phase_fam.labels(name)
            self._phase_children[name] = h
        return h

    def span(self, name: str, **args) -> _ObsSpan:
        return _ObsSpan(self, name, args or None)

    # -- compile events -----------------------------------------------------

    def record_compile(self, kind: str, shape: Any, wall_s: float,
                       step: int) -> None:
        """Log one compile event: `shape` is the bucket signature that was
        new (e.g. (batch_bucket, window_bucket)); `wall_s` the wall time of
        the call that ran it first."""
        self._compile_counter.labels(kind).inc()
        self.compile_events.append({
            "kind": kind, "shape": tuple(shape), "wall_s": wall_s,
            "step": step, "t": self.now(),
        })
        if self.tracer.enabled:
            self.tracer.instant(f"compile:{kind}", cat="compile",
                                shape=str(tuple(shape)),
                                wall_ms=round(wall_s * 1e3, 3))

    # -- export -------------------------------------------------------------

    def write_trace(self, path: Optional[str] = None) -> str:
        path = path or self.config.trace_path
        if not path:
            raise ValueError("no trace path: pass one or set "
                             "ObsConfig.trace_path")
        return self.tracer.write(path)

    @contextlib.contextmanager
    def profile(self):
        """Opt-in ``torch.profiler`` passthrough around a serving run (host
        activity, and the card's where CUDA is available), exported as a
        Chrome trace ``trace.json`` into ObsConfig.torch_profile_dir; a
        no-op unless that is set."""
        out_dir = self.config.torch_profile_dir
        if not out_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullTracer",
    "NULL_TRACER", "StepTracer", "ObsConfig", "Observability",
    "DEFAULT_TIME_EDGES", "PHASE_EDGES",
]

# imported last: audit.py needs Observability from this module
from .audit import AuditConfig, ShadowAuditor, audit_hash  # noqa: E402
from .error_model import calibrate, derive_target_rates, relax_mask  # noqa: E402

__all__ += ["AuditConfig", "ShadowAuditor", "audit_hash", "calibrate",
            "derive_target_rates", "relax_mask"]
