"""Step-phase tracer: ring-buffered span events, Chrome-trace export (the
port's copy of ``repro/obs/tracing.py``, which imports no framework).

The engine wraps every phase of its step loop (schedule, block alloc,
prefill window, decode, draft, verify, host<->device sync, emit, defrag) in
`span(...)`; each completed span is one fixed-size tuple written into a
preallocated ring buffer, so a hot serving loop can trace indefinitely with
bounded memory and the *last* `capacity` events always available (hang
diagnostics read the tail).

Export is Chrome trace format (the JSON object form: {"traceEvents": [...]})
with complete events (`"ph": "X"`, microsecond `ts`/`dur`) plus instant
(`"i"`) and counter (`"C"`) events -- loadable in Perfetto / chrome://tracing
as-is. Timestamps come from the injected `clock` (seconds), so a fake clock
makes the tracer fully deterministic under test; they are rebased to the
first buffered event at export time.

`NULL_TRACER` is a shared no-op with the same surface: `tracer.span(...)`
costs one attribute lookup and a constant context manager when tracing is
off, keeping the engine free of `if tracing:` branches.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

# event kinds (Chrome trace "ph" values)
_COMPLETE, _INSTANT, _COUNTER = "X", "i", "C"


class _Span:
    """Reusable-shape span context manager; one is allocated per span()
    call (cheap), records on clean exit AND on exception so a crashing
    phase still shows up in the trace tail."""

    __slots__ = ("_tr", "name", "cat", "args", "t0")

    def __init__(self, tr: "StepTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = self._tr._clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tr
        tr._record((_COMPLETE, self.name, self.cat, self.t0,
                    tr._clock() - self.t0, self.args))

    @property
    def elapsed(self) -> float:
        return self._tr._clock() - self.t0


class _NullSpan:
    __slots__ = ()
    t0 = 0.0
    elapsed = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer with the full StepTracer surface."""

    enabled = False
    dropped = 0

    def span(self, name: str, cat: str = "step", **args):
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "step", **args) -> None:
        pass

    def counter(self, name: str, **values: float) -> None:
        pass

    def events(self) -> List[tuple]:
        return []

    def last(self, n: int) -> List[tuple]:
        return []

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": []}

    def write(self, path: str) -> None:
        raise RuntimeError("tracing is disabled; enable ObsConfig.trace")


NULL_TRACER = NullTracer()


class StepTracer(NullTracer):
    enabled = True

    def __init__(self, capacity: int = 8192,
                 clock: Callable[[], float] = time.monotonic,
                 pid: int = 0, tid: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self.pid = pid
        self.tid = tid
        self._buf: List[Optional[tuple]] = [None] * capacity
        self._n = 0                     # total events ever recorded

    # -- recording ----------------------------------------------------------

    def _record(self, ev: tuple) -> None:
        self._buf[self._n % self.capacity] = ev
        self._n += 1

    def span(self, name: str, cat: str = "step", **args) -> _Span:
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "step", **args) -> None:
        self._record((_INSTANT, name, cat, self._clock(), 0.0, args or None))

    def counter(self, name: str, **values: float) -> None:
        """Chrome counter event: Perfetto renders each named series as a
        stacked track (the per-layer recompute-rate time series)."""
        self._record((_COUNTER, name, "counter", self._clock(), 0.0,
                      dict(values)))

    # -- inspection ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def events(self) -> List[tuple]:
        """Buffered events, oldest first. Tuple layout:
        (ph, name, cat, t_start_s, dur_s, args | None)."""
        if self._n <= self.capacity:
            return [e for e in self._buf[:self._n]]
        head = self._n % self.capacity
        return self._buf[head:] + self._buf[:head]

    def last(self, n: int) -> List[tuple]:
        return self.events()[-n:]

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        evs = self.events()
        t0 = min((e[3] for e in evs), default=0.0)
        out = []
        for ph, name, cat, ts, dur, args in evs:
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph, "pid": self.pid,
                "tid": self.tid, "ts": round((ts - t0) * 1e6, 3),
            }
            if ph == _COMPLETE:
                ev["dur"] = round(dur * 1e6, 3)
            if ph == _INSTANT:
                ev["s"] = "t"           # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path
