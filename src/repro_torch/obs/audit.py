"""Shadow-audit sampling (the port's copy of ``repro/obs/audit.py``, so far
its hash only: the fault injector draws its decisions from it; the audit
itself is not ported yet).
"""

from __future__ import annotations

__all__ = ["audit_hash"]

_MASK64 = (1 << 64) - 1


def audit_hash(step: int, req_id: int, salt: int = 0) -> float:
    """Deterministic (step, request, salt) -> [0, 1) via splitmix64 mixing.

    Pure and platform-independent (no Python `hash`, which is salted per
    process): the audit decision for a given stream replays exactly."""
    x = (step * 0x9E3779B97F4A7C15
         + req_id * 0xBF58476D1CE4E5B9
         + salt * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x / 2.0 ** 64
