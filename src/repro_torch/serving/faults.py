"""Fault types the KV pool and the scheduler raise.

Copied from the JAX package's ``serving/faults.py``: only the exception
classes this slice needs. Fault injection itself waits for a later slice.
"""

from __future__ import annotations

__all__ = ["FaultError", "ArenaAllocFault"]


class FaultError(RuntimeError):
    """Base class for injected faults (never raised by real failures)."""


class ArenaAllocFault(FaultError):
    """Simulated KV-pool block-allocation failure (raised by
    `PagedKVPool.alloc` when armed, before any pool state mutates)."""
