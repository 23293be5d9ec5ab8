"""Straggler and failure detection for the training loop (a copy of
``repro/distributed/straggler.py``).

On a real multi-host job each host runs this monitor around its step; the
policy layer (runtime/train_loop.py) reacts:

  * slow step (> threshold x trailing median)   -> log + counter; repeated
    stragglers trigger a checkpoint so a scheduler can replace the host
  * missed heartbeat (host stops stepping)      -> after `grace` seconds the
    survivors restart from the last checkpoint on a shrunken mesh
    (checkpoint/elastic.py re-places the checkpoint on it)

Host-side logic only, free of any framework, so it is unit-testable and
portable to any launcher.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerPolicy:
    slow_factor: float = 2.0        # step is "slow" above factor x median
    window: int = 32                # trailing steps for the median
    max_consecutive_slow: int = 3   # then recommend checkpoint + replace
    heartbeat_timeout_s: float = 300.0


class StragglerMonitor:
    def __init__(self, policy: StragglerPolicy = StragglerPolicy(),
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.clock = clock
        self.durations: List[float] = []
        self.consecutive_slow = 0
        self.last_heartbeat: Dict[int, float] = {}
        self.events: List[dict] = []

    # ------------------------------------------------------------ steps
    def record_step(self, duration_s: float) -> Optional[str]:
        """Returns an action: None | 'warn_slow' | 'checkpoint_and_replace'."""
        self.durations.append(duration_s)
        hist = self.durations[-self.policy.window - 1: -1]
        if len(hist) < 5:
            return None
        med = statistics.median(hist)
        if duration_s > self.policy.slow_factor * med:
            self.consecutive_slow += 1
            ev = {"type": "slow_step", "duration": duration_s, "median": med,
                  "consecutive": self.consecutive_slow}
            self.events.append(ev)
            if self.consecutive_slow >= self.policy.max_consecutive_slow:
                self.consecutive_slow = 0
                return "checkpoint_and_replace"
            return "warn_slow"
        self.consecutive_slow = 0
        return None

    # ------------------------------------------------------- heartbeats
    def heartbeat(self, host_id: int) -> None:
        self.last_heartbeat[host_id] = self.clock()

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_heartbeat.items()
                if now - t > self.policy.heartbeat_timeout_s]

    def should_shrink(self) -> bool:
        return bool(self.dead_hosts())
