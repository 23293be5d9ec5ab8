"""LAMP policy configuration: where and how the technique is applied."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LampSite:
    """LAMP applied at one composition site (g = matmul, f = nonlinearity)."""
    enabled: bool = True
    mu: int = 7                  # PS(mu) accumulation precision for g
    tau: float = 0.1             # LAMP threshold
    rule: str = "relaxed"        # strict | relaxed | relaxed_ln | none
    granularity: int = 0         # dot_ps simulation tier (0=cast-only, 1=per-FMA)
    n_ref: int = 1024            # LN rule reference length (paper: GPT-2 ctx)
    onepass: bool = False        # online rule (9) vs running max (1 KV sweep,
                                 # conservative over-selection; Sec 4.4 tier)

    def replace(self, **kw) -> "LampSite":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LampPolicy:
    """Per-model LAMP policy.

    Sites:
      kq         -- KQ inner products ahead of attention softmax (paper Sec 3.3)
      router     -- MoE router logits ahead of routing softmax (beyond-paper)
      rmsnorm    -- matmul ahead of RMS layer norm (paper Sec 3.2)
      activation -- matmul ahead of entrywise activation (paper Sec 3.1)
      logits     -- LM-head logits ahead of the output softmax
    """
    kq: LampSite = LampSite()
    router: LampSite = LampSite(enabled=False, rule="strict")
    rmsnorm: LampSite = LampSite(enabled=False)
    activation: LampSite = LampSite(enabled=False)
    logits: LampSite = LampSite(enabled=False)

    def replace(self, **kw) -> "LampPolicy":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def disabled() -> "LampPolicy":
        off = LampSite(enabled=False)
        return LampPolicy(kq=off, router=off, rmsnorm=off, activation=off, logits=off)

    @staticmethod
    def paper_default(mu: int = 7, tau: float = 0.1, rule: str = "strict",
                      granularity: int = 1) -> "LampPolicy":
        """The paper's experimental setting: LAMP on KQ products only."""
        return LampPolicy(
            kq=LampSite(enabled=True, mu=mu, tau=tau, rule=rule,
                        granularity=granularity),
            router=LampSite(enabled=False),
            rmsnorm=LampSite(enabled=False),
            activation=LampSite(enabled=False),
            logits=LampSite(enabled=False),
        )

    @staticmethod
    def deployment(mu: int = 7, tau: float = 0.05) -> "LampPolicy":
        """TPU deployment tier: relaxed rule, cast-only simulation, one-pass
        online threshold (single KV sweep; conservative over-selection),
        router LAMP on MoE models (site is ignored by dense models)."""
        return LampPolicy(
            kq=LampSite(enabled=True, mu=mu, tau=tau, rule="relaxed",
                        granularity=0, onepass=True),
            router=LampSite(enabled=True, mu=mu, tau=tau, rule="strict", granularity=0),
            rmsnorm=LampSite(enabled=False),
            activation=LampSite(enabled=False),
            logits=LampSite(enabled=False),
        )
