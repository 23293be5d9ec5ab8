"""The continuous-batching LAMP serving engine (port of
``repro/serving/engine.py``: the fused step, speculative decoding, the
split twin, the phase-segregated plans and the shadow audit).

`add_request()` enqueues; `step()` asks the scheduler for a plan and runs
it. With `fused_step` (the default) every plan is mixed -- chunked-prefill
windows, decode rows (width-1 windows at start = cache_len) and, with
`speculative`, verify rows (width 1 + kd) side by side. `mixed_exec="fused"`
pads the plan to a power-of-two (rows, window) bucket and runs it through
one ``transformer.paged_mixed_step``; a plan with draft rows first runs the
draft (`draft_len` decode steps over the decode rows' own bucket), then
verifies, samples and accepts in that one mixed call. `mixed_exec="split"`
runs the same plan through per-phase sub-steps (`_step_prefill`,
`_step_decode`, `_step_spec`): the differential twin, token for token the
same. With `fused_step=False` the scheduler emits the JAX engine's
phase-segregated plans instead -- each step all prefill or all decode --
and the engine runs each through the one sub-step of its phase (a decode
plan with a draft budget as a speculative round). Paged attention runs on
the hand-written CUDA kernels when the engine's device is a card, and on
their plain PyTorch versions on the CPU (``device="cpu"``, which the tests
ask for).
``EngineConfig.kernel="gather"`` runs the plain versions by name on any
device: the counterpart of the JAX engine's attention-path knob, and the
gather arm of a kernel-against-gather differential on a card.

The engine runs on ``cuda`` unless the caller asks for the CPU, and raises
when CUDA is asked for and absent: it never falls back.

Observability (``repro_torch.obs``), as in the JAX engine: every step phase
-- schedule, block alloc, the step's host work (mixed, draft, prefill,
decode, verify), sync, emit -- runs inside an ``obs.span(...)``, feeding
per-phase duration histograms (always on) and, with ``ObsConfig.trace``, a
ring-buffered Chrome-trace exporter. The ``sync`` span wraps exactly the
device-to-host copies the step makes anyway (sampled tokens, accepted
counts, LAMP counts): on a card it is the wait for the device, the spans
before it the host's enqueueing (where a pageable host-to-device copy
inside them waits for the stream, that wait lands in them). The engine's
counters live in the obs metrics registry (``stats()`` is a view over it;
the attribute names are properties over the same counters). A compile
event is the first run in the process of a (step function, bucket) key:
the port has no jit cache, and that first run carries the kernel
library's first-use build, cuBLAS's first-call setup and the caching
allocator's growth (``reset_step_caches`` forgets the keys).

Fault tolerance (``serving/faults.py``), as in the JAX engine: with
`health_guard` (the default) every step also reduces, on the device, a
per-row health scalar -- max |logit| over the row's live positions -- and
copies it to the host inside the `sync` span with the step's LAMP counts.
A non-finite row (or one above `health_max_abs`) is quarantined: its
bookkeeping is skipped and its window re-runs alone through the recovery
ladder (`retry_ladder`, bounded by `max_retries`) before the request fails
alone with `RequestOutput.error`. With the "cuda" path on a card the
ladder is retry -> strict rule: a rung that ran the plain versions in
place of the kernels would hide a kernel fault, so a row the kernels
cannot recover fails. On the CPU it is the JAX engine's (retry -> strict
-> gather -> FP32). Each recovery is counted in
``engine_recoveries_total{action}`` and traced as a ``recover:<action>``
instant. Injected faults (`EngineConfig.faults`) fire reproducibly per
(step, site, salt); an injected fused-step fault degrades that step to the
split twin, and nothing else is caught: a kernel wrapper's own error
propagates out of `step()`. Deadlines (`SamplingParams.deadline_s`), a
bounded admission queue (`max_queue`, `QueueFullError`), the stall
watchdog of `run_to_completion` (`stall_patience`), `paranoid` pool checks
and `defrag()` complete the JAX engine's recovery half.

The arena's dtype (``EngineConfig.kv_dtype``: float32, bfloat16 or
float16) is the pool's; the CUDA kernel reads a narrow arena itself and
widens K and V to FP32 as it reads them, and the plain versions widen the
gathered span, so no pass over the arena is added. Sampled rows draw the
JAX engine's threefry noise (``sampling.row_key``), so sampled streams
equal the JAX engine's token for token on the same plan stream.

The adaptive LAMP policy loop (``serving/policy.py``, ``EngineConfig.policy``)
runs after every step that ran a plan (and after an injected stall, with
its latency): it reads the step's per-layer recompute rates, the pool's
utilization, preemptions, recoveries, the step's wall time and the draft
acceptance, then writes the per-layer thresholds into the device tensor
the kernel reads (``taus``, in place), sets the scheduler's draft length
and, under SHED, the rule tier every later step's ``site.rule`` comes
from (``_serving_cfg``).

The shadow audit (``obs/audit.py``, ``EngineConfig.audit``; off at rate 0,
when no auditor exists and the step runs as without it): on a
deterministic, replayable sample of steps, up to `audit.max_rows` of the
step's rows are captured before the step runs and replayed after it
through ``transformer.paged_audit_window`` -- the LAMP stream against the
FP32 reference, on the gather path, reading the arena without writing it
-- in an "audit" span. Served tokens never change. The realized error
lands in ``lamp_audit_*`` metrics, ``stats()["audit"]``, each request's
``audit_*`` fields and, with a live policy, the error model's per-layer
recompute targets (``ShadowAuditor.maybe_calibrate``).
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.obs import ObsConfig, Observability
from repro_torch.obs.audit import AuditConfig, ShadowAuditor

from . import sampling as SM
from . import speculative as SP
from .faults import FaultConfig, FaultInjector, StepLaunchFault
from .kv_pool import PagedKVPool
from .policy import PolicyConfig, PolicyController, PolicySignals
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan

TEXT_FAMILIES = transformer.FAMILIES
LAUNCH_KINDS = ("prefill", "decode", "draft", "verify", "mixed", "audit")
# arena dtypes the paged kernel reads (EngineConfig.kv_dtype)
KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}

# (step function, model/engine key, draft length, top-k variant, bucket)
# keys run so far in this process: the counterpart of the JAX engine's jit
# caches, whose growth it logs as compile events
_STEP_KEYS: Set[tuple] = set()


class QueueFullError(RuntimeError):
    """Raised by `add_request` when the bounded admission queue
    (`EngineConfig.max_queue`) is full: explicit backpressure instead of an
    unbounded waiting deque under overload."""


def reset_step_caches() -> None:
    """Forget every step key run so far, so the next run of each logs a
    compile event again (the JAX engine's ``reset_step_caches``)."""
    _STEP_KEYS.clear()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    n_blocks: int = 0               # 0 = auto-size from max_model_len
    max_model_len: int = 0          # 0 = cfg.max_seq
    max_prefill_batch: int = 8
    max_prefill_tokens: int = 2048  # prefill-step token budget = chunk size
    max_decode_batch: int = 32
    use_lamp: bool = True
    # the paged KV arena's dtype (one of KV_DTYPES): the kernel widens a
    # bfloat16 or float16 arena to FP32 as it reads it
    kv_dtype: str = "float32"
    # prefix caching: requests sharing a prompt prefix map their block
    # tables onto the same arena rows (refcounted, copy-on-write)
    prefix_cache: bool = True
    # chunked prefill: long prompts prefill max_prefill_tokens per step so
    # decode rows keep moving
    chunked_prefill: bool = True
    # LAMP self-draft speculative decoding: decode rows draft `draft_len`
    # tokens with the pure low-precision forward (rule "none"), then verify
    # all draft_len + 1 positions in one window with the configured rule.
    # Greedy outputs are those of plain decoding
    speculative: bool = False
    draft_len: int = 4
    # fused serving step: the scheduler emits one mixed plan per step
    # (prefill windows, decode rows and verify rows together); False
    # restores the JAX engine's phase-segregated plans (each step all
    # prefill or all decode, run through that phase's sub-step)
    fused_step: bool = True
    # how mixed plans execute: "fused" (one mixed launch, plus the draft
    # when rows drafted) or "split" (the same plan through the prefill /
    # decode / speculative sub-steps: the differential twin); consulted
    # only when fused_step is on
    mixed_exec: str = "fused"
    # attention path over the paged arena: "cuda" calls the kernel wrappers
    # (the hand-written kernels on a card, their plain versions on the
    # CPU); "gather" calls the plain versions by name on any device (the
    # JAX engine's default path, and the arm a card differential holds the
    # kernels against)
    kernel: str = "cuda"
    # observability: the metrics registry and per-phase histograms are
    # always on; obs.trace additionally records step-phase spans for
    # Chrome-trace export (see repro_torch.obs.ObsConfig)
    obs: ObsConfig = ObsConfig()
    # shadow audit (obs/audit.py): on a deterministic sample of steps,
    # replay up to audit.max_rows rows through the LAMP-vs-FP32 lockstep
    # forward (gather path, the arena read, never written) and record the
    # realized error -- lamp_audit_* metrics, stats()["audit"] and, with the
    # policy on, error-model-calibrated per-layer targets. rate 0 (the
    # default) builds no auditor
    audit: AuditConfig = AuditConfig()
    # adaptive LAMP policy loop (serving/policy.py): per-layer thresholds
    # moved toward target recompute rates every step (written in place into
    # the device tensor the kernel reads), with load-aware degradation of
    # draft length and rule tier under pool pressure. Off by default: the
    # engine then runs the static site tau
    policy: PolicyConfig = PolicyConfig()
    # finished RequestOutputs retained for exact end-of-run percentiles
    finished_retention: int = 1024
    device: str = "cuda"
    # -- fault tolerance (serving/faults.py) --------------------------------
    # deterministic fault injection: seeded chaos behind named sites; the
    # default (enabled=False) constructs no injector at all
    faults: FaultConfig = FaultConfig()
    # numerical health guard: every step also returns a per-row health
    # scalar (max |final logit| over the row's live positions, reduced on
    # the device and copied with the step's LAMP counts); the guard
    # quarantines non-finite rows and retries them through the recovery
    # ladder (retry_ladder: retry -> strict rule, and on the CPU or the
    # gather path also the plain-version rungs, bounded by max_retries)
    # before failing the request alone. health_max_abs > 0
    # additionally treats |logit| above it as unhealthy (0 = finite-only)
    health_guard: bool = True
    health_max_abs: float = 0.0
    max_retries: int = 4
    # bounded admission queue: add_request raises QueueFullError once this
    # many requests are waiting (0 = unbounded)
    max_queue: int = 0
    # stall watchdog: consecutive no-progress steps run_to_completion
    # tolerates before attempting recovery (evict the stalled rows,
    # continue) and, only if recovery changes nothing, raising
    stall_patience: int = 64
    # paranoid mode: run pool.check_invariants() against every live
    # sequence after every step (recovery paths always check)
    paranoid: bool = False


@dataclasses.dataclass
class RequestOutput:
    req_id: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    latency: float
    ttft: float
    num_preemptions: int
    lamp_selected: float
    lamp_valid: float
    num_cached_tokens: int = 0      # prompt tokens served from prefix cache
    num_resume_cached_tokens: int = 0
    spec_drafted: int = 0           # tokens drafted for this request
    spec_accepted: int = 0          # drafted tokens the verifier accepted
    lamp_layer_selected: Optional[List[float]] = None
    lamp_layer_valid: Optional[List[float]] = None
    # shadow-audit accumulation: steps this request was audited in, summed
    # final-logit relative error across them, and argmax flips observed
    audit_samples: int = 0
    audit_err_sum: float = 0.0
    audit_flips: int = 0
    # set only on individually-failed requests (finish_reason "timeout" /
    # "unhealthy" / "stalled"): the diagnostic the engine failed them with
    error: Optional[str] = None

    @property
    def lamp_recompute_rate(self) -> float:
        return self.lamp_selected / self.lamp_valid if self.lamp_valid else 0.0

    @property
    def lamp_layer_rates(self) -> List[float]:
        """Per-layer recompute rate for this request (empty if no LAMP)."""
        if not self.lamp_layer_selected:
            return []
        return [s / v if v else 0.0 for s, v in
                zip(self.lamp_layer_selected, self.lamp_layer_valid)]

    @property
    def spec_acceptance_rate(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


def retry_ladder(cfg, econfig: EngineConfig, on_card: bool,
                 serving_cfg=None) -> List[tuple]:
    """(action, cfg, use_lamp, kernel) escalation rungs for retrying a
    quarantined row, cheapest first: (0) plain re-run of the step's own
    configuration (`serving_cfg`, the rule tier the policy left in force;
    default `cfg`) -- sampling is keyed on (seed, tokens generated), not on
    batch shape; (1) the strict LAMP rule; (2) the gather path, the plain
    PyTorch versions instead of the kernels; (3) FP32 reference, no LAMP,
    on the gather path. Bounded by EngineConfig.max_retries.

    Rungs (2) and (3) run the plain versions in place of the kernels. With
    the "cuda" path on a card that would hide a kernel fault behind a
    recovered request, so there the ladder ends after the strict rung: a
    row the kernels cannot give healthy logits fails alone. On the CPU
    (where the "cuda" path is the plain versions anyway) the ladder is the
    JAX "pallas" path's; the "gather" path's is JAX "gather"'s."""
    kq = cfg.lamp.kq
    ladder = [("retry", serving_cfg or cfg, econfig.use_lamp, econfig.kernel)]
    if econfig.use_lamp and kq.enabled and kq.rule != "strict":
        strict = cfg.replace(
            lamp=cfg.lamp.replace(kq=kq.replace(rule="strict")))
        ladder.append(("strict", strict, True, econfig.kernel))
    if econfig.kernel != "gather":
        if on_card:
            return ladder[:max(1, econfig.max_retries)]
        _, pcfg, plamp, _ = ladder[-1]
        ladder.append(("gather", pcfg, plamp, "gather"))
    ladder.append(("fp32", cfg, False, "gather"))
    return ladder[:max(1, econfig.max_retries)]


class LampEngine:
    def __init__(self, cfg, params, econfig: EngineConfig = EngineConfig(),
                 *, clock: Optional[Callable[[], float]] = None):
        if cfg.family not in TEXT_FAMILIES:
            raise ValueError(f"the port serves the paged-KV text families "
                             f"{TEXT_FAMILIES}, got {cfg.family!r}")
        if min(econfig.max_prefill_tokens, econfig.max_prefill_batch,
               econfig.max_decode_batch) < 1:
            raise ValueError(
                "max_prefill_tokens, max_prefill_batch and max_decode_batch "
                "must all be >= 1 (a zero prefill budget cannot make "
                "progress)")
        if econfig.speculative and econfig.draft_len < 1:
            raise ValueError(f"speculative decoding needs draft_len >= 1, got "
                             f"{econfig.draft_len}")
        if econfig.mixed_exec not in ("fused", "split"):
            raise ValueError(f"mixed_exec must be 'fused' or 'split', got "
                             f"{econfig.mixed_exec!r}")
        transformer.check_kernel(econfig.kernel)
        if econfig.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {list(KV_DTYPES)}, "
                             f"got {econfig.kv_dtype!r}")
        self.device = transformer.resolve_device(econfig.device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(f"params are on {tok.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.econfig = econfig
        self.max_model_len = econfig.max_model_len or cfg.max_seq
        bs = econfig.block_size
        self.blocks_per_seq = -(-self.max_model_len // bs)
        n_blocks = econfig.n_blocks or 4 * self.blocks_per_seq + 1
        if n_blocks - 1 < self.blocks_per_seq:
            raise ValueError(
                f"n_blocks={n_blocks} (one reserved for the null block) "
                f"cannot hold one max-length sequence: need "
                f"{self.blocks_per_seq + 1} for max_model_len="
                f"{self.max_model_len} at block_size={bs}")
        # every engine timestamp (arrivals, ttft, latency, trace spans) comes
        # from this one injectable clock
        self.obs = Observability(econfig.obs, clock=clock)
        self._now = self.obs.now
        self.pool = PagedKVPool(cfg, n_blocks=n_blocks, block_size=bs,
                                dtype=KV_DTYPES[econfig.kv_dtype],
                                enable_prefix_cache=econfig.prefix_cache,
                                device=self.device)
        self.scheduler = Scheduler(
            self.pool, max_prefill_batch=econfig.max_prefill_batch,
            max_prefill_tokens=econfig.max_prefill_tokens,
            max_decode_batch=econfig.max_decode_batch,
            chunked_prefill=econfig.chunked_prefill,
            spec_draft_len=econfig.draft_len if econfig.speculative else 0,
            mixed=econfig.fused_step, obs=self.obs)
        self.spec_config = (SP.SpecConfig(draft_len=econfig.draft_len)
                            if econfig.speculative else None)
        self._next_id = 0
        self._seqs: Dict[int, Sequence] = {}          # live sequences only
        self._finished: Deque[RequestOutput] = deque(
            maxlen=max(1, econfig.finished_retention))
        self._start: Optional[float] = None
        self._util_sum = 0.0
        self._util_n = 0
        # the step keys' model part by rule tier (hashed once per tier: a
        # frozen config hashes every field), and the configs of the tiers
        # the policy swapped to
        self._step_keys: Dict[Optional[str], int] = {}
        self._cfg_cache: Dict[str, Any] = {}

        # -- metrics registry: the one source of truth for the engine's
        # cumulative counters (stats() and the attribute properties below
        # are views over it), under the JAX engine's names and labels;
        # children resolved once, so the per-step cost is a float add
        reg = self.obs.registry
        steps = reg.counter("engine_steps_total",
                            help="engine steps by kind", labels=("kind",))
        self._c_prefill_steps = steps.labels("prefill")
        self._c_decode_steps = steps.labels("decode")
        self._c_spec_rounds = steps.labels("spec")
        self._c_mixed_steps = steps.labels("mixed")
        # role presence per mixed step (a mixed step with any prefill row
        # counts as a prefill step, etc.)
        mixed_roles = reg.counter(
            "engine_mixed_steps_total",
            help="mixed fused steps containing each row role",
            labels=("role",))
        self._c_mixed_prefill = mixed_roles.labels("prefill")
        self._c_mixed_decode = mixed_roles.labels("decode")
        self._c_mixed_verify = mixed_roles.labels("verify")
        launches = reg.counter(
            "engine_launches_total",
            help="step-function calls by kind (fused: mixed, plus draft in "
                 "a speculative round; split: prefill, decode, draft, "
                 "verify)", labels=("fn",))
        self._c_launches = {name: launches.labels(name)
                            for name in LAUNCH_KINDS}
        self._c_prefill_chunks = reg.counter(
            "engine_prefill_chunks_total",
            help="partial prefill windows (prompt continued next step)")
        self._c_prefill_tokens = reg.counter(
            "engine_prefill_tokens_total",
            help="prompt tokens actually computed", unit="tokens")
        self._c_generated = reg.counter(
            "engine_generated_tokens_total", help="tokens emitted",
            unit="tokens")
        self._c_finished = reg.counter(
            "engine_requests_finished_total", help="requests completed")
        cached = reg.counter(
            "engine_cached_tokens_total",
            help="prompt tokens served from cached KV (prefix = "
                 "cross-request hits, resume = own KV after preemption)",
            unit="tokens", labels=("kind",))
        self._c_cached_prefix = cached.labels("prefix")
        self._c_cached_resume = cached.labels("resume")
        spec = reg.counter("engine_spec_tokens_total",
                           help="speculative-decoding token flow",
                           labels=("event",))
        self._c_spec_drafted = spec.labels("drafted")
        self._c_spec_accepted = spec.labels("accepted")
        self._c_spec_emitted = spec.labels("emitted")
        lamp = reg.counter("lamp_kq_products_total",
                           help="KQ products by layer and disposition "
                                "(selected = recomputed in high precision)",
                           labels=("layer", "kind"))
        L = cfg.n_layers
        self._c_lamp_sel = [lamp.labels(str(l), "selected") for l in range(L)]
        self._c_lamp_val = [lamp.labels(str(l), "valid") for l in range(L)]
        vspec = reg.counter("lamp_verify_products_total",
                            help="LAMP counts of speculative verify passes",
                            labels=("kind",))
        self._c_verify_sel = vspec.labels("selected")
        self._c_verify_val = vspec.labels("valid")
        self._h_latency = reg.histogram(
            "engine_request_latency_seconds",
            help="request arrival -> finish", unit="s")
        self._h_ttft = reg.histogram(
            "engine_request_ttft_seconds",
            help="request arrival -> first token", unit="s")
        # -- fault tolerance: recovery actions by kind, failed requests by
        # cause (the fault-injection counter itself lives in FaultInjector);
        # stats() and the watchdog read these families
        self._c_recover_fam = reg.counter(
            "engine_recoveries_total",
            help="recovery actions absorbed without failing the engine "
                 "(retry rungs, alloc deferrals, split fallbacks, stall "
                 "evictions)", labels=("action",))
        self._c_failed_fam = reg.counter(
            "engine_requests_failed_total",
            help="requests individually failed (engine kept serving)",
            labels=("reason",))
        # per-layer accumulators mirrored into the counters above (numpy, so
        # the per-step update is one vector add), and a bounded time series
        # of each step's per-layer recompute rates
        self._layer_sel = np.zeros((L,), np.float64)
        self._layer_val = np.zeros((L,), np.float64)
        self.layer_rate_series = deque(maxlen=econfig.obs.series_capacity)
        # live per-layer LAMP thresholds, read by the kernel from device
        # memory: the static site tau, moved in place by the policy loop
        self.taus = torch.full((L,), float(cfg.lamp.kq.tau),
                               dtype=torch.float32, device=self.device)
        # -- adaptive policy loop: the rule tier it degraded to (None = the
        # base rule) and the controller (None when disabled)
        self._active_rule: Optional[str] = None
        self._last_step_wall = 0.0
        self.policy: Optional[PolicyController] = None
        if econfig.policy.enabled:
            base_rule = cfg.lamp.kq.rule
            if base_rule == "random":   # serving maps the control arm
                base_rule = "strict"
            self.policy = PolicyController(
                econfig.policy, L,
                np.full((L,), float(cfg.lamp.kq.tau), np.float32),
                base_rule=base_rule,
                base_draft_len=(econfig.draft_len if econfig.speculative
                                else 0),
                obs=self.obs)

        # -- shadow audit: realized-error telemetry on a deterministic sample
        # of steps. Only with LAMP on: without it LAMP-vs-reference
        # divergence is identically zero
        self.auditor: Optional[ShadowAuditor] = None
        if econfig.audit.rate > 0 and econfig.use_lamp:
            self.auditor = ShadowAuditor(econfig.audit, L, self.obs)

        # -- fault tolerance: the deterministic injector (None when
        # disabled), the rows the health guard pulled out of this step, and
        # the failures to merge into step()'s output
        self.faults: Optional[FaultInjector] = (
            FaultInjector(econfig.faults, self.obs)
            if econfig.faults.enabled else None)
        self._quarantine: List[tuple] = []
        self._step_failures: List[RequestOutput] = []
        self._last_alloc_degrades = 0
        self._has_deadlines = False

    # -- counter attributes: views over the metrics registry ----------------

    @property
    def prefill_steps(self) -> int:
        """Steps with a prefill row."""
        return int(self._c_prefill_steps.value + self._c_mixed_prefill.value)

    @property
    def decode_steps(self) -> int:
        """Steps with a decode or verify row."""
        return int(self._c_decode_steps.value + self._c_spec_rounds.value
                   + self._c_mixed_decode.value)

    @property
    def total_steps(self) -> int:
        return int(self._c_prefill_steps.value + self._c_decode_steps.value
                   + self._c_spec_rounds.value + self._c_mixed_steps.value)

    @property
    def mixed_steps(self) -> int:
        return int(self._c_mixed_steps.value)

    @property
    def spec_rounds(self) -> int:
        """Mixed steps with a drafting row."""
        return int(self._c_spec_rounds.value + self._c_mixed_verify.value)

    @property
    def launch_counts(self) -> Dict[str, int]:
        """Step-function calls by kind."""
        return {name: int(c.value) for name, c in self._c_launches.items()}

    @property
    def launches(self) -> int:
        return int(sum(c.value for c in self._c_launches.values()))

    @property
    def prefill_chunks(self) -> int:
        return int(self._c_prefill_chunks.value)

    @property
    def prefill_tokens_run(self) -> int:
        return int(self._c_prefill_tokens.value)

    @property
    def generated_tokens(self) -> int:
        return int(self._c_generated.value)

    @property
    def agg_lamp_selected(self) -> float:
        return float(self._layer_sel.sum())

    @property
    def agg_lamp_valid(self) -> float:
        return float(self._layer_val.sum())

    @property
    def spec_drafted(self) -> int:
        return int(self._c_spec_drafted.value)

    @property
    def spec_accepted(self) -> int:
        return int(self._c_spec_accepted.value)

    @property
    def spec_emitted(self) -> int:
        return int(self._c_spec_emitted.value)

    @property
    def spec_verify_selected(self) -> float:
        return self._c_verify_sel.value

    @property
    def spec_verify_valid(self) -> float:
        return self._c_verify_val.value

    @property
    def compile_events(self):
        return self.obs.compile_events

    @property
    def recoveries(self) -> int:
        """Recovery actions absorbed, all kinds."""
        return int(sum(c.value for _, c in self._c_recover_fam.items()))

    @property
    def failed_requests(self) -> int:
        """Requests failed alone (admission rejections are not requests)."""
        return int(sum(c.value for (reason,), c in self._c_failed_fam.items()
                       if reason != "queue_full"))

    # -- request intake -----------------------------------------------------

    def add_request(self, prompt: List[int],
                    sampling: SamplingParams = SamplingParams(),
                    arrival_time: Optional[float] = None) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if sampling.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{sampling.max_new_tokens}")
        if len(prompt) + sampling.max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens"
                f"({sampling.max_new_tokens}) exceeds max_model_len "
                f"{self.max_model_len}")
        if not all(0 <= int(t) < self.cfg.vocab for t in prompt):
            raise ValueError(f"prompt token outside [0, {self.cfg.vocab})")
        if self.econfig.max_queue and \
                len(self.scheduler.waiting) >= self.econfig.max_queue:
            self._c_failed_fam.labels("queue_full").inc()
            if self.obs.tracer.enabled:
                self.obs.tracer.instant("reject", cat="fault",
                                        reason="queue_full")
            raise QueueFullError(
                f"admission queue full ({self.econfig.max_queue} waiting); "
                f"retry later or raise EngineConfig.max_queue")
        req_id = self._next_id
        self._next_id += 1
        seq = Sequence(req_id, prompt, sampling,
                       arrival_time if arrival_time is not None
                       else self._now())
        if sampling.deadline_s > 0:
            self._has_deadlines = True
        self._seqs[req_id] = seq
        self.scheduler.add(seq)
        return req_id

    def has_unfinished(self) -> bool:
        return self.scheduler.has_work()

    # -- the step loop ------------------------------------------------------

    @torch.no_grad()
    def step(self) -> List[RequestOutput]:
        """Run one engine step; returns requests finished by this step
        (successfully or -- with `RequestOutput.error` set -- failed)."""
        if self._start is None:
            self._start = self._now()
        t0 = self._now()
        step_id = self.total_steps
        inj = self.faults
        if inj is not None and inj.maybe_stall(step_id):
            # injected stall: the step schedules nothing and reports the
            # configured latency spike, so the policy sees the pressure and
            # the run_to_completion watchdog sees no progress
            self._last_step_wall = inj.config.stall_s
            if self.policy is not None:
                self._policy_update()
            return self._drain_failures()
        if self._has_deadlines:
            self._expire_deadlines()
        if inj is not None and inj.fires(step_id, "alloc"):
            self.pool.arm_alloc_failure(1)
            inj.record(step_id, "alloc")
        with self.obs.span("schedule"):
            plan = self.scheduler.schedule()
        d_alloc = (self.scheduler.alloc_fault_degrades
                   - self._last_alloc_degrades)
        if d_alloc:
            self._last_alloc_degrades = self.scheduler.alloc_fault_degrades
            self._recover("alloc_defer", n=d_alloc)
        if plan is None:
            return self._drain_failures()
        # audit rows are captured before the sub-step runs (it moves
        # cursors, appends tokens and rolls back block tables) and replayed
        # after it, against the post-step arena: the audited window rewrites
        # its own K/V in the shadow's copy, and the prefix below `starts` is
        # the same before and after the step
        audit_batch = (self._audit_capture(plan)
                       if self.auditor is not None else None)
        if plan.kind == "prefill":
            self._step_prefill(plan.seqs, plan.windows)
            self._c_prefill_steps.inc()
        elif plan.kind == "mixed":
            self._run_mixed(plan, step_id)
        elif self._spec_round(plan.draft_lens):
            self._step_spec(plan.seqs, plan.draft_lens)
            self._c_spec_rounds.inc()
        else:
            # no draft budget anywhere (spec off, block pressure shed it, or
            # every sequence is at its token limit): a plain decode step
            self._step_decode(plan.seqs)
            self._c_decode_steps.inc()
        if self._quarantine:
            # rows the health guard pulled out of the step: retry each
            # through the recovery ladder (or fail it alone), then prove the
            # pool survived the surgery
            with self.obs.span("recover", rows=len(self._quarantine)):
                self._drain_quarantine()
            self.pool.check_invariants(self._seqs.values())
        self._util_sum += self.pool.utilization
        self._util_n += 1
        if audit_batch is not None:
            # before _collect_finished (which frees blocks), so a request
            # audited on its finishing step still folds into its histogram
            self._run_audit(audit_batch)
        with self.obs.span("emit"):
            done = self._collect_finished(plan.seqs)
        done.extend(self._drain_failures())
        if self.econfig.paranoid:
            self.pool.check_invariants(self._seqs.values())
        self._last_step_wall = self._now() - t0
        if self.policy is not None:
            self._policy_update()
        return done

    def _run_mixed(self, plan: StepPlan, step_id: int) -> None:
        """Run a mixed plan: fused, or through the split twin."""
        inj = self.faults
        if self.econfig.mixed_exec == "split":
            self._step_mixed_split(plan)
        else:
            try:
                if inj is not None and inj.fires(step_id, "step"):
                    inj.record(step_id, "step")
                    raise StepLaunchFault("injected fused-step launch failure")
                self._step_mixed(plan)
            except StepLaunchFault:
                # degrade this step to the split twin: same plan, same
                # tokens. Only the injected type is caught (it is raised
                # before any launch, so nothing has moved); a kernel's own
                # error stays loud rather than re-run a half-applied step
                self._recover("split_fallback")
                self._step_mixed_split(plan)
        self._c_mixed_steps.inc()
        roles = plan.roles or []
        if any(r == "prefill" for r in roles):
            self._c_mixed_prefill.inc()
        if any(r != "prefill" for r in roles):
            self._c_mixed_decode.inc()
        if self._spec_round(plan.draft_lens):
            self._c_mixed_verify.inc()

    # -- adaptive policy loop -----------------------------------------------

    def _serving_cfg(self):
        """The model config the next step runs with: the base config,
        unless the policy degraded the LAMP rule tier (the kernel is then
        launched with that tier's rule; tau and draft-length moves change
        no config)."""
        rule = self._active_rule
        if rule is None or not self.cfg.lamp.kq.enabled \
                or rule == self.cfg.lamp.kq.rule:
            return self.cfg
        cfg = self._cfg_cache.get(rule)
        if cfg is None:
            pol = self.cfg.lamp
            cfg = self.cfg.replace(
                lamp=pol.replace(kq=pol.kq.replace(rule=rule)))
            self._cfg_cache[rule] = cfg
        return cfg

    def _policy_update(self) -> None:
        """Feed this step's telemetry to the controller and apply what it
        actuated: the per-layer thresholds (written in place into `taus`,
        the device tensor the kernel reads), the scheduler's draft budget
        and -- only under SHED -- the rule tier."""
        # _account_lamp stamps an entry with the step count before the step
        # counter increments, so the entry this step produced reads
        # total_steps - 1; an older one means this step had no LAMP counts
        # and the controller holds its EMA
        rates = None
        if (self.layer_rate_series
                and self.layer_rate_series[-1][0] == self.total_steps - 1):
            rates = self.layer_rate_series[-1][1]
        drafted = self.spec_drafted
        sig = PolicySignals(
            layer_rates=rates,
            utilization=self.pool.utilization,
            preemptions=self.scheduler.num_preemptions,
            step_latency_s=self._last_step_wall,
            spec_acceptance=(self.spec_accepted / drafted
                             if drafted else 0.0),
            recoveries=self.recoveries)
        act = self.policy.update(sig)
        if self.policy.config.frozen:
            return
        self.taus.copy_(torch.from_numpy(np.asarray(act.taus, np.float32)))
        self._active_rule = act.rule
        if self.econfig.speculative:
            self.scheduler.spec_draft_len = act.draft_len

    # -- shadow audit -------------------------------------------------------

    def _audit_capture(self, plan: StepPlan) -> Optional[Dict[str, Any]]:
        """Select and copy this step's audited rows (or None).

        Rows are chosen by the hash of (step, request, salt), so a rerun of
        the same stream audits the same rows. Every input the shadow forward
        needs is copied now: the step advances prefill cursors, appends
        tokens and rolls back block tables before the audit runs. Decode and
        verify rows are audited as their width-1 pre-draft window (the query
        the serving step's first position ran); prefill rows replay their
        chunk."""
        step_id = self.total_steps
        seqs = plan.seqs
        idx = self.auditor.select(step_id, [s.req_id for s in seqs])
        if not idx:
            return None
        roles = list(plan.roles or [None] * len(seqs))
        rows: List[Any] = []
        for i in idx:
            seq = seqs[i]
            if plan.kind == "prefill" or roles[i] == "prefill":
                w = plan.windows[i]
                cur = seq.prefill_cursor
                toks = list(seq.prefill_tokens()[cur:cur + w])
                start = cur
            else:
                toks = [seq.last_token]
                start = seq.cache_len
            rows.append((seq, start, toks))
        Bb = _bucket(len(rows), 0)
        Wb = _bucket(max(len(t) for _, _, t in rows), 0)
        tokens = np.zeros((Bb, Wb), np.int32)
        starts = np.zeros((Bb,), np.int32)
        lengths = np.ones((Bb,), np.int32)   # pad rows: 1 token, null table
        row_mask = np.zeros((Bb,), np.float32)
        bt = np.zeros((Bb, self.blocks_per_seq), np.int32)
        for j, (seq, start, toks) in enumerate(rows):
            tokens[j, :len(toks)] = toks
            starts[j] = start
            lengths[j] = len(toks)
            row_mask[j] = 1.0
            bt[j, :len(seq.block_ids)] = seq.block_ids
        return {"step": step_id, "seqs": [r[0] for r in rows],
                "tokens": tokens, "starts": starts, "lengths": lengths,
                "row_mask": row_mask, "bt": bt, "bucket": (Bb, Wb)}

    def _run_audit(self, batch: Dict[str, Any]) -> None:
        """Replay one captured audit batch through the shadow forward (the
        arena is read, never written: every served token is untouched) at
        the rule tier and taus in force, bring its metrics to the host in
        one copy, fold them into the auditor and, with a live policy, run
        the error model's calibration."""
        Bb, Wb = batch["bucket"]
        first = self._first_run("audit", (Bb, Wb))
        with self.obs.span("audit", rows=len(batch["seqs"]),
                           bucket=[Bb, Wb]) as sp:
            out = transformer.paged_audit_window(
                self._serving_cfg(), self.params, self._dev(batch["tokens"]),
                {"k": self.pool.k, "v": self.pool.v}, self._dev(batch["bt"]),
                self._dev(batch["starts"]), self._dev(batch["lengths"]),
                self._dev(batch["row_mask"]), taus=self.taus,
                top_k=self.econfig.audit.top_k)
            host = torch.cat([v.reshape(-1) for v in out.values()]
                             ).cpu().numpy()
        self._c_launches["audit"].inc()
        if first:
            self.obs.record_compile("audit", (Bb, Wb), sp.elapsed,
                                    self.total_steps)
        metrics, at = {}, 0
        for name, v in out.items():
            metrics[name] = host[at:at + v.numel()]
            at += v.numel()
        self.auditor.account(batch["step"], batch["seqs"], metrics)
        if self.policy is not None and not self.policy.config.frozen:
            self.auditor.maybe_calibrate(self.policy)

    def _batch_arrays(self, seqs: List[Sequence], Bb: int):
        bt = np.zeros((Bb, self.blocks_per_seq), np.int32)
        seeds = np.zeros((Bb,), np.int64)
        counts = np.zeros((Bb,), np.int64)
        temps = np.zeros((Bb,), np.float32)
        topks = np.zeros((Bb,), np.int64)
        for i, seq in enumerate(seqs):
            bt[i, :len(seq.block_ids)] = seq.block_ids
            seeds[i] = seq.sampling.seed
            counts[i] = seq.num_generated
            temps[i] = seq.sampling.temperature
            topks[i] = seq.sampling.top_k
        return bt, seeds, counts, temps, topks

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _to_host(self, nsel: torch.Tensor, nval: torch.Tensor,
                 health: Optional[torch.Tensor]):
        """A step's per-layer (L, Bb) LAMP counts and, under the guard, its
        (Bb,) health in one device-to-host copy (inside the caller's sync
        span). Returns numpy (nsel, nval, health or None)."""
        L = nsel.shape[0]
        parts = [nsel, nval] if health is None else [nsel, nval, health[None]]
        host = torch.cat(parts).cpu().numpy()
        return host[:L], host[L:2 * L], \
            None if health is None else host[2 * L]

    def _last_health(self, last: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-row max |logit| of (Bb, V) final logits, on the device (NaN
        and Inf propagate); None with the guard off."""
        return last.abs().amax(dim=-1) if self.econfig.health_guard else None

    def _spec_round(self, draft_lens) -> bool:
        return self.spec_config is not None and any(draft_lens)

    def _first_run(self, fn: str, shape: tuple,
                   topks: Optional[np.ndarray] = None) -> bool:
        """Whether this is the process's first run of step function `fn`
        (keyed as the JAX engine keys its jitted functions: model config,
        LAMP flag, attention path, draft length, top-k variant) at bucket
        `shape`: the port's compile event. Marks the key as run."""
        rule = self._active_rule
        model = self._step_keys.get(rule)
        if model is None:
            model = self._step_keys[rule] = hash(
                (self._serving_cfg(), self.econfig.use_lamp,
                 self.econfig.kernel))
        key = (fn, model, self.econfig.draft_len
               if fn in ("draft", "verify", "mixed_spec") else 0,
               topks is not None and bool(topks.any()), shape)
        if key in _STEP_KEYS:
            return False
        _STEP_KEYS.add(key)
        return True

    def _account_lamp(self, seqs: List[Sequence], nsel: np.ndarray,
                      nval: np.ndarray, *, verify: bool = False,
                      verify_cols: Optional[List[int]] = None) -> None:
        """Fold one step's per-layer (L, Bb) counts (on the host) into the
        per-layer counters (every bucket column, padded rows included, as
        the JAX engine sums them), the recompute-rate time series and each
        sequence's breakdown. `verify=True` credits the whole batch to the
        verify counters (a split speculative round); `verify_cols` only
        those columns (a fused mixed step whose decode rows verified)."""
        sel_l = nsel.sum(axis=1)
        val_l = nval.sum(axis=1)
        self._layer_sel += sel_l
        self._layer_val += val_l
        for l in range(len(sel_l)):
            self._c_lamp_sel[l].inc(float(sel_l[l]))
            self._c_lamp_val[l].inc(float(val_l[l]))
        if verify:
            self._c_verify_sel.inc(float(sel_l.sum()))
            self._c_verify_val.inc(float(val_l.sum()))
        elif verify_cols:
            self._c_verify_sel.inc(float(nsel[:, verify_cols].sum()))
            self._c_verify_val.inc(float(nval[:, verify_cols].sum()))
        if val_l.sum() > 0:
            rates = np.divide(sel_l, val_l, out=np.zeros_like(sel_l),
                              where=val_l > 0)
            self.layer_rate_series.append((self.total_steps, rates))
            if self.obs.tracer.enabled:
                self.obs.tracer.counter(
                    "lamp_recompute_rate",
                    **{f"layer{l}": round(float(r), 6)
                       for l, r in enumerate(rates)})
        for i, seq in enumerate(seqs):
            seq.lamp.add_layers(nsel[:, i], nval[:, i])

    # -- per-row bookkeeping, shared by the fused step and the split twin ---

    def _after_prefill(self, seq: Sequence, w: int, tok: int,
                       now: float) -> None:
        seq.prefill_cursor += w
        seq.cache_len = seq.prefill_cursor
        self._c_prefill_tokens.inc(w)
        if self.econfig.prefix_cache:
            self.pool.register_prefix(seq.prefill_tokens(), seq.block_ids,
                                      seq.cache_len, hashes=seq.prefix_hashes)
        if seq.prefill_remaining == 0:
            seq.status = SequenceStatus.DECODE
            seq.on_token(tok, now)
            self._c_generated.inc()
        else:
            self._c_prefill_chunks.inc()

    def _after_decode(self, seq: Sequence, tok: int, now: float) -> None:
        seq.cache_len += 1
        seq.on_token(tok, now)
        self._c_generated.inc()

    def _after_verify(self, seq: Sequence, kd: int, n_acc: int,
                      emit: np.ndarray, now: float) -> None:
        """Emit the accepted drafts and the verifier's token, stopping at
        the request's own limits, then roll back the blocks that held
        rejected (or surplus) draft K/V."""
        seq.spec_drafted += kd
        self._c_spec_drafted.inc(kd)
        appended = 0
        for t in emit[:n_acc + 1]:
            seq.on_token(int(t), now)
            appended += 1
            self._c_generated.inc()
            if seq.should_stop():
                break
        # only drafts actually kept count as accepted: a stop inside the
        # accepted run drops the surplus
        kept = min(n_acc, appended)
        seq.spec_accepted += kept
        self._c_spec_accepted.inc(kept)
        seq.cache_len += appended
        self._c_spec_emitted.inc(appended)
        seq.block_ids = self.pool.rollback(seq.block_ids, seq.cache_len)
        # the kept tail was written by this round's verify window, in blocks
        # the draft budget allocated privately past every registered prefix
        # block, so rollback never has to drop it for want of a COW block
        assert len(seq.block_ids) * self.pool.block_size >= seq.cache_len, \
            "rollback dropped a verified tail block"

    # -- fault tolerance ----------------------------------------------------

    def _recover(self, action: str, n: int = 1, **detail) -> None:
        """Account one absorbed recovery action (metric + trace instant)."""
        self._c_recover_fam.labels(action).inc(n)
        if self.obs.tracer.enabled:
            self.obs.tracer.instant(f"recover:{action}", cat="fault",
                                    **detail)

    def _unhealthy(self, h: float) -> bool:
        h = float(h)
        if not np.isfinite(h):
            return True
        cap = self.econfig.health_max_abs
        return cap > 0 and h > cap

    def _quarantine_row(self, seq: Sequence, prefill: bool,
                        window: int) -> None:
        """Pull an unhealthy row out of this step: its bookkeeping is
        skipped and its window queued for the recovery ladder. A decode or
        verify row drops this round's speculative span, keeping the slot at
        cache_len that its width-1 retry writes, and retries as a plain
        decode."""
        if prefill:
            self._quarantine.append((seq, "prefill", window))
            return
        seq.block_ids = self.pool.rollback(seq.block_ids, seq.cache_len + 1)
        # the kept tail is the row's own decode-write block, private and
        # unregistered (check_invariants), so rollback never drops it
        assert len(seq.block_ids) * self.pool.block_size > seq.cache_len, \
            "rollback dropped a decode-write tail block"
        self._quarantine.append((seq, "decode", 1))

    def _inject_nan(self, seqs: List[Sequence], health: Optional[np.ndarray],
                    spans: List[tuple]) -> Optional[np.ndarray]:
        """Fault site "nan": poison one deterministic victim row -- its
        health value goes NaN and the arena KV positions it wrote this step
        (`spans[row]` = (start, width), exactly what its recovery retry
        rewrites) are overwritten with NaN. With the guard off (health
        None), the corruption propagates like a real kernel fault would."""
        inj = self.faults
        step_id = self.total_steps
        if inj is None or not inj.fires(step_id, "nan"):
            return health
        row = inj.pick_row(step_id, "nan", [s.req_id for s in seqs])
        if row is None:
            return health
        seq = seqs[row]
        start, width = spans[row]
        bs = self.pool.block_size
        pos = [p for p in range(start, start + width)
               if p // bs < len(seq.block_ids)]
        if pos:
            blocks = torch.tensor([seq.block_ids[p // bs] for p in pos],
                                  device=self.device)
            offs = torch.tensor([p % bs for p in pos], device=self.device)
            self.pool.k[:, blocks, offs] = float("nan")
            self.pool.v[:, blocks, offs] = float("nan")
        if health is not None:
            health = np.array(health, np.float64)
            health[row] = np.nan
        inj.record(step_id, "nan", req=seq.req_id, start=start, width=width)
        return health

    def _inject_draft(self, dseqs: List[Sequence], kd, d_toks: torch.Tensor,
                      vocab: int) -> torch.Tensor:
        """Fault site "draft": corrupt one drafting row's proposals (each
        token bumped mod vocab, on the device). No dedicated recovery: the
        verify pass is the recovery -- a greedy verifier rejects them."""
        inj = self.faults
        step_id = self.total_steps
        if inj is None or not inj.fires(step_id, "draft"):
            return d_toks
        rows = [j for j in range(len(dseqs)) if int(kd[j]) > 0]
        if not rows:
            return d_toks
        j = rows[inj.pick_row(step_id, "draft",
                              [dseqs[r].req_id for r in rows])]
        d_toks[j] = (d_toks[j] + 1) % vocab
        inj.record(step_id, "draft", req=dseqs[j].req_id)
        return d_toks

    def _retry_ladder(self) -> List[tuple]:
        return retry_ladder(self.cfg, self.econfig,
                            self.device.type == "cuda", self._serving_cfg())

    def _retry_row(self, seq: Sequence, kind: str, window: int,
                   rcfg, rlamp: bool, rkernel: str) -> bool:
        """Re-run one quarantined row's window as a one-row
        `paged_mixed_step` (a decode is a width-1 window) under a ladder
        rung's configuration; its launch counts under "prefill", as the
        JAX engine's does. Healthy result: apply the bookkeeping the
        quarantine skipped and return True; still unhealthy: leave the
        sequence untouched for the next rung."""
        tokens = np.zeros((1, _bucket(window, 0)), np.int32)
        if kind == "prefill":
            start = seq.prefill_cursor
            tokens[0, :window] = seq.prefill_tokens()[start:start + window]
        else:
            start = seq.cache_len
            tokens[0, 0] = seq.last_token
        bt, seeds, counts, temps, topks = self._batch_arrays([seq], 1)
        with self.obs.span("retry", req=seq.req_id, kind=kind,
                           window=window):
            logits, _, (nsel, nval) = transformer.paged_mixed_step(
                rcfg, self.params, self._dev(tokens),
                {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
                self._dev(np.asarray([start], np.int32)),
                self._dev(np.asarray([window], np.int32)), use_lamp=rlamp,
                kernel=rkernel, per_layer=True, taus=self.taus)
            last = logits[:, -1]
            nxt = SM.sample_rows(last, seeds, counts, temps,
                                 topks if topks.any() else None).cpu().numpy()
            nsel, nval, health = self._to_host(nsel, nval,
                                               last.abs().amax(dim=-1))
        self._c_launches["prefill"].inc()
        if self._unhealthy(health[0]):
            return False
        now = self._now()
        self._account_lamp([seq], nsel, nval)
        if kind == "prefill":
            self._after_prefill(seq, window, int(nxt[0]), now)
        else:
            self._after_decode(seq, int(nxt[0]), now)
        return True

    def _drain_quarantine(self) -> None:
        """Walk every row the health guard quarantined this step through
        the recovery ladder; a row no rung can produce healthy logits for
        fails alone (diagnostic RequestOutput.error), never the engine."""
        q, self._quarantine = self._quarantine, []
        ladder = self._retry_ladder()
        for seq, kind, window in q:
            for action, rcfg, rlamp, rkernel in ladder:
                if self._retry_row(seq, kind, window, rcfg, rlamp, rkernel):
                    self._recover(action, req=seq.req_id)
                    break
            else:
                self._fail_seq(
                    seq, "unhealthy",
                    f"non-finite or out-of-range logits persisted through "
                    f"{len(ladder)} recovery rung(s) "
                    f"[{'/'.join(a for a, *_ in ladder)}] at {kind} "
                    f"window={window} cache_len={seq.cache_len}")

    def _fail_seq(self, seq: Sequence, reason: str, error: str) -> None:
        """Terminal per-request failure: cancel it wherever it sits, free
        its blocks, and emit a diagnostic RequestOutput. The engine --
        and every other request -- keeps serving."""
        seq.finish(reason, self._now())
        self.scheduler.cancel(seq)
        self._c_failed_fam.labels(reason).inc()
        if self.obs.tracer.enabled:
            self.obs.tracer.instant("request_failed", cat="fault",
                                    req=seq.req_id, reason=reason)
        out = RequestOutput(
            req_id=seq.req_id, prompt=seq.prompt, tokens=seq.generated,
            finish_reason=reason, latency=seq.latency() or 0.0,
            ttft=seq.ttft() or 0.0, num_preemptions=seq.num_preemptions,
            lamp_selected=seq.lamp.selected, lamp_valid=seq.lamp.valid,
            num_cached_tokens=seq.num_cached_tokens,
            num_resume_cached_tokens=seq.num_resume_cached_tokens,
            spec_drafted=seq.spec_drafted, spec_accepted=seq.spec_accepted,
            audit_samples=seq.audit_samples, audit_err_sum=seq.audit_err_sum,
            audit_flips=seq.audit_flips, error=error)
        self._finished.append(out)
        self._seqs.pop(seq.req_id, None)
        self._step_failures.append(out)

    def _drain_failures(self) -> List[RequestOutput]:
        out, self._step_failures = self._step_failures, []
        return out

    def _expire_deadlines(self) -> None:
        """Cancel requests whose wall-clock TTL elapsed (blocks released,
        finish_reason "timeout"); runs before scheduling so an expired
        request never costs another step of compute."""
        now = self._now()
        for seq in [s for s in self._seqs.values()
                    if s.sampling.deadline_s > 0 and not s.is_finished
                    and now - s.arrival_time > s.sampling.deadline_s]:
            self._fail_seq(
                seq, "timeout",
                f"deadline_s={seq.sampling.deadline_s} exceeded after "
                f"{now - seq.arrival_time:.3f}s "
                f"({seq.num_generated} tokens generated)")

    def _stall_recover(self) -> bool:
        """The watchdog's recovery attempt after `stall_patience` steps
        without progress. Cheapest plausible fix first: clear an injected
        stall; else evict every running row (recompute-style, so resumed
        token streams are identical); else fail the oldest waiting request.
        Returns False when nothing changed -- the caller then raises."""
        if self.faults is not None and self.faults.stalled:
            self.faults.clear_stall()
            self._recover("stall_clear")
            return True
        acted = False
        evicted = 0
        while self.scheduler._preempt_youngest():
            evicted += 1
        if evicted:
            self._recover("stall_evict", n=evicted)
            acted = True
        elif self.scheduler.waiting:
            self._fail_seq(
                self.scheduler.waiting[0], "stalled",
                f"no step progress for {self.econfig.stall_patience} "
                f"steps with the request still queued")
            acted = True
        self.pool.check_invariants(self._seqs.values())
        return acted

    # -- the fused step -----------------------------------------------------

    def _decode_bucket(self, seqs: List[Sequence], kd: List[int]):
        """Host inputs of decode rows padded to their own (Rb,) bucket:
        (last tokens, cache lengths, draft budgets) and `_batch_arrays`.
        Pad rows have length 0 and a null table: they write the null
        block."""
        Rb = _bucket(len(seqs), self.econfig.max_decode_batch)
        tok0 = np.zeros((Rb,), np.int32)
        lengths = np.zeros((Rb,), np.int32)
        kdv = np.zeros((Rb,), np.int64)
        for j, seq in enumerate(seqs):
            tok0[j], lengths[j], kdv[j] = seq.last_token, seq.cache_len, kd[j]
        return (tok0, lengths, kdv) + self._batch_arrays(seqs, Rb)

    def _draft(self, bucket, rows: int):
        """The draft over a `_decode_bucket` of `rows` live rows, inside the
        "draft" span: returns the draft tokens (Rb, k) and logits (Rb, k, V)
        on the device, and the span (for a compile event's wall time)."""
        tok0, lengths, kdv, bt, seeds, counts, temps, topks = bucket
        with self.obs.span("draft", rows=rows, bucket=[len(tok0)]) as sp:
            out = SP.draft(self._serving_cfg(), self.params,
                           {"k": self.pool.k, "v": self.pool.v},
                           self._dev(bt), self._dev(lengths), self._dev(tok0),
                           kdv, self.spec_config,
                           use_lamp=self.econfig.use_lamp,
                           kernel=self.econfig.kernel, seeds=seeds,
                           counts=counts, temps=temps,
                           top_k=topks if topks.any() else None)
        self._c_launches["draft"].inc()
        return out, sp

    def _step_mixed(self, plan: StepPlan) -> None:
        """Run one mixed plan as one bucketed (rows, max_window) batch. A
        plan with draft rows first drafts over the decode rows' compact
        bucket, scatters the drafts into their rows' windows, then verifies,
        samples and accepts in the same mixed call: two launches, against
        the split twin's three."""
        seqs, windows = plan.seqs, list(plan.windows)
        roles, draft_lens = list(plan.roles), list(plan.draft_lens)
        spec_round = self._spec_round(draft_lens)
        dec_rows = [i for i, r in enumerate(roles) if r != "prefill"]
        cap = self.econfig.max_prefill_batch + self.econfig.max_decode_batch
        Bb = _bucket(len(seqs), cap)
        Wb = _bucket(max(windows), 0)
        if spec_round:
            # the accept rule reads k + 1 window positions per verify row
            Wb = max(Wb, self.spec_config.verify_width)
        tokens = np.zeros((Bb, Wb), np.int32)
        starts = np.zeros((Bb,), np.int32)
        qlens = np.ones((Bb,), np.int32)   # pad rows: 1 token in null block
        for i, seq in enumerate(seqs):
            w = windows[i]
            if roles[i] == "prefill":
                cur = seq.prefill_cursor
                tokens[i, :w] = seq.prefill_tokens()[cur:cur + w]
                starts[i] = cur
            else:
                # decode / verify: [last_token, drafts...] at the decode tail
                tokens[i, 0] = seq.last_token
                starts[i] = seq.cache_len
            qlens[i] = w
        bt, seeds, counts, temps, topks = self._batch_arrays(seqs, Bb)
        top = topks if topks.any() else None
        if spec_round:
            k = self.spec_config.draft_len
            dseqs = [seqs[i] for i in dec_rows]
            kd = [draft_lens[i] for i in dec_rows]
            dbucket = self._decode_bucket(dseqs, kd)
            first_draft = self._first_run("draft", (len(dbucket[0]),),
                                          dbucket[-1])
            (d_toks, d_logits), spd = self._draft(dbucket, len(dseqs))
            if first_draft:
                self.obs.record_compile("draft", (len(dbucket[0]),),
                                        spd.elapsed, self.total_steps)
            d_toks = self._inject_draft(dseqs, kd, d_toks, d_logits.shape[-1])
        first = self._first_run("mixed_spec" if spec_round else "window",
                                (Bb, Wb), topks)
        with self.obs.span("mixed", rows=len(seqs), bucket=[Bb, Wb],
                           tokens=int(sum(windows))) as sp:
            tokens_t = self._dev(tokens)
            if spec_round:
                rows = torch.as_tensor(dec_rows, device=self.device)
                tokens_t[rows, 1:k + 1] = d_toks[:len(dec_rows)].to(torch.int32)
            logits, _, (nsel, nval) = transformer.paged_mixed_step(
                self._serving_cfg(), self.params, tokens_t,
                {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
                self._dev(starts), self._dev(qlens),
                use_lamp=self.econfig.use_lamp, kernel=self.econfig.kernel,
                per_layer=True, taus=self.taus, all_logits=spec_round)
            if spec_round:
                qlens_t = self._dev(qlens)
                last = logits[torch.arange(Bb, device=self.device),
                              qlens_t.long() - 1]
                # accept only over the verify rows: the rule is row-wise
                emit, n_acc = SP.speculative_accept(
                    logits[rows, :k + 1], d_toks[:len(dec_rows)],
                    d_logits[:len(dec_rows)], kd, seeds[dec_rows],
                    counts[dec_rows], temps[dec_rows],
                    None if top is None else top[dec_rows])
                # over each row's live positions only: the CUDA kernel
                # writes zeros past qlens[b], the plain version values
                health = (SP.live_max_abs(logits, qlens_t)
                          if self.econfig.health_guard else None)
            else:
                last = logits[:, -1]
                health = self._last_health(last)
            nxt = SM.sample_rows(last, seeds, counts, temps, top)
        self._c_launches["mixed"].inc()
        with self.obs.span("sync"):
            if spec_round:
                emit, n_acc = emit.cpu().numpy(), n_acc.cpu().numpy()
            nxt = nxt.cpu().numpy()
            nsel, nval, health = self._to_host(nsel, nval, health)
        if first:
            self.obs.record_compile("mixed", (Bb, Wb), sp.elapsed,
                                    self.total_steps)
        # decode / verify rows poison width 1 (what their width-1 retry
        # rewrites -- see _step_spec); prefill rows poison their window
        health = self._inject_nan(
            seqs, health,
            [(s.prefill_cursor, windows[i]) if roles[i] == "prefill"
             else (s.cache_len, 1) for i, s in enumerate(seqs)])
        now = self._now()
        self._account_lamp(seqs, nsel, nval,
                           verify_cols=dec_rows if spec_round else None)
        verify_row = {i: j for j, i in enumerate(dec_rows)}
        for i, seq in enumerate(seqs):
            if health is not None and self._unhealthy(health[i]):
                self._quarantine_row(seq, roles[i] == "prefill", windows[i])
                continue
            if roles[i] == "prefill":
                self._after_prefill(seq, windows[i], int(nxt[i]), now)
            elif spec_round:
                j = verify_row[i]
                self._after_verify(seq, draft_lens[i], int(n_acc[j]),
                                   emit[j], now)
            else:
                self._after_decode(seq, int(nxt[i]), now)

    # -- the split twin -----------------------------------------------------

    def _step_mixed_split(self, plan: StepPlan) -> None:
        """Execute a mixed plan through per-phase sub-steps: the same rows,
        windows and draft budgets as `_step_mixed`, the same tokens, in two
        or three launches instead of one or two."""
        pre = [i for i, r in enumerate(plan.roles) if r == "prefill"]
        dec = [i for i, r in enumerate(plan.roles) if r != "prefill"]
        if pre:
            self._step_prefill([plan.seqs[i] for i in pre],
                               [plan.windows[i] for i in pre])
        if dec:
            dseqs = [plan.seqs[i] for i in dec]
            dkd = [plan.draft_lens[i] for i in dec]
            if self._spec_round(dkd):
                self._step_spec(dseqs, dkd)
            else:
                self._step_decode(dseqs)

    def _step_prefill(self, seqs: List[Sequence], windows: List[int]) -> None:
        """One prefill window per sequence through `paged_prefill_window`."""
        Bb = _bucket(len(seqs), self.econfig.max_prefill_batch)
        Wb = _bucket(max(windows), 0)
        tokens = np.zeros((Bb, Wb), np.int32)
        starts = np.zeros((Bb,), np.int32)
        lengths = np.ones((Bb,), np.int32)   # pad rows: 1 token in null block
        for i, (seq, w) in enumerate(zip(seqs, windows)):
            cur = seq.prefill_cursor
            tokens[i, :w] = seq.prefill_tokens()[cur:cur + w]
            starts[i] = cur
            lengths[i] = w
        bt, seeds, counts, temps, topks = self._batch_arrays(seqs, Bb)
        first = self._first_run("window", (Bb, Wb), topks)
        with self.obs.span("prefill", rows=len(seqs), bucket=[Bb, Wb],
                           tokens=int(sum(windows))) as sp:
            logits, _, (nsel, nval) = transformer.paged_prefill_window(
                self._serving_cfg(), self.params, self._dev(tokens),
                {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
                self._dev(starts), self._dev(lengths),
                use_lamp=self.econfig.use_lamp, kernel=self.econfig.kernel,
                per_layer=True, taus=self.taus)
            nxt = SM.sample_rows(logits[:, -1], seeds, counts, temps,
                                 topks if topks.any() else None)
            health = self._last_health(logits[:, -1])
        self._c_launches["prefill"].inc()
        with self.obs.span("sync"):
            nxt = nxt.cpu().numpy()
            nsel, nval, health = self._to_host(nsel, nval, health)
        if first:
            self.obs.record_compile("prefill", (Bb, Wb), sp.elapsed,
                                    self.total_steps)
        health = self._inject_nan(
            seqs, health,
            [(s.prefill_cursor, w) for s, w in zip(seqs, windows)])
        now = self._now()
        self._account_lamp(seqs, nsel, nval)
        for i, (seq, w) in enumerate(zip(seqs, windows)):
            if health is not None and self._unhealthy(health[i]):
                self._quarantine_row(seq, True, w)
                continue
            self._after_prefill(seq, w, int(nxt[i]), now)

    def _step_decode(self, seqs: List[Sequence]) -> None:
        """One token per sequence through `paged_decode_step` (the decode
        kernel)."""
        tok0, lengths, _, bt, seeds, counts, temps, topks = \
            self._decode_bucket(seqs, [0] * len(seqs))
        Rb = len(tok0)
        first = self._first_run("decode", (Rb,), topks)
        with self.obs.span("decode", rows=len(seqs), bucket=[Rb]) as sp:
            logits, _, (nsel, nval) = transformer.paged_decode_step(
                self._serving_cfg(), self.params, {"k": self.pool.k, "v": self.pool.v},
                self._dev(bt), self._dev(lengths), self._dev(tok0[:, None]),
                use_lamp=self.econfig.use_lamp, kernel=self.econfig.kernel,
                per_layer=True, taus=self.taus)
            nxt = SM.sample_rows(logits[:, -1], seeds, counts, temps,
                                 topks if topks.any() else None)
            health = self._last_health(logits[:, -1])
        self._c_launches["decode"].inc()
        with self.obs.span("sync"):
            nxt = nxt.cpu().numpy()
            nsel, nval, health = self._to_host(nsel, nval, health)
        if first:
            self.obs.record_compile("decode", (Rb,), sp.elapsed,
                                    self.total_steps)
        health = self._inject_nan(seqs, health,
                                  [(s.cache_len, 1) for s in seqs])
        now = self._now()
        self._account_lamp(seqs, nsel, nval)
        for i, seq in enumerate(seqs):
            if health is not None and self._unhealthy(health[i]):
                self._quarantine_row(seq, False, 1)
                continue
            self._after_decode(seq, int(nxt[i]), now)

    def _step_spec(self, seqs: List[Sequence], draft_lens: List[int]) -> None:
        """One speculative round over the decode rows: draft, verify every
        drafted position plus the bonus slot in one window, emit the
        accepted prefix and one verifier token, roll back the rest. A row
        with budget 0 runs a verify-only round: one plain decode step's
        progress."""
        bucket = self._decode_bucket(seqs, draft_lens)
        tok0, lengths, kd, bt, seeds, counts, temps, topks = bucket
        Rb = len(tok0)
        first_d = self._first_run("draft", (Rb,), topks)
        first_v = self._first_run("verify", (Rb,), topks)
        (d_toks, d_logits), spd = self._draft(bucket, len(seqs))
        d_toks = self._inject_draft(seqs, kd, d_toks, d_logits.shape[-1])
        with self.obs.span("verify", rows=len(seqs), bucket=[Rb]) as spv:
            emit, n_acc, health, nsel, nval = SP.verify(
                self._serving_cfg(), self.params, {"k": self.pool.k, "v": self.pool.v},
                self._dev(bt), self._dev(lengths), self._dev(tok0), d_toks,
                d_logits, kd, self.spec_config, use_lamp=self.econfig.use_lamp,
                kernel=self.econfig.kernel, taus=self.taus, seeds=seeds,
                counts=counts, temps=temps,
                top_k=topks if topks.any() else None)
            if not self.econfig.health_guard:
                health = None
        self._c_launches["verify"].inc()
        with self.obs.span("sync"):
            emit, n_acc = emit.cpu().numpy(), n_acc.cpu().numpy()
            nsel, nval, health = self._to_host(nsel, nval, health)
        if first_d:
            self.obs.record_compile("draft", (Rb,), spd.elapsed,
                                    self.total_steps)
        if first_v:
            self.obs.record_compile("verify", (Rb,), spv.elapsed,
                                    self.total_steps)
        # poison width 1 even for drafted rows: the quarantine retries a
        # verify row as a plain decode, which rewrites only position
        # cache_len -- poison past it would outlive the recovery
        health = self._inject_nan(seqs, health,
                                  [(s.cache_len, 1) for s in seqs])
        now = self._now()
        self._account_lamp(seqs, nsel, nval, verify=True)
        for i, seq in enumerate(seqs):
            if health is not None and self._unhealthy(health[i]):
                self._quarantine_row(seq, False, 1)
                continue
            self._after_verify(seq, draft_lens[i], int(n_acc[i]), emit[i], now)

    def _collect_finished(self, seqs: List[Sequence]) -> List[RequestOutput]:
        done = []
        now = self._now()
        for seq in seqs:
            reason = seq.should_stop()
            if reason is None:
                continue
            seq.finish(reason, now)
            self.scheduler.finish(seq)
            lamp_l_sel = lamp_l_val = None
            if seq.lamp.by_layer_selected is not None:
                lamp_l_sel = [float(s) for s in seq.lamp.by_layer_selected]
                lamp_l_val = [float(v) for v in seq.lamp.by_layer_valid]
            out = RequestOutput(
                req_id=seq.req_id, prompt=seq.prompt, tokens=seq.generated,
                finish_reason=reason, latency=seq.latency(),
                ttft=seq.ttft(), num_preemptions=seq.num_preemptions,
                lamp_selected=seq.lamp.selected, lamp_valid=seq.lamp.valid,
                num_cached_tokens=seq.num_cached_tokens,
                num_resume_cached_tokens=seq.num_resume_cached_tokens,
                spec_drafted=seq.spec_drafted,
                spec_accepted=seq.spec_accepted,
                lamp_layer_selected=lamp_l_sel, lamp_layer_valid=lamp_l_val,
                audit_samples=seq.audit_samples,
                audit_err_sum=seq.audit_err_sum,
                audit_flips=seq.audit_flips)
            if self.auditor is not None:
                self.auditor.finish_request(seq)
            self._finished.append(out)
            self._c_finished.inc()
            self._c_cached_prefix.inc(seq.num_cached_tokens)
            self._c_cached_resume.inc(seq.num_resume_cached_tokens)
            self._h_latency.observe(out.latency)
            self._h_ttft.observe(out.ttft)
            self._seqs.pop(seq.req_id, None)
            done.append(out)
        return done

    # -- maintenance / metrics ----------------------------------------------

    def defrag(self) -> None:
        """Compact the live sequences' blocks to the lowest arena rows,
        oldest sequence first (``PagedKVPool.defrag``)."""
        with self.obs.span("defrag"):
            self.pool.defrag(sorted(self.scheduler.running,
                                    key=lambda s: s.arrival_time))

    @property
    def num_preemptions(self) -> int:
        return self.scheduler.num_preemptions

    def lamp_layer_rates(self) -> List[float]:
        """Cumulative per-layer recompute rate (len n_layers)."""
        return [float(s / v) if v else 0.0
                for s, v in zip(self._layer_sel, self._layer_val)]

    def _sync_gauges(self) -> None:
        """Publish point-in-time state (pool, scheduler) into the registry
        so snapshots and exposition carry it; counters update in the hot
        path."""
        reg = self.obs.registry
        reg.gauge("engine_live_requests", help="requests queued or running"
                  ).set(len(self.scheduler.waiting) + len(self.scheduler.running))
        reg.gauge("kv_blocks_used", help="arena blocks in use").set(
            self.pool.num_used)
        reg.gauge("kv_util", help="arena utilization").set(
            self.pool.utilization)
        reg.gauge("kv_util_peak").set(self.pool.peak_used
                                      / self.pool.num_total)
        reg.gauge("engine_preemptions", help="recompute-style evictions"
                  ).set(self.scheduler.num_preemptions)
        reg.gauge("kv_blocks_allocated_total").set(self.pool.total_allocs)
        reg.gauge("kv_blocks_prefix_hits_total").set(self.pool.hit_blocks)
        reg.gauge("kv_cow_copies_total").set(self.pool.cow_copies)
        reg.gauge("kv_cache_evictions_total").set(self.pool.evictions)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-serializable dump of the whole metrics registry."""
        self._sync_gauges()
        return self.obs.registry.snapshot()

    def stats(self, exact: bool = False) -> Dict[str, object]:
        """Cumulative serving stats under the JAX engine's key names (a view
        over the metrics registry). Latency and TTFT percentiles come from
        the streaming histograms; `exact=True` computes them exactly over
        the retained finished requests (the last `finished_retention`)."""
        elapsed = (self._now() - self._start) if self._start else 0.0
        if exact:
            lat = [o.latency for o in self._finished]
            ttft = [o.ttft for o in self._finished]
            lat_p50 = float(np.percentile(lat, 50)) if lat else 0.0
            lat_p99 = float(np.percentile(lat, 99)) if lat else 0.0
            ttft_p50 = float(np.percentile(ttft, 50)) if ttft else 0.0
        else:
            lat_p50 = self._h_latency.quantile(0.5)
            lat_p99 = self._h_latency.quantile(0.99)
            ttft_p50 = self._h_ttft.quantile(0.5)
        cached = int(self._c_cached_prefix.value) + sum(
            s.num_cached_tokens for s in self._seqs.values())
        resume_cached = int(self._c_cached_resume.value) + sum(
            s.num_resume_cached_tokens for s in self._seqs.values())
        generated = self.generated_tokens
        n_done = int(self._c_finished.value)
        phase = {name: {"mean_us": h.mean * 1e6, "count": h.count}
                 for name, h in self.obs._phase_children.items() if h.count}
        sel, val = self.agg_lamp_selected, self.agg_lamp_valid
        return {
            "num_finished": n_done,
            "elapsed_s": elapsed,
            "tokens_per_s": generated / elapsed if elapsed else 0.0,
            "requests_per_s": n_done / elapsed if elapsed else 0.0,
            "latency_p50_s": lat_p50,
            "latency_p99_s": lat_p99,
            "ttft_p50_s": ttft_p50,
            "steps": self.total_steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "launches": self.launches,
            "launches_by_fn": self.launch_counts,
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.num_preemptions,
            "blocks_allocated": self.pool.total_allocs,
            "blocks_saved": self.pool.hit_blocks,
            "cached_tokens": cached,
            "resume_cached_tokens": resume_cached,
            "prefill_tokens_run": self.prefill_tokens_run,
            "cache_hit_rate": cached / max(1, self.prefill_tokens_run + cached),
            "cow_copies": self.pool.cow_copies,
            "cache_evictions": self.pool.evictions,
            "kv_util_mean": (self._util_sum / self._util_n
                             if self._util_n else 0.0),
            "kv_util_peak": self.pool.peak_used / self.pool.num_total,
            "lamp_recompute_rate": sel / val if val else 0.0,
            "lamp_layer_rates": self.lamp_layer_rates(),
            # first runs of a (step function, bucket) key (compile events)
            "compiles": len(self.compile_events),
            "compile_time_s": sum(e["wall_s"] for e in self.compile_events),
            # per-phase wall time (mean us + sample count per phase)
            "phase": phase,
            "live_requests": (len(self.scheduler.waiting)
                              + len(self.scheduler.running)),
            "spec_rounds": self.spec_rounds,
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": (self.spec_accepted / self.spec_drafted
                                     if self.spec_drafted else 0.0),
            "spec_tokens_per_round": (self.spec_emitted / self.spec_rounds
                                      if self.spec_rounds else 0.0),
            "verify_recompute_rate": (self.spec_verify_selected
                                      / self.spec_verify_valid
                                      if self.spec_verify_valid else 0.0),
            # adaptive policy loop (serving/policy.py)
            "policy": (self.policy.stats() if self.policy is not None
                       else {"enabled": False}),
            # shadow audit (obs/audit.py): realized LAMP error telemetry
            "audit": (self.auditor.stats() if self.auditor is not None
                      else {"enabled": False}),
            # fault tolerance (serving/faults.py + the recovery ladder)
            "recoveries": self.recoveries,
            "failed_requests": self.failed_requests,
            "faults": (self.faults.stats() if self.faults is not None
                       else {"enabled": False}),
        }

    def write_trace(self, path: Optional[str] = None) -> str:
        """Write the buffered step-phase trace as Chrome trace JSON
        (loadable in Perfetto / chrome://tracing). Requires
        ObsConfig.trace; `path` defaults to ObsConfig.trace_path."""
        return self.obs.write_trace(path)

    def _hang_diagnostic(self, n_events: int = 16) -> str:
        """The registry's scalar metrics, the live sequences, the trace
        tail and the audit ring's tail, for the run_to_completion error: a hung stream is debuggable
        from the log alone."""
        self._sync_gauges()
        scalars = {k: v for k, v in self.obs.registry.snapshot().items()
                   if isinstance(v, (int, float))}
        lines = ["registry snapshot: " + json.dumps(scalars, sort_keys=True)]
        seqs = list(self.scheduler.running) + list(self.scheduler.waiting)
        lines.append("live sequences: " + "; ".join(
            f"req {s.req_id} {s.status.value} gen={s.num_generated}"
            f"/{s.sampling.max_new_tokens} blocks={len(s.block_ids)}"
            for s in seqs[:8]))
        if self.obs.tracer.enabled:
            evs = self.obs.tracer.last(n_events)
            lines.append(f"last {len(evs)} trace events: " + "; ".join(
                f"{name}@{ts:.3f}s+{dur * 1e3:.2f}ms"
                for _, name, _, ts, dur, _ in evs))
        else:
            lines.append("trace ring empty (enable EngineConfig.obs.trace "
                         "for span-level hang forensics)")
        # accuracy regressions that stall acceptance (and so progress) show
        # up as flip-rate spikes in the audit ring
        if self.auditor is not None:
            tail = self.auditor.ring_tail()
            lines.append("audit ring tail: " + ("; ".join(tail) if tail
                                                else "(no audited steps)"))
        else:
            lines.append("audit off (set EngineConfig.audit.rate for "
                         "realized-error forensics)")
        return "\n".join(lines)

    def run_to_completion(self, max_steps: int = 100000) -> List[RequestOutput]:
        """Drive step() until every queued request finishes; raises when
        `max_steps` elapse with requests still live, with a diagnostic
        snapshot (registry scalars, live sequences, trace tail).

        A stall watchdog runs first: after `EngineConfig.stall_patience`
        consecutive steps with zero progress (no tokens, no prefill, no
        finishes, no failures) it attempts `_stall_recover()` -- clearing
        an injected stall, evicting wedged rows, or failing the oldest
        queued request -- and only raises when recovery changes nothing."""
        out: List[RequestOutput] = []
        idle = 0
        last = None
        for _ in range(max_steps):
            if not self.has_unfinished():
                return out
            out.extend(self.step())
            prog = (self.generated_tokens, self.prefill_tokens_run,
                    int(self._c_finished.value), self.failed_requests)
            if prog == last:
                idle += 1
                if idle >= self.econfig.stall_patience:
                    if not self._stall_recover():
                        break
                    idle = 0
            else:
                idle = 0
                last = prog
        raise RuntimeError(
            f"run_to_completion exceeded max_steps={max_steps} with "
            f"{self.stats()['live_requests']} request(s) still live "
            f"({int(self._c_finished.value)} finished); the stream is hung "
            f"or max_steps is too small\n" + self._hang_diagnostic())
