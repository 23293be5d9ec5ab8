"""The continuous-batching LAMP serving engine, fused step (port of the
fused, no-draft part of ``repro/serving/engine.py``).

`add_request()` enqueues; `step()` asks the scheduler for one mixed plan --
chunked-prefill windows and decode rows (width-1 windows at start =
cache_len) side by side -- pads it to a power-of-two (rows, window) bucket,
runs it through ``transformer.paged_mixed_step`` over the paged KV pool,
samples one token for every row whose window completes, and returns the
requests that finished. Paged attention runs on the hand-written CUDA kernel
when the engine's device is a card, and on the plain PyTorch version on the
CPU (``device="cpu"``, which the tests ask for).

The engine runs on ``cuda`` unless the caller asks for the CPU, and raises
when CUDA is asked for and absent: it never falls back.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer

from . import sampling as SM
from .kv_pool import PagedKVPool
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan

TEXT_FAMILIES = transformer.FAMILIES


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    n_blocks: int = 0               # 0 = auto-size from max_model_len
    max_model_len: int = 0          # 0 = cfg.max_seq
    max_prefill_batch: int = 8
    max_prefill_tokens: int = 2048  # prefill-step token budget = chunk size
    max_decode_batch: int = 32
    use_lamp: bool = True
    # prefix caching: requests sharing a prompt prefix map their block
    # tables onto the same arena rows (refcounted, copy-on-write)
    prefix_cache: bool = True
    # chunked prefill: long prompts prefill max_prefill_tokens per step so
    # decode rows keep moving
    chunked_prefill: bool = True
    device: str = "cuda"


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
    lamp_layer_selected: Optional[List[float]] = None
    lamp_layer_valid: Optional[List[float]] = None

    @property
    def lamp_recompute_rate(self) -> float:
        return self.lamp_selected / self.lamp_valid if self.lamp_valid else 0.0


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


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
        self._now = clock or time.perf_counter
        self.pool = PagedKVPool(cfg, n_blocks=n_blocks, block_size=bs,
                                dtype=torch.float32,   # the kernel's K/V type
                                enable_prefix_cache=econfig.prefix_cache,
                                device=self.device)
        self.scheduler = Scheduler(
            self.pool, max_prefill_batch=econfig.max_prefill_batch,
            max_prefill_tokens=econfig.max_prefill_tokens,
            max_decode_batch=econfig.max_decode_batch,
            chunked_prefill=econfig.chunked_prefill)
        self._next_id = 0
        self._seqs: Dict[int, Sequence] = {}          # live sequences only
        self._finished: Deque[RequestOutput] = deque(maxlen=1024)
        self._start: Optional[float] = None
        self._util_sum = 0.0
        self._util_n = 0
        # cumulative counters (stats() reports them under the JAX engine's
        # key names)
        self.mixed_steps = 0
        self.prefill_steps = 0      # mixed steps with a prefill row
        self.decode_steps = 0       # mixed steps with a decode row
        self.prefill_chunks = 0
        self.prefill_tokens_run = 0
        self.generated_tokens = 0
        self._n_finished = 0
        self._cached_prefix = 0
        self._cached_resume = 0
        L = cfg.n_layers
        self._layer_sel = np.zeros((L,), np.float64)
        self._layer_val = np.zeros((L,), np.float64)
        # live per-layer LAMP thresholds, read by the kernel from device
        # memory (the static site tau; a later slice's policy moves them)
        self.taus = torch.full((L,), float(cfg.lamp.kq.tau),
                               dtype=torch.float32, device=self.device)

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
        req_id = self._next_id
        self._next_id += 1
        seq = Sequence(req_id, prompt, sampling,
                       arrival_time if arrival_time is not None
                       else self._now())
        self._seqs[req_id] = seq
        self.scheduler.add(seq)
        return req_id

    def has_unfinished(self) -> bool:
        return self.scheduler.has_work()

    # -- the step loop ------------------------------------------------------

    @torch.no_grad()
    def step(self) -> List[RequestOutput]:
        """Run one engine step; returns the requests it finished."""
        if self._start is None:
            self._start = self._now()
        plan = self.scheduler.schedule()
        if plan is None:
            return []
        self._step_mixed(plan)
        self.mixed_steps += 1
        roles = plan.roles or []
        self.prefill_steps += any(r == "prefill" for r in roles)
        self.decode_steps += any(r != "prefill" for r in roles)
        self._util_sum += self.pool.utilization
        self._util_n += 1
        return self._collect_finished(plan.seqs)

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

    def _account_lamp(self, seqs: List[Sequence], nsel: np.ndarray,
                      nval: np.ndarray) -> None:
        """Fold one step's per-layer (L, Bb) counts into the engine's
        per-layer totals (every bucket column, padded rows included, as the
        JAX engine sums them) and each sequence's breakdown."""
        self._layer_sel += nsel.sum(axis=1)
        self._layer_val += nval.sum(axis=1)
        for i, seq in enumerate(seqs):
            seq.lamp.add_layers(nsel[:, i], nval[:, i])

    def _step_mixed(self, plan: StepPlan) -> None:
        """Run one mixed plan as one bucketed (rows, max_window) batch."""
        seqs, windows = plan.seqs, list(plan.windows)
        roles = list(plan.roles or ["decode"] * len(seqs))
        cap = self.econfig.max_prefill_batch + self.econfig.max_decode_batch
        Bb = _bucket(len(seqs), cap)
        Wb = _bucket(max(windows), 0)
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
                tokens[i, 0] = seq.last_token
                starts[i] = seq.cache_len
            qlens[i] = w
        bt, seeds, counts, temps, topks = self._batch_arrays(seqs, Bb)
        dev = self.device
        logits, _, (nsel, nval) = transformer.paged_mixed_step(
            self.cfg, self.params, torch.from_numpy(tokens).to(dev),
            {"k": self.pool.k, "v": self.pool.v},
            torch.from_numpy(bt).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(qlens).to(dev), use_lamp=self.econfig.use_lamp,
            per_layer=True, taus=self.taus)
        nxt = SM.sample_rows(logits[:, -1], seeds, counts, temps,
                                   topks if topks.any() else None)
        nxt = nxt.cpu().numpy()
        nsel, nval = nsel.cpu().numpy(), nval.cpu().numpy()
        now = self._now()
        self._account_lamp(seqs, nsel, nval)
        for i, seq in enumerate(seqs):
            w = windows[i]
            if roles[i] == "prefill":
                seq.prefill_cursor += w
                seq.cache_len = seq.prefill_cursor
                self.prefill_tokens_run += w
                if self.econfig.prefix_cache:
                    self.pool.register_prefix(seq.prefill_tokens(),
                                              seq.block_ids, seq.cache_len,
                                              hashes=seq.prefix_hashes)
                if seq.prefill_remaining == 0:
                    seq.status = SequenceStatus.DECODE
                    seq.on_token(int(nxt[i]), now)
                    self.generated_tokens += 1
                else:
                    self.prefill_chunks += 1
            else:
                seq.cache_len += 1
                seq.on_token(int(nxt[i]), now)
                self.generated_tokens += 1

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
                lamp_layer_selected=lamp_l_sel, lamp_layer_valid=lamp_l_val)
            self._finished.append(out)
            self._n_finished += 1
            self._cached_prefix += seq.num_cached_tokens
            self._cached_resume += seq.num_resume_cached_tokens
            self._seqs.pop(seq.req_id, None)
            done.append(out)
        return done

    # -- metrics ------------------------------------------------------------

    @property
    def num_preemptions(self) -> int:
        return self.scheduler.num_preemptions

    def lamp_layer_rates(self) -> List[float]:
        """Cumulative per-layer recompute rate (len n_layers)."""
        return [float(s / v) if v else 0.0
                for s, v in zip(self._layer_sel, self._layer_val)]

    def stats(self) -> Dict[str, object]:
        """Cumulative serving stats, under the JAX engine's key names.
        Percentiles are exact over the last 1024 finished requests."""
        elapsed = (self._now() - self._start) if self._start else 0.0
        lat = [o.latency for o in self._finished]
        ttft = [o.ttft for o in self._finished]
        cached = self._cached_prefix + sum(
            s.num_cached_tokens for s in self._seqs.values())
        resume_cached = self._cached_resume + sum(
            s.num_resume_cached_tokens for s in self._seqs.values())
        sel, val = float(self._layer_sel.sum()), float(self._layer_val.sum())
        return {
            "num_finished": self._n_finished,
            "elapsed_s": elapsed,
            "tokens_per_s": self.generated_tokens / elapsed if elapsed else 0.0,
            "requests_per_s": self._n_finished / elapsed if elapsed else 0.0,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "steps": self.mixed_steps,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "launches": self.mixed_steps,     # one step function call per step
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
            "live_requests": (len(self.scheduler.waiting)
                              + len(self.scheduler.running)),
        }

    def run_to_completion(self, max_steps: int = 100000) -> List[RequestOutput]:
        """Drive step() until every queued request finishes; raises when
        `max_steps` elapse with requests still live."""
        out: List[RequestOutput] = []
        for _ in range(max_steps):
            if not self.has_unfinished():
                return out
            out.extend(self.step())
        raise RuntimeError(
            f"run_to_completion exceeded max_steps={max_steps} with "
            f"{self.stats()['live_requests']} request(s) still live")
