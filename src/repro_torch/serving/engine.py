"""The continuous-batching LAMP serving engine (port of
``repro/serving/engine.py``: the fused step, speculative decoding and the
split twin).

`add_request()` enqueues; `step()` asks the scheduler for one mixed plan --
chunked-prefill windows, decode rows (width-1 windows at start = cache_len)
and, with `speculative`, verify rows (width 1 + kd) side by side -- and runs
it. `mixed_exec="fused"` pads the plan to a power-of-two (rows, window)
bucket and runs it through one ``transformer.paged_mixed_step``; a plan with
draft rows first runs the draft (`draft_len` decode steps over the decode
rows' own bucket), then verifies, samples and accepts in that one mixed
call. `mixed_exec="split"` runs the same plan through per-phase sub-steps
(`_step_prefill`, `_step_decode`, `_step_spec`): the differential twin,
token for token the same. Paged attention runs on the hand-written CUDA
kernels when the engine's device is a card, and on their plain PyTorch
versions on the CPU (``device="cpu"``, which the tests ask for).

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
from . import speculative as SP
from .kv_pool import PagedKVPool
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan

TEXT_FAMILIES = transformer.FAMILIES
LAUNCH_KINDS = ("prefill", "decode", "draft", "verify", "mixed")


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
    # LAMP self-draft speculative decoding: decode rows draft `draft_len`
    # tokens with the pure low-precision forward (rule "none"), then verify
    # all draft_len + 1 positions in one window with the configured rule.
    # Greedy outputs are those of plain decoding
    speculative: bool = False
    draft_len: int = 4
    # how mixed plans execute: "fused" (one mixed launch, plus the draft
    # when rows drafted) or "split" (the same plan through the prefill /
    # decode / speculative sub-steps: the differential twin)
    mixed_exec: str = "fused"
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
    spec_drafted: int = 0           # tokens drafted for this request
    spec_accepted: int = 0          # drafted tokens the verifier accepted
    lamp_layer_selected: Optional[List[float]] = None
    lamp_layer_valid: Optional[List[float]] = None

    @property
    def lamp_recompute_rate(self) -> float:
        return self.lamp_selected / self.lamp_valid if self.lamp_valid else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)


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
        if econfig.speculative and econfig.draft_len < 1:
            raise ValueError(f"speculative decoding needs draft_len >= 1, got "
                             f"{econfig.draft_len}")
        if econfig.mixed_exec not in ("fused", "split"):
            raise ValueError(f"mixed_exec must be 'fused' or 'split', got "
                             f"{econfig.mixed_exec!r}")
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
            chunked_prefill=econfig.chunked_prefill,
            spec_draft_len=econfig.draft_len if econfig.speculative else 0)
        self.spec_config = (SP.SpecConfig(draft_len=econfig.draft_len)
                            if econfig.speculative else None)
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
        self.decode_steps = 0       # mixed steps with a decode / verify row
        self.spec_rounds = 0        # mixed steps with a drafting row
        # step-function calls by kind (fused: "mixed", plus "draft" in a
        # speculative round; split: "prefill", "decode", "draft", "verify")
        self.launch_counts = dict.fromkeys(LAUNCH_KINDS, 0)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self._verify_sel = 0.0      # LAMP counts of the verify passes
        self._verify_val = 0.0
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
        if self.econfig.mixed_exec == "split":
            self._step_mixed_split(plan)
        else:
            self._step_mixed(plan)
        self.mixed_steps += 1
        roles = plan.roles or []
        self.prefill_steps += any(r == "prefill" for r in roles)
        self.decode_steps += any(r != "prefill" for r in roles)
        self.spec_rounds += self._spec_round(plan.draft_lens)
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

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _spec_round(self, draft_lens) -> bool:
        return self.spec_config is not None and any(draft_lens)

    def _account_lamp(self, seqs: List[Sequence], nsel: torch.Tensor,
                      nval: torch.Tensor, *, verify: bool = False,
                      verify_cols: Optional[List[int]] = None) -> None:
        """Fold one step's per-layer (L, Bb) counts into the engine's
        per-layer totals (every bucket column, padded rows included, as the
        JAX engine sums them) and each sequence's breakdown. `verify=True`
        credits the whole batch to the verify counters (a split speculative
        round); `verify_cols` only those columns (a fused mixed step whose
        decode rows verified)."""
        nsel, nval = nsel.cpu().numpy(), nval.cpu().numpy()
        self._layer_sel += nsel.sum(axis=1)
        self._layer_val += nval.sum(axis=1)
        if verify:
            self._verify_sel += float(nsel.sum())
            self._verify_val += float(nval.sum())
        elif verify_cols:
            self._verify_sel += float(nsel[:, verify_cols].sum())
            self._verify_val += float(nval[:, verify_cols].sum())
        for i, seq in enumerate(seqs):
            seq.lamp.add_layers(nsel[:, i], nval[:, i])

    # -- per-row bookkeeping, shared by the fused step and the split twin ---

    def _after_prefill(self, seq: Sequence, w: int, tok: int,
                       now: float) -> None:
        seq.prefill_cursor += w
        seq.cache_len = seq.prefill_cursor
        self.prefill_tokens_run += w
        if self.econfig.prefix_cache:
            self.pool.register_prefix(seq.prefill_tokens(), seq.block_ids,
                                      seq.cache_len, hashes=seq.prefix_hashes)
        if seq.prefill_remaining == 0:
            seq.status = SequenceStatus.DECODE
            seq.on_token(tok, now)
            self.generated_tokens += 1
        else:
            self.prefill_chunks += 1

    def _after_decode(self, seq: Sequence, tok: int, now: float) -> None:
        seq.cache_len += 1
        seq.on_token(tok, now)
        self.generated_tokens += 1

    def _after_verify(self, seq: Sequence, kd: int, n_acc: int,
                      emit: np.ndarray, now: float) -> None:
        """Emit the accepted drafts and the verifier's token, stopping at
        the request's own limits, then roll back the blocks that held
        rejected (or surplus) draft K/V."""
        seq.spec_drafted += kd
        self.spec_drafted += kd
        appended = 0
        for t in emit[:n_acc + 1]:
            seq.on_token(int(t), now)
            appended += 1
            self.generated_tokens += 1
            if seq.should_stop():
                break
        # only drafts actually kept count as accepted: a stop inside the
        # accepted run drops the surplus
        kept = min(n_acc, appended)
        seq.spec_accepted += kept
        self.spec_accepted += kept
        seq.cache_len += appended
        self.spec_emitted += appended
        seq.block_ids = self.pool.rollback(seq.block_ids, seq.cache_len)

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

    def _draft(self, bucket):
        """The draft over a `_decode_bucket`: returns the draft tokens
        (Rb, k) and logits (Rb, k, V) on the device."""
        tok0, lengths, kdv, bt, seeds, counts, temps, topks = bucket
        out = SP.draft(self.cfg, self.params,
                       {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
                       self._dev(lengths), self._dev(tok0), kdv,
                       self.spec_config, use_lamp=self.econfig.use_lamp,
                       seeds=seeds, counts=counts, temps=temps,
                       top_k=topks if topks.any() else None)
        self.launch_counts["draft"] += 1
        return out

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
        tokens_t = self._dev(tokens)
        if spec_round:
            k = self.spec_config.draft_len
            dseqs = [seqs[i] for i in dec_rows]
            kd = [draft_lens[i] for i in dec_rows]
            d_toks, d_logits = self._draft(self._decode_bucket(dseqs, kd))
            rows = torch.as_tensor(dec_rows, device=self.device)
            tokens_t[rows, 1:k + 1] = d_toks[:len(dec_rows)].to(torch.int32)
        logits, _, (nsel, nval) = transformer.paged_mixed_step(
            self.cfg, self.params, tokens_t,
            {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
            self._dev(starts), self._dev(qlens), use_lamp=self.econfig.use_lamp,
            per_layer=True, taus=self.taus, all_logits=spec_round)
        self.launch_counts["mixed"] += 1
        if spec_round:
            last = logits[torch.arange(Bb, device=self.device),
                          self._dev(qlens).long() - 1]
            # accept only over the verify rows: the rule is row-wise
            emit, n_acc = SP.speculative_accept(
                logits[rows, :k + 1], d_toks[:len(dec_rows)],
                d_logits[:len(dec_rows)], kd, seeds[dec_rows],
                counts[dec_rows], temps[dec_rows],
                None if top is None else top[dec_rows])
            emit, n_acc = emit.cpu().numpy(), n_acc.cpu().numpy()
        else:
            last = logits[:, -1]
        nxt = SM.sample_rows(last, seeds, counts, temps, top).cpu().numpy()
        now = self._now()
        self._account_lamp(seqs, nsel, nval,
                           verify_cols=dec_rows if spec_round else None)
        verify_row = {i: j for j, i in enumerate(dec_rows)}
        for i, seq in enumerate(seqs):
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
        logits, _, (nsel, nval) = transformer.paged_prefill_window(
            self.cfg, self.params, self._dev(tokens),
            {"k": self.pool.k, "v": self.pool.v}, self._dev(bt),
            self._dev(starts), self._dev(lengths),
            use_lamp=self.econfig.use_lamp, per_layer=True, taus=self.taus)
        self.launch_counts["prefill"] += 1
        nxt = SM.sample_rows(logits[:, -1], seeds, counts, temps,
                             topks if topks.any() else None).cpu().numpy()
        now = self._now()
        self._account_lamp(seqs, nsel, nval)
        for i, (seq, w) in enumerate(zip(seqs, windows)):
            self._after_prefill(seq, w, int(nxt[i]), now)

    def _step_decode(self, seqs: List[Sequence]) -> None:
        """One token per sequence through `paged_decode_step` (the decode
        kernel)."""
        tok0, lengths, _, bt, seeds, counts, temps, topks = \
            self._decode_bucket(seqs, [0] * len(seqs))
        logits, _, (nsel, nval) = transformer.paged_decode_step(
            self.cfg, self.params, {"k": self.pool.k, "v": self.pool.v},
            self._dev(bt), self._dev(lengths), self._dev(tok0[:, None]),
            use_lamp=self.econfig.use_lamp, per_layer=True, taus=self.taus)
        self.launch_counts["decode"] += 1
        nxt = SM.sample_rows(logits[:, -1], seeds, counts, temps,
                             topks if topks.any() else None).cpu().numpy()
        now = self._now()
        self._account_lamp(seqs, nsel, nval)
        for i, seq in enumerate(seqs):
            self._after_decode(seq, int(nxt[i]), now)

    def _step_spec(self, seqs: List[Sequence], draft_lens: List[int]) -> None:
        """One speculative round over the decode rows: draft, verify every
        drafted position plus the bonus slot in one window, emit the
        accepted prefix and one verifier token, roll back the rest. A row
        with budget 0 runs a verify-only round: one plain decode step's
        progress."""
        bucket = self._decode_bucket(seqs, draft_lens)
        d_toks, d_logits = self._draft(bucket)
        tok0, lengths, kd, bt, seeds, counts, temps, topks = bucket
        emit, n_acc, nsel, nval = SP.verify(
            self.cfg, self.params, {"k": self.pool.k, "v": self.pool.v},
            self._dev(bt), self._dev(lengths), self._dev(tok0), d_toks,
            d_logits, kd, self.spec_config, use_lamp=self.econfig.use_lamp,
            taus=self.taus, seeds=seeds, counts=counts, temps=temps,
            top_k=topks if topks.any() else None)
        self.launch_counts["verify"] += 1
        emit, n_acc = emit.cpu().numpy(), n_acc.cpu().numpy()
        now = self._now()
        self._account_lamp(seqs, nsel, nval, verify=True)
        for i, seq in enumerate(seqs):
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
            "launches": sum(self.launch_counts.values()),
            "launches_by_fn": dict(self.launch_counts),
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
            "spec_rounds": self.spec_rounds,
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": (self.spec_accepted / self.spec_drafted
                                     if self.spec_drafted else 0.0),
            "spec_tokens_per_round": (self.spec_emitted / self.spec_rounds
                                      if self.spec_rounds else 0.0),
            "verify_recompute_rate": (self._verify_sel / self._verify_val
                                      if self._verify_val else 0.0),
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
