"""The paper's figures and tables on the port (the twin of
``benchmarks/common.py`` and ``benchmarks/paper_figs.py``).

    PYTHONPATH=src python -m repro_torch.launch.paper_figs \
        [--device cuda|cpu] [--scale reduced|full] [--only fig1,fig5,...]

Each job prints CSV rows ``name,us_per_call,derived``, where `derived` packs
the figure's metrics: KL divergence of the model's next-token distribution
under a LAMP policy from the FP32 model's, the flip rate of its greedy
token, the KQ recompute rate and the perplexity (`eval_policy`).
`us_per_call` is the time of one `eval_policy` on one batch (the FP32
forward and the policy's), synchronized with the card.

The model is GPT-2 with seeded random weights whose query and key
projections are scaled by QK_GAIN, which concentrates attention toward a
trained model's logit range, and the token streams are synthetic (Markov
chains, or uniform): no pretrained weights or corpus are in the
repository. The comparisons (LAMP against uniform low precision and the
random control, strict against relaxed, trends in mu and tau) are
relative, which survives the substitution.

Scales: "reduced" is the JAX benchmark's (4 layers at d 128 for the small
model, 8 at d 256 for fig 5's large one, vocabulary 512, 2 sequences of
128); "full" is gpt2-small, and gpt2-xl for fig 5's large model, at their
published widths, 2 sequences of 1024. Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.lamp import select_rmsnorm
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.numerics import round_to_mantissa
from repro_torch.core.policy import LampPolicy
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.models import api
from repro_torch.models import transformer as TT
from repro_torch.runtime.serve_loop import lamp_logits_softmax

QK_GAIN = 2.0   # calibrates the attention-logit spread toward a trained model's


@dataclasses.dataclass(frozen=True)
class Scale:
    """The benchmark's two models, each (arch, width overrides), and the
    batches' shape."""
    small: Tuple[str, Dict]
    large: Tuple[str, Dict]
    seq: int
    batch: int


SCALES = {
    "reduced": Scale(
        small=("gpt2-small", dict(n_layers=4, d_model=128, n_heads=4,
                                  n_kv_heads=4, d_ff=512, vocab=512,
                                  max_seq=256)),
        large=("gpt2-small", dict(n_layers=8, d_model=256, n_heads=8,
                                  n_kv_heads=8, d_ff=1024, vocab=512,
                                  max_seq=256)),
        seq=128, batch=2),
    "full": Scale(small=("gpt2-small", {}), large=("gpt2-xl", {}),
                  seq=1024, batch=2),
}

_UNIFORM_TAU = 1e9  # the strict rule at a huge tau selects nothing: uniform PS(mu)


def build_model(model: Tuple[str, Dict], seed: int = 0, device="cuda"):
    """(cfg, params): the arch at its overrides, seeded random weights with
    the query and key projections scaled by QK_GAIN."""
    arch, overrides = model
    cfg = get_config(arch).replace(**overrides)
    params = TT.init_params(cfg, seed, device=device)
    attn = params["blocks"]["attn"]
    attn["wq"] = attn["wq"] * QK_GAIN
    attn["wk"] = attn["wk"] * QK_GAIN
    return cfg, params


def make_batches(cfg, sc: Scale, n_batches: int = 2, *, seed: int = 0,
                 kind: str = "markov", branching: int = 8,
                 permute: bool = False, device="cuda") -> List[Dict]:
    """`n_batches` synthetic token batches (sc.batch, sc.seq) on `device`;
    `permute` shuffles each row's tokens (the token-order control)."""
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=sc.seq,
                                     global_batch=sc.batch, seed=seed,
                                     kind=kind, branching=branching))
    rng = np.random.default_rng(seed + 99)
    out = []
    for i in range(n_batches):
        b = ds.batch_at(i)["tokens"]
        if permute:
            b = np.stack([row[rng.permutation(len(row))] for row in b])
        out.append({"tokens": torch.from_numpy(b).to(device)})
    return out


def logit_metrics(ref: torch.Tensor, test: torch.Tensor,
                  tokens: torch.Tensor) -> Tuple[float, float, float]:
    """(mean KL(ref || test) of the next-token distributions, the share of
    positions whose greedy token flips, the mean next-token NLL of test)
    for logits (B, S, V) of the same tokens (B, S)."""
    p = torch.softmax(ref, -1)
    lp = torch.log_softmax(ref, -1)
    lq = torch.log_softmax(test, -1)
    kl = float(torch.mean(torch.sum(p * (lp - lq), -1)))
    flip = float(torch.mean(
        (torch.argmax(test, -1) != torch.argmax(ref, -1)).float()))
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(torch.log_softmax(test[:, :-1], -1), -1,
                        tgt[..., None])
    return kl, flip, float(torch.mean(nll))


def eval_policy(cfg, params, batches, policy: Optional[LampPolicy]
                ) -> Dict[str, float]:
    """The model under `policy` against the FP32 reference (`policy` None:
    the reference itself): mean KL, flip rate, recompute rate, and the
    perplexity of the policy's logits."""
    kls, flips, rates, nlls = [], [], [], []
    for batch in batches:
        tokens = batch["tokens"]
        ref, _ = TT.forward(cfg.replace(lamp=LampPolicy.disabled()), params,
                            tokens, use_lamp=False, attn_impl="full")
        if policy is None:
            test, rate = ref, 0.0
        else:
            test, aux = TT.forward(cfg.replace(lamp=policy), params, tokens,
                                   use_lamp=True, attn_impl="full")
            rate = float(aux["attn_lamp_rate"])
        kl, flip, nll = logit_metrics(ref, test, tokens)
        kls.append(kl)
        flips.append(flip)
        rates.append(rate)
        nlls.append(nll)
    return {"kl": float(np.mean(kls)),
            "flip_rate": float(np.mean(flips)),
            "recompute_rate": float(np.mean(rates)),
            "perplexity": float(np.exp(np.mean(nlls)))}


def timed(fn: Callable, device, *, warmup: int = 1, iters: int = 3):
    """(microseconds per call, last result) of `fn()`, synchronized with the
    card when `device` is one."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    out = None
    for _ in range(warmup):
        out = fn()
        sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
        sync()
    return (time.perf_counter() - t0) / iters * 1e6, out


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def _policy(mu, tau, rule="strict", granularity=1):
    return LampPolicy.paper_default(mu=mu, tau=tau, rule=rule,
                                    granularity=granularity)


def fig1_kl_vs_mu(sc: Scale, device):
    """Fig 1: KL against mu at tau 0.1: uniform, LAMP, random control."""
    cfg, params = build_model(sc.small, device=device)
    batches = make_batches(cfg, sc, device=device)
    for mu in (3, 4, 5, 7, 10):
        r_uni = eval_policy(cfg, params, batches, _policy(mu, _UNIFORM_TAU))
        us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                          _policy(mu, 0.1)), device)
        r_lamp = eval_policy(cfg, params, batches, _policy(mu, 0.1))
        r_rand = eval_policy(cfg, params, batches, _policy(mu, 0.1, "random"))
        emit(f"fig1_mu{mu}", us,
             f"kl_uniform={r_uni['kl']:.3e};kl_lamp={r_lamp['kl']:.3e};"
             f"kl_random={r_rand['kl']:.3e};rate={r_lamp['recompute_rate']:.4f}")


def fig2_tau_sweep(sc: Scale, device):
    """Fig 2: tau sweep per mu: KL, flip rate, recompute rate."""
    cfg, params = build_model(sc.small, device=device)
    batches = make_batches(cfg, sc, device=device)
    for mu in (3, 4, 6):
        for tau in (0.4, 0.2, 0.1, 0.05, 0.02):
            us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                              _policy(mu, tau)), device)
            r = eval_policy(cfg, params, batches, _policy(mu, tau))
            emit(f"fig2_mu{mu}_tau{tau}", us,
                 f"kl={r['kl']:.3e};flip={r['flip_rate']:.4f};"
                 f"rate={r['recompute_rate']:.4f}")


def fig3_strict_vs_relaxed(sc: Scale, device):
    """Fig 3: Pareto boundaries of strict (8) and relaxed (9) at mu 4."""
    cfg, params = build_model(sc.small, device=device)
    batches = make_batches(cfg, sc, device=device)
    for rule, taus in (("strict", (0.4, 0.1, 0.02, 0.005)),
                       ("relaxed", (0.8, 0.4, 0.1, 0.02))):
        for tau in taus:
            us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                              _policy(4, tau, rule)), device)
            r = eval_policy(cfg, params, batches, _policy(4, tau, rule))
            emit(f"fig3_{rule}_tau{tau}", us,
                 f"kl={r['kl']:.3e};flip={r['flip_rate']:.4f};"
                 f"rate={r['recompute_rate']:.4f}")


_DATASETS = (("markov8", dict(kind="markov", branching=8)),
             ("markov2", dict(kind="markov", branching=2)),
             ("uniform", dict(kind="uniform")))


def fig4_datasets(sc: Scale, device):
    """Fig 4 (App C.1): the rule across dataset structures."""
    cfg, params = build_model(sc.small, device=device)
    for name, kw in _DATASETS:
        batches = make_batches(cfg, sc, device=device, **kw)
        us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                          _policy(4, 0.1)), device)
        r = eval_policy(cfg, params, batches, _policy(4, 0.1))
        emit(f"fig4_{name}", us,
             f"kl={r['kl']:.3e};rate={r['recompute_rate']:.4f}")


def fig5_model_scale(sc: Scale, device):
    """Fig 5 (App C.2): the larger model gains at least as much."""
    for name, model in (("small", sc.small), ("large", sc.large)):
        cfg, params = build_model(model, device=device)
        batches = make_batches(cfg, sc, device=device)
        r_uni = eval_policy(cfg, params, batches, _policy(4, _UNIFORM_TAU))
        us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                          _policy(4, 0.1)), device)
        r = eval_policy(cfg, params, batches, _policy(4, 0.1))
        emit(f"fig5_{name}", us,
             f"kl_uniform={r_uni['kl']:.3e};kl_lamp={r['kl']:.3e};"
             f"gain={r_uni['kl'] / max(r['kl'], 1e-12):.1f}x;"
             f"rate={r['recompute_rate']:.4f}")
        del params


def fig6_permuted(sc: Scale, device):
    """Fig 6 (App C.3): permuting the tokens does not break LAMP."""
    cfg, params = build_model(sc.small, device=device)
    for name, permute in (("direct", False), ("permuted", True)):
        batches = make_batches(cfg, sc, permute=permute, device=device)
        us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                          _policy(4, 0.1)), device)
        r = eval_policy(cfg, params, batches, _policy(4, 0.1))
        emit(f"fig6_{name}", us,
             f"kl={r['kl']:.3e};flip={r['flip_rate']:.4f};"
             f"rate={r['recompute_rate']:.4f}")


def fig7_random_control(sc: Scale, device):
    """Fig 7 (App C.4): LAMP against random recompute of the same counts."""
    cfg, params = build_model(sc.small, device=device)
    batches = make_batches(cfg, sc, device=device)
    for tau in (0.4, 0.1, 0.02):
        r_lamp = eval_policy(cfg, params, batches, _policy(4, tau))
        us, _ = timed(lambda: eval_policy(cfg, params, batches[:1],
                                          _policy(4, tau, "random")), device)
        r_rand = eval_policy(cfg, params, batches, _policy(4, tau, "random"))
        emit(f"fig7_tau{tau}", us,
             f"kl_lamp={r_lamp['kl']:.3e};kl_random={r_rand['kl']:.3e};"
             f"rate={r_lamp['recompute_rate']:.4f}")


def table1_perplexity(sc: Scale, device):
    """Table 1 (App C.5): perplexity, full / low / relaxed / relaxed-LN."""
    cfg, params = build_model(sc.small, device=device)
    for ds_name, kw in _DATASETS:
        batches = make_batches(cfg, sc, device=device, **kw)
        rows = [("full", None),
                ("low", _policy(4, _UNIFORM_TAU)),
                ("relaxed_t03", _policy(4, 0.03, "relaxed")),
                ("relaxed_ln_t03", _policy(4, 0.03, "relaxed_ln")),
                ("relaxed_t09", _policy(4, 0.09, "relaxed")),
                ("relaxed_ln_t09", _policy(4, 0.09, "relaxed_ln"))]
        for mname, pol in rows:
            us, _ = timed(lambda: eval_policy(cfg, params, batches[:1], pol),
                          device, warmup=1, iters=1)
            r = eval_policy(cfg, params, batches, pol)
            emit(f"table1_{ds_name}_{mname}", us,
                 f"ppl={r['perplexity']:.4f};rate={r['recompute_rate']:.4f}")


def rwkv_logits_site(sc: Scale, device):
    """Beyond the paper: LAMP at the LM-head -> sampling-softmax site of the
    attention-free rwkv6 (it has no KQ softmax). The strict rule (8) on the
    final logits against uniform PS(mu) logits, by KL from the FP32
    softmax. rwkv6-7b reduced to d 128 and vocabulary 2048 at every scale,
    as the JAX benchmark runs it; seeded weights and tokens (not the JAX
    benchmark's draws)."""
    cfg = reduced(get_config("rwkv6-7b"), d_model=128, vocab=2048)
    params = api.init_params(cfg, 0, device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64))).to(device)
    logits = api.forward_logits(cfg, params, {"tokens": toks}) * 4.0
    p_ref = torch.softmax(logits, -1)

    def kl(p):
        return float(torch.mean(torch.sum(
            p_ref * (torch.log(p_ref + 1e-20) - torch.log(p + 1e-20)), -1)))

    for mu in (4, 6):
        p_low = torch.softmax(round_to_mantissa(logits, mu), -1)
        us, (p_lamp, rate) = timed(
            lambda: lamp_logits_softmax(logits, mu, 0.05), device)
        emit(f"rwkv_logits_site_mu{mu}", us,
             f"kl_low={kl(p_low):.3e};kl_lamp={kl(p_lamp):.3e};"
             f"rate={float(rate):.4f}")


def rmsnorm_site(sc: Scale, device):
    """The paper's Sec 3.2 (Props 3.1 / 3.2): LAMP for matmul -> RMSNorm.
    The greedy prefix of the largest y_i^2 against uniform PS(4) and a
    random selection of the same size, across tau, on the error of the
    normalization factor ||y||, which multiplies every output (each
    component's own rounding is outside LAMP's scope). kappa_c of RMSNorm
    lies in (1, 2], so tau runs in (1, 2). Heavy-tailed rows from a seeded
    generator (not the JAX benchmark's draws: the comparison is relative)."""
    gen = torch.Generator().manual_seed(0)
    n, kdim, mu = 256, 128, 4
    A = (torch.randn(n, kdim, generator=gen)
         * torch.exp(torch.randn(n, 1, generator=gen))).to(device)
    xv = torch.randn(kdim, generator=gen).to(device)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    y_exact = A @ xv
    y_low = dot_ps(A[None], xv[None, :, None], mu, granularity=1)[0, :, 0]
    norm_ref = float(torch.linalg.norm(y_exact))

    def norm_err(y):
        return abs(float(torch.linalg.norm(y)) - norm_ref) / norm_ref

    err_low = norm_err(y_low)
    for tau in (1.9, 1.5, 1.2, 1.05):
        us, mask = timed(lambda: select_rmsnorm(y_low, tau), device)
        err = norm_err(torch.where(mask, y_exact, y_low))
        rmask = torch.zeros(n, dtype=torch.bool)
        rmask[perm[:int(mask.sum())]] = True
        err_rand = norm_err(torch.where(rmask.to(device), y_exact, y_low))
        emit(f"rmsnorm_site_tau{tau}", us,
             f"err_low={err_low:.3e};err_lamp={err:.3e};"
             f"err_random={err_rand:.3e};rate={float(mask.float().mean()):.4f}")


JOBS = {
    "fig1": fig1_kl_vs_mu,
    "fig2": fig2_tau_sweep,
    "fig3": fig3_strict_vs_relaxed,
    "fig4": fig4_datasets,
    "fig5": fig5_model_scale,
    "fig6": fig6_permuted,
    "fig7": fig7_random_control,
    "table1": table1_perplexity,
    "rwkv_logits_site": rwkv_logits_site,
    "rmsnorm_site": rmsnorm_site,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", choices=sorted(SCALES), default="reduced")
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(JOBS))
    args = ap.parse_args(argv)
    device = TT.resolve_device(args.device)
    selected = args.only.split(",") if args.only else list(JOBS)
    unknown = [k for k in selected if k not in JOBS]
    if unknown:
        ap.error(f"unknown jobs {unknown}; have {list(JOBS)}")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device={name} scale={args.scale}", flush=True)
    print("name,us_per_call,derived", flush=True)
    for key in selected:
        t0 = time.perf_counter()
        JOBS[key](SCALES[args.scale], device)
        print(f"# {key} seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
