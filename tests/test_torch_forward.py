"""Port vs JAX: the paper's evaluation path.

`core/attention.py` (the App C.4 random control arm, `chunked_attention`,
`chunked_attention_lamp`), `models/layers.py::attention_sublayer`,
`models/transformer.py::forward` on tiny gpt2, dense (glm4-9b: GQA, half
RoPE) and moe configs, `data/synthetic.py`, and `launch/paper_figs.py`'s
`eval_policy` against the JAX benchmark's (`benchmarks/common.py`), with
the same inputs and the weights carried across by `params_from_jax`; then
`paper_figs` and `quickstart` as a user runs them on the CPU.

Tolerances:
  * the random arm's mask and the synthetic tokens: bit-exact;
  * attention outputs and logits: rtol 2e-5 / atol 2e-6
    (tests/test_paged_kernel.py:50-65); each backend sums its FP32
    products in its own order;
  * counts of the max-based rules (relaxed, and the online rule): exact;
    the strict rule (and the random arm, which takes its counts): a slack
    of 1 a query row, over heads (the softmax normalizer is summed in each
    backend's order); in a whole model, 1 a (layer, query row) -- q and k
    then differ in their last bits, so a y_low on a PS(mu) rounding edge
    may round the other way (and XLA on the CPU contracts dot_ps's g 1
    step c + a*b into one FMA, where the port rounds twice): so the whole
    model is held at mu 4 on one token seed, and layer by layer on JAX's
    own inputs at mu 7 on eight;
  * `eval_policy`: KL and flip rate within what those logits allow (KL
    atol 2e-6 plus rtol 1e-3; the flip rate within one position of the
    batches), the recompute rate within the count slack, perplexity rtol
    1e-5.
"""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import common as JB  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import attention as JA  # noqa: E402
from repro.core import mixed_matmul as JMM  # noqa: E402
from repro.core.policy import LampPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import LampSite as JaxSite  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import attention as TA  # noqa: E402
from repro_torch.core import mixed_matmul as TMM  # noqa: E402
from repro_torch.core import numerics as TN  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.policy import LampPolicy, LampSite  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402
from repro_torch.launch import paper_figs as PF  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
            vocab=512, max_seq=64)
TINY_SCALE = PF.Scale(small=("gpt2-small", TINY), large=("gpt2-small", TINY),
                      seq=32, batch=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are tiny: more torch threads only contend with XLA's
    (and the other test workers') threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# JAX's forward, jitted once per config (the eager one recompiles its layer
# scan on every call)
jax_forward = jax.jit(JT.forward, static_argnums=(0,),
                      static_argnames=("use_lamp", "attn_impl", "remat",
                                       "moe_groups"))


def _jit(fn, **static):
    """A JAX function jitted with its static arguments bound (eager JAX
    compiles op by op, the scans on every call)."""
    return jax.jit(functools.partial(fn, **static))


def _qkv(seed, B=2, H=3, Tq=24, Tk=24, D=16, gain=2.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, H, T, D)) * g).astype(np.float32)
            for T, g in ((Tq, gain), (Tk, gain), (Tk, 1.0))]


def _both(arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


STRICT = dict(rule="strict", mu=4, tau=0.1, granularity=1)


@pytest.mark.parametrize("causal,window", [(True, 7), (False, None)])
def test_random_arm_matches_jax(causal, window):
    """The control arm: JAX's own construction (attention.py:152-161) on a
    given mask against the port's, bit for bit; then the whole call's
    outputs and per-row counts, which equal the strict rule's."""
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(1))
    B, H, T = 2, 3, 24
    where = (np.arange(T)[None, :] <= np.arange(T)[:, None]) & \
        (np.arange(T)[None, :] > np.arange(T)[:, None] - window) \
        if causal else None
    wb = None if where is None else np.broadcast_to(where, (B, H, T, T))
    mask = np.random.default_rng(2).random((B, H, T, T)) < 0.3
    if wb is not None:
        mask &= wb
    n_sel = mask.sum(-1, keepdims=True)
    scores = jax.random.uniform(jax.random.PRNGKey(0), mask.shape)
    if wb is not None:
        scores = jnp.where(wb, scores, -1.0)
    ranks = jnp.argsort(jnp.argsort(-scores, axis=-1), axis=-1)
    want = np.asarray(ranks < n_sel) & (True if wb is None else wb)
    got = TA._random_mask(torch.from_numpy(mask), prng.PRNGKey(0),
                          None if wb is None else torch.from_numpy(wb.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(-1), mask.sum(-1))

    kw = dict(causal=causal, window=window)
    jo, ja = _jit(JA.attention_lamp, site=JaxSite(**STRICT), reduce=False,
                  **kw)(jq, jk, jv, random_key=jax.random.PRNGKey(0))
    to, ta = TA.attention_lamp(tq, tk, tv, LampSite(**STRICT), reduce=False,
                               random_key=prng.PRNGKey(0), **kw)
    _, ts = TA.attention_lamp(tq, tk, tv, LampSite(**STRICT), reduce=False,
                              **kw)
    torch.testing.assert_close(ta.n_selected, ts.n_selected, rtol=0, atol=0)
    assert np.abs(ta.n_selected.numpy()
                  - np.asarray(ja.n_selected)).max() <= 1
    np.testing.assert_array_equal(ta.n_valid.numpy(), np.asarray(ja.n_valid))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("case", ["causal_tiled_window", "noncausal_padded",
                                  "offset"])
def test_chunked_attention_matches_jax(case):
    kw, shape = {
        # 64 // q_tiles 4 = 16 >= block 16: the causal q-tiling is on
        "causal_tiled_window": (dict(block=16, window=10, q_tiles=4),
                                dict(Tq=64, Tk=64)),
        # 40 keys in blocks of 16: the last block padded
        "noncausal_padded": (dict(causal=False, block=16), dict(Tq=8, Tk=40)),
        "offset": (dict(block=8, offset=32), dict(Tq=8, Tk=40)),
    }[case]
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(3, **shape))
    np.testing.assert_allclose(
        TA.chunked_attention(tq, tk, tv, **kw).numpy(),
        np.asarray(_jit(JA.chunked_attention, **kw)(jq, jk, jv)), **TOL)


_TILED = (dict(Tq=64, Tk=64), dict(block=16, window=20, q_tiles=4))
_OFFSET = (dict(Tq=8, Tk=40), dict(block=16, offset=32))


@pytest.mark.parametrize("onepass,granularity,case", [
    (False, 0, _TILED), (False, 1, _OFFSET), (True, 0, _OFFSET),
    (True, 1, _TILED)])
def test_chunked_attention_lamp_matches_jax(onepass, granularity, case):
    """Two-pass and one-pass online LAMP, the cast-only tier (g 0) and
    g 1, q-tiled with a window, or with an offset and padding: outputs,
    exact counts. Inside the port at g 1, the two-pass count equals
    attention_lamp's relaxed count and the one-pass count is at least it."""
    site = dict(rule="relaxed", mu=4, tau=0.1, granularity=granularity)
    for shape, kw in (case,):
        (tq, tk, tv), (jq, jk, jv) = _both(_qkv(4, **shape))
        jo, ja = _jit(JA.chunked_attention_lamp, site=JaxSite(**site),
                      onepass=onepass, **kw)(jq, jk, jv)
        to, ta = TA.chunked_attention_lamp(tq, tk, tv, LampSite(**site),
                                           onepass=onepass, **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        assert float(ta.n_selected) == float(ja.n_selected) > 0
        assert float(ta.n_valid) == float(ja.n_valid)
        if granularity == 1:
            _, two = TA.chunked_attention_lamp(tq, tk, tv, LampSite(**site),
                                               **kw)
            _, full = TA.attention_lamp(
                tq, tk, tv, LampSite(**site), offset=kw.get("offset", 0),
                window=kw.get("window"))
            assert float(two.n_selected) == float(full.n_selected)
            assert float(ta.n_selected) >= float(two.n_selected)
    with pytest.raises(ValueError, match="relaxed rule"):
        TA.chunked_attention_lamp(tq, tk, tv, LampSite(**STRICT))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.mark.parametrize("arch,rule", [("gpt2", "random"),
                                       ("glm4-9b", "relaxed"),
                                       ("qwen3-moe-30b-a3b", "strict")])
def test_forward_matches_jax(arch, rule):
    """Logits and aux of `forward` with LAMP off and on (the MoE with its
    router site on, strict g 0, as deployed). Logits: atol 2e-6 of the
    largest logit (the roundoff of each backend's FP32 sums grows with the
    activations through the layers; the dense and MoE logits reach 4-5).
    A y_low on a PS(mu) rounding edge (XLA on the CPU takes dot_ps's g 1
    step as one FMA, the port as two roundings), a KQ selection or a
    routing choice on a near-tie can fall the other way across the
    backends and move a token's logits by 1e-5 to 1e-3; at mu 7 most seeds
    meet one in the MoE (ROADMAP queue 3). So these run at mu 4 on tokens
    where none falls apart (the rates and kept_frac hold that), and
    test_layers_match_jax_on_shared_inputs holds every layer at mu 7 on
    any seed."""
    jcfg, cfg, jparams, tparams = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24))
    kq = dict(rule=rule, mu=4, tau=0.1, granularity=1)
    router = dict(rule="strict", mu=7, tau=0.05, granularity=0)
    jpol = JaxPolicy(kq=JaxSite(**kq), router=JaxSite(**router))
    tpol = LampPolicy(kq=LampSite(**kq), router=LampSite(**router))
    # LAMP off once, in the MoE (the gpt2 model's FP32 reference is held in
    # test_eval_policy_matches_jax)
    for use_lamp in ((False, True) if arch == "qwen3-moe-30b-a3b" else (True,)):
        jl, jaux = jax_forward(jcfg.replace(lamp=jpol), jparams,
                               jnp.asarray(toks, jnp.int32), use_lamp=use_lamp)
        tl, taux = TT.forward(cfg.replace(lamp=tpol), tparams,
                              torch.from_numpy(toks), use_lamp=use_lamp)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(jl).max())
        assert set(taux) == set(jaux)
        # the rate is a mean over layers of selected / valid: slack 1 a
        # (layer, query row)
        slack = 2 * 24 / (2 * cfg.n_heads * 24 * 25 / 2)
        assert abs(float(taux["attn_lamp_rate"])
                   - float(jaux["attn_lamp_rate"])) <= slack
        assert (float(taux["attn_lamp_rate"]) > 0) == use_lamp
        if arch == "qwen3-moe-30b-a3b":
            assert float(taux["kept_frac"]) == float(jaux["kept_frac"])
            np.testing.assert_allclose(float(taux["router_lamp_rate"]),
                                       float(jaux["router_lamp_rate"]),
                                       rtol=0, atol=0)
            np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                                       float(jaux["moe_aux_loss"]), **TOL)


def _fma_dot_ps(a, b, mu, *, granularity=1):
    """`dot_ps` with each g 1 step c + a*b taken in one rounding (the
    product and the sum in float64), as XLA on the CPU contracts it into an
    FMA; the port rounds the product to FP32 first, as its kernels do."""
    if granularity != 1:
        return TMM.dot_ps(a, b, mu, granularity=granularity)
    acc = torch.zeros((), dtype=torch.float64)
    for s in range(a.shape[-1]):
        acc = TN.round_to_mantissa(
            (acc + a[..., s:s + 1].double() * b[..., s:s + 1, :].double())
            .float(), mu).double()
    return acc.float()


@pytest.mark.parametrize("arch,rule", [("glm4-9b", "relaxed"),
                                       ("qwen3-moe-30b-a3b", "strict")])
def test_layers_match_jax_on_shared_inputs(arch, rule, monkeypatch):
    """The cause of the mu 7 divergence that test_forward_matches_jax steps
    round, on any token seed: layer by layer on JAX's own inputs, at mu 7.
    A layer's q, k, v from JAX's residual stream are within TOL of JAX's.
    JAX's y_low on them is the FMA form of `dot_ps` bit for bit (XLA on
    the CPU contracts the g 1 step into one rounding; the port takes two);
    with that step, `attention_sublayer` fed JAX's q, k, v gives JAX's
    output within TOL and its KQ counts within the strict slack. The MLP or
    MoE fed JAX's second-norm output gives JAX's within TOL, and the MoE's
    routing (kept and router-recomputed shares, as counts) exactly. So a
    whole model moves only where a PS(7) rounding edge turns the FMA, or
    FP32 roundoff carried from an earlier layer, into another y_low, KQ
    selection or expert."""
    jcfg, cfg, jparams, tparams = _models(arch)
    kq = dict(rule=rule, mu=7, tau=0.1, granularity=1)
    router = dict(rule="strict", mu=7, tau=0.05, granularity=0)
    jcfg = jcfg.replace(lamp=JaxPolicy(kq=JaxSite(**kq),
                                       router=JaxSite(**router)))
    cfg = cfg.replace(lamp=LampPolicy(kq=LampSite(**kq),
                                      router=LampSite(**router)))
    T, H, Hkv = 24, cfg.n_heads, cfg.n_kv_heads
    jctx = JT._ctx(jcfg, jnp.arange(T), True, "auto", 1)
    tctx = TT._ctx(cfg, torch.arange(T), True, "auto")

    @jax.jit
    def jax_layer(p, x):
        """JAX's block, with its q, k, v, its KQ y_low and its second-norm
        output."""
        h = JL.apply_norm(jcfg, x, p, "ln1")
        q, k, v = JL._project_qkv(jcfg, p["attn"], h, jctx.positions)
        qh = jnp.swapaxes(q, 1, 2) * cfg.hd ** -0.5
        kh = JL._repeat_kv(jnp.swapaxes(k, 1, 2), H // Hkv)
        y_low = JMM.dot_ps(qh, jnp.swapaxes(kh, -1, -2), 7, granularity=1)
        a, rate = JL.attention_sublayer(jcfg, p["attn"], h,
                                        positions=jctx.positions,
                                        lamp_site=jctx.lamp_kq)
        h2 = JL.apply_norm(jcfg, x + a, p, "ln2")
        if jcfg.family == "moe":
            m, met = JM.moe_apply(jcfg, p["moe"], h2,
                                  lamp_site=jctx.lamp_router)
        else:
            m, met = JL.mlp_apply(jcfg, p["mlp"], h2), {}
        return (q, k, v), y_low, a, rate, h2, m, met

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(want).max())

    def torch_of(a):
        return torch.from_numpy(np.array(a))

    own_qkv, shared = TL._project_qkv, {}
    monkeypatch.setattr(TL, "_project_qkv", lambda *a, **k: shared["qkv"])
    monkeypatch.setattr(TA, "dot_ps", _fma_dot_ps)
    slack = T / (H * T * (T + 1) / 2)
    edges = 0                     # y_low where the port's two roundings differ
    for seed in range(8):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab, (2, T))
        x = JL.embed(jcfg, jparams["embed"], jnp.asarray(toks, jnp.int32),
                     jctx.positions)
        for l in range(cfg.n_layers):
            jp = jax.tree.map(lambda t: t[l], jparams["blocks"])
            tp = TT.layer_params(tparams["blocks"], l)
            jqkv, jy, ja, jrate, h2, jm, jmet = jax_layer(jp, x)
            tx = torch_of(x)
            for got, want in zip(own_qkv(cfg, tp["attn"],
                                         TL.apply_norm(cfg, tx, tp, "ln1"),
                                         tctx.positions), jqkv):
                close(got, want)
            shared["qkv"] = tq, tk, tv = tuple(torch_of(t) for t in jqkv)
            kh = TL._repeat_kv(tk.transpose(1, 2), H // Hkv)
            qs, kt = tq.transpose(1, 2) * cfg.hd ** -0.5, kh.transpose(-1, -2)
            np.testing.assert_array_equal(_fma_dot_ps(qs, kt, 7).numpy(),
                                          np.asarray(jy))
            edges += int((TMM.dot_ps(qs, kt, 7).numpy() != jy).sum())
            ta, trate = TL.attention_sublayer(
                cfg, tp["attn"], TL.apply_norm(cfg, tx, tp, "ln1"),
                positions=tctx.positions, lamp_site=tctx.lamp_kq)
            close(ta, ja)
            assert abs(float(trate) - float(jrate)) <= slack
            assert float(trate) > 0
            th = torch_of(h2)
            if cfg.family == "moe":
                tm, tmet = TM.moe_apply(cfg, tp["moe"], th,
                                        lamp_site=tctx.lamp_router)
                # the shares as counts (each backend sums its mean in its
                # own order)
                n = 2 * T * cfg.n_experts
                for key in ("kept_frac", "router_lamp_rate"):
                    assert round(float(tmet[key]) * n) == \
                        round(float(jmet[key]) * n), key
            else:
                tm = TL.mlp_apply(cfg, tp["mlp"], th)
            close(tm, jm)
            x = x + ja + jm
    # ... and on these seeds the two roundings do land on another side of
    # a PS(7) edge: the FMA is what the whole-model comparison meets
    assert edges > 0


def test_forward_chunked_onepass_and_sublayer_matches_jax():
    """attn_impl "chunked": the relaxed rule whatever the site names, the
    site's onepass picked; the strict site's counts, and the sublayer's
    "auto" picking "full" at this length."""
    jcfg, cfg, jparams, tparams = _models("gpt2")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 40))
    for onepass in (False, True):
        site = dict(rule="strict", mu=4, tau=0.1, granularity=1,
                    onepass=onepass)
        jl, ja = jax_forward(jcfg.replace(lamp=JaxPolicy(kq=JaxSite(**site))),
                             jparams, jnp.asarray(toks, jnp.int32),
                             use_lamp=True, attn_impl="chunked")
        tl, ta = TT.forward(cfg.replace(lamp=LampPolicy(kq=LampSite(**site))),
                            tparams, torch.from_numpy(toks), use_lamp=True,
                            attn_impl="chunked")
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(jl).max())
        slack = 2 * 40 / (2 * cfg.n_heads * 40 * 41 / 2)
        assert abs(float(ta["attn_lamp_rate"])
                   - float(ja["attn_lamp_rate"])) <= slack
    with pytest.raises(ValueError, match="unknown attn_impl"):
        TT.forward(cfg, tparams, torch.from_numpy(toks), attn_impl="flash")


def test_synthetic_tokens_and_batches_match_jax():
    for kind, hosts in (("markov", 1), ("uniform", 1), ("markov", 2)):
        dc = dict(vocab=777, seq_len=33, global_batch=4, seed=9, kind=kind,
                  branching=3)
        jd = JS.SyntheticDataset(JS.DataConfig(**dc))
        td = TS.SyntheticDataset(TS.DataConfig(**dc))
        for step in (0, 5):
            for host in range(hosts):
                np.testing.assert_array_equal(
                    td.batch_at(step, host_id=host, n_hosts=hosts)["tokens"],
                    jd.batch_at(step, host_id=host, n_hosts=hosts)["tokens"])
    # the benchmark's batches, permuted too (JAX's at its own SEQ and BATCH)
    cfg = get_config("gpt2-small").replace(**TINY)
    sc = PF.Scale(TINY_SCALE.small, TINY_SCALE.large, JB.SEQ, JB.BATCH)
    for kw in (dict(), dict(permute=True), dict(kind="uniform")):
        got = PF.make_batches(cfg, sc, device="cpu", **kw)
        want = JB.make_batches(cfg, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["tokens"].numpy(),
                                          np.asarray(w["tokens"]))


@pytest.fixture(scope="module")
def bench():
    """The JAX benchmark's model at TINY (QK_GAIN included) and the port's
    copy of its weights; batches of 2 x 32 from both packages. The JAX
    benchmark's forward is the jitted one while the fixture lives."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JB, "transformer", types.SimpleNamespace(forward=jax_forward))
    jcfg, jparams = JB.build_model(TINY)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = get_config("gpt2-small").replace(**TINY)
    tb = PF.make_batches(cfg, TINY_SCALE, device="cpu")
    jds = JS.SyntheticDataset(JS.DataConfig(vocab=512, seq_len=32,
                                            global_batch=2, seed=0))
    jb = [{"tokens": jnp.asarray(jds.batch_at(i)["tokens"])} for i in range(2)]
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t["tokens"].numpy(),
                                      np.asarray(j["tokens"]))
    yield jcfg, jparams, jb, cfg, tparams, tb
    mp.undo()


@pytest.mark.parametrize("policy", [None, "uniform", "strict", "relaxed",
                                    "relaxed_ln", "random"])
def test_eval_policy_matches_jax(bench, policy):
    jcfg, jparams, jb, cfg, tparams, tb = bench
    if policy is None:
        jpol = tpol = None
    else:
        tau = PF._UNIFORM_TAU if policy == "uniform" else 0.1
        rule = "strict" if policy == "uniform" else policy
        jpol = JaxPolicy.paper_default(mu=4, tau=tau, rule=rule)
        tpol = LampPolicy.paper_default(mu=4, tau=tau, rule=rule)
    want = JB.eval_policy(jcfg, jparams, jb, jpol)
    got = PF.eval_policy(cfg, tparams, tb, tpol)
    assert got.keys() == want.keys()
    assert got["kl"] == pytest.approx(want["kl"], rel=1e-3, abs=2e-6)
    assert abs(got["flip_rate"] - want["flip_rate"]) <= 1 / (2 * 32)
    slack = 2 * 32 / (2 * TINY["n_heads"] * 32 * 33 / 2)
    assert abs(got["recompute_rate"] - want["recompute_rate"]) <= slack
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)
    if policy in (None, "uniform"):
        assert got["recompute_rate"] == 0.0
    else:
        assert 0 < got["recompute_rate"] < 1 and got["kl"] >= 0


def test_paper_figs_and_quickstart_on_the_cpu(capsys, monkeypatch):
    """The CLI's rows, a figure at TINY, the QK gain, and quickstart; and
    neither entry point falls back to the CPU without CUDA."""
    assert PF.main(["--device", "cpu", "--only", "rmsnorm_site"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "name,us_per_call,derived"
    rows = [r.split(",") for r in out if r.startswith("rmsnorm_site_tau")]
    assert len(rows) == 4 and all(float(r[1]) > 0 for r in rows)
    PF.fig7_random_control(TINY_SCALE, torch.device("cpu"))
    rows = [r for r in capsys.readouterr().out.splitlines()
            if r.startswith("fig7_")]
    assert len(rows) == 3
    fields = dict(kv.split("=") for kv in rows[1].split(",")[2].split(";"))
    assert float(fields["kl_lamp"]) < float(fields["kl_random"])
    cfg, params = PF.build_model(TINY_SCALE.small, seed=3, device="cpu")
    plain = TT.init_params(cfg, 3, device="cpu")
    torch.testing.assert_close(params["blocks"]["attn"]["wq"],
                               plain["blocks"]["attn"]["wq"] * PF.QK_GAIN)
    assert quickstart.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    kl = [float(l.split("=")[1]) for l in lines if "KL(" in l]
    assert len(kl) == 2 and kl[1] < kl[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (PF.main, quickstart.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(ValueError, match="llava"):
        TT.forward(get_config("llava-next-mistral-7b"), {},
                   torch.zeros((1, 4), dtype=torch.long))
