"""Port vs JAX: the static KV-cache serving loop through the uniform model
API, on the transformer's families.

`transformer.init_cache` / `prefill` / `decode_step` / `loss_fn` (gpt2,
dense: glm4-9b reduced, with GQA and half RoPE; moe; llava with its image
rows), `layers.attention_decode_sublayer` (a window, GQA, a write past the
cache; and cross-attention), `sampling.sample`, `runtime.serve_loop`'s
`generate` and `lamp_logits_softmax`, `models.api`'s dispatch, and the
`launch/serve_lamp.py` CLI, with the same inputs (numpy seeds) and the
weights carried across by `params_from_jax`. JAX runs jitted, as its own
tests run it, on the CPU.

Tolerances:
  * logits: rtol 2e-5 / atol 2e-6 of the largest logit; attention outputs
    and caches: rtol 2e-5 / atol 2e-6 (tests/test_paged_kernel.py:50-65);
    each backend sums its FP32 products in its own order;
  * with LAMP on, a whole model's cache past layer 0: at granularity 0 an
    FP32 dot sitting on a PS(mu) rounding midpoint can round one step apart
    in the two backends (tests/test_torch_decode.py), which moves that
    query's attention output in layer 0, and so the next layer's K/V at
    that position, by far more than roundoff (llava's first text position
    in row 1 has one: 2e-5 of 4). At most one (row, position) a layer past
    layer 0 may fall outside the tolerance, held to atol 1e-3 instead;
  * KQ counts (the decode sublayer's recompute rate, as a count): the
    relaxed rule exact; the strict rule within 1 a query row (its softmax
    normalizer is summed in each backend's order);
  * token streams, the sampled ones included, and the logits site's mask:
    equal; its softmax: rtol 2e-5 / atol 2e-6 of the largest probability;
  * the loss: rtol 2e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import LampSite as JaxSite  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import serve_loop as JSL  # noqa: E402
from repro.serving import sampling as JSM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.policy import LampSite  # noqa: E402
from repro_torch.launch import serve, serve_lamp  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime import serve_loop as TSL  # noqa: E402
from repro_torch.serving import EngineConfig, LampEngine  # noqa: E402
from repro_torch.serving import sampling as TSM  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)
B, S, N_DECODE, CACHE_LEN = 2, 12, 3, 32
OTHER_FAMILIES = {"llava": "llava-next-mistral-7b", "hymba": "hymba-1.5b",
                  "rwkv6": "rwkv6-7b", "whisper": "whisper-medium"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are tiny: more torch threads only contend with XLA's
    (and the other test workers') threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    """A JAX function of (cfg, ...) jitted with cfg and `static` bound."""
    return jax.jit(functools.partial(fn, **static), static_argnums=0)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = _jit(JAPI.init_params)(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _batch(cfg, seed, batch=B, seq=S):
    """A prompt dict as numpy arrays: tokens, and the stub inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "llava":
        out["image_embeds"] = (rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "whisper":
        out["frames"] = (rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close_cache(got, want, use_lamp):
    """A (L, B, T, Hkv, hd) cache at TOL, but for the (row, position)s of
    the module docstring's rounding midpoint: with LAMP on, at most one a
    layer past layer 0, within 1e-3."""
    got, want = got.numpy(), np.asarray(want)
    bad = ~np.isclose(got, want, rtol=TOL["rtol"],
                      atol=TOL["atol"] * max(np.abs(want).max(), 1.0))
    bad = bad.any(axis=(3, 4))
    assert not bad[0].any() and (use_lamp or not bad.any())
    assert all(b.sum() <= 1 for b in bad), bad.sum(axis=(1, 2))
    np.testing.assert_allclose(got[bad], want[bad], rtol=0, atol=1e-3)


def _close(got, want, **tol):
    want = np.asarray(want).astype(np.float32)
    tol = tol or TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("arch,attn_impl", [
    ("gpt2", "auto"), ("glm4-9b", "chunked"), ("qwen3-moe-30b-a3b", "auto"),
    ("llava-next-mistral-7b", "auto")])
def test_cache_stack_matches_jax(arch, attn_impl):
    """prefill then N_DECODE decode steps on an FP32 cache (the serve
    loop's), LAMP off and on under the config's own policy (gpt2: strict,
    g 1; the others: the deployment tier, relaxed one-pass g 0, the MoE's
    router strict): last logits, the whole cache (llava's image rows
    included) and its length after each call. glm4 prefills on the
    chunked arm; the MoE's decode is dropless."""
    jcfg, cfg, jparams, tparams = _models(arch)
    jb, tb = _both(_batch(cfg, 1))
    nxt = np.random.default_rng(2).integers(0, cfg.vocab, (B, N_DECODE))
    for use_lamp in (False, True):
        jc = JT.init_cache(jcfg, B, CACHE_LEN, jnp.float32)
        tc = TT.init_cache(cfg, B, CACHE_LEN, torch.float32, device="cpu")
        jl, jc = _jit(JT.prefill, use_lamp=use_lamp, attn_impl=attn_impl)(
            jcfg, jparams, jb["tokens"], jc, image_embeds=jb.get("image_embeds"))
        tl, tc = TT.prefill(cfg, tparams, tb["tokens"], tc,
                            image_embeds=tb.get("image_embeds"),
                            use_lamp=use_lamp, attn_impl=attn_impl)
        assert tl.shape == (B, 1, cfg.vocab)
        calls = [(jl, tl, jc, tc)]
        for i in range(N_DECODE):
            tok = nxt[:, i:i + 1].astype(np.int32)
            jl, jc = _jit(JT.decode_step, use_lamp=use_lamp)(
                jcfg, jparams, jc, jnp.asarray(tok))
            tl, tc = TT.decode_step(cfg, tparams, tc, torch.from_numpy(tok),
                                    use_lamp=use_lamp)
            calls.append((jl, tl, jc, tc))
        for jl, tl, jc, tc in calls:
            _close(tl, jl)
            np.testing.assert_array_equal(tc["length"].numpy(), jc["length"])
        for key in ("k", "v"):
            _close_cache(tc[key], jc[key], use_lamp)


@pytest.mark.parametrize("case", ["window_gqa", "cross"])
def test_attention_decode_sublayer_matches_jax(case):
    """One layer's decode (glm4's layer 0: GQA, half RoPE) against a random
    cache: the new K/V written at each row's length (a row at the cache's
    end: JAX drops that write, and so does the port) with a sliding window
    under the strict rule at mu 4, g 1; or cross-attention, whisper's use
    (q at position `length`, every encoder key, nothing written), under
    the relaxed rule at g 0. Outputs, the cache, and the rate as a
    count."""
    jcfg, cfg, jparams, tparams = _models("glm4-9b")
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["attn"])
    tp = TT.layer_params(tparams["blocks"], 0)["attn"]
    rng = np.random.default_rng(3)
    Bd, Sc, Hkv, hd = 4, 20, cfg.n_kv_heads, cfg.hd
    x = (rng.standard_normal((Bd, 1, cfg.d_model)) * 2).astype(np.float32)
    ck, cv = (rng.standard_normal((Bd, Sc, Hkv, hd)).astype(np.float32) * 2
              for _ in range(2))
    length = np.array([0, 7, 19, 20], np.int32)
    if case == "window_gqa":
        site, window = dict(rule="strict", mu=4, tau=0.1, granularity=1), 6
        jcfg, cfg = jcfg.replace(window=window), cfg.replace(window=window)
        jcross = tcross = None
    else:
        site = dict(rule="relaxed", mu=7, tau=0.05, granularity=0)
        assert cfg.window is None
        jcross = (jnp.asarray(ck), jnp.asarray(cv))
        tcross = (torch.from_numpy(ck), torch.from_numpy(cv))
    jout, jk, jv, jrate = jax.jit(functools.partial(
        JL.attention_decode_sublayer, jcfg, lamp_site=JaxSite(**site)))(
            jp, jnp.asarray(x), cache_k=jnp.asarray(ck),
            cache_v=jnp.asarray(cv), length=jnp.asarray(length),
            kv_cross=jcross)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tout, tk, tv, trate = TL.attention_decode_sublayer(
        cfg, tp, torch.from_numpy(x), cache_k=tck, cache_v=tcv,
        length=torch.from_numpy(length), lamp_site=LampSite(**site),
        kv_cross=tcross)
    assert tk is tck and tv is tcv            # written in place
    _close(tout, jout)
    _close(tk, jk)
    _close(tv, jv)
    # the rate as a count: selected over the valid (row, head, key) slots
    pos = np.arange(Sc)[None, :]
    if case == "window_gqa":
        eff = (length + 1)[:, None]
        valid = ((pos < eff) & (pos > eff - 1 - window)).sum() * cfg.n_heads
        assert abs(float(trate) - float(jrate)) * valid <= Bd * cfg.n_heads
        np.testing.assert_array_equal(tk[3].numpy(), ck[3])   # dropped write
    else:
        valid = Bd * cfg.n_heads * Sc
        assert round(float(trate) * valid) == round(float(jrate) * valid)
        np.testing.assert_array_equal(tk.numpy(), ck)        # nothing written
    assert float(trate) > 0


@pytest.mark.parametrize("temperature,top_k,shape", [
    (0.0, 0, (5, 300)), (0.7, 40, (3, 2, 300))])
def test_sample_matches_jax(temperature, top_k, shape):
    """One key for the whole batch: greedy (ties to the first index, as
    argmax), and Gumbel-max at a temperature with top-k (over a 3-D batch):
    the tokens of JAX's `sampling.sample` under the same key, for 20 keys."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(shape) * 2).astype(np.float32)
    logits[0, ..., 7] = logits[0, ..., 3] = logits.max() + 1      # a tie
    for seed in range(20):
        want = JSM.sample(jnp.asarray(logits), jax.random.PRNGKey(seed),
                          temperature, top_k=top_k)
        got = TSM.sample(torch.from_numpy(logits), prng.PRNGKey(seed),
                         temperature, top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,temperature,top_k", [
    ("gpt2", 0.0, 0), ("qwen3-moe-30b-a3b", 0.8, 20)])
def test_generate_matches_jax(arch, temperature, top_k):
    """`generate` with LAMP on: the JAX loop's tokens, greedy and sampled
    (one key split a token), token for token."""
    jcfg, cfg, jparams, tparams = _models(arch)
    jb, tb = _both(_batch(cfg, 5))
    kw = dict(max_new_tokens=8, temperature=temperature, seed=11,
              cache_len=CACHE_LEN, top_k=top_k, use_lamp=True)
    want = JSL.generate(jcfg, jparams, jb, JSL.ServeConfig(**kw))
    got = TSL.generate(cfg, tparams, tb, TSL.ServeConfig(**kw))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert got["prefill_s"] > 0 and got["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", ["gpt2", "qwen3-moe-30b-a3b",
                                  "llava-next-mistral-7b"])
def test_loss_and_forward_logits_match_jax(arch):
    """`api.loss_fn` (the MoE's with 0.01 x its load-balancing loss; llava's
    over the text positions only) and `api.forward_logits` (llava's over
    image rows and text) with LAMP on."""
    jcfg, cfg, jparams, tparams = _models(arch)
    jb, tb = _both(_batch(cfg, 6))
    jloss, jmet = _jit(JAPI.loss_fn, use_lamp=True)(jcfg, jparams, jb)
    tloss, tmet = TAPI.loss_fn(cfg, tparams, tb, use_lamp=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-6)
    assert set(tmet) == set(jmet)
    jl = _jit(JAPI.forward_logits, use_lamp=True)(jcfg, jparams, jb)
    tl = TAPI.forward_logits(cfg, tparams, tb, use_lamp=True)
    assert tl.shape == (B, S + cfg.n_patches, cfg.vocab)
    _close(tl, jl)


def test_lamp_logits_softmax_matches_jax():
    """The logits site at mu 4 and 6: the strict rule's mask (as its rate,
    a count) and the softmax, against JAX's on the same logits."""
    logits = (np.random.default_rng(8).standard_normal((4, 512)) * 4
              ).astype(np.float32)
    for mu in (4, 6):
        jp, jrate = JSL.lamp_logits_softmax(jnp.asarray(logits), mu, 0.05)
        tp, trate = TSL.lamp_logits_softmax(torch.from_numpy(logits), mu, 0.05)
        assert round(float(trate) * logits.size) == \
            round(float(jrate) * logits.size) > 0
        _close(tp, jp)


def test_api_rejects_an_unknown_family():
    cfg = reduced(get_config("gpt2")).replace(family="mamba")
    with pytest.raises(ValueError, match="unknown family 'mamba'"):
        TAPI.init_params(cfg, 0, device="cpu")
    for call in (lambda: TAPI.loss_fn(cfg, {}, {}),
                 lambda: TAPI.forward_logits(cfg, {}, {}),
                 lambda: TAPI.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: TAPI.prefill(cfg, {}, {}, {}),
                 lambda: TAPI.decode_step(cfg, {}, {}, None)):
        with pytest.raises(ValueError, match="unknown family"):
            call()


def test_engine_and_serve_cli_still_refuse_the_other_families():
    """The static stack runs llava, hymba, rwkv6 and whisper; the paged
    engine and its CLI serve exactly the JAX engine's families."""
    assert TT.FAMILIES == ("dense", "moe", "gpt2")
    assert {get_config(a).family for a in serve.servable_archs()} == \
        set(TT.FAMILIES)
    for fam, arch in OTHER_FAMILIES.items():
        cfg = reduced(get_config(arch))
        assert cfg.family == fam
        with pytest.raises(ValueError, match="paged-KV text families"):
            LampEngine(cfg, None, EngineConfig(device="cpu"))
        assert arch not in serve.servable_archs()
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_static_entry_points_raise_without_cuda(monkeypatch):
    """The weights, the caches and the CLI run on CUDA unless the caller
    asks for the CPU: without a card they raise, for every family."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("gpt2",) + tuple(OTHER_FAMILIES.values()):
        cfg = reduced(get_config(arch))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TAPI.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TAPI.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lamp.main(["gpt2"])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "rwkv6-7b"])
def test_serve_lamp_cli_on_cpu(arch, capsys):
    assert serve_lamp.main([arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for tag in ("[FP32]", "[LAMP]"):
        line = next(ln for ln in out.splitlines() if ln.startswith(tag))
        assert "tok/s" in line and "first-seq tokens" in line
