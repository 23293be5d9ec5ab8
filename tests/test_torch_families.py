"""Port vs JAX: the hymba, rwkv6 and whisper families, through the uniform
model API and the static serving loop.

hymba's `mamba_branch` and its forward, prefill and decode past a full
ring (the reference's slot W - 1 write); rwkv6's `time_mix` on the step
scan and at chunk 64 with T not a multiple of 64, and its forward, prefill
and decode with the state carried; whisper's `encode`, `decode_full`,
prefill and decode with the cross K/V; and for each family, prefill +
decode equal to the port's own teacher-forced forward
(tests/test_models_smoke.py:65), `loss_fn` and `generate` against JAX.
The same inputs (numpy seeds) go to both packages, the weights carried
across by `params_from_jax`; JAX runs jitted, on the CPU.

Tolerances:
  * logits, branch outputs, states and caches: rtol 2e-5 / atol 2e-6 of
    the largest magnitude (tests/test_paged_kernel.py:50-65; each backend
    sums its FP32 products in its own order). The whole rwkv6 model's
    logits and state at atol 4e-6 of the largest: its relu^2 channel mix
    doubles a relative error and its per-head group norm (over 64
    channels, eps 64e-5) divides by a small std, so the roundoff of one
    layer's output (held at 2e-6 in its time-mix) grows through the
    layers (1.5e-5 of 3.7 in the two-call forward);
  * prefill + decode against the port's own forward: rtol 2e-3 / atol
    2e-4 (tests/test_models_smoke.py:81), LAMP off;
  * KQ rates (hymba's attention branch): the relaxed rule's counts, exact;
  * the loss: rtol 2e-6; token streams, greedy and sampled: equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.models import hymba as JH  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.runtime import serve_loop as JSL  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.policy import LampPolicy  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models import hymba as TH  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.runtime import serve_loop as TSL  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)
RWKV_TOL = dict(rtol=2e-5, atol=4e-6)
ARCHS = {"hymba": "hymba-1.5b", "rwkv6": "rwkv6-7b",
         "whisper": "whisper-medium"}
B = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def _batch(cfg, seed, seq, batch=B):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.family == "whisper":
        out["frames"] = (rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, tol=TOL):
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(want).max(), 1.0))


def _close_tree(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        if k == "length":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            _close(got[k], want[k], tol)


def _states(rng, shapes):
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


def test_mamba_branch_matches_jax():
    """Layer 0's Mamba branch on a random input and nonzero conv / SSM
    states: the output and both new states."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["hymba"])
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"])
    tp = layer_params(tparams["blocks"], 0)
    rng = np.random.default_rng(0)
    d, N = cfg.d_model, cfg.ssm_state
    x = rng.standard_normal((B, 9, d)).astype(np.float32)
    st = _states(rng, {"conv": (B, TH.CONV_K - 1, d), "ssm": (B, d, N)})
    want = jax.jit(functools.partial(JH.mamba_branch, jcfg))(
        jp, jnp.asarray(x), jnp.asarray(st["conv"]), jnp.asarray(st["ssm"]))
    got = TH.mamba_branch(cfg, tp, torch.from_numpy(x),
                          torch.from_numpy(st["conv"]),
                          torch.from_numpy(st["ssm"]))
    for g, w in zip(got, want):
        _close(g, w)


def test_hymba_forward_prefill_and_decode_past_a_full_ring_match_jax():
    """The forward with LAMP on (the deployment tier: relaxed one-pass,
    g 0) and its rate; then a ring of W = min(window, 8) + 4 = 12 slots
    filled by prefill (M + S = 14 positions, the last 12 kept at slot 0
    on) and three decode steps, each writing slot W - 1 (the reference's
    shift-free ring): logits, the ring, the conv and SSM states."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["hymba"])
    jb, tb = _both(_batch(cfg, 1, 10))
    jl, jst, jaux = _jit(JH.forward, use_lamp=True)(jcfg, jparams, jb["tokens"])
    tl, tst, taux = TH.forward(cfg, tparams, tb["tokens"], use_lamp=True)
    _close(tl, jl)
    _close_tree(tst, jst)
    # the rate as a count of the layers' (B, H, T, T) causal window slots
    T, H = 10 + cfg.n_meta_tokens, cfg.n_heads
    n = B * H * T * (T + 1) // 2 * cfg.n_layers
    assert round(float(taux["attn_lamp_rate"]) * n) == \
        round(float(jaux["attn_lamp_rate"]) * n) > 0
    jc = JH.init_cache(jcfg, B, 8, jnp.float32)
    tc = TH.init_cache(cfg, B, 8, torch.float32, device="cpu")
    assert tc["k"].shape[2] == 12
    jl, jc = _jit(JH.prefill, use_lamp=True)(jcfg, jparams, jb["tokens"], jc)
    tl, tc = TH.prefill(cfg, tparams, tb["tokens"], tc, use_lamp=True)
    _close(tl, jl)
    _close_tree(tc, jc)
    nxt = np.random.default_rng(2).integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    for i in range(3):
        jl, jc = _jit(JH.decode_step, use_lamp=True)(
            jcfg, jparams, jc, jnp.asarray(nxt[:, i:i + 1]))
        tl, tc = TH.decode_step(cfg, tparams, tc, torch.from_numpy(nxt[:, i:i + 1]),
                                use_lamp=True)
        _close(tl, jl)
        _close_tree(tc, jc)
    assert int(tc["length"][0]) == 14 + 3


@pytest.mark.parametrize("T,chunk", [(9, 0), (100, 64)])
def test_rwkv_time_mix_matches_jax(T, chunk):
    """Layer 0's time-mix from a nonzero state: the step scan, and the
    chunked recurrence at chunk 64 over T = 100 (a padded second chunk):
    the output and the new state."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["rwkv6"])
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"])
    tp = layer_params(tparams["blocks"], 0)
    rng = np.random.default_rng(T)
    H, n, d = TR._n_heads(cfg), TR.HEAD_DIM, cfg.d_model
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    st = _states(rng, {"S": (B, H, n, n), "x_prev": (B, d)})
    want = jax.jit(functools.partial(JR.time_mix, jcfg, wkv_chunk=chunk))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    got = TR.time_mix(cfg, tp, torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in st.items()},
                      wkv_chunk=chunk)
    _close(got[0], want[0])
    _close_tree(got[1], want[1])


def test_rwkv_forward_prefill_and_decode_carry_the_state_like_jax():
    """The step-scan forward in two calls, the state carried from the
    first into the second; prefill on the chunked recurrence (T = 70: a
    padded chunk) and three decode steps: logits and the whole state."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["rwkv6"])
    jb, tb = _both(_batch(cfg, 3, 12))
    jst, tst = JR.init_state(jcfg, B), TR.init_state(cfg, B, device="cpu")
    for lo, hi in ((0, 6), (6, 12)):
        jl, jst, _ = _jit(JR.forward)(jcfg, jparams, jb["tokens"][:, lo:hi],
                                      state=jst)
        tl, tst, _ = TR.forward(cfg, tparams, tb["tokens"][:, lo:hi], state=tst)
        _close(tl, jl, RWKV_TOL)
        _close_tree(tst, jst, RWKV_TOL)
    jb, tb = _both(_batch(cfg, 4, 70))
    jl, jst = _jit(JR.prefill)(jcfg, jparams, jb["tokens"],
                               JR.init_state(jcfg, B))
    tl, tst = TR.prefill(cfg, tparams, tb["tokens"],
                         TR.init_state(cfg, B, device="cpu"))
    _close(tl, jl, RWKV_TOL)
    _close_tree(tst, jst, RWKV_TOL)
    nxt = np.random.default_rng(5).integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    for i in range(3):
        jl, jst = _jit(JR.decode_step)(jcfg, jparams, jst,
                                       jnp.asarray(nxt[:, i:i + 1]))
        tl, tst = TR.decode_step(cfg, tparams, tst,
                                 torch.from_numpy(nxt[:, i:i + 1]))
        _close(tl, jl, RWKV_TOL)
        _close_tree(tst, jst, RWKV_TOL)
    assert int(tst["length"][0]) == 73


def test_whisper_encode_and_decode_full_match_jax():
    """The bidirectional encoder and the teacher-forced decoder (causal
    self-attention, cross-attention to the encoder output), LAMP on (the
    deployment tier at all three sites)."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["whisper"])
    jb, tb = _both(_batch(cfg, 6, 10))
    jenc = _jit(JW.encode, use_lamp=True)(jcfg, jparams, jb["frames"])
    tenc = TW.encode(cfg, tparams, tb["frames"], use_lamp=True)
    _close(tenc, jenc)
    jl = _jit(JW.decode_full, use_lamp=True)(jcfg, jparams, jb["tokens"], jenc)
    tl = TW.decode_full(cfg, tparams, tb["tokens"], torch.from_numpy(
        np.array(jenc)), use_lamp=True)
    _close(tl, jl)


def test_whisper_prefill_and_decode_match_jax():
    """prefill (the cross K/V of every layer stored, the self-attention
    cache filled) and three decode steps, LAMP on: logits and the cache."""
    jcfg, cfg, jparams, tparams = _models(ARCHS["whisper"])
    jb, tb = _both(_batch(cfg, 7, 10))
    jc = JW.init_cache(jcfg, B, 24, jnp.float32)
    tc = TW.init_cache(cfg, B, 24, torch.float32, device="cpu")
    jl, jc = _jit(JW.prefill, use_lamp=True)(jcfg, jparams, jb["tokens"], jc,
                                             frames=jb["frames"])
    tl, tc = TW.prefill(cfg, tparams, tb["tokens"], tc, frames=tb["frames"],
                        use_lamp=True)
    _close(tl, jl)
    _close_tree(tc, jc)
    nxt = np.random.default_rng(8).integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    for i in range(3):
        jl, jc = _jit(JW.decode_step, use_lamp=True)(
            jcfg, jparams, jc, jnp.asarray(nxt[:, i:i + 1]))
        tl, tc = TW.decode_step(cfg, tparams, tc,
                                torch.from_numpy(nxt[:, i:i + 1]), use_lamp=True)
        _close(tl, jl)
        _close_tree(tc, jc)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_prefill_then_decode_equals_the_forward(family):
    """prefill(S - 1) + decode(1) == the teacher-forced forward at position
    S - 1, LAMP off, through the port's API alone (hymba: M + S inside the
    window, so the ring holds every position the forward's window does)."""
    _, cfg, _, tparams = _models(ARCHS[family])
    cfg = cfg.replace(lamp=LampPolicy.disabled())
    S = 24
    tb = _both(_batch(cfg, 9, S))[1]
    full = TAPI.forward_logits(cfg, tparams, tb)
    pb = dict(tb, tokens=tb["tokens"][:, :S - 1])
    cache = TAPI.init_cache(cfg, B, 64, torch.float32, device="cpu")
    _, cache = TAPI.prefill(cfg, tparams, pb, cache, use_lamp=False)
    length = int(cache["length"][0])
    ld, cache = TAPI.decode_step(cfg, tparams, cache, tb["tokens"][:, S - 1:],
                                 use_lamp=False)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-4)
    assert int(cache["length"][0]) == length + 1


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_loss_matches_jax(family):
    """`api.loss_fn` with LAMP on (rwkv6's policy is disabled: the pops
    drop use_lamp)."""
    jcfg, cfg, jparams, tparams = _models(ARCHS[family])
    jb, tb = _both(_batch(cfg, 10, 12))
    jloss, jmet = _jit(JAPI.loss_fn, use_lamp=True)(jcfg, jparams, jb)
    tloss, tmet = TAPI.loss_fn(cfg, tparams, tb, use_lamp=True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-6)
    assert set(tmet) == set(jmet)


@pytest.mark.parametrize("family,temperature,top_k", [
    ("hymba", 0.0, 0), ("rwkv6", 0.8, 0), ("whisper", 0.7, 30)])
def test_generate_matches_jax(family, temperature, top_k):
    """`generate` with LAMP on: JAX's tokens, greedy and sampled."""
    jcfg, cfg, jparams, tparams = _models(ARCHS[family])
    jb, tb = _both(_batch(cfg, 11, 10))
    kw = dict(max_new_tokens=8, temperature=temperature, seed=3,
              cache_len=32, top_k=top_k, use_lamp=True)
    want = JSL.generate(jcfg, jparams, jb, JSL.ServeConfig(**kw))
    got = TSL.generate(cfg, tparams, tb, TSL.ServeConfig(**kw))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
