"""Port vs JAX: one fused serving step (`paged_mixed_step`) of the reduced
GPT-2 on the same weights (converted with `params_from_jax`), the same
arena and the same mixed plan: a fresh prompt window, a chunk continuing at
a ragged start, two decode rows and a padded row.

Tolerances: logits atol 1e-5 / rtol 1e-5 and the arena after the step
atol 1e-5 -- the two backends run every FP32 matmul (QKV, output, MLP,
unembedding) in their own summation order, so activations differ in the
last bits and those differences grow through the layers. The (L, B)
selected counts get a slack of 1 per (layer, row) for the same reason:
q and k enter the PS(mu) rounding with different last bits, so a y_low near
a rounding boundary may round the other way and flip a selection. Valid
counts are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax


def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _models("gpt2")


def test_configs_are_copies(model):
    jcfg, cfg, _, _ = model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def _plan(cfg, seed=0, bs=4, n_max=8, W=8):
    rng = np.random.default_rng(seed)
    starts = np.asarray([0, 9, 14, 21, 0], np.int32)
    lengths = np.asarray([8, 5, 1, 1, 1], np.int32)       # last row: padding
    B = len(starts)
    n_blocks = 1 + (B - 1) * n_max
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, n_max), np.int32)
    for r in range(B - 1):
        nb = -(-(starts[r] + lengths[r]) // bs)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb]
    tokens = rng.integers(0, cfg.vocab, size=(B, W)).astype(np.int32)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.hd)
    ak = rng.standard_normal(shape).astype(np.float32)   # the cached prefix
    av = rng.standard_normal(shape).astype(np.float32)
    return tokens, ak, av, bt, starts, lengths


# gpt2: LayerNorm, learned positions, gelu-tanh, tied unembedding, the
# strict rule at granularity 1. glm4-9b: RMSNorm, half-width RoPE, GQA,
# swiglu, the relaxed rule at granularity 0. gemma-7b: geglu, scaled and
# tied embeddings.
@pytest.mark.parametrize("arch,all_logits", [
    ("gpt2", False), ("gpt2", True), ("glm4-9b", False), ("gemma-7b", True)])
def test_paged_mixed_step_matches_jax(arch, all_logits):
    jcfg, cfg, jparams, tparams = _models(arch)
    tokens, ak, av, bt, starts, lengths = _plan(cfg)
    wl, warena, (wsel, wval) = JT.paged_mixed_step(
        jcfg, jparams, jnp.asarray(tokens),
        {"k": jnp.asarray(ak), "v": jnp.asarray(av)}, jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(lengths), kernel="gather",
        per_layer=True, all_logits=all_logits)
    arena = {"k": torch.from_numpy(ak.copy()), "v": torch.from_numpy(av.copy())}
    gl, garena, (gsel, gval) = TT.paged_mixed_step(
        cfg, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths), per_layer=True,
        all_logits=all_logits)
    live = slice(0, 4)                       # the padded row is discarded
    wl, gl = np.asarray(wl)[live], gl.numpy()[live]
    if all_logits:
        keep = np.arange(8)[None, :] < lengths[live][:, None]
        wl, gl = wl[keep], gl[keep]
    np.testing.assert_allclose(gl, wl, atol=1e-5, rtol=1e-5)
    # the arena, except the null block that padding writes into
    for name in ("k", "v"):
        np.testing.assert_allclose(garena[name].numpy()[:, 1:],
                                   np.asarray(warena[name])[:, 1:], atol=1e-5)
    assert gsel.shape == (cfg.n_layers, 5)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_allclose(gsel.numpy()[:, live],
                               np.asarray(wsel)[:, live], atol=1)


def test_paged_prefill_window_sums_layers(model):
    _, cfg, _, tparams = model
    tokens, ak, av, bt, starts, lengths = _plan(cfg, seed=1)
    t = torch.from_numpy
    logits, _, (nsel, nval) = TT.paged_prefill_window(
        cfg, tparams, t(tokens), {"k": t(ak.copy()), "v": t(av.copy())},
        t(bt), t(starts), t(lengths))
    assert logits.shape == (5, 1, cfg.vocab)
    assert nsel.shape == nval.shape == (5,)
    assert torch.isfinite(logits).all()
    # valid KQ products: every head sees positions 0 .. its own
    pos = starts[:, None] + np.arange(8)[None, :]
    live = np.arange(8)[None, :] < lengths[:, None]
    want = ((pos + 1) * live).sum(1) * cfg.n_heads * cfg.n_layers
    np.testing.assert_array_equal(nval.numpy(), want)


def test_init_params_is_seeded_and_shaped(model):
    _, cfg, _, tparams = model
    a = TT.init_params(cfg, 3, device="cpu")
    b = TT.init_params(cfg, 3, device="cpu")
    flat = lambda p: {k: v for k, v in _leaves(p)}
    fa, fb, ft = flat(a), flat(b), flat(tparams)
    assert fa.keys() == ft.keys()
    for key in fa:
        assert fa[key].shape == ft[key].shape, key
        assert torch.equal(fa[key], fb[key]), key


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v
