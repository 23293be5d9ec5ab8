"""Port vs JAX: `decode_attention_lamp` and the single-token model steps.

  * `decode_attention_lamp` against the JAX function, every LAMP site of
    tests/test_torch_decode.py, with and without a sliding window, at
    ragged lengths, per row and reduced.
  * `paged_decode_step` and `paged_verify_window` against JAX on the
    reduced gpt2 and glm4-9b (GQA) through `params_from_jax`, and the
    verify window against sequential decode steps inside the port.

Tolerances: those of tests/test_torch_decode.py for attention (outputs
rtol 2e-5 / atol 2e-6, counts exact but for the named slack, a
(row, head) whose y_low rounds apart across the packages at atol 1e-3).
The model steps get the tolerances of tests/test_torch_model.py and for
the same reason: logits and arena atol 1e-5 / rtol 1e-5, selected counts
one per (layer, row), valid counts exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import attention as JA
from repro.core.policy import LampSite as JaxSite
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention as TA
from repro_torch.core.policy import LampSite
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from test_torch_decode import (H, HD, SITES, assert_outputs, check_counts,
                               ylow_apart)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("name", sorted(SITES))
def test_decode_attention_lamp_matches_jax(name, window):
    rng = np.random.default_rng(1)
    R, S = 4, 20
    q = (rng.standard_normal((R, H, 1, HD)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((R, H, S, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((R, H, S, HD)).astype(np.float32)
    lengths = np.asarray([1, 4, 13, 20], np.int32)
    want, aux = JA.decode_attention_lamp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        JaxSite(**SITES[name]), window=window, reduce=False)
    got, taux = TA.decode_attention_lamp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), LampSite(**SITES[name]), window=window,
        reduce=False)
    assert_outputs(got.numpy(), np.asarray(want), ylow_apart(q, k, SITES[name]))
    check_counts(taux.n_selected.numpy(), aux.n_selected, name)
    np.testing.assert_array_equal(taux.n_valid.numpy(), np.asarray(aux.n_valid))
    # reduce=True: the scalar totals of the same counts
    _, red = TA.decode_attention_lamp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), LampSite(**SITES[name]), window=window)
    assert float(red.n_valid) == float(taux.n_valid.sum())
    assert float(red.n_selected) == float(taux.n_selected.sum())


def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module", params=["gpt2", "glm4-9b"])
def models(request):
    return _models(request.param)


def _arena_plan(cfg, seed=0, bs=4, n_max=8):
    """Rows cached to lengths 0 (fresh), 7, 12 (a block edge) and 20, and a
    padded row (length 0, null table)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([0, 7, 12, 20, 0], np.int32)
    R = len(lengths)
    n_blocks = 1 + (R - 1) * n_max
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((R, n_max), np.int32)
    for r in range(R - 1):
        nb = -(-(int(lengths[r]) + 4) // bs)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb]
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.hd)
    ak = rng.standard_normal(shape).astype(np.float32)
    av = rng.standard_normal(shape).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(R, 4)).astype(np.int32)
    return tokens, ak, av, bt, lengths


def test_paged_decode_step_matches_jax(models):
    jcfg, cfg, jparams, tparams = models
    tokens, ak, av, bt, lengths = _arena_plan(cfg)
    tok = tokens[:, :1]
    wl, warena, (wsel, wval) = JT.paged_decode_step(
        jcfg, jparams, {"k": jnp.asarray(ak), "v": jnp.asarray(av)},
        jnp.asarray(bt), jnp.asarray(lengths), jnp.asarray(tok),
        kernel="gather", per_layer=True)
    arena = {"k": torch.from_numpy(ak.copy()), "v": torch.from_numpy(av.copy())}
    gl, garena, (gsel, gval) = TT.paged_decode_step(
        cfg, tparams, arena, torch.from_numpy(bt), torch.from_numpy(lengths),
        torch.from_numpy(tok), per_layer=True)
    live = slice(0, 4)                       # the padded row is discarded
    np.testing.assert_allclose(gl.numpy()[live], np.asarray(wl)[live],
                               atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(garena[name].numpy()[:, 1:],
                                   np.asarray(warena[name])[:, 1:], atol=1e-5)
    assert gsel.shape == (cfg.n_layers, 5)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_allclose(gsel.numpy()[:, live],
                               np.asarray(wsel)[:, live], atol=1)


def test_paged_verify_window_matches_jax(models):
    jcfg, cfg, jparams, tparams = models
    tokens, ak, av, bt, starts = _arena_plan(cfg, seed=1)
    qlens = np.asarray([4, 3, 1, 4, 1], np.int32)
    wl, warena, (wsel, wval) = JT.paged_verify_window(
        jcfg, jparams, jnp.asarray(tokens),
        {"k": jnp.asarray(ak), "v": jnp.asarray(av)}, jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(qlens), kernel="gather",
        per_layer=True)
    arena = {"k": torch.from_numpy(ak.copy()), "v": torch.from_numpy(av.copy())}
    gl, garena, (gsel, gval) = TT.paged_verify_window(
        cfg, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(qlens), per_layer=True)
    assert gl.shape == (5, 4, cfg.vocab)
    keep = np.arange(4)[None, :] < qlens[:4, None]
    np.testing.assert_allclose(gl.numpy()[:4][keep], np.asarray(wl)[:4][keep],
                               atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(garena[name].numpy()[:, 1:],
                                   np.asarray(warena[name])[:, 1:], atol=1e-5)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_allclose(gsel.numpy()[:, :4], np.asarray(wsel)[:, :4],
                               atol=1)


def test_verify_window_matches_sequential_decode():
    """One verify window over tokens t1..t3 reproduces the logits of three
    sequential decode steps fed the same tokens (the port of the JAX
    test_verify_window_matches_sequential_decode)."""
    cfg = reduced(get_config("gpt2")).replace(vocab=128)
    params = TT.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=9)
    bs = 4
    bt = torch.tensor([[1, 2, 3, 4, 0, 0, 0, 0]], dtype=torch.int32)
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    tokens[0, :9] = torch.from_numpy(prompt)
    steps = [int(x) for x in rng.integers(0, cfg.vocab, size=3)]
    results = {}
    with torch.no_grad():
        for name in ("seq", "win"):
            arena = TT.init_paged_cache(cfg, 16, bs, device="cpu")
            TT.paged_prefill_window(cfg, params, tokens, arena, bt,
                                    torch.tensor([0], dtype=torch.int32),
                                    torch.tensor([9], dtype=torch.int32))
            if name == "seq":
                out = []
                for j, t in enumerate(steps):
                    lg, _, _ = TT.paged_decode_step(
                        cfg, params, arena, bt,
                        torch.tensor([9 + j], dtype=torch.int32),
                        torch.tensor([[t]], dtype=torch.int32))
                    out.append(lg[0, 0])
                results[name] = torch.stack(out)
            else:
                win = torch.zeros((1, 4), dtype=torch.int32)
                win[0, :3] = torch.tensor(steps)
                lg, _, _ = TT.paged_verify_window(
                    cfg, params, win, arena, bt,
                    torch.tensor([9], dtype=torch.int32),
                    torch.tensor([3], dtype=torch.int32))
                results[name] = lg[0, :3]
    torch.testing.assert_close(results["win"], results["seq"], atol=2e-4,
                               rtol=2e-4)
    assert torch.equal(results["win"].argmax(-1), results["seq"].argmax(-1))
