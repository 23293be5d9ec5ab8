"""Port vs JAX: materialized LAMP attention (the gather path and the plain
version of the paged kernel).

Inputs are made with numpy from a seed and fed to both packages, with
per-row offsets (partial prefill windows), `reduce=False` counts and a
tau override. Tolerances: outputs rtol 2e-5 / atol 2e-6 (FP32 softmax and
P.V roundoff: the two backends sum in different orders); selection counts
per (row, query) are exact for the max-based rules at granularity 1, where
y_low is bit-exact across the packages. The strict rule thresholds on the
softmax normalizer, a sum of exps in each backend's order, so a criterion
within an ulp of tau may flip: one count per row of slack (as
tests/test_paged_kernel.py allows the kernel). At granularity 0 the FP32
dot before the rounding is summed in each backend's order, so a y_low may
land one PS(mu) step apart: one count per row of slack there too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import attention as JA
from repro.core.policy import LampSite as JaxSite
from repro_torch.core import attention as TA
from repro_torch.core.policy import LampSite

SITES = {
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "none": dict(rule="none", mu=5, granularity=0),
}
TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(seed, B=3, H=4, Tq=6, Tk=24, D=16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Tq, D)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, H, Tk, D)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    offset = np.asarray([0, 7, 18], np.int32)[:B]
    return q, k, v, offset


def _exact_counts(name: str) -> bool:
    return name in ("relaxed-g1", "ln-g1", "none")


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("name", sorted(SITES))
def test_attention_lamp_matches_jax(name, window):
    q, k, v, offset = _inputs(1)
    tau = 0.08
    want, waux = JA.attention_lamp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JaxSite(**SITES[name]),
        causal=True, window=window, offset=jnp.asarray(offset), reduce=False,
        tau=jnp.float32(tau))
    got, aux = TA.attention_lamp(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        LampSite(**SITES[name]), causal=True, window=window,
        offset=torch.from_numpy(offset), reduce=False,
        tau=torch.tensor(tau, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(aux.n_valid.numpy(), np.asarray(waux.n_valid))
    if _exact_counts(name):
        np.testing.assert_array_equal(aux.n_selected.numpy(),
                                      np.asarray(waux.n_selected))
    else:
        np.testing.assert_allclose(aux.n_selected.numpy(),
                                   np.asarray(waux.n_selected), atol=1)
    assert aux.n_selected.shape == (3, 6)


def test_attention_lamp_reduced_counts_and_static_tau():
    q, k, v, _ = _inputs(2)
    site = dict(rule="relaxed", mu=7, tau=0.0, granularity=1)
    want, waux = JA.attention_lamp(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), JaxSite(**site), offset=18)
    got, aux = TA.attention_lamp(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), LampSite(**site),
                                 offset=18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux.n_selected) == float(waux.n_selected)
    assert float(aux.n_valid) == float(waux.n_valid)
    assert abs(float(aux.recompute_rate) - float(waux.recompute_rate)) < 1e-7


def test_attention_reference_matches_jax():
    q, k, v, offset = _inputs(3)
    want = JA.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), offset=jnp.asarray(offset),
                                  window=11)
    got = TA.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 offset=torch.from_numpy(offset), window=11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
