"""The port's paged LAMP attention: the plain version against the JAX
package (the CUDA kernel against the plain version is in
tests/test_torch_kernel_card.py, which runs on a card).

On the CPU the wrapper runs its plain version; it is held against both the
JAX Pallas kernel (`repro.kernels.ops.paged_mixed_attention`, interpret mode
as tests/conftest.py sets it) and the JAX gather path, over mixed `qlens`
(a decode row, a short window, a full window) at ragged starts across
block boundaries. Only live query positions are compared: padding queries
are computed by some versions and zeroed by others.

Tolerances are those of tests/test_paged_kernel.py: outputs rtol 2e-5 /
atol 2e-6; counts exact for the max-based rules at granularity 1 (y_low and
the row max are bit-exact across the packages) and for rule none / off;
one count per row of slack for strict (the normalizer is a sum in each
backend's order) and at granularity 0 (the FP32 dot before rounding is a
sum in each backend's order, so a y_low may land one PS(mu) step apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import attention as JA
from repro.core.policy import LampSite as JaxSite
from repro.kernels import ops as JOPS
from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

H, HKV, HD = 4, 2, 16
BS, N_MAX, W = 4, 8, 8

SITES = {
    "off": dict(enabled=False),
    "none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}
TOL = dict(rtol=2e-5, atol=2e-6)


def make_case(seed, starts=(0, 5, 13, 22), qlens=(8, 1, 3, 6), H=H, HKV=HKV,
              HD=HD, BS=BS, N_MAX=N_MAX, W=W):
    """Random arena and shuffled block tables; row r owns the blocks that
    cover starts[r] + qlens[r] positions, the rest of its table is null."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, HKV, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        nb = -(-(starts[r] + qlens[r]) // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(np.float32)
    return (q, k, v, bt, np.asarray(starts, np.int32),
            np.asarray(qlens, np.int32))


def live_mask(qlens, W=W):
    return np.arange(W)[None, :] < np.asarray(qlens)[:, None]


def check_counts(got, want, name, live):
    got, want = np.asarray(got)[live], np.asarray(want)[live]
    if name in ("strict-g1", "relaxed-g0"):
        np.testing.assert_allclose(got, want, atol=1)
    else:
        np.testing.assert_array_equal(got, want)


def jax_gather(q, k, v, bt, starts, site):
    B = q.shape[0]
    ks = jnp.asarray(k)[bt].reshape(B, -1, HKV, HD)
    vs = jnp.asarray(v)[bt].reshape(B, -1, HKV, HD)
    kh = jnp.repeat(jnp.moveaxis(ks, 2, 1), H // HKV, axis=1)
    vh = jnp.repeat(jnp.moveaxis(vs, 2, 1), H // HKV, axis=1)
    if site.enabled:
        o, aux = JA.attention_lamp(jnp.asarray(q), kh, vh, site,
                                   offset=jnp.asarray(starts), reduce=False)
        return np.asarray(o), np.asarray(aux.n_selected)
    o = JA.attention_reference(jnp.asarray(q), kh, vh,
                               offset=jnp.asarray(starts))
    return np.asarray(o), np.zeros(q.shape[0:1] + q.shape[2:3], np.float32)


@pytest.mark.parametrize("name", sorted(SITES))
def test_plain_matches_jax_pallas_and_gather(name):
    q, k, v, bt, starts, qlens = make_case(0)
    site_j, site_t = JaxSite(**SITES[name]), LampSite(**SITES[name])
    live = live_mask(qlens)
    lo = live[:, None, :, None].repeat(H, 1).repeat(HD, 3)

    before = PA.paged_mixed_attention.launches
    got, nsel = PA.paged_mixed_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bt, starts, qlens)), site_t)
    assert PA.paged_mixed_attention.launches == before   # CPU: no launch
    got, nsel = got.numpy(), nsel.numpy()

    want_p, nsel_p = JOPS.paged_mixed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(qlens), site_j)
    np.testing.assert_allclose(got[lo], np.asarray(want_p)[lo], **TOL)
    check_counts(nsel, nsel_p, name, live)

    want_g, nsel_g = jax_gather(q, k, v, bt, starts, site_j)
    np.testing.assert_allclose(got, want_g, **TOL)   # same computation: all
    check_counts(nsel, nsel_g, name, np.ones_like(live))


def test_plain_tau_override_moves_selection():
    q, k, v, bt, starts, qlens = make_case(1)
    args = [torch.from_numpy(a) for a in (q, k, v, bt, starts, qlens)]
    site = LampSite(**SITES["relaxed-g1"])
    _, lo = PA.paged_mixed_attention(*args, site, tau=torch.tensor(0.01))
    _, hi = PA.paged_mixed_attention(*args, site, tau=torch.tensor(0.5))
    live = torch.from_numpy(live_mask(qlens))
    assert float(lo[live].sum()) > float(hi[live].sum())


def test_supports_site_and_passes():
    assert PA.supports_site(LampSite(enabled=False, rule="random"))
    assert not PA.supports_site(LampSite(enabled=True, rule="random"))
    assert PA.passes(LampSite(enabled=False)) == 1
    assert PA.passes(LampSite(rule="none")) == 1
    assert PA.passes(LampSite(rule="strict")) == 2


def test_wrapper_refuses_other_devices():
    q, k, v, bt, starts, qlens = make_case(2)
    args = [torch.from_numpy(a).to("meta") for a in (q, k, v, bt, starts, qlens)]
    with pytest.raises(ValueError, match="no paged attention"):
        PA.paged_mixed_attention(*args, LampSite())
