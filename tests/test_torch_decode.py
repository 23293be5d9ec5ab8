"""Port vs JAX: the paged decode kernel's plain version (the CUDA kernel
against its plain version is in tests/test_torch_kernel_card.py, which runs
on a card; `decode_attention_lamp` and the single-token model steps are in
tests/test_torch_decode_step.py).

`paged_decode_attention` on the CPU (its plain version) is held against
both the JAX gather path and the JAX Pallas kernel in interpret mode (as
tests/conftest.py sets it), for every LAMP site of tests/test_paged_kernel.py
(plus relaxed_ln at granularity 1), over ragged lengths at and across block
edges, with and without a window that cuts a block; and in the 12 decode
cases of the JAX suite's seeded walk.

Tolerances are those of tests/test_paged_kernel.py: outputs rtol 2e-5 /
atol 2e-6; counts exact for the max-based rules at granularity 1 and for
rule none / off; one count per row of slack for strict (the normalizer is
a sum in each backend's order) and at granularity 0 (the FP32 dot before
the rounding is a sum in each backend's order). That last effect also
reaches the outputs: at granularity 0 a logit whose FP32 dot sits on a
PS(mu) rounding midpoint can round one step apart in the two backends
(seed 10828 of the seeded walk has one), which moves that (row, head)'s
output by far more than softmax roundoff. Such a (row, head) -- found by
computing y_low in both packages -- is held to atol 1e-3 instead, and at
most one per case may occur.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import attention as JA
from repro.core.mixed_matmul import dot_ps as jax_dot_ps
from repro.core.policy import LampSite as JaxSite
from repro.kernels import ops as JOPS
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

H, HKV, HD = 4, 2, 16

SITES = {
    "off": dict(enabled=False),
    "rule-none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g0": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=0, n_ref=64),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}
SLACK = {"strict-g1": 1, "relaxed-g0": 1, "ln-g0": 1}
TOL = dict(rtol=2e-5, atol=2e-6)


def check_counts(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    if SLACK.get(name):
        np.testing.assert_allclose(got, want, atol=SLACK[name])
    else:
        np.testing.assert_array_equal(got, want)


def ylow_apart(q, kh, site):
    """(R, H) mask of the (row, head)s where the two packages' y_low differ
    anywhere (only possible at granularity 0, see the module docstring)."""
    if not site.get("enabled", True) or site.get("granularity", 0) != 0:
        return np.zeros(q.shape[:2], bool)
    qs = q * q.shape[-1] ** -0.5
    kt = np.swapaxes(np.asarray(kh), -1, -2).copy()
    yj = np.asarray(jax_dot_ps(jnp.asarray(qs), jnp.asarray(kt), site["mu"],
                               granularity=0))
    yt = dot_ps(torch.from_numpy(qs), torch.from_numpy(kt), site["mu"],
                granularity=0).numpy()
    return (yj != yt).any(axis=(2, 3))


def assert_outputs(got, want, apart):
    """TOL everywhere, except (row, head)s whose y_low round apart."""
    assert apart.sum() <= 1, f"{int(apart.sum())} (row, head)s round apart"
    np.testing.assert_allclose(got[~apart], want[~apart], **TOL)
    np.testing.assert_allclose(got[apart], want[apart], atol=1e-3)


def gathered(k, bt):
    R = bt.shape[0]
    ks = k[bt].reshape(R, -1, HKV, HD)
    return np.repeat(np.moveaxis(ks, 2, 1), H // HKV, axis=1)


def make_paged(seed, lengths, bs, n_max):
    """Random arena and shuffled block tables: row r owns the blocks that
    cover lengths[r] positions, the rest of its table is null. Returns
    numpy (q, arena_k, arena_v, block_tables, lengths)."""
    rng = np.random.default_rng(seed)
    R = len(lengths)
    n_blocks = 1 + R * n_max
    k = (rng.standard_normal((n_blocks, bs, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, HKV, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((R, n_max), np.int32)
    for r in range(R):
        nb = -(-max(int(lengths[r]), 1) // bs)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb]
    q = (np.random.default_rng(seed + 7).standard_normal((R, H, 1, HD))
         * 1.5).astype(np.float32)
    return q, k, v, bt, np.asarray(lengths, np.int32)


def jax_gather(q, k, v, bt, lengths, site, window):
    R = q.shape[0]
    ks = jnp.asarray(k)[bt].reshape(R, -1, HKV, HD)
    vs = jnp.asarray(v)[bt].reshape(R, -1, HKV, HD)
    kh = jnp.repeat(jnp.moveaxis(ks, 2, 1), H // HKV, axis=1)
    vh = jnp.repeat(jnp.moveaxis(vs, 2, 1), H // HKV, axis=1)
    o, aux = JA.decode_attention_lamp(jnp.asarray(q), kh, vh,
                                      jnp.asarray(lengths), site,
                                      window=window, reduce=False)
    return np.asarray(o), np.asarray(aux.n_selected), np.asarray(aux.n_valid)


def port_plain(q, k, v, bt, lengths, site, window):
    before = PA.paged_decode_attention.launches
    out, nsel = PA.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bt, lengths)), site,
        window=window)
    assert PA.paged_decode_attention.launches == before   # CPU: no launch
    return out.numpy(), nsel.numpy()


# ragged effective lengths: 1, a block edge (4), mid-block (9), a full
# table (20); the window of 6 cuts mid-block
@pytest.mark.parametrize("name,window", [(n, None) for n in sorted(SITES)]
                         + [("relaxed-g1", 6), ("ln-g1", 6), ("strict-g1", 6)])
def test_paged_decode_plain_matches_jax_pallas_and_gather(name, window):
    q, k, v, bt, lengths = make_paged(3, [1, 4, 9, 20], bs=4, n_max=5)
    site_j = JaxSite(**SITES[name])
    got, nsel = port_plain(q, k, v, bt, lengths, LampSite(**SITES[name]),
                           window)
    apart = ylow_apart(q, gathered(k, bt), SITES[name])
    want_g, nsel_g, _ = jax_gather(q, k, v, bt, lengths, site_j, window)
    assert_outputs(got, want_g, apart)
    check_counts(nsel, nsel_g, name)
    want_p, nsel_p = JOPS.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lengths), site_j, window=window)
    assert_outputs(got, np.asarray(want_p), apart)
    check_counts(nsel, nsel_p, name)


def _walk_decode_cases():
    """The decode cases of tests/test_paged_kernel.py's seeded walk (its
    prefill draws are consumed to keep the same sequence)."""
    rng = np.random.default_rng(42)
    cases = []
    for _ in range(12):
        seed = int(rng.integers(1 << 16))
        lengths = rng.integers(1, 17, size=3)
        rng.integers(1 << 16)
        rng.integers(0, 13, size=3)
        cases.append((seed, [int(x) for x in lengths]))
    return cases


@pytest.mark.parametrize("seed,lengths", _walk_decode_cases())
def test_seeded_walk_decode_cases(seed, lengths):
    q, k, v, bt, lens = make_paged(seed, lengths, bs=4, n_max=4)
    site_j = JaxSite(**SITES["relaxed-g0"])
    got, nsel = port_plain(q, k, v, bt, lens, LampSite(**SITES["relaxed-g0"]),
                           None)
    want_p, nsel_p = JOPS.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lens), site_j)
    want_g, nsel_g, _ = jax_gather(q, k, v, bt, lens, site_j, None)
    apart = ylow_apart(q, gathered(k, bt), SITES["relaxed-g0"])
    for want, ns in ((np.asarray(want_p), nsel_p), (want_g, nsel_g)):
        assert_outputs(got, want, apart)
        check_counts(nsel, ns, "relaxed-g0")


def test_decode_wrapper_checks():
    q, k, v, bt, lengths = make_paged(4, [3, 8], bs=4, n_max=3)
    args = [torch.from_numpy(a) for a in (q, k, v, bt, lengths)]
    with pytest.raises(ValueError, match="no paged attention"):
        PA.paged_decode_attention(*[a.to("meta") for a in args], LampSite())
    # tau override: a lower threshold selects more
    site = LampSite(**SITES["relaxed-g1"])
    _, lo = PA.paged_decode_attention(*args, site, tau=torch.tensor(0.01))
    _, hi = PA.paged_decode_attention(*args, site, tau=torch.tensor(0.5))
    assert float(lo.sum()) > float(hi.sum())
