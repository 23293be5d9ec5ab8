"""The paged plain versions sum in the CUDA kernel's order, on the CPU.

``paged_mixed_attention_plain`` and ``paged_decode_attention_plain`` (the
oracle ``kernels/csrc/paged_attention.cu`` is held to on a card) take y_low
and the FP32 logits y_exact with ``core.attention``'s ``order="kernel"``:
at granularity g in {4, 8, 16} y_low is ``slab_sums(qs, k, mu, g)``; at
granularity 0 and at mu 23 the FP32 logits are ``slab_sums(qs, k, 23, hd)``
(d ascending, each product and sum rounded: the kernel's mul/add chain)
and y_low their PS(mu) rounding. Checked bit for bit on every live (query,
key) pair, through the values the plain versions hand to the selection
rule and to the softmax. Then the relaxed rule's counts equal those of an
independent float32 evaluation of rule (9) on those y_low, exactly.

Tolerance: bit-exact logits, exact counts."""

import numpy as np
import pytest
import torch

from repro_torch.core import attention as CA
from repro_torch.core import lamp as LM
from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.core.numerics import round_to_mantissa
from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

H, HKV, HD, BS, N_MAX = 4, 2, 16, 8, 6


def _case(seed, decode):
    rng = np.random.default_rng(seed)
    B = 3
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, HKV, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        bt[r] = perm[r * N_MAX:(r + 1) * N_MAX]
    W = 1 if decode else 8
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, bt)]
    if decode:
        return t + [torch.tensor([1, 17, 40], dtype=torch.int32)]
    return t + [torch.tensor([0, 13, 30], dtype=torch.int32),
                torch.tensor([8, 5, 1], dtype=torch.int32)]


def _keys(k, bt):
    """(B, H, Tk, hd): each row's block-table span, KV heads repeated."""
    B = bt.shape[0]
    ks = k[bt.long()].reshape(B, N_MAX * BS, HKV, HD).permute(0, 2, 1, 3)
    return torch.repeat_interleave(ks, H // HKV, dim=1)


def _valid(case, decode):
    """(B, 1, W, Tk) live (query, key) pairs."""
    pos = torch.arange(N_MAX * BS)[None, None, None, :]
    if decode:
        return pos < case[4][:, None, None, None]
    qi = case[4][:, None, None, None] + torch.arange(case[0].shape[2])[None, None, :, None]
    return (pos <= qi) & (torch.arange(case[0].shape[2])[None, None, :, None]
                          < case[5][:, None, None, None])


def _run(case, site, decode, monkeypatch):
    """The plain version once; returns what it handed to the selection rule
    (y_low) and to the softmax (y), and its counts."""
    seen = {}
    select, softmax = CA._select, LM.masked_softmax

    def spy_select(y, *a, **k):
        seen["y_low"] = y.clone()
        return select(y, *a, **k)

    def spy_softmax(y, *a, **k):
        seen.setdefault("y", y.clone())
        return softmax(y, *a, **k)

    monkeypatch.setattr(CA, "_select", spy_select)
    monkeypatch.setattr(LM, "masked_softmax", spy_softmax)
    if decode:
        _, n = PA.paged_decode_attention_plain(*case, site)
    else:
        _, n = PA.paged_mixed_attention_plain(*case, site)
    return seen["y_low"], seen["y"], n


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("g", [4, 8, 16])
def test_ylow_in_chunks_is_slab_sums(monkeypatch, g, decode):
    case = _case(g, decode)
    site = LampSite(rule="relaxed", mu=5, tau=0.05, granularity=g)
    y_low, y, _ = _run(case, site, decode, monkeypatch)
    qs = case[0] * HD ** -0.5
    kt = _keys(case[1], case[3]).transpose(-1, -2)
    want = slab_sums(qs, kt, 5, g)
    ok = _valid(case, decode).expand_as(want)
    assert torch.equal(y_low[ok], want[ok])
    # a selected logit is the FP32 one, in the kernel's order
    ye = slab_sums(qs, kt, 23, HD)
    sel = (y != y_low) & ok
    assert torch.equal(y[sel], ye[sel])


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("mu,g", [(7, 0), (23, 1), (23, 0)])
def test_exact_logits_are_slab_sums(monkeypatch, mu, g, decode):
    case = _case(mu + g, decode)
    site = LampSite(rule="relaxed", mu=mu, tau=0.05, granularity=g)
    y_low, y, _ = _run(case, site, decode, monkeypatch)
    qs = case[0] * HD ** -0.5
    ye = slab_sums(qs, _keys(case[1], case[3]).transpose(-1, -2), 23, HD)
    ok = _valid(case, decode).expand_as(ye)
    assert torch.equal(y_low[ok], round_to_mantissa(ye, mu)[ok])
    sel = (y != y_low) & ok
    assert torch.equal(y[ok & sel], ye[ok & sel])
    if mu < 23:
        assert sel.any()


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("g", [0, 1, 8])
def test_relaxed_counts_are_exact(monkeypatch, g, decode):
    """Rule (9) evaluated apart in float32 on the y_low the plain version
    computed: s = y + log|y|, selected where s > log(tau) + max s."""
    case = _case(40 + g, decode)
    site = LampSite(rule="relaxed", mu=7, tau=0.05, granularity=g)
    y_low, _, n = _run(case, site, decode, monkeypatch)
    ok = _valid(case, decode).expand_as(y_low)
    s = torch.where(ok, y_low + torch.log(torch.abs(y_low)),
                    torch.tensor(float("-inf")))
    smax = s.amax(-1, keepdim=True)
    sel = (s > torch.log(torch.tensor(0.05, dtype=torch.float32)) + smax) & ok
    if decode:
        assert torch.equal(n, sel.float().sum(dim=(1, 2, 3)))
    else:     # padding queries (past qlens) are computed and discarded
        live = torch.arange(case[0].shape[2])[None, :] < case[5][:, None]
        assert torch.equal(n[live], sel.float().sum(dim=(1, 3))[live])
    assert 0 < float(n.sum()) < float(ok.sum())


def test_order_keyword_defaults_and_checks():
    """The gather path keeps dot_ps (held against JAX) unless asked, and
    refuses an unknown order."""
    q = torch.randn(1, 2, 3, 8)
    k = torch.randn(1, 2, 5, 8)
    site = LampSite(rule="relaxed", mu=5, tau=0.05, granularity=0)
    a, _ = CA.attention_lamp(q, k, k, site, causal=False)
    b, _ = CA.attention_lamp(q, k, k, site, causal=False, order="dot_ps")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="order must be"):
        CA.attention_lamp(q, k, k, site, order="cublas")
    with pytest.raises(ValueError, match="order must be"):
        CA.decode_attention_lamp(q[:, :, :1], k, k, torch.tensor([3]), site,
                                 order="xla")
