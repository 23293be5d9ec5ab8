"""Port vs JAX: the plain versions of the four kernels of the kernel
micro-benchmark (flash_decode, lamp_flash_attention, ps_matmul, rmsnorm),
and the port's micro-benchmark entry point. The CUDA kernels against their
plain versions are in tests/test_torch_micro_card.py, which runs on a card.

Each case feeds the same seeded numpy inputs to the JAX kernel (through
``repro.kernels.ops``, in interpret mode as tests/conftest.py pins it) and
to the port's wrapper on CPU tensors, which runs the plain version. The
cases are those of tests/test_kernels.py.

Tolerances are tests/test_kernels.py's: attention outputs rtol 2e-5 / atol
2e-6 with selection counts equal; rmsnorm rtol 1e-6 in float32 and one
bfloat16 step (rtol 2e-2) in bfloat16; ps_matmul 1e-6, and 1e-5 at mu 23
(plain FP32 accumulation, summed in another order). Named slack:
- ps_matmul at mu < 23: inside a block_k slab XLA's dot and the port (lane
  by lane, the CUDA kernel's order) sum in different orders; where the slab
  sum sits on a PS(mu) rounding midpoint the two round one step apart, and
  the step carries to the output. At most PS_STEP_SLACK entries per case
  may differ by more than 1e-6, each by at most one PS(mu) step of a
  running accumulator (2^(1-mu) * sum_k |a_ik b_kj|). These seeds have
  none.
- attention: a y_low chunk sum on a midpoint rounds apart in the two
  packages in the same way (as tests/test_torch_decode.py found at
  granularity 0), which moves that query row's output by more than
  roundoff and may move its count. Such rows are found by computing y_low
  in both packages (``ylow_apart``); at most APART_ROWS per case may occur,
  their outputs are held to atol 1e-3 and their counts to the number of
  keys that round apart. Every other row is held to TOL, every count
  exact. The non-causal mu 7 case (seed 70) has one such row.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JOPS
from repro.kernels.ref import _subtile_qk
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import lamp_attention as LA
from repro_torch.kernels import ps_matmul as PM
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import kernels_micro

TOL = dict(rtol=2e-5, atol=2e-6)
PS_STEP_SLACK = 2
APART_ROWS = 2


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, bf16=False):
    """The same numpy array as a JAX and a torch array (both bfloat16 when
    asked: a float32 -> bfloat16 rounding is the same in both)."""
    j, t = jnp.asarray(x), torch.from_numpy(x)
    return (j.astype(jnp.bfloat16), t.bfloat16()) if bf16 else (j, t)


def ylow_apart(q, k, mu, sub, ok):
    """(B, H, T) valid keys (mask `ok`) per query row whose y_low differs
    between the JAX oracle's chunk sums and the port's ``dot_ps`` (module
    docstring). None at mu >= 23, where y_low is not rounded."""
    if mu >= 23:
        return np.zeros(q.shape[:-1], np.int64)
    qs = q.astype(np.float32) * np.float32(q.shape[-1] ** -0.5)
    k = k.astype(np.float32)
    yt = dot_ps(torch.from_numpy(qs), torch.from_numpy(k).transpose(-1, -2),
                mu, granularity=sub).numpy()
    yj = np.stack([np.stack([np.asarray(_subtile_qk(
        jnp.asarray(qs[b, h]), jnp.asarray(k[b, h]).T, mu, sub))
        for h in range(q.shape[1])]) for b in range(q.shape[0])])
    return ((yt != yj) & ok).sum(-1)


def assert_attention(got, want, nsel, nref, apart):
    """TOL and exact counts, but for the rows whose y_low rounds apart."""
    got, want = got.numpy(), np.asarray(want)
    rows = apart > 0
    assert rows.sum() <= APART_ROWS, f"{rows.sum()} rows round apart"
    np.testing.assert_allclose(got[~rows], want[~rows], **TOL)
    np.testing.assert_allclose(got[rows], want[rows], rtol=0, atol=1e-3)
    assert abs(float(nsel) - float(nref)) <= apart.sum()


# ---------------------------------------------------------- flash_decode

FD_SHAPES = [(128, 32, 32, 8), (256, 64, 64, 32), (64, 16, 16, 16)]


@pytest.mark.parametrize("mu,tau", [(5, 0.05), (23, 0.2)])
def test_flash_decode_matches_jax(mu, tau):
    rng = np.random.default_rng(mu)
    for S, D, bk, sub in FD_SHAPES:
        q, kc = _rand(rng, (2, 3, 1, D), 1.5), _rand(rng, (2, 3, S, D), 1.5)
        vc = _rand(rng, (2, 3, S, D))
        length = np.asarray([S - 7, S], np.int32)
        kw = dict(mu=mu, tau=tau, block_k=bk, k_subtile=sub)
        want, nref = JOPS.flash_decode(*(_both(a)[0] for a in (q, kc, vc, length)),
                                       **kw)
        got, nsel = FD.flash_decode(*(_both(a)[1] for a in (q, kc, vc, length)),
                                    **kw)
        ok = (np.arange(S)[None, :] < length[:, None])[:, None, None, :]
        apart = ylow_apart(q, kc, mu, sub, ok)
        assert_attention(got, want, nsel, nref, apart)
        assert float(nref) > 0


def test_flash_decode_zero_length_row_gives_zero():
    rng = np.random.default_rng(1)
    q, kc, vc = (_rand(rng, s) for s in ((2, 2, 1, 16), (2, 2, 32, 16),
                                         (2, 2, 32, 16)))
    length = np.asarray([0, 20], np.int32)
    want, nref = JOPS.flash_decode(*(jnp.asarray(a) for a in (q, kc, vc, length)),
                                   block_k=16, k_subtile=8)
    got, nsel = FD.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc, length)),
                                block_k=16, k_subtile=8)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(nsel) == float(nref)


# ------------------------------------------------------- lamp_attention

LA_SHAPES = [(64, 32, 16, 16, 8), (128, 64, 32, 64, 32), (96, 16, 32, 32, 16)]


@pytest.mark.parametrize("mu,tau", [(5, 0.05), (7, 0.2), (23, 0.05)])
@pytest.mark.parametrize("causal", [True, False])
def test_lamp_flash_attention_matches_jax(mu, tau, causal):
    rng = np.random.default_rng(10 * mu + causal)
    for T, D, bq, bk, sub in LA_SHAPES:
        q, k = _rand(rng, (1, 2, T, D), 1.5), _rand(rng, (1, 2, T, D), 1.5)
        v = _rand(rng, (1, 2, T, D))
        kw = dict(mu=mu, tau=tau, causal=causal, block_q=bq, block_k=bk,
                  k_subtile=sub)
        want, nref = JOPS.lamp_flash_attention(*(_both(a)[0] for a in (q, k, v)),
                                               **kw)
        got, nsel = LA.lamp_flash_attention(*(_both(a)[1] for a in (q, k, v)),
                                            **kw)
        ok = np.tril(np.ones((T, T), bool)) if causal else True
        apart = ylow_apart(q, k, mu, sub, ok)
        assert_attention(got, want, nsel, nref, apart)
        assert float(nref) > 0


def test_lamp_flash_attention_bf16_inputs():
    rng = np.random.default_rng(2)
    q, k = _rand(rng, (1, 1, 64, 32), 1.5), _rand(rng, (1, 1, 64, 32), 1.5)
    v = _rand(rng, (1, 1, 64, 32))
    kw = dict(mu=7, tau=0.1, causal=True, block_q=16, block_k=16, k_subtile=16)
    want, nref = JOPS.lamp_flash_attention(*(_both(a, True)[0] for a in (q, k, v)),
                                           **kw)
    got, nsel = LA.lamp_flash_attention(*(_both(a, True)[1] for a in (q, k, v)),
                                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(nsel) == float(nref)


def test_lamp_per_row_counts_sum_to_total():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, (2, 2, 32, 16), 1.5)) for _ in range(3))
    kw = dict(block_q=8, block_k=8, k_subtile=4)
    out, total = LA.lamp_flash_attention(q, k, v, **kw)
    out_r, rows = LA.lamp_flash_attention(q, k, v, reduce=False, **kw)
    assert rows.shape == (2, 2, 32) and torch.equal(out, out_r)
    assert float(rows.sum()) == float(total) > 0


# ------------------------------------------------------------- ps_matmul

def _divblock(n, cap=32):
    for c in (cap, 16, 8, 4):
        if n % c == 0:
            return c
    return n


PS_SHAPES = [(32, 64, 16), (128, 128, 128), (64, 96, 48), (16, 256, 32)]


@pytest.mark.parametrize("mu", [4, 7, 23])
@pytest.mark.parametrize("bf16", [False, True])
def test_ps_matmul_matches_jax(mu, bf16):
    rng = np.random.default_rng(mu + 100 * bf16)
    for M, K, N in PS_SHAPES:                  # K 96: not a power of two
        a, b = _rand(rng, (M, K)), _rand(rng, (K, N))
        (ja, ta), (jb, tb) = _both(a, bf16), _both(b, bf16)
        blocks = dict(block_m=_divblock(M), block_n=_divblock(N),
                      block_k=_divblock(K))
        want = np.asarray(JOPS.ps_matmul(ja, jb, mu=mu, **blocks))
        got = PM.ps_matmul(ta, tb, mu=mu, **blocks).numpy()
        if mu == 23:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            continue
        apart = ~np.isclose(got, want, rtol=1e-6, atol=1e-6)
        assert apart.sum() <= PS_STEP_SLACK, f"{apart.sum()} entries apart"
        mag = np.abs(ta.float().numpy()) @ np.abs(tb.float().numpy())
        assert np.all(np.abs(got - want)[apart] <= 2.0 ** (1 - mu) * mag[apart])


def test_ps_matmul_plain_rounds_after_each_slab():
    """slab_sums at one slab of K is the FP32 sum rounded once; with slabs
    it re-rounds the running sum, and every output lies on the PS(mu)
    grid."""
    from repro_torch.core.numerics import round_to_mantissa
    rng = np.random.default_rng(4)
    a, b = torch.from_numpy(_rand(rng, (8, 24))), torch.from_numpy(_rand(rng, (24, 8)))
    one = PM.ps_matmul(a, b, mu=5, block_k=24)
    assert torch.equal(one, round_to_mantissa(PM.slab_sums(a, b, 23, 24), 5))
    three = PM.ps_matmul(a, b, mu=5, block_k=8)
    assert torch.equal(three, round_to_mantissa(three, 5))
    assert not torch.equal(one, three)


# --------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_matches_jax(bf16):
    rng = np.random.default_rng(5 + bf16)
    for shape in [(8, 64), (3, 37, 128), (256, 16)]:   # 3-D: 111 rows
        x, w = _rand(rng, shape), _rand(rng, (shape[-1],), 0.1)
        (jx, tx), (jw, tw) = _both(x, bf16), _both(w)
        want = JOPS.rmsnorm(jx, jw, block_rows=16)
        got = RN.rmsnorm(tx, tw, block_rows=16)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2e-2 if bf16 else 1e-6, atol=1e-6)


# ------------------------------------------------- wrappers and the CLI

def test_wrappers_raise_the_jax_errors_and_never_fall_back(monkeypatch):
    q = torch.zeros(1, 1, 48, 16)
    with pytest.raises(ValueError, match="block_k"):
        LA.lamp_flash_attention(q, q, q, block_q=16, block_k=32)
    with pytest.raises(ValueError, match="block_k"):
        FD.flash_decode(q[:, :, :1], q, q, torch.tensor([4]), block_k=32)
    with pytest.raises(ValueError, match="not divisible"):
        PM.ps_matmul(torch.zeros(48, 48), torch.zeros(48, 48), block_k=32)
    meta = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="no rmsnorm kernel"):
        RN.rmsnorm(meta, torch.zeros(16, device="meta"))
    with pytest.raises(ValueError, match="no ps_matmul kernel"):
        PM.ps_matmul(meta, torch.zeros(16, 4, device="meta"), block_m=4,
                     block_n=4, block_k=16)
    # the entry point runs on CUDA unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels_micro.main([])


def test_micro_cli_on_cpu_emits_the_six_rows(capsys):
    assert kernels_micro.main(["--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["name"] for r in rows] == list(kernels_micro.ROW_NAMES)
    assert all(r["device"] == "cpu" and r["ok"] for r in rows)
    assert all("ms" not in r for r in rows)      # no device time off the card
    by = {r["name"]: r for r in rows}
    assert by["kernel_flash_decode_2k"]["nsel"] == \
        by["kernel_flash_decode_2k"]["nsel_ref"] > 0
    assert by["kernel_ps_matmul_256"]["flops"] == 2 * 256 ** 3
    assert by["kernel_paged_decode_fused"]["bytes_kv"] < \
        by["kernel_paged_decode_gather"]["bytes_kv"]

