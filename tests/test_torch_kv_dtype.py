"""Port vs JAX: the paged arena's dtype (`EngineConfig.kv_dtype`).

The JAX engine declares `kv_dtype` and its Pallas bodies widen any arena
dtype to FP32 inside the kernel; the port's CUDA kernel reads a bfloat16
or float16 arena itself and widens as it reads (the card tests and
`chip_smoke.py` phase kv_dtype hold it to its plain version), and the plain
versions and the gather path widen the gathered span. Here, on the CPU:

  * the arena writes cast as JAX's `astype` does (round to nearest even);
  * both paged plain versions on bfloat16 and float16 arenas against the
    JAX kernels (interpret mode) on the same narrow arenas, and bit for bit
    against themselves on the arena's float32 widening;
  * the gather path's attention widens a narrow K/V explicitly (torch does
    not promote float32 @ bfloat16);
  * `_check_arena`'s accept and refuse cases, and the dtype code each
    wrapper binds for the kernel;
  * the pool's dtype through copy-on-write, `rollback` and `defrag()`;
  * the engine with `kv_dtype="bfloat16"` replaying the JAX engine's plan
    stream (its `kv_dtype="bfloat16"`): spec off on the gather path, spec
    on through the wrappers (their plain versions on the CPU).

Tolerances: those of tests/test_paged_kernel.py (rtol 2e-5 / atol 2e-6;
counts exact at granularity 1 for the max-based rules and rule none,
one a query row for strict); a narrow arena against its float32 widening
exact; engine tokens exact, per-request selected counts within 0.1% of the
valid products (tests/test_torch_engine.py's slack: each backend sums its
FP32 matmuls in its own order).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core.policy import LampSite as JaxSite
from repro.kernels import ops as JOPS
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.core.attention import attention_lamp
from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (EngineConfig, LampEngine, PagedKVPool,
                                 SamplingParams, Sequence)

H, HKV, HD = 4, 2, 16
BS, N_MAX, W = 4, 8, 8
TOL = dict(rtol=2e-5, atol=2e-6)
SITES = {
    "none": dict(rule="none", mu=5, granularity=1),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
}
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16),
          "float16": (torch.float16, jnp.float16, np.float16)}


def _narrow(a, name):
    """(torch arena, jax arena) of float32 `a` cast to dtype `name`."""
    tdt, jdt, _ = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_arena_cast_rounds_to_nearest_even(name):
    """`tensor.to(dtype)` (every arena write) gives the bits of JAX's
    `astype`: random values, exact halfway ties, overflow, subnormals,
    Inf and NaN."""
    tdt, jdt, ndt = DTYPES[name]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
         ).astype(np.float32)
    # halfway between two narrow values: an odd low bit below the cut
    cut = 16 if name == "bfloat16" else 13
    ties = (np.arange(1, 257, dtype=np.uint32) << cut | (1 << (cut - 1)))
    ties = (ties + np.uint32(0x3F800000)).view(np.float32)
    special = np.asarray([1e5, 7e4, 3.4e38, 1e-40, -1e-45, np.inf, -np.inf,
                          np.nan], np.float32)
    x = np.concatenate([x, ties, -ties, special])
    got = torch.from_numpy(x).to(tdt).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jdt)).view(np.int16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert torch.isnan(torch.from_numpy(x).to(tdt)[torch.from_numpy(nan)]).all()


def _mixed_case(seed):
    rng = np.random.default_rng(seed)
    starts, qlens = (0, 5, 13, 22), (8, 1, 3, 6)
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
    return q, k, v, bt, np.asarray(starts, np.int32), np.asarray(qlens, np.int32)


def _counts_close(got, want, name):
    if name == "strict-g1":
        np.testing.assert_allclose(got, want, atol=1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(SITES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mixed_plain_on_narrow_arena(name, dtype):
    q, k, v, bt, starts, qlens = _mixed_case(3)
    tk, jk = _narrow(k, dtype)
    tv, jv = _narrow(v, dtype)
    idx = [torch.from_numpy(a) for a in (bt, starts, qlens)]
    site = LampSite(**SITES[name])
    got, nsel = PA.paged_mixed_attention(torch.from_numpy(q), tk, tv, *idx, site)
    # the float32 widening of the same arena: the same bits
    wide, nwide = PA.paged_mixed_attention_plain(torch.from_numpy(q), tk.float(),
                                                 tv.float(), *idx, site)
    assert torch.equal(got, wide) and torch.equal(nsel, nwide)
    want, nwant = JOPS.paged_mixed_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(starts),
        jnp.asarray(qlens), JaxSite(**SITES[name]))
    live = np.arange(W)[None, :] < qlens[:, None]
    lo = np.broadcast_to(live[:, None, :, None], got.shape)
    np.testing.assert_allclose(got.numpy()[lo], np.asarray(want)[lo], **TOL)
    _counts_close(nsel.numpy()[live], np.asarray(nwant)[live], name)


@pytest.mark.parametrize("dtype,window", [("bfloat16", 6), ("float16", None)])
def test_decode_plain_on_narrow_arena(dtype, window):
    """Ragged effective lengths (1, a block edge, mid-block, long), every
    site; on bfloat16 a window cutting mid-block."""
    rng = np.random.default_rng(5)
    lengths = np.asarray([1, 4, 11, 29], np.int32)
    R = len(lengths)
    n_blocks = 1 + R * N_MAX
    k = (rng.standard_normal((n_blocks, BS, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, HKV, HD)).astype(np.float32)
    bt = np.zeros((R, N_MAX), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    for r in range(R):
        nb = -(-int(lengths[r]) // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((R, H, 1, HD)) * 1.5).astype(np.float32)
    tk, jk = _narrow(k, dtype)
    tv, jv = _narrow(v, dtype)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
            torch.from_numpy(lengths))
    for name, kw in SITES.items():
        got, nsel = PA.paged_decode_attention(*args, LampSite(**kw),
                                              window=window)
        wide, nwide = PA.paged_decode_attention_plain(
            args[0], tk.float(), tv.float(), *args[3:], LampSite(**kw),
            window=window)
        assert torch.equal(got, wide) and torch.equal(nsel, nwide)
        want, nwant = JOPS.paged_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
            JaxSite(**kw), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _counts_close(nsel.numpy(), np.asarray(nwant), name)


def test_gather_attention_widens_narrow_kv():
    """torch refuses float32 @ bfloat16, so the widening is explicit: the
    gather path's attention on a bfloat16 K/V is its float32 widening's."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, H, 5, HD)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, H, 9, HD)).astype(
        np.float32)).bfloat16() for _ in range(2))
    with pytest.raises(RuntimeError):
        torch.matmul(q, k.transpose(-1, -2))
    site = LampSite(**SITES["relaxed-g1"])
    for order in ("dot_ps", "kernel"):
        out, aux = attention_lamp(q, k, v, site, offset=4, order=order)
        ref, raux = attention_lamp(q, k.float(), v.float(), site, offset=4,
                                   order=order)
        assert out.dtype == torch.float32
        assert torch.equal(out, ref) and torch.equal(aux.n_selected,
                                                      raux.n_selected)


def test_check_arena_accepts_and_refuses():
    q = torch.zeros(1, H, 1, HD)
    bt = torch.zeros(1, N_MAX, dtype=torch.int32)
    arena = lambda dt: torch.zeros(5, BS, HKV, HD, dtype=dt)
    site = LampSite(**SITES["relaxed-g1"])
    for dt, code in PA.KV_DTYPES.items():
        assert PA._check_arena(q, arena(dt), arena(dt), bt, site, None) == HKV
        assert code == {torch.float32: 0, torch.bfloat16: 1,
                        torch.float16: 2}[dt]
    with pytest.raises(TypeError, match="arena_k"):
        PA._check_arena(q, arena(torch.float64), arena(torch.float64), bt,
                        site, None)
    with pytest.raises(TypeError, match="arena_k"):
        PA._check_arena(q, arena(torch.int8), arena(torch.int8), bt, site, None)
    with pytest.raises(TypeError, match="arena_v"):
        PA._check_arena(q, arena(torch.bfloat16), arena(torch.float16), bt,
                        site, None)
    with pytest.raises(TypeError, match="q must be"):
        PA._check_arena(q.bfloat16(), arena(torch.bfloat16),
                        arena(torch.bfloat16), bt, site, None)


class _FakeStream:
    cuda_stream = 0


class _FakeLib:
    """Stands in for the built library: records what a launch would pass."""

    def __init__(self):
        self.calls = []

    def lamp_paged_attention_workspace(self, *a):
        return 16

    def lamp_paged_attention_arrivals(self, *a):
        return 1

    def _entry(self, *args):
        self.calls.append(args)
        return 0

    lamp_paged_mixed_attention = lamp_paged_decode_attention = _entry


@pytest.mark.parametrize("kind", ["mixed", "decode"])
def test_wrappers_bind_the_arena_dtype_code(monkeypatch, kind):
    """Each wrapper passes the arena's dtype code where the C entry takes
    it (kv_dtype, just before scale), in as many arguments as its ctypes
    signature declares."""
    from repro_torch.kernels import build
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _FakeStream())
    monkeypatch.setattr(PA, "arrival_counters",
                        lambda dev, n: torch.zeros(n, dtype=torch.int32))
    site = LampSite(**SITES["strict-g1"])
    entry = f"lamp_paged_{kind}_attention"
    argtypes = build.SIGNATURES["paged_attention.cu"][entry][0]
    for dt, code in PA.KV_DTYPES.items():
        lib = _FakeLib()
        ak = torch.zeros(5, BS, HKV, HD, dtype=dt)
        bt = torch.zeros(2, N_MAX, dtype=torch.int32)
        rows = torch.ones(2, dtype=torch.int32)
        if kind == "mixed":
            launch, _, _ = PA.prepare_launch(torch.zeros(2, H, 3, HD), ak, ak,
                                             bt, rows, rows, site, lib=lib)
        else:
            launch, _, _ = PA.prepare_decode_launch(torch.zeros(2, H, 1, HD),
                                                    ak, ak, bt, rows, site,
                                                    lib=lib)
        assert launch() == 2
        assert [c[-2] for c in lib.calls] == [1, 2]           # the passes
        for args in lib.calls:
            assert len(args) == len(argtypes)
            assert args[-4] == code and args[-3] == HD ** -0.5


def test_pool_keeps_its_dtype_through_cow_rollback_and_defrag():
    cfg = reduced(get_config("gpt2"))
    pool = PagedKVPool(cfg, n_blocks=12, block_size=4, device="cpu",
                       dtype=torch.bfloat16, enable_prefix_cache=True)
    assert pool.k.dtype == pool.v.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    pool.k.copy_(torch.randn(pool.k.shape, generator=g))
    pool.v.copy_(torch.randn(pool.v.shape, generator=g))
    a = Sequence(0, list(range(10)), SamplingParams(), 0.0)
    b = Sequence(1, list(range(5)), SamplingParams(), 1.0)
    c = Sequence(2, list(range(8)), SamplingParams(), 2.0)   # a's sharer
    pool.alloc(2)                                    # freed below: a hole
    a.block_ids = pool.alloc(3)
    b.block_ids = pool.alloc(1)
    pool.free_blocks([1, 2])
    # copy-on-write of a shared block: the copy is the same bfloat16 bits
    pool.share(a.block_ids[:2])
    c.block_ids = a.block_ids[:2]
    src = a.block_ids[0]
    new = pool.copy_on_write(src)
    assert torch.equal(pool.k[:, new].view(torch.int16),
                       pool.k[:, src].view(torch.int16))
    a.block_ids = [new] + a.block_ids[1:]
    # rollback of a shared, partly kept tail copies it in the arena's dtype
    tail = pool.k[:, a.block_ids[1]].clone()
    kept = pool.rollback(a.block_ids, 6)
    assert len(kept) == 2 and kept[1] != a.block_ids[1]
    assert torch.equal(pool.k[:, kept[1]].view(torch.int16),
                       tail.view(torch.int16))
    a.block_ids = kept
    rows = {s.req_id: (pool.k[:, s.block_ids].clone(),
                       pool.v[:, s.block_ids].clone()) for s in (a, b, c)}
    pool.defrag([a, b, c])
    assert pool.k.dtype == pool.v.dtype == torch.bfloat16
    for s in (a, b, c):
        k, v = rows[s.req_id]
        assert torch.equal(pool.k[:, s.block_ids], k)
        assert torch.equal(pool.v[:, s.block_ids], v)
    pool.check_invariants([a, b, c])


def test_engine_refuses_an_unknown_kv_dtype():
    cfg = reduced(get_config("gpt2"))
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        LampEngine(cfg, params, EngineConfig(device="cpu", kv_dtype="int8"))
    eng = LampEngine(cfg, params, EngineConfig(device="cpu",
                                               kv_dtype="float16"))
    assert eng.pool.k.dtype == torch.float16


_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24, prefix_cache=True,
             chunked_prefill=True, n_blocks=24, kv_dtype="bfloat16")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2"))
    cfg = reduced(get_config("gpt2"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _requests(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    return [((shared if i % 3 == 0 else [])
             + rng.integers(0, vocab, size=int(rng.integers(4, 24))).tolist(),
             int(rng.integers(6, 10)), i) for i in range(n)]


_JAX_RUNS = {}


def _jax_run(model, reqs, extra):
    key = tuple(sorted(extra.items()))
    if key not in _JAX_RUNS:
        jcfg, _, jparams, _ = model
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
            fused_step=True, kernel="gather", **_BASE, **extra))
        assert jeng.pool.k.dtype == jnp.bfloat16
        trace = record_plans(jeng)
        for i, (prompt, n_new, seed) in enumerate(reqs):
            jeng.add_request(prompt, JaxSamplingParams(max_new_tokens=n_new,
                                                       seed=seed),
                             arrival_time=float(i))
        _JAX_RUNS[key] = trace, {o.req_id: o for o in jeng.run_to_completion()}
    return _JAX_RUNS[key]


@pytest.mark.parametrize("kernel,spec", [("gather", False), ("cuda", True)])
def test_engine_bfloat16_arena_replays_jax(model, kernel, spec):
    """A pool tight enough to preempt: greedy tokens identical to the JAX
    engine's on its bfloat16 arena."""
    _, cfg, _, tparams = model
    reqs = _requests(cfg.vocab)
    extra = dict(speculative=True, draft_len=3) if spec else {}
    trace, jouts = _jax_run(model, reqs, extra)
    teng = LampEngine(cfg, tparams, EngineConfig(device="cpu", kernel=kernel,
                                                 **_BASE, **extra))
    assert teng.pool.k.dtype == torch.bfloat16
    seen = check_replay(teng, trace)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        teng.add_request(prompt, SamplingParams(max_new_tokens=n_new,
                                                seed=seed),
                         arrival_time=float(i))
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert seen == trace
    assert touts.keys() == jouts.keys() == set(range(len(reqs)))
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert to.lamp_valid == jo.lamp_valid
        assert abs(to.lamp_selected - jo.lamp_selected) <= 1e-3 * jo.lamp_valid
    assert teng.stats()["preemptions"] + teng.stats()["cached_tokens"] > 0
