"""Port vs JAX: the fault injector (``serving/faults.py``) and the pool's
fault hooks.

The port keeps its own copies of `audit_hash` (``obs/audit.py``) and of the
whole fault module; the engine differential (test_torch_faults_engine.py)
rests on both packages firing the same fault at the same (step, site,
salt). So: the hashes are bit-equal over a grid; `FaultConfig` refuses the
same values with the same messages; `fires`, `pick_row`, the `max_faults`
budget, the one-per-(site, step) latch and the stall state agree step for
step over 10^4 steps; the injector's metric family and trace instants carry
the JAX names. The port's pool fails an armed allocation once and
`check_invariants` catches corruption, as `tests/test_faults.py:113-135`
holds of the JAX pool. Everything here is exact.
"""

import numpy as np
import pytest

from repro.obs import Observability as JaxObservability
from repro.obs import ObsConfig as JaxObsConfig
from repro.obs.audit import audit_hash as jax_audit_hash
from repro.serving import faults as JF
from repro_torch.configs import get_config, reduced
from repro_torch.obs import ObsConfig, Observability
from repro_torch.obs.audit import audit_hash
from repro_torch.serving import (ArenaAllocFault, FaultConfig, FaultInjector,
                                 PagedKVPool, fault_hash)
from repro_torch.serving import faults as TF


def test_audit_hash_bit_equal_over_a_grid():
    rng = np.random.default_rng(0)
    steps = list(range(64)) + rng.integers(0, 2 ** 40, 64).tolist()
    for step in steps:
        for req in (0, 1, 7, 12345, 2 ** 33 + 5):
            for salt in (0, 1, 3, 0x5EED, 2 ** 31 - 1):
                assert audit_hash(step, req, salt) == \
                    jax_audit_hash(step, req, salt)


@pytest.mark.parametrize("site", JF.FAULT_SITES)
def test_fault_hash_bit_equal(site):
    assert TF.FAULT_SITES == JF.FAULT_SITES
    assert TF._SITE_IDS == JF._SITE_IDS
    for step in range(2000):
        for salt in (0, 3, 7, 9):
            assert fault_hash(step, site, salt) == \
                JF.fault_hash(step, site, salt)


@pytest.mark.parametrize("bad", [
    dict(nan_rate=1.5), dict(alloc_rate=-0.1), dict(draft_rate=2.0),
    dict(stall_steps=0), dict(stall_s=-1.0), dict(max_faults=-1)])
def test_fault_config_validation_same_errors(bad):
    with pytest.raises(ValueError) as jerr:
        JF.FaultConfig(**bad)
    with pytest.raises(ValueError) as terr:
        FaultConfig(**bad)
    assert str(terr.value) == str(jerr.value)


def test_fault_config_fields_and_any_rate():
    import dataclasses
    assert [f.name for f in dataclasses.fields(FaultConfig)] == \
        [f.name for f in dataclasses.fields(JF.FaultConfig)]
    assert FaultConfig() == FaultConfig() and hash(FaultConfig()) is not None
    assert not FaultConfig().any_rate and not JF.FaultConfig().any_rate
    for site in JF.FAULT_SITES:
        kw = {f"{site}_rate": 0.5}
        assert FaultConfig(**kw).any_rate == JF.FaultConfig(**kw).any_rate


def _walk(inj, rng, n_steps):
    """Drive an injector as the engine does, from a seeded decision stream:
    per step the stall hook, then each site's fires / pick_row / record,
    sometimes a watchdog clear. Returns every observable decision."""
    log = []
    for step in range(n_steps):
        stalled = inj.maybe_stall(step)
        log.append(("stall", step, stalled, inj.stalled))
        if stalled and rng.random() < 0.1:
            inj.clear_stall()
        for site in ("nan", "alloc", "draft", "step"):
            f = inj.fires(step, site)
            row = None
            if f:
                reqs = rng.integers(0, 64, int(rng.integers(0, 6))).tolist()
                row = inj.pick_row(step, site, reqs)
                if rng.random() < 0.8:
                    inj.record(step, site, req=row)
                    # the latch: one injection per (site, step)
                    assert not inj.fires(step, site)
            log.append((site, step, f, row))
    return log, inj.stats()


@pytest.mark.parametrize("fc", [
    dict(salt=7, nan_rate=0.25, alloc_rate=0.15, stall_rate=0.05,
         stall_steps=2, stall_s=0.0),
    dict(salt=3, nan_rate=0.3, draft_rate=0.3, step_rate=0.2,
         alloc_rate=0.1, stall_rate=0.05, stall_steps=3),
    dict(salt=11, nan_rate=1.0, draft_rate=0.5, stall_rate=0.02,
         max_faults=500, stall_steps=7)])
def test_injector_agrees_with_jax_over_1e4_steps(fc):
    j = JF.FaultInjector(JF.FaultConfig(enabled=True, **fc))
    t = FaultInjector(FaultConfig(enabled=True, **fc))
    jlog, jstats = _walk(j, np.random.default_rng(1), 10_000)
    tlog, tstats = _walk(t, np.random.default_rng(1), 10_000)
    assert tlog == jlog
    assert tstats == jstats
    assert tstats["injected"] > 0
    if fc.get("max_faults"):
        assert tstats["injected"] == fc["max_faults"]


def test_pick_row_agrees_and_spreads():
    for salt in (0, 5):
        j = JF.FaultInjector(JF.FaultConfig(enabled=True, salt=salt))
        t = FaultInjector(FaultConfig(enabled=True, salt=salt))
        rng = np.random.default_rng(salt)
        for step in range(500):
            reqs = rng.integers(0, 1000, int(rng.integers(0, 9))).tolist()
            for site in JF.FAULT_SITES:
                assert t.pick_row(step, site, reqs) == \
                    j.pick_row(step, site, reqs)
        assert t.pick_row(3, "nan", []) is None
        assert {t.pick_row(s, "nan", [4, 9, 17]) for s in range(50)} == \
            {0, 1, 2}


def test_stall_latch_and_clear_agree():
    fc = dict(enabled=True, salt=1, stall_rate=1.0, max_faults=1,
              stall_steps=500)
    for mod in (JF, TF):
        inj = mod.FaultInjector(mod.FaultConfig(**fc))
        # a stall event wedges the same step id repeatedly
        assert all(inj.maybe_stall(0) for _ in range(10))
        assert inj.stalled
        inj.clear_stall()
        assert not inj.stalled and not inj.maybe_stall(0)
        assert inj.stats() == {"enabled": True, "injected": 1,
                               "by_site": {"nan": 0, "alloc": 0, "draft": 0,
                                           "step": 0, "stall": 1}}


def test_injector_metric_and_trace_names_match_jax():
    fc = dict(enabled=True, salt=2, nan_rate=1.0, alloc_rate=1.0)
    jobs = JaxObservability(JaxObsConfig(trace=True))
    tobs = Observability(ObsConfig(trace=True))
    j = JF.FaultInjector(JF.FaultConfig(**fc), jobs)
    t = FaultInjector(FaultConfig(**fc), tobs)
    for inj in (j, t):
        for step in range(3):
            for site in ("nan", "alloc"):
                if inj.fires(step, site):
                    inj.record(step, site, req=step)
    assert tobs.registry.snapshot()["engine_faults_injected_total"] == \
        jobs.registry.snapshot()["engine_faults_injected_total"]
    names = [[e[1] for e in obs.tracer.events()] for obs in (jobs, tobs)]
    assert names[1] == names[0] == ["fault:nan", "fault:alloc"] * 3


def _pool(n_blocks=8, block_size=4):
    cfg = reduced(get_config("gpt2"))
    return PagedKVPool(cfg, n_blocks=n_blocks, block_size=block_size,
                       device="cpu")


def test_arm_alloc_failure_raises_once():
    pool = _pool()
    pool.arm_alloc_failure()
    with pytest.raises(ArenaAllocFault):
        pool.alloc(1)
    blocks = pool.alloc(2)               # one-shot: the next alloc succeeds
    assert len(blocks) == 2
    pool.check_invariants()


def test_check_invariants_detects_corruption():
    pool = _pool()
    blocks = pool.alloc(3)
    pool.check_invariants()
    pool.refcount[blocks[0]] = 0         # corrupt: owned block with rc 0
    with pytest.raises(RuntimeError, match="invariant"):
        pool.check_invariants()
    pool.refcount[blocks[0]] = 1
    pool.check_invariants()
    pool._free.append(blocks[1])         # corrupt: block both owned and free
    pool._free_set.add(blocks[1])
    with pytest.raises(RuntimeError, match="invariant"):
        pool.check_invariants()
