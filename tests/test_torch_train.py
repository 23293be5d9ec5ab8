"""Port vs JAX: the training path's numerics.

Every family's `loss_fn` and its gradient by autograd (remat on, the
default) against ``jax.value_and_grad``; remat off against on; AdamW
(`apply_updates` over 3 clipped steps, FP32 and bfloat16 params),
`cosine_schedule`, gradient compression (`topk_compress`,
`quantize_int8`), `make_train_step` with 2 microbatches, a step with
LAMP on and steps with the cosine schedule setting the lr, `prng.normal`,
the optimizer state carried across by `opt_from_jax`, the tokenizer copy,
and the new entry points' refusal to run without CUDA. The same inputs
(numpy seeds) go to both packages, and the same weights: the port's seeded
ones, carried to JAX as numpy arrays (`params_from_jax` and `opt_from_jax`
carry JAX's the other way); JAX runs jitted, on the CPU.

Tolerances:
  * the loss: rtol 1e-6; each gradient leaf: atol 1e-5 x its largest
    magnitude (each backend sums its FP32 products, and its backward, in
    its own order), rwkv6's 2e-5 (GRAD_ATOL_FAMILY: 1.03e-5 seen);
  * remat on against off, on the CPU: bit for bit;
  * AdamW: FP32 params rtol 1e-6 / atol 1e-7 of the largest, m and v and
    the global norm rtol 1e-5 (the norm's sum of squares in each order,
    then every update divided by it); bfloat16 params: at most one
    bfloat16 step apart (an FP32 value on a rounding midpoint may cast
    either way);
  * the schedule: rtol 1e-6; compression: masks, int8 values and density
    exact, the carried error and the dequantized values bit for bit;
  * a train step (`make_train_step`, or value_and_grad and
    apply_updates): loss rtol 1e-6, grad_norm rtol 1e-5, each leaf's
    update (new params - old) to 1e-3 of its L2 norm: Adam divides each
    entry by its own gradient's scale, so an entry whose gradient is near
    0 carries that gradient's relative roundoff (large) into its update,
    and no per-entry bound holds; with LAMP on (strict rule, mu 4, g 1, as the
    whole-model forward test holds it), the same, with the recompute rate
    equal;
  * `prng.normal`: its uniform is JAX's bit for bit; the values within 3
    float32 steps (rtol 1e-6, atol 1e-6; 7.2e-7 the largest seen over 12
    seeds), since XLA's CPU log1p inside erf_inv is its own
    approximation.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.policy import LampPolicy as JaxPolicy  # noqa: E402
from repro.data import tokenizer as JTOK  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro.optim import adamw as JADAM  # noqa: E402
from repro.optim import compression as JCOMP  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.policy import LampPolicy  # noqa: E402
from repro_torch.data import tokenizer as TTOK  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402
from repro_torch.models.convert import opt_from_jax, params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TADAM  # noqa: E402
from repro_torch.optim import compression as TCOMP  # noqa: E402

ARCHS = {"gpt2": "gpt2", "dense": "glm4-9b", "moe": "qwen3-moe-30b-a3b",
         "llava": "llava-next-mistral-7b", "hymba": "hymba-1.5b",
         "rwkv6": "rwkv6-7b", "whisper": "whisper-medium"}
B, S = 2, 12
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5
# rwkv6's relu^2 channel mix doubles a relative error and its per-head
# group norm divides by a 64-channel std, so its backward grows the
# roundoff more (1.03e-5 of `tm_lora_up`'s largest seen;
# tests/test_torch_families.py doubles its forward tolerance likewise)
GRAD_ATOL_FAMILY = {"rwkv6": 2e-5}
UPDATE_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(family, **overrides):
    arch = ARCHS[family]
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    if overrides:
        jcfg, cfg = jcfg.replace(**overrides), cfg.replace(**overrides)
    # the port's seeded weights, carried to JAX (a JAX init would compile
    # for seconds a family)
    tparams = TAPI.init_params(cfg, 0, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, cfg, jparams, tparams


def _batch(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    rows = {"whisper": ("frames", cfg.enc_seq),
            "llava": ("image_embeds", cfg.n_patches)}.get(cfg.family)
    if rows is not None:
        out[rows[0]] = (rng.standard_normal(
            (batch, rows[1], cfg.d_model)) * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _leaves_close(got, want, atol_rel, rtol=0.0, atol=0.0):
    """Each leaf of the port's tree against the JAX tree's, matched by path:
    within rtol, plus atol_rel x the leaf's largest magnitude, plus atol."""
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = T.flatten_with_path(got)
    assert len(jflat) == len(tflat)
    for (jpath, w), (tpath, g) in zip(jflat, tflat):
        jkey = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                        for p in jpath)
        assert jkey == "/".join(tpath)
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=rtol,
            atol=atol_rel * max(np.abs(w).max(), 1e-30) + atol, err_msg=jkey)


@pytest.mark.parametrize("family", list(ARCHS))
def test_loss_and_every_gradient_match_jax(family):
    """api.loss_fn and its gradient (remat on) against
    jax.value_and_grad of the JAX api.loss_fn, every leaf."""
    jcfg, cfg, jparams, tparams = _models(family)
    jb, tb = _batch(cfg, 1)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JAPI.loss_fn(jcfg, p, b), has_aux=True))
    (jloss, _), jgrads = vg(jparams, jb)
    (tloss, _), tgrads = TST.value_and_grad(
        lambda p, b: TAPI.loss_fn(cfg, p, b), tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _leaves_close(tgrads, jgrads, GRAD_ATOL_FAMILY.get(family, GRAD_ATOL))


def test_remat_changes_no_bit():
    """remat=True against remat=False: the same loss and gradients, bit for
    bit, on every family (the port only: checkpointing recomputes the same
    CPU ops)."""
    for family in ARCHS:
        _, cfg, _, tparams = _models(family)
        _, tb = _batch(cfg, 2)
        runs = [TST.value_and_grad(
            lambda p, b: TAPI.loss_fn(cfg, p, b, remat=remat), tparams, tb)
            for remat in (True, False)]
        (l1, _), g1 = runs[0]
        (l2, _), g2 = runs[1]
        assert torch.equal(l1, l2), family
        for a, b in zip(T.leaves(g1), T.leaves(g2)):
            assert torch.equal(a, b), family
        # the forward too
        x1, _ = TAPI.loss_fn(cfg, tparams, tb, remat=True)
        assert torch.equal(x1, l1), family


def _adam_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "blocks": {"a": (2, 7), "b": (3,)}, "z": (4,)}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = jax.tree.map(lambda a: a.astype(dtype), draw(1.0))
    grads = [draw(2.0) for _ in range(3)]          # norm well above the clip
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_three_clipped_steps_match_jax(dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    params, grads = _adam_inputs(np_dtype)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = JADAM.AdamWConfig(**cfg_kw), TADAM.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, params)
    jo = JADAM.init_state(jp)
    tp = params_from_jax(params, device="cpu")
    to = TADAM.init_state(tp)
    before = jax.tree.map(np.copy, params)
    inputs = tp
    upd = jax.jit(functools.partial(JADAM.apply_updates, jcfg))
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a.astype(np_dtype)), g)
        jp, jo, jm = upd(jp, jg, jo)
        tp, to, tm = TADAM.apply_updates(
            tcfg, tp, params_from_jax(jax.tree.map(
                lambda a: a.astype(np_dtype), g), device="cpu"), to)
        assert float(jm["grad_norm"]) > tcfg.grad_clip       # clip active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(to.step) == int(jo.step) == 3 and to.step.dtype == torch.int32
    _leaves_close(to.m, jo.m, 1e-6, rtol=1e-5)
    _leaves_close(to.v, jo.v, 1e-6, rtol=1e-5)
    for (_, w), g in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                         T.leaves(tp)):
        w = np.asarray(w)
        assert g.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32)
        if dtype == "bfloat16":
            gb = g.view(torch.int16).numpy().astype(np.int32)
            wb = w.view(np.int16).astype(np.int32)
            assert np.abs(gb - wb).max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       atol=1e-7 * np.abs(w).max())
    # the first step's inputs are left as they were (a new tree came back)
    for (_, w), g in zip(jax.tree_util.tree_flatten_with_path(before)[0],
                         T.leaves(inputs)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))


def test_cosine_schedule_matches_jax():
    j = JADAM.cosine_schedule(3e-4, 5, 40, min_frac=0.2)
    t = TADAM.cosine_schedule(3e-4, 5, 40, min_frac=0.2)
    for s in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        want = float(j(jnp.asarray(s, jnp.int32)))
        got = t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_topk_compress_with_error_feedback_matches_jax():
    """Equal masks, carried error and density over three steps, ties at the
    threshold included, and the pass-throughs (a 16-entry leaf, frac 1)."""
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((8, 9)).astype(np.float32),
         "b": rng.standard_normal((16,)).astype(np.float32),
         "c": np.round(rng.standard_normal((40,)) * 2).astype(np.float32)}
    je = JCOMP.init_error(jax.tree.map(jnp.asarray, g))
    te = TCOMP.init_error(params_from_jax(g, device="cpu"))
    for frac in (0.1, 0.25, 1.0):
        jg = jax.tree.map(jnp.asarray, g)
        js, je, jst = JCOMP.topk_compress(jg, je, frac)
        ts, te, tst = TCOMP.topk_compress(params_from_jax(g, device="cpu"),
                                          te, frac)
        assert tst["density"] == jst["density"]
        for k in g:
            np.testing.assert_array_equal(ts[k].numpy() != 0,
                                          np.asarray(js[k]) != 0)
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    with pytest.raises(ValueError):
        TCOMP.topk_compress(params_from_jax(g, device="cpu"), te, 0.0)
    assert TCOMP.compressed_wire_bytes(te, 0.1) == \
        JCOMP.compressed_wire_bytes(je, 0.1)


def test_int8_round_trip_matches_jax_on_exact_halves():
    """Values k + 0.5 scale units apart round half to even in both
    packages (torch.round as jnp.round)."""
    halves = (np.arange(-20, 21) + 0.5).astype(np.float32)
    x = {"h": np.concatenate([halves, [127.0, -127.0]]).astype(np.float32),
         "r": np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)}
    jq, js = JCOMP.quantize_int8(jax.tree.map(jnp.asarray, x))
    tq, ts = TCOMP.quantize_int8(params_from_jax(x, device="cpu"))
    for k in x:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert float(ts[k]) == float(js[k])
    # the halves are exact: scale 1 there, and even results (20.5 -> 20)
    assert float(ts["h"]) == 1.0
    assert tq["h"][40].item() == 20 and tq["h"][0].item() == -20
    jd = JCOMP.dequantize_int8(jq, js)
    td = TCOMP.dequantize_int8(tq, ts)
    for k in x:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def _check_step(jout, tout, before):
    (jp, jo, jm), (tp, to, tm) = jout, tout
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(to.step) == int(jo.step)
    # Adam divides each entry by its own gradient's scale, so an entry whose
    # gradient is tiny carries its gradient's relative roundoff into its
    # update: each leaf's update is held in the L2 norm
    for (path, w), g, p0 in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                T.leaves(tp), jax.tree.leaves(before)):
        w, p0 = np.asarray(w, np.float64), np.asarray(p0, np.float64)
        upd = np.linalg.norm(w - p0)
        assert upd > 0, path
        assert np.linalg.norm(g.double().numpy() - w) <= UPDATE_RTOL * upd, path


def test_train_step_with_two_microbatches_matches_jax():
    """make_train_step at M = 2 (gradients summed in FP32, divided by M,
    the loss averaged; metrics {loss, grad_norm}), two steps, against the
    JAX step."""
    jcfg, cfg, jp, tp = _models("gpt2")
    jstep = jax.jit(JST.make_train_step(jcfg, JADAM.AdamWConfig(lr=1e-3),
                                        num_microbatches=2))
    tstep = TST.make_train_step(cfg, TADAM.AdamWConfig(lr=1e-3),
                                num_microbatches=2)
    jo = JADAM.init_state(jp)
    to = opt_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    before = jp
    for seed in (7, 8):
        jb, tb = _batch(cfg, seed, batch=4)
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert set(tm) == set(jm) == {"loss", "grad_norm"}
        _check_step((jp, jo, jm), (tp, to, tm), before)


def test_scheduled_lr_step_matches_jax():
    """The cosine schedule driving AdamW: the port's value_and_grad and
    apply_updates(lr=schedule(step)) against the JAX step made with
    `lr_schedule`, three steps through the warmup (lr 0, then half) and
    into the decay, held after the third (the first moves nothing)."""
    sched_j = JADAM.cosine_schedule(1e-3, 2, 4)
    sched_t = TADAM.cosine_schedule(1e-3, 2, 4)
    ocfg = dict(lr=5.0)          # never read: the schedule sets the lr
    jcfg, cfg, jp, tp = _models("gpt2")
    jstep = jax.jit(JST.make_train_step(jcfg, JADAM.AdamWConfig(**ocfg),
                                        lr_schedule=sched_j))
    jo = JADAM.init_state(jp)
    to = opt_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    before = jp
    for seed in (11, 12, 13):
        jb, tb = _batch(cfg, seed)
        jp, jo, jm = jstep(jp, jo, jb)
        (loss, _), g = TST.value_and_grad(
            lambda p, b: TAPI.loss_fn(cfg, p, b), tp, tb)
        tp, to, tm = TADAM.apply_updates(TADAM.AdamWConfig(**ocfg), tp, g, to,
                                         lr=sched_t(to.step))
    _check_step((jp, jo, jm), (tp, to, {"loss": loss, **tm}), before)


def test_train_step_with_lamp_on_matches_jax():
    """use_lamp=True under a gradient: the PS(mu) rounding's bitcasts give
    a zero derivative in JAX (value_and_grad of round_to_mantissa is 0),
    and the port's int32 view carries none either, so the gradient flows
    through the FP32 logits the rule recomputes and the rest of the model.
    The strict rule at mu 4, g 1, as tests/test_torch_forward.py holds the
    whole model."""
    kq = dict(mu=4, tau=0.1, rule="strict", granularity=1)
    jcfg, cfg, jp, tp = _models("gpt2")
    jcfg = jcfg.replace(lamp=JaxPolicy.paper_default(**kq))
    cfg = cfg.replace(lamp=LampPolicy.paper_default(**kq))
    jo = JADAM.init_state(jp)
    to = opt_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    jstep = jax.jit(JST.make_train_step(jcfg, JADAM.AdamWConfig(lr=1e-3),
                                        use_lamp=True))
    jb, tb = _batch(cfg, 9)
    (loss, _), g = TST.value_and_grad(
        lambda p, b: TAPI.loss_fn(cfg, p, b, use_lamp=True), tp, tb)
    tp1, to1, tm = TADAM.apply_updates(TADAM.AdamWConfig(lr=1e-3), tp, g, to)
    _check_step(jstep(jp, jo, jb), (tp1, to1, {"loss": loss, **tm}), jp)
    # the recompute rate and the loss with LAMP on differ from LAMP off
    (_, jaux) = JAPI.loss_fn(jcfg, jp, jb, use_lamp=True)
    (_, taux) = TAPI.loss_fn(cfg, tp, tb, use_lamp=True)
    assert 0 < float(taux["attn_lamp_rate"]) < 1
    assert float(taux["attn_lamp_rate"]) == pytest.approx(
        float(jaux["attn_lamp_rate"]), abs=0.0)
    # the rounding passes no derivative, in both packages
    from repro.core.numerics import round_to_mantissa as jround
    from repro_torch.core.numerics import round_to_mantissa as tround
    x = np.asarray([1.1, -2.3, 0.7], np.float32)
    jg = jax.grad(lambda v: jnp.sum(jround(v, 4)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    assert not tround(xt, 4).requires_grad
    np.testing.assert_array_equal(np.asarray(jg), 0.0)


def test_prng_normal_matches_jax():
    for seed, shape in ((0, (3, 5, 7)), (5, (2, 16, 64)), (2**31 + 3, (1000,))):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(prng.PRNGKey(seed), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        d = got.numpy().view(np.int32).astype(np.int64) - \
            want.view(np.int32).astype(np.int64)
        assert np.abs(d).max() <= 3
    # its uniform, bit for bit
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (4096,),
                                       minval=lo, maxval=1.0))
    tu = prng.uniform(prng.PRNGKey(4), (4096,), lo)
    np.testing.assert_array_equal(tu.numpy().view(np.int32), ju.view(np.int32))
    # erf_inv's ends
    e = prng.erf_inv(torch.tensor([-1.0, 0.0, 1.0]))
    assert e[0] == -float("inf") and e[1] == 0 and e[2] == float("inf")


def test_opt_from_jax_carries_bfloat16_state_bit_for_bit():
    _, _, jparams, _ = _models("gpt2")
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    jo = JADAM.init_state(jp16)
    jo = jo._replace(m=jax.tree.map(lambda a: a.astype(jnp.bfloat16) + 1, jo.m))
    to = opt_from_jax(jax.tree.map(np.asarray, jo), device="cpu")
    assert to.step.dtype == torch.int32 and to.step.shape == ()
    for (_, w), g in zip(jax.tree_util.tree_flatten_with_path(jo.m)[0],
                         T.leaves(to.m)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    tp = params_from_jax(jax.tree.map(np.asarray, jp16), device="cpu")
    assert T.leaves(tp)[0].dtype == torch.bfloat16


def test_tokenizer_copy_matches_jax():
    docs = ["héllo", "", "LAMP: look-ahead mixed precision", "x" * 40]
    for d in docs:
        assert TTOK.encode(d) == JTOK.encode(d)
        assert TTOK.decode(TTOK.encode(d)) == JTOK.decode(JTOK.encode(d)) == d
    np.testing.assert_array_equal(TTOK.pack(docs, 8), JTOK.pack(docs, 8))
    assert (TTOK.BOS, TTOK.EOS, TTOK.PAD, TTOK.VOCAB) == \
        (JTOK.BOS, JTOK.EOS, JTOK.PAD, JTOK.VOCAB)


def test_training_entry_points_refuse_to_run_without_cuda(monkeypatch, tmp_path):
    """train, the CLI and make_train_step's parameters default to CUDA and
    raise without it: never a quiet fall back to the CPU."""
    from repro_torch.launch import train as TL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import train_loop as TLOOP
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("gpt2"))
    loop = TLOOP.TrainLoopConfig(total_steps=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLOOP.train(cfg, make_host_mesh(), loop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.main(["--arch", "gpt2", "--reduced", "--steps", "1",
                 "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TAPI.init_params(cfg, 0)
    assert not list(tmp_path.iterdir())
