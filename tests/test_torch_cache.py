"""The port's hard-negative cache (clip_dplm_tpu_torch: ops/infonce.py
`clip_loss(cache=...)` and `update_cache`, ops/fused_infonce.py
`fused_clip_loss(cache=...)`, the cache of train/state.py and
train/trainer.py, utils/convert.py `load_cache`) against the JAX package on
the same numpy inputs and weights: the loss and da, db, d(logit_scale) with a
partly filled cache (cache_len 20 of 48) at smoothing 0 and 0.1 against both
JAX routes (JAX suite's bounds: loss rtol 1e-5, gradients atol 1e-5 / rtol
1e-4); the ring's semantics over a fill, a full cache, a wrap and B = C;
three cached train steps (B=32, C=64: fill, full, wrap) with the fused and
the plain loss, one from a warm cache carried across, and the
grad-accumulation step whose cache takes the full batch; and the
`two_tower_optimized` preset through the train CLI for one epoch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu_torch.experiments import train as train_cli
from clip_dplm_tpu_torch.ops import fused_infonce as fi
from clip_dplm_tpu_torch.ops import infonce as inf
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_train_step, to_device
from clip_dplm_tpu_torch.utils.convert import load_cache
from test_torch_two_tower import SMALL, STEP, _batch, _pair, fused_jax  # noqa: F401

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PRESET = ["contrastive.use_cache=true", "contrastive.use_fused_kernel=true"]


def _loss_inputs(seed=0, B=32, D=16, C=48):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, D)).astype(np.float32)
    b = rng.normal(size=(B, D)).astype(np.float32)
    cache = np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(C, D)).astype(np.float32))))
    return a, b, cache, np.float32(2.0)


def _jax_loss(fn, a, b, cache, ls, cache_len, **kw):
    def f(a, b, ls):
        return fn(a, b, ls, cache=jnp.asarray(cache), cache_len=jnp.int32(cache_len), **kw)

    (loss, metrics), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ls))
    return float(loss), [np.asarray(x) for x in g], metrics


def _port_loss(fn, a, b, cache, ls, cache_len, **kw):
    ta, tb, tls = (torch.tensor(v, requires_grad=True) for v in (a, b, ls))
    loss, metrics = fn(ta, tb, tls, cache=torch.from_numpy(cache),
                       cache_len=torch.tensor(cache_len, dtype=torch.int32), **kw)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in (ta, tb, tls)], metrics


def _close(port, ref):
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
    for name, x, y in zip(("da", "db", "dlogit_scale"), port[1], ref[1]):
        np.testing.assert_allclose(x, y, err_msg=name, **GRAD_TOL)
    for k in ("loss_a", "loss_b", "logit_scale"):
        np.testing.assert_allclose(float(port[2][k].detach()), float(ref[2][k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cached_fused_clip_loss_matches_jax_fused(smoothing):
    a, b, cache, ls = _loss_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_loss(jfi.fused_clip_loss, a, b, cache, ls, 20, label_smoothing=smoothing)
    _close(_port_loss(fi.fused_clip_loss, a, b, cache, ls, 20, label_smoothing=smoothing), ref)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cached_losses_match_jax_plain(smoothing):
    """Both port routes against the JAX package's plain clip_loss; the plain
    route's accuracies too (taken over the widened logits)."""
    a, b, cache, ls = _loss_inputs(seed=1)
    ref = _jax_loss(jinf.clip_loss, a, b, cache, ls, 20, label_smoothing=smoothing)
    _close(_port_loss(fi.fused_clip_loss, a, b, cache, ls, 20, label_smoothing=smoothing), ref)
    plain = _port_loss(inf.clip_loss, a, b, cache, ls, 20, label_smoothing=smoothing)
    _close(plain, ref)
    for k in ("accuracy_a", "accuracy_b", "accuracy"):
        np.testing.assert_allclose(float(plain[2][k]), float(ref[2][k]), rtol=1e-6, err_msg=k)


def test_update_cache_matches_jax():
    """A fill, a full cache, a wrap (ptr resets to 0, the high-water mark
    stays) and B = C, against the JAX ring on the same rows."""
    rng = np.random.default_rng(2)
    C, D = 10, 4
    jc, jp, jf = jnp.zeros((C, D)), jnp.int32(0), jnp.int32(0)
    pc = torch.zeros(C, D)
    pp, pf = torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    for B in (4, 4, 4, 2, 10, 3):
        new = rng.normal(size=(B, D)).astype(np.float32)
        jc, jp, jf = jinf.update_cache(jc, jp, jnp.asarray(new), jf)
        pc, pp, pf = inf.update_cache(pc, pp, torch.from_numpy(new), pf)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        assert int(pp) == int(jp) and int(pf) == int(jf)
        assert pp.dtype == pf.dtype == torch.int32
    assert (int(pp), int(pf)) == (3, 10)
    with pytest.raises(ValueError, match="does not fit"):
        inf.update_cache(pc, pp, torch.zeros(C + 1, D), pf)


def _jax_state(jm, jcfg, params, batch):
    js = jax_create_train_state(jm, jcfg, jax.tree_util.tree_map(jnp.asarray, batch))
    return js.replace(params=params, opt_state=js.tx.init(params))


def _cached_steps(extra, batches, warm=None, cache_tol=1e-6):
    """Run the JAX and the port train step over `batches` from the same
    weights (and the same warm cache): the loss of every step, the cache
    rows, cache_ptr and cache_len after each."""
    jcfg, pcfg, jm, params, port = _pair(STEP + extra, jnp.float32, torch.float32)
    js = _jax_state(jm, jcfg, params, batches[0])
    pst = create_train_state(port, pcfg, init=False)
    if warm is not None:
        js = js.replace(cache=jnp.asarray(warm[0]), cache_ptr=jnp.int32(warm[1]),
                        cache_len=jnp.int32(warm[2]))
        load_cache(pst, *(np.asarray(getattr(js, k)) for k in ("cache", "cache_ptr",
                                                                 "cache_len")))
    jstep, pstep = jax.jit(jax_make_train_step(jcfg)), make_train_step(pcfg)
    seen = []
    for b in batches:
        js, jm_metrics = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm_metrics["loss"]), rtol=1e-4)
        assert int(pst.cache_ptr) == int(js.cache_ptr)
        assert int(pst.cache_len) == int(js.cache_len)
        np.testing.assert_allclose(pst.cache.numpy(), np.asarray(js.cache), rtol=0,
                                   atol=cache_tol)
        seen.append((int(pst.cache_ptr), int(pst.cache_len)))
    return seen


def test_three_cached_train_steps_match_jax_plain_loss():
    """The plain loss in f32: fill (ptr 32), full (ptr 0, len 64), wrap."""
    batches = [_batch(32, seed=s) for s in range(3)]
    seen = _cached_steps(["contrastive.use_cache=true", "contrastive.cache_size=64"], batches)
    assert seen == [(32, 32), (0, 64), (32, 64)]


def test_three_cached_train_steps_match_jax_fused_loss(fused_jax):
    """The fused loss (bf16 similarity operands on both sides). The first
    step's cache rows come from equal weights; the later ones from weights
    after Adam steps, which the bf16 operands let drift (a near-zero
    gradient whose sign differs moves a leaf by +-lr, test_torch_two_tower.py),
    so the unit cache rows are held to 1e-5 (6e-7 seen)."""
    batches = [_batch(32, seed=s) for s in range(3)]
    seen = _cached_steps(PRESET + ["contrastive.cache_size=64"], batches, cache_tol=1e-5)
    assert seen == [(32, 32), (0, 64), (32, 64)]


def test_cached_train_step_from_a_warm_cache_matches_jax(fused_jax):
    """A partly filled cache (40 of 64 rows, ptr 40) carried across with
    load_cache: the step reads its 40 rows, then 40 + 32 > 64 resets ptr to
    0 and the high-water mark stays at 40 until the next step passes it."""
    rng = np.random.default_rng(3)
    warm = np.zeros((64, 128), np.float32)
    warm[:40] = np.asarray(jinf.l2_normalize(jnp.asarray(
        rng.normal(size=(40, 128)).astype(np.float32))))
    seen = _cached_steps(PRESET + ["contrastive.cache_size=64"],
                         [_batch(32, seed=s) for s in range(2)], warm=(warm, 40, 40),
                         cache_tol=1e-5)
    assert seen == [(32, 40), (0, 64)]


def test_grad_accumulation_cache_takes_the_full_batch():
    """grad_accum_steps=2: both micro-batches read the old cache, and the
    cache then takes both micro-batches' emb_b in order (64 rows)."""
    seen = _cached_steps(["contrastive.use_cache=true", "contrastive.cache_size=128",
                          "train.optim.grad_accum_steps=2"],
                         [_batch(64, seed=s) for s in range(2)])
    assert seen == [(64, 64), (0, 128)]


def test_cache_exists_only_with_use_cache():
    _, pcfg, _, _, port = _pair(STEP, jnp.float32, torch.float32)
    st = create_train_state(port, pcfg, init=False)
    assert st.cache is None and st.cache_ptr is None and st.cache_len is None
    with pytest.raises(ValueError, match="no hard-negative cache"):
        load_cache(st, np.zeros((4, 128)), 0, 0)


def test_train_cli_one_epoch_two_tower_optimized_preset(capsys, tmp_path):
    hist = train_cli.main(["--device", "cpu", "--epochs", "1",
                           *sum((["-o", o] for o in SMALL + PRESET), []),
                           "-o", "train.batch_size=128", "-o", f"logging.log_dir={tmp_path}"])
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    assert np.isfinite(hist["val_loss"][0])
    assert '"done": true' in capsys.readouterr().out
