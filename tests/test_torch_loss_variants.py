"""The port's contrastive loss variants (clip_dplm_tpu_torch/ops/
loss_variants.py) and the train step's dispatch on contrastive.loss_kind
(train/trainer.py) against the JAX package on the same numpy inputs and
weights, in f32:

- supcon_loss, supcon_pair_loss, flatnce_loss and siglip_loss (with and
  without a logit bias) on seeded inputs at B=32, d=16: value rtol 1e-5,
  every gradient atol 1e-5 / rtol 1e-4; FlatNCE's value is 1.
- A small two-tower under each loss_kind (flatnce, siglip, supcon with
  labels in the batch, and an unknown kind, which trains InfoNCE in both
  packages): every leaf's gradient of the first step before the optimizer
  within the larger of 1e-4 of the leaf's largest entry (as
  test_torch_tf_clip.py holds them) and 3x the leaf's own f32 noise (the
  port in f32 against an f64 copy: the b head's layer_scale, one sum that
  cancels before the L2 norm, is 4.8e-5 off f64 under siglip and 1.2e-4
  off JAX), then three train steps' losses and
  metrics (rtol 1e-4); with the hard-negative cache under flatnce, the
  cache rows the steps write (atol 1e-6); supcon without labels raises
  JAX's message.
- The faults this slice repairs: tf_clip under loss_kind=siglip trains as
  JAX's (the multiway loss ignores the kind), and the eval step under every
  variant computes InfoNCE as JAX's (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.ops import loss_variants as jlv
from clip_dplm_tpu.train import create_train_state as jax_create_train_state
from clip_dplm_tpu.train import make_eval_step as jax_make_eval_step
from clip_dplm_tpu.train import make_train_step as jax_make_train_step
from clip_dplm_tpu.train import trainer as jtrainer
from clip_dplm_tpu.models import tf_clip as jtf
from clip_dplm_tpu_torch.ops import loss_variants as plv
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train import trainer as ptrainer
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_eval_step, make_train_step, to_device
from clip_dplm_tpu_torch.models.clip import TwoTowerCLIP
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params
from test_torch_cache import _cached_steps
from test_torch_tf_clip import (
    STEP as TF_STEP,
    _NoDropoutEncoder,
    _batch as _tf_batch,
    _jnp,
    _no_block_dropout,
    _pair as _tf_pair,
)
from test_torch_two_tower import STEP, _batch, _pair

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for these small CPU ops (the suite runs six xdist
    workers on the host's cores; a probe's 80 steps took 2x as long on
    eight threads as on one, alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, B=32, d=16):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, d)).astype(np.float32)
    b = (a + rng.normal(size=(B, d))).astype(np.float32)
    labels = rng.integers(0, 5, B).astype(np.int32)
    return a, b, labels, np.float32(2.3)


def _both(jfn, pfn, arrays, extra=()):
    """(JAX value, metrics, grads) and the port's, gradients over `arrays`."""
    def jf(*xs):
        out = jfn(*xs, *[jnp.asarray(e) for e in extra])
        return out if isinstance(out, tuple) else (out, {})

    (jv, jm), jg = jax.value_and_grad(jf, argnums=tuple(range(len(arrays))), has_aux=True)(
        *[jnp.asarray(x) for x in arrays])
    leaves = [torch.tensor(x, requires_grad=True) for x in arrays]
    out = pfn(*leaves, *[torch.as_tensor(np.asarray(e)) for e in extra])
    pv, pm = out if isinstance(out, tuple) else (out, {})
    pv.backward()
    return (float(jv), jm, [np.asarray(g) for g in jg]), (float(pv.detach()), pm,
                                                           [t.grad.numpy() for t in leaves])


def _close(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(float(got[1][k].detach()), float(want[1][k]), rtol=1e-5,
                                   err_msg=k)
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        np.testing.assert_allclose(g, w, err_msg=f"grad {i}", **GRAD_TOL)


def test_supcon_loss_matches_jax():
    a, _, labels, _ = _inputs()
    want, got = _both(lambda e, lab: jlv.supcon_loss(e, lab, 0.1),
                      lambda e, lab: plv.supcon_loss(e, lab, 0.1), [a], extra=[labels])
    _close(want, got)


def test_supcon_pair_loss_matches_jax():
    a, b, labels, ls = _inputs(1)
    want, got = _both(lambda x, y, s, lab: jlv.supcon_pair_loss(x, y, lab, s),
                      lambda x, y, s, lab: plv.supcon_pair_loss(x, y, lab, s), [a, b, ls],
                      extra=[labels])
    _close(want, got)
    assert set(got[1]) == {"logit_scale"}


def test_flatnce_loss_matches_jax():
    a, b, _, ls = _inputs(2)
    want, got = _both(jlv.flatnce_loss, plv.flatnce_loss, [a, b, ls])
    _close(want, got)
    assert got[0] == pytest.approx(1.0, abs=1e-6)  # the surrogate's value
    assert set(got[1]) == {"infonce_monitor", "logit_scale"}
    assert float(got[1]["infonce_monitor"].detach()) > 0


@pytest.mark.parametrize("bias", [None, np.float32(-10.0)])
def test_siglip_loss_matches_jax(bias):
    a, b, _, ls = _inputs(3)
    if bias is None:
        want, got = _both(jlv.siglip_loss, plv.siglip_loss, [a, b, ls])
    else:  # the bias is differentiated too
        want, got = _both(jlv.siglip_loss, plv.siglip_loss, [a, b, ls, bias])
    _close(want, got)
    assert set(got[1]) == {"accuracy", "logit_scale"}


def _port_grads(pcfg, model, batch, dtype):
    b = {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
         for k, v in batch.items()}
    loss, _ = ptrainer._pair_loss_fn(pcfg)(model, b, DropoutSeeds(0, 0))
    loss.backward()
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def _grads_of_first_step(jcfg, pcfg, jm, params, port, batch):
    """Every leaf's gradient of the trainers' losses before the optimizer,
    within the larger of 1e-4 of the leaf's largest entry and 3x the leaf's
    own f32 rounding noise (the port in f32 against an f64 copy)."""
    jloss = jtrainer._pair_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batch)))
    got = _port_grads(pcfg, port, batch, torch.float32)
    f64 = _port_grads(pcfg, load_flax_params(TwoTowerCLIP(pcfg, dtype=torch.float64),
                                             params).double(), batch, torch.float64)
    for k, g in got.items():
        w = want[k].numpy()
        noise = np.abs(g - f64[k]).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=max(1e-4 * np.abs(w).max(), 3 * noise),
                                   err_msg=k)


def _labelled(n, seed):
    b = _batch(n, seed)
    b["labels"] = np.random.default_rng(100 + seed).integers(0, 4, n).astype(np.int32)
    return b


@pytest.mark.parametrize("kind", ["flatnce", "siglip", "supcon", "no_such_kind"])
def test_train_steps_under_each_loss_kind_match_jax(kind):
    jcfg, pcfg, jm, params, port = _pair(STEP + [f"contrastive.loss_kind={kind}"],
                                         jnp.float32, torch.float32)
    batches = [_labelled(32, s) for s in range(3)]
    _grads_of_first_step(jcfg, pcfg, jm, params, port, batches[0])
    js = jax_create_train_state(jm, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    jstep, pstep = jax.jit(jax_make_train_step(jcfg)), make_train_step(pcfg)
    pst = create_train_state(port, pcfg, init=False)
    for b in batches:
        js, jmetrics = jstep(js, _jnp(b))
        pst, pm = pstep(pst, to_device(b, "cpu"))
        assert set(pm) == set(jmetrics), (set(pm), set(jmetrics))
        for k in jmetrics:
            np.testing.assert_allclose(float(pm[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    if kind == "flatnce":
        assert float(pm["loss"]) == pytest.approx(1.0, abs=1e-6)
    if kind == "no_such_kind":  # InfoNCE's metrics
        assert {"loss_a", "loss_b", "accuracy"} <= set(pm)


def test_flatnce_writes_the_cache_as_jax():
    """The variants read no cache, but the step writes the batch's
    normalized emb_b into it: fill, full, wrap, as JAX's."""
    seen = _cached_steps(["contrastive.loss_kind=flatnce", "contrastive.use_cache=true",
                          "contrastive.cache_size=64"], [_batch(32, seed=s) for s in range(3)])
    assert seen == [(32, 32), (0, 64), (32, 64)]


def test_supcon_without_labels_raises_as_jax():
    jcfg, pcfg, jm, params, port = _pair(STEP + ["contrastive.loss_kind=supcon"],
                                         jnp.float32, torch.float32)
    with pytest.raises(ValueError, match="supcon loss requires `labels` in the batch"):
        jtrainer._pair_loss_fn(jcfg)(params, jm.apply, _jnp(_batch(32)),
                                     jax.random.PRNGKey(0), None, None)
    with pytest.raises(ValueError, match="supcon loss requires `labels` in the batch"):
        ptrainer._pair_loss_fn(pcfg)(port, to_device(_batch(32), "cpu"), DropoutSeeds(0, 0))


@pytest.mark.parametrize("kind", ["flatnce", "siglip", "supcon"])
def test_eval_step_under_each_variant_matches_jax(kind):
    """The eval step computes InfoNCE whatever the kind (it raised before)."""
    jcfg, pcfg, jm, params, port = _pair(STEP + [f"contrastive.loss_kind={kind}"],
                                         jnp.float32, torch.float32)
    batch = _batch(32, seed=7)
    js = jax_create_train_state(jm, jcfg, _jnp(batch)).replace(params=params)
    want = jax.jit(jax_make_eval_step(jcfg))(js, _jnp(batch))
    got = make_eval_step(pcfg)(create_train_state(port, pcfg, init=False),
                               to_device(batch, "cpu"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_tf_clip_under_siglip_matches_jax(monkeypatch):
    """The multiway loss ignores loss_kind in both packages (the port raised
    before): every leaf's first-step gradient at 1e-4 of its largest entry,
    the eval step's metrics at rtol 1e-5; the port's train step runs, its
    loss the loss whose gradient was held."""
    monkeypatch.setattr(jtf, "_Encoder", _NoDropoutEncoder)
    jcfg, pcfg, jm, params, port = _tf_pair(jnp.float32, torch.float32,
                                            TF_STEP + ["contrastive.loss_kind=siglip"])
    _no_block_dropout(port)
    batches = [_tf_batch(seed=s) for s in range(2)]
    jloss = jtrainer._multiway_loss_fn(jcfg)
    want = flax_to_state_dict(jax.jit(jax.grad(lambda p, b: jloss(
        p, jm.apply, b, jax.random.PRNGKey(0), None, None)[0]))(params, _jnp(batches[0])))
    loss, _ = ptrainer.make_loss_fn(pcfg)(port, to_device(batches[0], "cpu"),
                                          DropoutSeeds(0, 0))
    loss.backward()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
        p.grad = None
    js = jax_create_train_state(jm, jcfg, _jnp(batches[0]))
    js = js.replace(params=params, opt_state=js.tx.init(params))
    pst = create_train_state(port, pcfg, init=False)
    jeval = jax.jit(jax_make_eval_step(jcfg))(js, _jnp(batches[1]))
    peval = make_eval_step(pcfg)(pst, to_device(batches[1], "cpu"))
    assert set(peval) == set(jeval)
    for k in jeval:
        np.testing.assert_allclose(float(peval[k]), float(jeval[k]), rtol=1e-5, err_msg=k)
    # the port's train step runs (it raised here before)
    pst, pm = make_train_step(pcfg)(pst, to_device(batches[0], "cpu"))
    np.testing.assert_allclose(float(pm["loss"]), float(loss.detach()), rtol=1e-6)
