"""The saved-raw schedule of the port's symmetric InfoNCE
(clip_dplm_tpu_torch/ops/fused_infonce.py: the int16 raw the forward saves
and the backward from it) against the JAX package's
(`_sym_row_col_lse(save_raw=True)`, `_sym_grad_passes_from_raw` with the
merged and the two-pass kernels, Pallas in interpret mode) on the same numpy
inputs: the forward's lse (rtol 1e-5) and int16 raw (|dq| <= 1, where the
two f32 sums round to either side of a half), the backward from the same
raw and lse (atol = rtol = 1e-4, JAX's own bound), the whole loss and its
gradients (loss rtol 1e-5; gradients atol 1e-5, rtol 1e-4), the saved
schedule against the recompute one at JAX's bounds (the loss equal bit for
bit), `fused_clip_loss` / `fused_multiway_clip_loss` at their defaults,
`_resolve_materialize`, and one two-tower train step "auto" against
"never"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.experiments.registry import build_model
from clip_dplm_tpu_torch.ops import fused_infonce as fi
from clip_dplm_tpu_torch.ops.fused_dense import DropoutSeeds
from clip_dplm_tpu_torch.train.state import create_train_state
from clip_dplm_tpu_torch.train.trainer import make_eval_step, make_loss_fn

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
MAX_SCALE = 100.0  # the logit_scale_max clamp


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(B=136, D=48, seed=0):
    rng = np.random.default_rng(seed)
    return _unit(rng, B, D), _unit(rng, B, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_save_matches_jax(dtype):
    a, b = _pair()
    scale = np.float32(np.exp(2.6592))
    jdt = None if dtype == "float32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        lse_row, lse_col, raw_q = jfi._sym_row_col_lse(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale), dot_dtype=jdt, save_raw=True)
    tdt = getattr(torch, dtype)
    got = fi._plain_lse_save(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
                             torch.tensor([scale]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(lse_row)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(lse_col)[:, 0], rtol=1e-5)
    want_q = np.asarray(raw_q)[:136, :136].astype(np.int32)
    assert got[2].dtype == torch.int16 and got[2].shape == (136, 136)
    assert np.abs(got[2].numpy().astype(np.int32) - want_q).max() <= 1
    # the lse equal those of the recompute forward, bit for bit
    plain = fi._plain_lse(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
                          torch.tensor([scale]))
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


@pytest.mark.parametrize("merged", ["0", "1"])
@pytest.mark.parametrize("shape", [(48, 256, 16, 128), (40, 300, 16, 128)])
def test_grad_from_raw_matches_jax(monkeypatch, shape, merged):
    """JAX's merged (CLIP_DPLM_LOSS_MERGED=1) and two-pass (=0) backward on a
    multi-tile grid, padded rows and columns included, against the port's
    plain from-raw version on the same raw and lse."""
    m, n, block_m, block_n = shape
    rng = np.random.default_rng(1)
    a, b = _unit(rng, m, 32), _unit(rng, n, 32)
    mp, np_ = jfi._round_up(m, block_m), jfi._round_up(n, block_n)
    raw_q = np.zeros((mp, np_), np.int16)
    raw_q[:m, :n] = np.round(a @ b.T * jfi.RAW_QSCALE).astype(np.int16)
    s = raw_q[:m, :n].astype(np.float32) * np.float32(7.0 / jfi.RAW_QSCALE)
    lse_row = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    lse_col = np.log(np.exp(s - s.max(0, keepdims=True)).sum(0)) + s.max(0)
    monkeypatch.setenv("CLIP_DPLM_LOSS_MERGED", merged)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *xs: jfi._sym_grad_passes_from_raw(
            *xs, block_m=block_m, block_n=block_n))(
            jnp.asarray(raw_q), jnp.asarray(a), jnp.asarray(b), jnp.float32(7.0),
            jnp.asarray(lse_row[:, None]), jnp.asarray(lse_col[:, None]))
    jax.clear_caches()  # the env is read at trace time
    got = fi._plain_grad_from_raw(torch.from_numpy(raw_q[:m, :n]), torch.from_numpy(a),
                                  torch.from_numpy(b), torch.tensor([7.0]),
                                  torch.from_numpy(lse_row), torch.from_numpy(lse_col))
    for g, w, name in zip(got, (want[0], np.asarray(want[1])[:, 0], want[2]),
                          ("acc_a", "rowdot", "acc_b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=name)


def _port_sym(a, b, scale, materialize_raw):
    ta, tb, ts = (torch.tensor(v, requires_grad=True) for v in (a, b, scale))
    loss = fi.fused_symmetric_infonce(ta, tb, ts, None, materialize_raw)
    loss.backward()
    return loss.detach(), [t.grad.numpy() for t in (ta, tb, ts)]


@pytest.mark.parametrize("scale", [float(np.exp(2.6592)), MAX_SCALE])
def test_saved_symmetric_infonce_matches_jax(scale):
    a, b = _pair(seed=2)
    scale = np.float32(scale)

    def loss(a, b, s):
        return jfi.fused_symmetric_infonce(a, b, s, None, True)

    with pltpu.force_tpu_interpret_mode():
        want, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale))
    got, got_grads = _port_sym(a, b, scale, True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for g, w, name in zip(got_grads, grads, ("da", "db", "dscale")):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("scale", [float(np.exp(2.6592)), MAX_SCALE])
def test_saved_matches_recompute(scale):
    """JAX's bounds for the int16 raw's effect (test_fused_infonce.py: atol
    2e-4, rtol 1e-3 at the init scale; 1 % relative L2 at the clamp); the
    forward is the same, so the loss is equal bit for bit."""
    a, b = _pair(seed=3)
    loss_s, grads_s = _port_sym(a, b, np.float32(scale), True)
    loss_r, grads_r = _port_sym(a, b, np.float32(scale), False)
    assert torch.equal(loss_s, loss_r)
    for s, r, name in zip(grads_s, grads_r, ("da", "db", "dscale")):
        if scale == MAX_SCALE:
            rel = np.linalg.norm(s - r) / max(np.linalg.norm(r), 1e-12)
            assert rel < 1e-2, f"{name} rel L2 {rel:.2e} at the clamp"
        else:
            np.testing.assert_allclose(s, r, atol=2e-4, rtol=1e-3, err_msg=name)


def _value_and_grads(port_fn, jax_fn, args, smoothing):
    """(port loss, port grads), (JAX loss, JAX grads) of fn(*args, ls)."""
    targs = [torch.tensor(v, requires_grad=True) for v in args]
    loss = port_fn(*targs, smoothing)
    loss.backward()
    with pltpu.force_tpu_interpret_mode():
        want, grads = jax.value_and_grad(
            lambda *xs: jax_fn(*xs, smoothing), argnums=tuple(range(len(args))))(
            *(jnp.asarray(v) for v in args))
    return ((float(loss.detach()), [t.grad.numpy() for t in targs]),
            (float(want), [np.asarray(g) for g in grads]))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_clip_loss_defaults_match_jax(smoothing):
    """Both at their defaults: "auto" saves the raw at B=136."""
    a, b = _pair(seed=4)
    ls = np.float32(2.3)
    got, want = _value_and_grads(
        lambda a, b, ls, sm: fi.fused_clip_loss(a, b, ls, label_smoothing=sm)[0],
        lambda a, b, ls, sm: jfi.fused_clip_loss(a, b, ls, label_smoothing=sm)[0],
        (a, b, ls), smoothing)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w, name in zip(got[1], want[1], ("da", "db", "dlogit_scale")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_multiway_clip_loss_defaults_match_jax(smoothing):
    rng = np.random.default_rng(5)
    embs = [rng.normal(size=(48, 24)).astype(np.float32) for _ in range(3)]
    names = ("cell", "pert", "protein")

    def port(c, p, pr, ls, sm):
        return fi.fused_multiway_clip_loss(dict(zip(names, (c, p, pr))), ls,
                                           label_smoothing=sm)[0]

    def ref(c, p, pr, ls, sm):
        return jfi.fused_multiway_clip_loss(dict(zip(names, (c, p, pr))), ls,
                                            label_smoothing=sm)[0]

    got, want = _value_and_grads(port, ref, (*embs, np.float32(2.0)), smoothing)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w, name in zip(got[1], want[1], ("dcell", "dpert", "dprot", "dls")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("mode,rows,want", [
    ("auto", 18317, True), ("auto", 18318, False), ("always", 10 ** 6, True),
    ("never", 8, False), ("sometimes", 8, False), (True, 10 ** 6, True), (False, 8, False)])
def test_resolve_materialize(mode, rows, want):
    """JAX's rule: "auto" while rows * cols * 2 bytes <= 640 MiB (up to
    B = 18317 square), "always", any other string never, a bool as given."""
    assert fi._resolve_materialize(mode, rows, rows) is want
    assert jfi._resolve_materialize(mode, rows, rows) is want


def _refuse_save(*args):
    raise AssertionError("the raw similarity was saved")


def test_cache_branch_saves_no_raw(monkeypatch):
    """The cache path (row cross-entropies) never saves the raw, whatever
    materialize_raw says, as in the reference."""
    monkeypatch.setattr(fi, "_plain_lse_save", _refuse_save)
    a, b = _pair(B=16, D=8, seed=6)
    cache = torch.from_numpy(_unit(np.random.default_rng(7), 32, 8))
    loss, _ = fi.fused_clip_loss(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(2.0),
                                 cache=cache, cache_len=torch.tensor(20, dtype=torch.int32),
                                 materialize_raw="always")
    assert torch.isfinite(loss)


# a two-tower model small enough for the CPU, every Dense+LN block and the loss fused
SMALL = ["tower_a.input_dim=24", "tower_a.hidden_size=64", "tower_a.num_hidden_layers=2",
         "tower_b.input_dim=40", "tower_b.hidden_size=64", "tower_b.num_hidden_layers=2",
         "projection.dim=32", "projection.hidden_dim=64", "train.batch_size=64",
         "tower_a.fused_dense=true", "tower_b.fused_dense=true", "projection.fused_dense=true",
         "contrastive.use_fused_kernel=true"]


def _small_batch(B=64, seed=8):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(B, 24)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(B, 40)).astype(np.float32))}


def test_eval_step_saves_no_raw(monkeypatch):
    cfg = pconfig.apply_overrides(pconfig.Config(), SMALL)
    model = build_model(cfg)
    state = create_train_state(model, cfg)
    monkeypatch.setattr(fi, "_plain_lse_save", _refuse_save)
    assert torch.isfinite(make_eval_step(cfg)(state, _small_batch())["loss"])


def test_two_tower_step_auto_matches_never():
    """The train path's fused loss with the saved raw ("auto", B=64) against
    the recompute schedule ("never") from the same weights, batch and dropout
    seeds: the same loss bit for bit (the forward is the same), every leaf's
    gradient within 1 % relative L2 (JAX's bound for the int16 raw at the
    clamp)."""
    grads, losses = {}, {}
    for mode in ("auto", "never"):
        cfg = pconfig.apply_overrides(pconfig.Config(),
                                      SMALL + [f"contrastive.fused_materialize_raw={mode}"])
        torch.manual_seed(0)
        model = build_model(cfg)
        state = create_train_state(model, cfg)
        loss, _ = make_loss_fn(cfg)(model, _small_batch(), DropoutSeeds(state.key, 0))
        loss.backward()
        losses[mode] = loss.detach()
        grads[mode] = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert torch.equal(losses["auto"], losses["never"])
    for k, g in grads["never"].items():
        rel = ((grads["auto"][k] - g).norm() / g.norm().clamp(min=1e-12)).item()
        assert rel < 1e-2, f"{k}: rel L2 {rel:.2e}"
