"""The port's symmetric InfoNCE (clip_dplm_tpu_torch/ops/infonce.py and
ops/fused_infonce.py) against the JAX package on the same numpy embeddings
at B=136, d=48: the loss and da, db, d(logit_scale) of `fused_clip_loss` /
`fused_symmetric_infonce` (Pallas in interpret mode) and of the plain
`infonce.clip_loss`, with and without label smoothing, at the JAX suite's
bounds (loss rtol 1e-5, gradients atol 1e-5 / rtol 1e-4), and the bf16 dot
dtype of the train path at the bf16 bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu_torch.ops import fused_infonce as fi
from clip_dplm_tpu_torch.ops import infonce as inf

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _pair(B=136, D=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32), np.float32(2.3))


def _port(fn, a, b, ls, **kw):
    ta, tb, tls = (torch.tensor(v, requires_grad=True) for v in (a, b, ls))
    loss, metrics = fn(ta, tb, tls, **kw)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in (ta, tb, tls)], metrics


def _jax(fn, a, b, ls, **kw):
    def f(a, b, ls):
        return fn(a, b, ls, **kw)

    (loss, metrics), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ls))
    return float(loss), [np.asarray(x) for x in g], metrics


def _close(port, ref, loss_rtol=1e-5, tol=GRAD_TOL):
    np.testing.assert_allclose(port[0], ref[0], rtol=loss_rtol)
    for name, x, y in zip(("da", "db", "dlogit_scale"), port[1], ref[1]):
        np.testing.assert_allclose(x, y, err_msg=name, **tol)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_clip_loss_matches_jax_fused(smoothing):
    """Both at their defaults: "auto" saves the int16 raw on both sides."""
    a, b, ls = _pair()
    with pltpu.force_tpu_interpret_mode():
        ref = _jax(jfi.fused_clip_loss, a, b, ls, label_smoothing=smoothing)
    port = _port(fi.fused_clip_loss, a, b, ls, label_smoothing=smoothing)
    _close(port, ref)
    assert sorted(port[2]) == sorted(ref[2]) == ["logit_scale", "loss_a", "loss_b"]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_fused_and_plain_losses_match_jax_plain(smoothing):
    """The plain loss and the fused one's recompute schedule (exact f32
    similarity; the saved int16 raw is held to JAX's own saved path in
    test_torch_saved_raw.py)."""
    a, b, ls = _pair(seed=1)
    ref = _jax(jinf.clip_loss, a, b, ls, label_smoothing=smoothing)
    _close(_port(inf.clip_loss, a, b, ls, label_smoothing=smoothing), ref)
    _close(_port(fi.fused_clip_loss, a, b, ls, label_smoothing=smoothing,
                 materialize_raw="never"), ref)
    port_metrics = _port(inf.clip_loss, a, b, ls, label_smoothing=smoothing)[2]
    for k in ("accuracy", "loss_a", "loss_b", "logit_scale"):
        np.testing.assert_allclose(float(port_metrics[k].detach()), float(ref[2][k]), rtol=1e-5)


def test_symmetric_infonce_bf16_dot_matches_jax():
    """The train path's dot dtype: both sides round a, b and p to bf16."""
    a, b, _ = _pair(seed=2)
    a = np.asarray(jinf.l2_normalize(jnp.asarray(a)))
    b = np.asarray(jinf.l2_normalize(jnp.asarray(b)))
    scale = np.float32(np.exp(2.6592))

    def jf(a, b, s):
        return jfi.fused_symmetric_infonce(a, b, s, jnp.bfloat16, False), {}

    with pltpu.force_tpu_interpret_mode():
        ref = _jax(jf, a, b, scale)
    port = _port(lambda a, b, s: (fi.fused_symmetric_infonce(a, b, s, torch.bfloat16), {}),
                 a, b, scale)
    _close(port, ref, loss_rtol=1e-4, tol=dict(atol=1e-4, rtol=1e-3))


def test_scale_clamp_has_zero_gradient_above_max():
    a, b, _ = _pair(B=16, D=8)
    _, grads, metrics = _port(fi.fused_clip_loss, a, b, np.float32(5.0))
    assert float(metrics["logit_scale"].detach()) == 100.0
    assert grads[2] == 0.0


def test_reference_matches_and_rejects():
    a, b, _ = _pair(B=16, D=8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s = torch.tensor(3.0)
    assert torch.equal(fi.fused_symmetric_infonce(ta, tb, s),
                       fi.fused_symmetric_infonce_reference(ta, tb, s))
    with pytest.raises(ValueError):
        fi.fused_symmetric_infonce(ta, tb[:8], s)
    with pytest.raises(ValueError, match="no kernel"):
        fi.fused_symmetric_infonce(ta.to("meta"), tb.to("meta"), s.to("meta"))
