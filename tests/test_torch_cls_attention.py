"""The port's CLS-query attention (clip_dplm_tpu_torch/ops/short_attention.py::
fused_cls_attention and ops/attention.py::cls_query_attention) against the
JAX package: the JAX kernel `fused_cls_attention` in Pallas interpret mode
and its XLA formulation `cls_query_attention`, on the same numpy inputs, in
f32 (values atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3, the JAX
suite's bounds). In f32 the kernel's f32 probabilities and the XLA
formulation's probabilities, rounded to the input dtype, agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.attention import cls_query_attention as jax_cls_query
from clip_dplm_tpu.ops.short_attention import fused_cls_attention as jax_fused_cls
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.attention import cls_query_attention

VAL = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-3)


def _inputs(rng, B, S, D, masked):
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    ct = rng.normal(size=(B, 1, D)).astype(np.float32)
    return qkv, mask if masked else None, ct


def _torch_value_and_grad(fn, qkv, mask, ct, H):
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    out = fn(leaf, H, mask=None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)), leaf)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_matches_jax_kernel_and_xla_formulation(rng, masked):
    """B=4, S=128, D=64, 4 heads: the plain version (autograd), the wrapper
    (its Function: the plain forward and the plain recompute backward) and
    the port's cls_query_attention, against the JAX kernel and its XLA
    formulation."""
    B, S, D, H = 4, 128, 64, 4
    qkv, mask, ct = _inputs(rng, B, S, D, masked)
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_cls(jnp.asarray(qkv), H, mask=jm, block_b=2, interpret=True)
        want_g = jax.grad(lambda x: jnp.sum(jax_fused_cls(
            x, H, mask=jm, block_b=2, interpret=True) * ct))(jnp.asarray(qkv))
    want_x = jax_cls_query(jnp.asarray(qkv), H, mask=jm)
    want_xg = jax.grad(lambda x: jnp.sum(jax_cls_query(x, H, mask=jm) * ct))(jnp.asarray(qkv))
    for fn in (sa.fused_cls_attention_reference, sa.fused_cls_attention, cls_query_attention):
        got, got_g = _torch_value_and_grad(fn, qkv, mask, ct, H)
        assert got.shape == (B, 1, D)
        np.testing.assert_allclose(got, np.asarray(want), **VAL, err_msg=fn.__name__)
        np.testing.assert_allclose(got, np.asarray(want_x), **VAL, err_msg=fn.__name__)
        np.testing.assert_allclose(got_g, np.asarray(want_g), **GRAD, err_msg=fn.__name__)
        np.testing.assert_allclose(got_g, np.asarray(want_xg), **GRAD, err_msg=fn.__name__)
    assert not np.any(got_g[:, 1:, :D])  # only row 0 of the q part carries gradient


def test_ragged_batch_matches_jax_kernel(rng):
    """B=3 against the JAX kernel's 2-row programs (it pads the batch), S=64."""
    B, S, D, H = 3, 64, 32, 2
    qkv, mask, ct = _inputs(rng, B, S, D, True)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_cls(jnp.asarray(qkv), H, mask=jnp.asarray(mask), block_b=2,
                             interpret=True)
        want_g = jax.grad(lambda x: jnp.sum(jax_fused_cls(
            x, H, mask=jnp.asarray(mask), block_b=2, interpret=True) * ct))(jnp.asarray(qkv))
    got, got_g = _torch_value_and_grad(sa.fused_cls_attention, qkv, mask, ct, H)
    np.testing.assert_allclose(got, np.asarray(want), **VAL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_bwd_reference_matches_autograd_and_counts_nothing(rng, masked):
    """The plain recompute backward equals autograd through the plain
    forward, with a fully masked row; CPU tensors launch nothing."""
    B, S, D, H = 3, 65, 64, 4
    qkv, mask, ct = _inputs(rng, B, S, D, masked)
    if mask is not None:
        mask[-1] = False
    before = _build.LAUNCHES.snapshot()
    _, want = _torch_value_and_grad(sa.fused_cls_attention_reference, qkv, mask, ct, H)
    got = sa.fused_cls_attention_bwd(torch.from_numpy(ct), torch.from_numpy(qkv), H,
                                     mask=None if mask is None else torch.from_numpy(mask))
    assert _build.LAUNCHES.snapshot() == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
