"""The port's flash attention backward (clip_dplm_tpu_torch/ops/
flash_attention.py): the CPU path's autograd gradients and
`flash_attention_bwd_reference`, the plain version the CUDA backward kernels
are held to, against the JAX package's `flash_attention` gradients run in
Pallas interpret mode, on the same numpy inputs in f32: B=1, H=2, S=300 (no
multiple of 64), Dh=32, with a ragged mask and without, at atol = rtol =
5e-4 (tests/test_flash_attention.py's gradient bound). Rows whose keys are
all masked are left out: their lse rounds to -1e30, so both backward
kernels take p = 1 per key there, not the forward's 1/Sk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.flash_attention import flash_attention as jax_flash
from clip_dplm_tpu_torch.ops.attention import attention_reference
from clip_dplm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_lse_reference,
)

TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(rng, B=1, H=2, S=300, Dh=32, masked=True):
    q, k, v, ct = (rng.normal(size=(B, H, S, Dh)).astype(np.float32) for _ in range(4))
    mask = np.arange(S)[None, :] < np.array([211])[:B] if masked else None
    return q, k, v, ct, mask


@pytest.mark.parametrize("masked", [True, False])
def test_flash_backward_matches_jax_interpret(rng, masked):
    q, k, v, ct, mask = _inputs(rng, masked=masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(*a):
        return jnp.sum(jax_flash(*a, mask=jmask) * ct)

    with pltpu.force_tpu_interpret_mode():  # the backward's calls are traced in jax.grad
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = flash_attention(*leaves, mask=tmask)
    out.backward(torch.from_numpy(ct))
    lse = flash_lse_reference(leaves[0].detach(), leaves[1].detach(), tmask)
    plain = flash_attention_bwd_reference(*(t.detach() for t in leaves), tmask, out.detach(),
                                          lse, torch.from_numpy(ct))
    for name, t, p, w in zip("qkv", leaves, plain, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=f"autograd d{name}",
                                   **TOL)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), err_msg=f"plain d{name}", **TOL)


def test_flash_lse_matches_jax_forward_stats(rng):
    """The plain lse equals the TPU forward's m + log(max(l, 1e-30)), which
    the backward kernels read (JAX's residual, interpret mode)."""
    from clip_dplm_tpu.ops.flash_attention import _flash_fwd

    q, k, v, _, mask = _inputs(rng, S=256)
    bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        _, jlse = _flash_fwd(*map(jnp.asarray, (q, k, v)), bias, block_q=128, block_k=128,
                             scale=1.0 / np.sqrt(32))
    got = flash_lse_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlse)[..., 0], atol=1e-5, rtol=1e-5)


def test_flash_backward_wrapper_takes_plain_version_on_cpu(rng):
    q, k, v, ct, mask = (torch.from_numpy(a) if a is not None else None
                         for a in _inputs(rng, S=70))
    out = attention_reference(q, k, v, mask)
    lse = flash_lse_reference(q, k, mask)
    got = flash_attention_bwd(q, k, v, mask, out, lse, ct)
    want = flash_attention_bwd_reference(q, k, v, mask, out, lse, ct)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
