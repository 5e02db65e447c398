"""Port's flash attention (clip_dplm_tpu_torch/ops/flash_attention.py)
against the JAX kernel it replaces, run in Pallas interpret mode, on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.flash_attention import flash_attention as jax_flash
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import attention_reference
from clip_dplm_tpu_torch.ops.flash_attention import flash_attention


def _qkv(rng, B, H, S, Dh):
    return tuple(rng.normal(size=(B, H, S, Dh)).astype(np.float32)
                 for _ in range(3))


def _ragged_mask(rng, B, S):
    lens = rng.integers(S // 2, S + 1, B)
    return np.arange(S)[None, :] < lens[:, None]


@pytest.mark.parametrize("masked", [True, False])
def test_plain_matches_jax_kernel_s300(rng, masked):
    """S=300 (the JAX kernel pads keys to its 384 block); f32 at the JAX
    suite's flash tolerance 2e-5."""
    B, H, S, Dh = 2, 2, 300, 64
    q, k, v = _qkv(rng, B, H, S, Dh)
    mask = _ragged_mask(rng, B, S) if masked else None
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         mask=None if mask is None else jnp.asarray(mask))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_fully_masked_row_is_uniform_over_its_keys(rng):
    """The finite -1e30 bias gives a row with no real key uniform weights
    over its Sk keys (padding takes none), not NaN or zeros."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 260, 16))
    mask = torch.zeros(1, 260, dtype=torch.bool)
    out = flash_attention(q, k, v, mask=mask)
    torch.testing.assert_close(out, v.mean(dim=2, keepdim=True).expand_as(v),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_nothing(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 256, 32))
    mask = torch.from_numpy(_ragged_mask(rng, 1, 256))
    before = _build.LAUNCHES.snapshot()
    torch.testing.assert_close(flash_attention(q, k, v, mask=mask),
                               attention_reference(q, k, v, mask=mask),
                               atol=0, rtol=0)
    assert _build.LAUNCHES.snapshot() == before


def test_rejects_bad_shapes(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 2, 64, 16))
    with pytest.raises(ValueError, match="k/v must be"):
        flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="mask must be"):
        flash_attention(q, k, v, mask=torch.ones(2, 63, dtype=torch.bool))

