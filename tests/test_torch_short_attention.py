"""Port's packed-qkv short-S attention (clip_dplm_tpu_torch/ops/
short_attention.py) against the JAX kernel it replaces, run in Pallas
interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.short_attention import (
    fused_short_attention_qkv_proj as jax_qkv_proj,
)
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.short_attention import (
    fused_short_attention_qkv_proj,
    fused_short_attention_qkv_proj_reference,
)


def _inputs(rng, B, S, D):
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    wo = (rng.normal(size=(D, D)) * 0.1).astype(np.float32)  # flax (in, out)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    return qkv, wo, bo, mask


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("S", [64, 100])
def test_plain_matches_jax_kernel(rng, rope, S):
    """Ragged masks; the JAX kernel pads S=100 to 128 rows in the kernel.
    Tolerance 2e-3 is the JAX suite's for its in-kernel RoPE path."""
    B, D, H = 2, 64, 2  # Dh = 32
    qkv, wo, bo, mask = _inputs(rng, B, S, D)
    pos = np.arange(S)
    with pltpu.force_tpu_interpret_mode():
        want = jax_qkv_proj(
            jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo), H,
            mask=jnp.asarray(mask), block_b=2,
            rope_positions=jnp.asarray(pos) if rope else None, interpret=True)
    got = fused_short_attention_qkv_proj(
        torch.from_numpy(qkv), torch.from_numpy(wo.T.copy()),
        torch.from_numpy(bo), H, mask=torch.from_numpy(mask),
        rope_positions=torch.from_numpy(pos) if rope else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-3, rtol=2e-3)


def test_cpu_tensor_takes_plain_version_and_counts_nothing(rng):
    qkv, wo, bo, mask = (torch.from_numpy(a) for a in _inputs(rng, 2, 70, 32))
    pos = torch.arange(70)
    before = _build.LAUNCHES.snapshot()
    got = fused_short_attention_qkv_proj(qkv, wo, bo, 4, mask=mask,
                                         rope_positions=pos)
    want = fused_short_attention_qkv_proj_reference(qkv, wo, bo, 4, mask=mask,
                                                    rope_positions=pos)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert _build.LAUNCHES.snapshot() == before


def test_rejects_bad_shapes(rng):
    qkv, wo, bo, mask = (torch.from_numpy(a) for a in _inputs(rng, 2, 64, 32))
    with pytest.raises(ValueError, match="divisible by 3"):
        fused_short_attention_qkv_proj(qkv[..., :-1], wo, bo, 4)
    with pytest.raises(ValueError, match="wo must be"):
        fused_short_attention_qkv_proj(qkv, wo[:, :16], bo, 4)
    with pytest.raises(ValueError, match="not divisible"):
        fused_short_attention_qkv_proj(qkv, wo, bo, 5)
    with pytest.raises(ValueError, match="even Dh"):
        fused_short_attention_qkv_proj(qkv[..., :3 * 30], wo[:30, :30], bo[:30],
                                       2, rope_positions=torch.arange(64))

