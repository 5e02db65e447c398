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


@pytest.mark.parametrize("S,rope,Dh,dead_row", [
    pytest.param(64, True, 32, False, id="64-True"),
    pytest.param(64, False, 32, False, id="64-False"),
    pytest.param(100, True, 32, False, id="100-True"),
    pytest.param(100, False, 32, False, id="100-False"),
    pytest.param(128, True, 32, True, id="128-True-dead_row"),
    pytest.param(129, True, 32, False, id="129-True"),
    pytest.param(256, False, 32, True, id="256-False-dead_row"),
    pytest.param(129, True, 24, False, id="129-True-Dh24"),
    pytest.param(128, False, 128, False, id="128-False-Dh128"),
    pytest.param(256, True, 128, False, id="256-True-Dh128"),
])
def test_plain_matches_jax_kernel(rng, S, rope, Dh, dead_row):
    """Ragged masks; the JAX kernel pads S=100 to 128 rows and S=129 to 256
    in the kernel. The shapes the CUDA forward treats differently: S=128
    (one block a head, two key tiles), 129 and 256 (two blocks, scores
    recomputed), Dh=24 (a partial 64-column block, RoPE by elements) and 128
    (two blocks of columns). A batch row with no real key (dead_row) takes
    uniform weights; JAX pads keys with the same -1e30 as a masked key, so it
    averages over its padded key count and agrees with the port only where
    that is S (S = 128, 256). Tolerance 2e-3 is the JAX suite's for its
    in-kernel RoPE path."""
    B, H = 2, 2
    D = H * Dh
    qkv, wo, bo, mask = _inputs(rng, B, S, D)
    if dead_row:
        mask[1] = False
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

