"""The port's CUDA kernels against their plain PyTorch versions on the card,
in bf16 at the JAX suite's bf16 bound (atol = rtol = 2e-2), with ragged and
fully masked rows. Every test here needs an NVIDIA GPU and skips without
one. The file imports no JAX, so on the card, which has none, it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import attention_reference
from clip_dplm_tpu_torch.ops.flash_attention import flash_attention
from clip_dplm_tpu_torch.ops.short_attention import (
    fused_short_attention_qkv_proj,
    fused_short_attention_qkv_proj_reference,
    out_projection,
    out_projection_reference,
)

TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)


def _ragged_mask(rng, B, S):
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    mask[-1] = False  # one row with no real key
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,H", [(4, 128, 640, 10), (2, 100, 256, 2),
                                     (3, 64, 96, 4), (2, 200, 1280, 20),
                                     (2, 256, 1024, 8)])
def test_short_attention_matches_plain(cuda_device, np_rng, B, S, D, H):
    qkv = torch.from_numpy(np_rng.normal(size=(B, S, 3 * D)).astype(np.float32))
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy((np_rng.normal(size=(D,)) * 0.1).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    wo, bo = wo.to(cuda_device), bo.to(cuda_device)
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    pos = torch.arange(S, device=cuda_device)
    before = _build.LAUNCHES.snapshot()
    got = fused_short_attention_qkv_proj(qkv, wo, bo, H, mask=mask,
                                         rope_positions=pos)
    torch.cuda.synchronize()
    after = _build.LAUNCHES.snapshot()
    assert after["short_attention"] == before["short_attention"] + 1
    assert after["short_attention_out_proj"] == before["short_attention_out_proj"] + 1
    want = fused_short_attention_qkv_proj_reference(qkv, wo, bo, H, mask=mask,
                                                    rope_positions=pos)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D", [(64, 64), (100, 104), (4096, 640), (33, 1280)])
def test_out_projection_matches_plain(cuda_device, np_rng, M, D):
    """The GEMM alone, at ragged M and a K that is no multiple of its 32-wide
    k tile."""
    o = torch.from_numpy(np_rng.normal(size=(M, D)).astype(np.float32))
    wo = torch.from_numpy((np_rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32))
    bo = torch.from_numpy(np_rng.normal(size=(D,)).astype(np.float32))
    o, wo, bo = o.to(cuda_device, torch.bfloat16), wo.to(cuda_device), bo.to(cuda_device)
    got = out_projection(o, wo, bo)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), out_projection_reference(o, wo, bo).float(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", [(2, 4, 256, 64), (2, 3, 300, 40),
                                      (1, 2, 1000, 64), (1, 2, 333, 128),
                                      (2, 2, 257, 256)])
def test_flash_attention_matches_plain(cuda_device, np_rng, B, H, S, Dh):
    q, k, v = (torch.from_numpy(np_rng.normal(size=(B, H, S, Dh)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    mask = torch.from_numpy(_ragged_mask(np_rng, B, S)).to(cuda_device)
    before = _build.LAUNCHES.snapshot()["flash_attention"]
    got = flash_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot()["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(),
                               attention_reference(q, k, v, mask=mask).float(), **TOL)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    qkv = torch.zeros(2, 64, 3 * 64, device=cuda_device)  # f32: not bf16
    w, b = torch.zeros(64, 64, device=cuda_device), torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        fused_short_attention_qkv_proj(qkv, w, b, 2)
    q = torch.zeros(1, 1, 256, 512, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh <="):
        flash_attention(q, q, q)
