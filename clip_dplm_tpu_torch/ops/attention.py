"""Attention: the plain formulation and the shape dispatch onto the kernels.

Counterpart of `clip_dplm_tpu/ops/attention.py`. Masking convention: `mask`
is a boolean (B, S) key-validity array (True = real token), applied as an
additive -1e30 bias, so a row whose keys are all masked gets uniform weights.

Dispatch is fixed by shape, as the TPU gates are without their backend term:
the packed short-S kernel for 64 <= S < 256 (`short_attn_packed_ok`), the
flash kernel for S >= 256 (`attention_dispatch`), and `attention_reference`
below 64. Each kernel wrapper runs its plain version for CPU tensors and its
CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
SHORT_MIN_SEQ = 64  # below: plain attention, as in the reference package
FLASH_MIN_SEQ = 256
SHORT_MAX_HEAD_DIM = 128  # K and V of one head at S = 256 fill shared memory
FLASH_MAX_HEAD_DIM = 256  # a 64-row q tile, k/v tiles and its f32 accumulator


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with f32 scores and accumulation.

    q, k, v: (B, H, S, Dh); mask: (B, S) key validity or (B, 1, S, S)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        m = mask[:, None, None, :] if mask.dim() == 2 else mask
        logits = logits + torch.where(m, 0.0, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, Dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * Dh)


def short_attn_packed_ok(qkv_shape, num_heads: int, mask) -> bool:
    """True when the packed short-S kernel handles this (B, S, 3D) shape."""
    S, D3 = qkv_shape[1], qkv_shape[2]
    if D3 % 3:
        return False
    D = D3 // 3
    if D % num_heads:
        return False
    Dh = D // num_heads
    return (
        SHORT_MIN_SEQ <= S < FLASH_MIN_SEQ
        and Dh % 8 == 0
        and Dh <= SHORT_MAX_HEAD_DIM
        and (mask is None or mask.dim() == 2)
    )


def packed_qkv_attention_proj(
    qkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed attention with the out-projection (caller must have checked
    short_attn_packed_ok). `wo` is (out, in); rope_positions applies ESM
    rotate-half RoPE to q/k inside the kernel."""
    from clip_dplm_tpu_torch.ops.short_attention import (
        fused_short_attention_qkv_proj,
    )

    return fused_short_attention_qkv_proj(
        qkv, wo, bo, num_heads, mask=mask, rope_positions=rope_positions)


def attention_dispatch(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Head-level dispatch over (B, H, S, Dh): the flash kernel from 256 keys
    on, the plain formulation below."""
    if (
        kh.shape[2] >= FLASH_MIN_SEQ
        and qh.shape[-1] <= FLASH_MAX_HEAD_DIM
        and (mask is None or mask.dim() == 2)
    ):
        from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(qh, kh, vh, mask=mask, scale=scale)
    return attention_reference(qh, kh, vh, mask=mask, scale=scale)
