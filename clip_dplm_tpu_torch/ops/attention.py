"""Attention: the plain formulation and the shape dispatch onto the kernels.

Counterpart of `clip_dplm_tpu/ops/attention.py`. Masking convention: `mask`
is a boolean (B, S) key-validity array (True = real token), applied as an
additive -1e30 bias, so a row whose keys are all masked gets uniform weights.

Dispatch is fixed by shape, as the TPU gates are without their backend term:
from packed qkv, the short-S kernel for 64 <= S < 256 (`short_attn_packed_ok`)
and the tiny-S kernel for 2 <= S < 64 (`tiny_attn_ok`), both with the
out-projection; the flash kernel for S >= 256 (`attention_dispatch`); the
CLS-query kernel for a block that keeps only row 0 (`cls_query_attention`).
Each kernel wrapper runs its plain version for CPU tensors and its CUDA
kernel for CUDA tensors. Separate q, k, v below 64 keys take
`attention_reference` on every device, as the TPU gates send them to plain
XLA (S = 1 included). At 64 <= S < 256, where `short_attn_separate_ok` holds
(one shape for q, k and v, Dh a multiple of 8, no mask or a (B, S) one),
`multihead_attention` and `attention_dispatch` take the short-S kernel over
separate q, k, v (`ops/short_attention.py::fused_short_attention`,
`fused_short_attention_heads`), as the TPU gates do: its plain version for
CPU tensors, its kernels for CUDA tensors, which raise with the kernel's
bound for what they do not take (f32, Dh > 128). Everywhere else in that
range both compute what the TPU computes, the plain formulation.
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


def require_no_grad(what: str, why: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record `what`, a kernel launch with no
    backward of its own: its output would carry no gradient to the inputs."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} on CUDA records no gradient ({why}); call it under "
            "torch.no_grad() or torch.inference_mode()")


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


def short_attn_separate_ok(q_shape, k_shape, v_shape, head_dim: int, mask) -> bool:
    """True where the TPU takes its short-S kernel over separate q, k, v
    (`multihead_attention`'s and `attention_dispatch`'s gates without their
    backend term): 64 <= S < 256 keys, one shape for q, k and v ((B, S, D)
    or (B, H, S, Dh): S is the second-to-last), Dh a multiple of 8, no mask
    or a (B, S) one."""
    return (
        SHORT_MIN_SEQ <= k_shape[-2] < FLASH_MIN_SEQ
        and tuple(q_shape) == tuple(k_shape) == tuple(v_shape)
        and head_dim % 8 == 0
        and (mask is None or mask.dim() == 2)
    )


def tiny_attn_ok(qkv_shape, num_heads: int, mask) -> bool:
    """True for the shapes of the TPU's packed-diagonal tiny-S kernel: 2 <= S
    < 64, Dh a multiple of 8, a (B, S) mask."""
    S, D3 = qkv_shape[1], qkv_shape[2]
    if D3 % 3 or (D3 // 3) % num_heads:
        return False
    return (2 <= S < SHORT_MIN_SEQ and (D3 // 3 // num_heads) % 8 == 0
            and (mask is None or mask.dim() == 2))


def cls_query_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output for query row 0 only, (B, 1, D), from packed (B, S,
    3D) qkv, with a (B, S) key mask: `multihead_attention(q, k, v)[:, :1]`,
    through `ops/short_attention.py::fused_cls_attention` on every device
    (its kernels for CUDA tensors, up to 128 heads, anything else raises;
    its plain versions for CPU tensors)."""
    from clip_dplm_tpu_torch.ops.short_attention import fused_cls_attention

    return fused_cls_attention(qkv, num_heads, mask=mask)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over (B, S, D) q, k, v: the short-S kernel over
    separate q, k, v where the TPU takes it (`short_attn_separate_ok` with D
    divisible by the heads: `fused_short_attention`, on every device), else
    `attention_dispatch` (the flash kernel from 256 keys on, the plain
    formulation below 64 keys and for other shapes)."""
    if q.shape[-1] % num_heads == 0 and short_attn_separate_ok(
            q.shape, k.shape, v.shape, q.shape[-1] // num_heads, mask):
        from clip_dplm_tpu_torch.ops.short_attention import fused_short_attention

        return fused_short_attention(q, k, v, num_heads, mask=mask)
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    return merge_heads(attention_dispatch(qh, kh, vh, mask=mask))


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


def packed_tiny_attention_proj(
    qkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tiny-S packed attention with the out-projection (caller must have
    checked tiny_attn_ok). `wo` is (out, in)."""
    from clip_dplm_tpu_torch.ops.tiny_attention import fused_tiny_attention_proj

    return fused_tiny_attention_proj(qkv, wo, bo, num_heads, mask=mask)


def attention_dispatch(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Head-level dispatch over (B, H, S, Dh): the flash kernel from 256 keys
    on; the short-S kernel over the heads where the TPU takes it
    (`short_attn_separate_ok`: `fused_short_attention_heads`, on every
    device); the plain formulation elsewhere."""
    if short_attn_separate_ok(qh.shape, kh.shape, vh.shape, qh.shape[-1], mask):
        from clip_dplm_tpu_torch.ops.short_attention import fused_short_attention_heads

        return fused_short_attention_heads(qh, kh, vh, mask=mask, scale=scale)
    if (
        kh.shape[2] >= FLASH_MIN_SEQ
        and qh.shape[-1] <= FLASH_MAX_HEAD_DIM
        and (mask is None or mask.dim() == 2)
    ):
        from clip_dplm_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(qh, kh, vh, mask=mask, scale=scale)
    return attention_reference(qh, kh, vh, mask=mask, scale=scale)
