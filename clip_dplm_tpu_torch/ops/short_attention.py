"""Packed-qkv short-sequence attention with the out-projection fused.

Counterpart of `clip_dplm_tpu/ops/short_attention.py::
fused_short_attention_qkv_proj` (forward only): y = attention(qkv) @ Wo^T + bo
from the (B, S, 3D) output of one qkv Dense in [q | k | v] layout, with
optional rotate-half RoPE on q and k. The TPU kernel's body is two CUDA
kernels here (`csrc/short_attention.cu`), each behind its own wrapper:
`short_attention_qkv` (RoPE + attention -> o) and `out_projection`
(o @ Wo^T + bo). Each wrapper runs its kernel for CUDA tensors and its plain
PyTorch version (`*_reference`) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import (
    SHORT_MAX_HEAD_DIM,
    attention_reference,
    merge_heads,
    split_heads,
)

MAX_SEQ = 256  # K and V of a head for the whole sequence sit in shared memory


def _rope_cos_sin(positions: torch.Tensor, Dh: int):
    """(S, Dh//2) f32 cos/sin tables of the ESM-2 rotary embedding
    (theta_i = 10000^(-2i/Dh))."""
    half = Dh // 2
    freqs = 1.0 / (10000.0 ** (
        torch.arange(0, half, dtype=torch.float32, device=positions.device) / half))
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rope_rot(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE over the last dim in f32: [t1*cos - t2*sin,
    t2*cos + t1*sin]; cos/sin broadcast against t's leading dims."""
    half = t.shape[-1] // 2
    t = t.float()
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)


def _check_qkv(qkv, num_heads, rope_positions):
    B, S, D3 = qkv.shape
    if D3 % 3:
        raise ValueError(f"packed qkv needs last dim divisible by 3, got {D3}")
    D = D3 // 3
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by num_heads={num_heads}")
    Dh = D // num_heads
    if rope_positions is not None and Dh % 2:
        raise ValueError(f"in-kernel RoPE needs even Dh, got {Dh}")
    return B, S, D, Dh


def _check_proj(o, wo, bo):
    D = o.shape[-1]
    if tuple(wo.shape) != (D, D):
        raise ValueError(f"wo must be ({D}, {D}), got {tuple(wo.shape)}")
    if tuple(bo.shape) != (D,):
        raise ValueError(f"bo must be ({D},), got {tuple(bo.shape)}")


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16, got {x.dtype}")


# ---------------------------------------------------------------------------
# attention: qkv (B, S, 3D) -> o (B, S, D)
# ---------------------------------------------------------------------------


def short_attention_qkv_reference(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: rotate q/k in f32 (rounded back to qkv's dtype), then
    attention_reference over the heads."""
    _, _, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    qh, kh, vh = (split_heads(qkv[..., i * D:(i + 1) * D], num_heads)
                  for i in range(3))
    if rope_positions is not None:
        cos, sin = _rope_cos_sin(rope_positions, Dh)
        qh = _rope_rot(qh, cos, sin).to(qkv.dtype)
        kh = _rope_rot(kh, cos, sin).to(qkv.dtype)
    return merge_heads(attention_reference(qh, kh, vh, mask=mask, scale=scale))


def short_attention_qkv(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head self-attention from packed qkv, (B, S, D) out. CPU tensors
    take the plain version; CUDA tensors take the kernel (bf16, S <= 256, Dh
    a multiple of 8 up to 128) or raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_reference(
            qkv, num_heads, mask=mask, scale=scale, rope_positions=rope_positions)
    _require_cuda(qkv)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"the short-S kernel takes 1 <= S <= {MAX_SEQ}, got {S}")
    if Dh % 8 or Dh > SHORT_MAX_HEAD_DIM:
        raise ValueError(f"the short-S kernel takes Dh a multiple of 8 up to "
                         f"{SHORT_MAX_HEAD_DIM}, got {Dh}")
    dev = qkv.device
    if mask is not None:
        if tuple(mask.shape) != (B, S):
            raise ValueError(f"mask must be ({B}, {S}), got {tuple(mask.shape)}")
        mask = mask.to(device=dev, dtype=torch.bool).contiguous()
    cos = sin = None
    if rope_positions is not None:
        if tuple(rope_positions.shape) != (S,):
            raise ValueError(f"rope_positions must be ({S},)")
        cos, sin = (t.contiguous() for t in _rope_cos_sin(rope_positions.to(dev), Dh))
    scale = 1.0 / (Dh ** 0.5) if scale is None else float(scale)
    o = torch.empty((B, S, D), dtype=torch.bfloat16, device=dev)
    _build.launch(
        "short_attention_qkv_fwd", qkv.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if cos is None else cos.data_ptr(),
        None if sin is None else sin.data_ptr(),
        o.data_ptr(), B, S, num_heads, Dh, scale, _build.stream_of(qkv))
    _build.LAUNCHES.add("short_attention")
    return o


# ---------------------------------------------------------------------------
# out-projection: y = o @ wo^T + bo
# ---------------------------------------------------------------------------


def out_projection_reference(o: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor) -> torch.Tensor:
    """Plain version: wo and bo rounded to o's dtype, f32 accumulation and
    bias add, one rounding of the result to o's dtype."""
    _check_proj(o, wo, bo)
    y = o.float() @ wo.to(o.dtype).float().t() + bo.to(o.dtype).float()
    return y.to(o.dtype)


def out_projection(o: torch.Tensor, wo: torch.Tensor,
                   bo: torch.Tensor) -> torch.Tensor:
    """y = o @ wo^T + bo over the last dim; `wo` is (out, in) as in the
    port's Dense. CPU tensors take the plain version; CUDA tensors take the
    GEMM kernel (bf16, D a multiple of 8) or raise."""
    if o.device.type == "cpu":
        return out_projection_reference(o, wo, bo)
    _require_cuda(o)
    _check_proj(o, wo, bo)
    D = o.shape[-1]
    if D % 8:
        raise ValueError(f"the projection kernel takes D a multiple of 8, got {D}")
    o = o.contiguous()
    wo = wo.to(device=o.device, dtype=torch.bfloat16).contiguous()
    bo = bo.to(device=o.device, dtype=torch.bfloat16).contiguous()
    if o.data_ptr() % 16 or wo.data_ptr() % 16:  # the GEMM reads 16-byte vectors
        o, wo = o.clone(), wo.clone()
    y = torch.empty_like(o)
    _build.launch("short_attention_out_proj", o.data_ptr(), wo.data_ptr(),
                  bo.data_ptr(), y.data_ptr(), o.numel() // D, D, D,
                  _build.stream_of(o))
    _build.LAUNCHES.add("short_attention_out_proj")
    return y


# ---------------------------------------------------------------------------
# the fused entry point the model calls
# ---------------------------------------------------------------------------


def fused_short_attention_qkv_proj_reference(
    qkv, wo, bo, num_heads, mask=None, scale=None, rope_positions=None,
) -> torch.Tensor:
    """Plain version of `fused_short_attention_qkv_proj`."""
    o = short_attention_qkv_reference(qkv, num_heads, mask=mask, scale=scale,
                                      rope_positions=rope_positions)
    return out_projection_reference(o, wo, bo)


def fused_short_attention_qkv_proj(
    qkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = attention(qkv) @ wo^T + bo, (B, S, D) out; rope_positions: (S,)
    positions for rotate-half RoPE on q/k. Two kernel launches on CUDA
    tensors, the plain versions on CPU tensors."""
    _, _, D, _ = _check_qkv(qkv, num_heads, rope_positions)
    _check_proj(qkv[..., :D], wo, bo)
    o = short_attention_qkv(qkv, num_heads, mask=mask, scale=scale,
                            rope_positions=rope_positions)
    return out_projection(o, wo, bo)
