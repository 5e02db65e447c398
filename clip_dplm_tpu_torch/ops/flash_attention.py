"""Flash attention forward over (B, H, S, Dh) with an optional (B, Sk) key mask.

Counterpart of `clip_dplm_tpu/ops/flash_attention.py::flash_attention`
(forward only). For CUDA tensors it runs the online-softmax kernel of
`csrc/flash_attention.cu`, and raises where autograd would record the call
(the backward is ROADMAP queue 2 item 6); for CPU tensors it runs
`attention_reference`, the plain PyTorch version of the same function.
Padding never takes weight: a row whose keys are all masked gets uniform
weights over its Sk keys.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import (
    FLASH_MAX_HEAD_DIM,
    attention_reference,
    require_no_grad,
)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over (B, H, S, Dh) q and (B, H, Sk, Dh) k/v with a (B, Sk)
    key mask (True = real token); the scale defaults to 1/sqrt(Dh). CPU
    tensors take the plain version; CUDA tensors take the kernel (bf16,
    Dh <= 256, no gradient recorded) or raise."""
    B, H, S, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"k/v must be ({B}, {H}, Sk, {Dh}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Sk = k.shape[2]
    if mask is not None and tuple(mask.shape) != (B, Sk):
        raise ValueError(f"mask must be ({B}, {Sk}), got {tuple(mask.shape)}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask=mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes bf16 q/k/v, got {q.dtype}")
    require_no_grad("flash_attention", "its backward kernel is ROADMAP queue 2 item 6",
                    q, k, v)
    if Dh > FLASH_MAX_HEAD_DIM or S < 1 or Sk < 1:
        raise ValueError(f"the flash kernel takes Dh <= {FLASH_MAX_HEAD_DIM} and "
                         f"S, Sk >= 1, got Dh={Dh}, S={S}, Sk={Sk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.bool).contiguous()
    scale = 1.0 / (Dh ** 0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        B, H, S, Sk, Dh, scale, _build.stream_of(q))
    _build.LAUNCHES.add("flash_attention")
    return out
