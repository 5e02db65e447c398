"""Flash attention over (B, H, S, Dh) with an optional (B, Sk) key mask,
forward and backward.

Counterpart of `clip_dplm_tpu/ops/flash_attention.py::flash_attention`. For
CUDA tensors it is an autograd Function over the kernels of
`csrc/flash_attention.cu`: the online-softmax forward, which also writes the
row logsumexp, and the two backward kernels (dQ; dK and dV) that recompute
the probabilities from it. For CPU tensors it
is `attention_reference`, the plain PyTorch version, differentiable by
autograd. `flash_bwd_dq_reference` and `flash_bwd_dkv_reference` repeat
the backward kernels' arithmetic in plain PyTorch
(`flash_attention_bwd_reference` both); the tests and the smoke run hold the
kernels against them. Padding never takes weight: a row whose keys are all
masked gets uniform weights over its Sk keys in the forward (its lse rounds
to -1e30, so its backward takes p = 1 per key, as the TPU kernel's does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import (
    FLASH_MAX_HEAD_DIM,
    NEG_INF,
    attention_reference,
)

FLASH_BWD_MAX_HEAD_DIM = 128  # q/dO/k/v tiles and two f32 accumulators in shared memory


def _scale(scale, Dh) -> float:
    return 1.0 / (Dh ** 0.5) if scale is None else float(scale)


def _scores(q, k, mask, scale) -> torch.Tensor:
    """f32 scores s = q·k^T·scale + key bias (-1e30 for a masked key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    return s


def flash_lse_reference(q, k, mask=None, scale=None) -> torch.Tensor:
    """Plain version of the forward's row logsumexp, (B, H, S) f32:
    m + log(max(Σ exp(s - m), 1e-30))."""
    s = _scores(q, k, mask, _scale(scale, q.shape[-1]))
    m = s.amax(dim=-1)
    return m + torch.log(torch.exp(s - m[..., None]).sum(dim=-1).clamp(min=1e-30))


def _bwd_terms(q, k, v, mask, out, lse, dout, scale):
    """p = exp(s - lse), ds = p·(dp - delta)·scale rounded to q's dtype and
    dO, all f32, with dp = dO·V^T and delta = rowsum(dO∘O)."""
    scale = _scale(scale, q.shape[-1])
    p = torch.exp(_scores(q, k, mask, scale) - lse.float()[..., None])
    do = dout.to(q.dtype).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    return p, (p * (dp - delta) * scale).to(q.dtype).float(), do


def flash_bwd_dq_reference(q, k, v, mask, out, lse, dout, scale=None) -> torch.Tensor:
    """Plain version of the dQ kernel: dq = ds·K, rounded once."""
    _, ds, _ = _bwd_terms(q, k, v, mask, out, lse, dout, scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, mask, out, lse, dout, scale=None):
    """Plain version of the dK/dV kernel: dk = ds^T·Q, dv = p^T·dO with p and
    dO in f32, each rounded once."""
    p, ds, do = _bwd_terms(q, k, v, mask, out, lse, dout, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, mask, out, lse, dout, scale=None):
    """Plain version of the backward kernels: (dq, dk, dv) from the forward's
    out and lse and the cotangent dout (`_bwd_dq_kernel`'s and
    `_bwd_dkv_kernel`'s arithmetic)."""
    return (flash_bwd_dq_reference(q, k, v, mask, out, lse, dout, scale),
            *flash_bwd_dkv_reference(q, k, v, mask, out, lse, dout, scale))


def _check(q, k, v, mask):
    B, H, S, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"k/v must be ({B}, {H}, Sk, {Dh}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Sk = k.shape[2]
    if mask is not None and tuple(mask.shape) != (B, Sk):
        raise ValueError(f"mask must be ({B}, {Sk}), got {tuple(mask.shape)}")
    return B, H, S, Sk, Dh


def _kernel_inputs(q, k, v, mask):
    """The kernels' checks; contiguous q, k, v and the mask on the device."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes bf16 q/k/v, got {q.dtype}")
    B, H, S, Sk, Dh = _check(q, k, v, mask)
    if Dh > FLASH_MAX_HEAD_DIM or S < 1 or Sk < 1:
        raise ValueError(f"the flash kernel takes Dh <= {FLASH_MAX_HEAD_DIM} and "
                         f"S, Sk >= 1, got Dh={Dh}, S={S}, Sk={Sk}")
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.bool).contiguous()
    return q.contiguous(), k.contiguous(), v.contiguous(), mask


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flash_forward(q, k, v, mask, scale):
    """The forward kernel: out and the (B, H, S) f32 lse."""
    q, k, v, mask = _kernel_inputs(q, k, v, mask)
    B, H, S, Dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _build.launch(
        "flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
        out.data_ptr(), lse.data_ptr(), B, H, S, k.shape[2], Dh, _scale(scale, Dh),
        _build.stream_of(q))
    _build.LAUNCHES.add("flash_attention")
    return out, lse


def _require_bwd_fits(Dh: int) -> None:
    if Dh > FLASH_BWD_MAX_HEAD_DIM:
        raise ValueError(f"the flash backward kernels take Dh <= {FLASH_BWD_MAX_HEAD_DIM}, "
                         f"got {Dh}")


def _bwd_inputs(q, k, v, mask, out, lse, dout):
    """The backward kernels' checks and inputs: contiguous q, k, v, the
    mask, dout in bf16, lse and delta = rowsum(dO∘O) in f32 (a plain op, as
    the JAX package leaves it to XLA)."""
    q, k, v, mask = _kernel_inputs(q, k, v, mask)
    B, H, S, Dh = q.shape
    _require_bwd_fits(Dh)
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (B, H, S))):
        if tuple(t.shape) != tuple(shape) or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(shape)} on {q.device}")
    dout = dout.to(torch.bfloat16).contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)
    return q, k, v, mask, dout, lse.float().contiguous(), delta


def _launch_bwd(name, inputs, outputs, scale):
    q, k = inputs[0], inputs[1]
    B, H, S, Dh = q.shape
    _build.launch(name, *(_ptr(t) for t in inputs), *(t.data_ptr() for t in outputs), B, H, S,
                  k.shape[2], Dh, _scale(scale, Dh), _build.stream_of(q))
    _build.LAUNCHES.add(name)


def flash_bwd_dq(q, k, v, mask, out, lse, dout, scale=None) -> torch.Tensor:
    """dq of `flash_attention` from its residuals (out, lse) and the
    cotangent dout: the dQ kernel for CUDA tensors (bf16, Dh <= 128), the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, mask, out, lse, dout, scale)
    inputs = _bwd_inputs(q, k, v, mask, out, lse, dout)
    dq = torch.empty_like(inputs[0])
    _launch_bwd("flash_attention_bwd_dq", inputs, (dq,), scale)
    return dq


def flash_bwd_dkv(q, k, v, mask, out, lse, dout, scale=None):
    """(dk, dv) of `flash_attention`, as `flash_bwd_dq`: the dK/dV kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, mask, out, lse, dout, scale)
    inputs = _bwd_inputs(q, k, v, mask, out, lse, dout)
    dk, dv = torch.empty_like(inputs[1]), torch.empty_like(inputs[2])
    _launch_bwd("flash_attention_bwd_dkv", inputs, (dk, dv), scale)
    return dk, dv


def flash_attention_bwd(q, k, v, mask, out, lse, dout, scale=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` from its residuals (out, lse) and
    the cotangent dout. CPU tensors take the plain version; CUDA tensors the
    two backward kernels (bf16, Dh <= 128) or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, mask, out, lse, dout, scale)
    inputs = _bwd_inputs(q, k, v, mask, out, lse, dout)
    dq, dk, dv = (torch.empty_like(t) for t in inputs[:3])
    _launch_bwd("flash_attention_bwd_dq", inputs, (dq,), scale)
    _launch_bwd("flash_attention_bwd_dkv", inputs, (dk, dv), scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, lse = _flash_forward(q, k, v, mask, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over (B, H, S, Dh) q and (B, H, Sk, Dh) k/v with a (B, Sk)
    key mask (True = real token); the scale defaults to 1/sqrt(Dh). CPU
    tensors take the plain version; CUDA tensors take the kernels (bf16,
    Dh <= 256, and Dh <= 128 when a gradient will be recorded, which is
    refused before the forward otherwise) or raise."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask=mask, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _require_bwd_fits(q.shape[-1])
    return _FlashAttention.apply(q, k, v, mask, scale)
