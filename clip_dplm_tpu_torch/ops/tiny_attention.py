"""Packed-qkv attention for tiny sequences (2 <= S < 64) with the
out-projection, forward and backward.

Counterpart of `clip_dplm_tpu/ops/short_attention.py::
fused_tiny_attention_proj`, the tf_clip perturbation tower's 10 DEG tokens
and the transformer tower's 8 tokens. `fused_tiny_attention_proj` is an
autograd Function over three wrappers: `tiny_attention` (qkv -> o, the
forward kernel of `csrc/tiny_attention.cu`), `out_projection` (o @ Wo^T +
bo, the package's GEMM) and, backward, `tiny_attention_bwd` (dqkv from dO =
dy·Wo through the same GEMM, the saved o, qkv and the mask). dWo = dy^T·o and
dbo = Σ dy are plain f32-output matmuls, as the JAX package leaves them to
XLA. bf16 qkv takes the tensor-core kernels; f32 qkv (the transformer probe
of models/classifiers.py) takes their f32 instances in
`csrc/tiny_attention_f32.cu`, which compute in f32 on the FMA units, with
the projection and dO through its f32 GEMM (`short_attention.f32_gemm`), as
the TPU kernel computes in qkv's dtype, its out-projection included.

The plain versions (`*_reference`) keep the TPU kernel's rounding points,
which differ from `attention_reference`'s: l sums the f32 p, p is rounded to
qkv's dtype for p·V, and the row is divided by l after p·V; the backward
forms dV from the f32 probabilities and the f32 dO. Each wrapper runs its
kernel for CUDA tensors and its plain version for CPU tensors;
`tiny_attention` has no backward of its own and, on CUDA, raises where
autograd would record it.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import (
    NEG_INF,
    merge_heads,
    require_no_grad,
    split_heads,
)
from clip_dplm_tpu_torch.ops.short_attention import (
    _check_proj,
    _check_qkv,
    _device_mask,
    _dout,
    _proj_param_grads,
    _ptr,
    _scale,
    out_projection,
    out_projection_reference,
)

MAX_SEQ = 64  # the kernels' bound; the dispatch sends only S < 64 here
MAX_HEAD_DIM = 256


def _heads_and_probs(qkv, num_heads, mask, scale):
    """q, k, v (B, H, S, Dh) and the f32 p = exp(s - m) and l = max(Σp, 1e-30)."""
    _, _, D, Dh = _check_qkv(qkv, num_heads, None)
    q, k, v = (split_heads(qkv[..., i * D:(i + 1) * D], num_heads) for i in range(3))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * _scale(scale, Dh)
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return q, k, v, p, p.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def tiny_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the forward kernel: o = (p·V) / l, p rounded to
    qkv's dtype for the product, (B, S, D) in qkv's dtype."""
    _, _, v, p, l = _heads_and_probs(qkv, num_heads, mask, scale)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(qkv.dtype).float(), v.float()) / l
    return merge_heads(o).to(qkv.dtype)


def tiny_attention_bwd_reference(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the backward kernel: (B, S, 3D) dqkv from dout (the
    cotangent of o), qkv, the saved o and the mask. prob = p / l in f32; dp =
    dO·V^T; delta = rowsum(dO∘o); ds = prob·(dp − delta)·scale rounded to
    qkv's dtype; dq = ds·K, dk = ds^T·Q, dv = prob^T·dO in f32."""
    dt = qkv.dtype
    q, k, v, p, l = _heads_and_probs(qkv, num_heads, mask, scale)
    prob = p / l
    do = split_heads(dout.to(dt), num_heads).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    delta = (do * split_heads(o, num_heads).float()).sum(dim=-1, keepdim=True)
    ds = (prob * (dp - delta) * _scale(scale, q.shape[-1])).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", prob, do)
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _entry(name: str, dtype: torch.dtype) -> str:
    """The C entry (and launch counter) of `name` for qkv's dtype."""
    return name if dtype == torch.bfloat16 else f"{name}_f32"


def _kernel_inputs(qkv, num_heads, mask):
    """The tiny kernels' checks; the mask on the device or None."""
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the tiny-S kernels take bf16 or f32, got {qkv.dtype}")
    B, S, D, Dh = _check_qkv(qkv, num_heads, None)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if not 1 <= S <= MAX_SEQ or Dh % 8 or Dh > MAX_HEAD_DIM:
        raise ValueError(f"the tiny-S kernel takes 1 <= S <= {MAX_SEQ} and Dh a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}, got S={S}, Dh={Dh}")
    return _device_mask(mask, B, S, qkv.device)


def tiny_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head self-attention from packed (B, S, 3D) qkv, (B, S, D) out.
    CPU tensors take the plain version; CUDA tensors take the kernel (bf16 or
    f32, S <= 64, Dh a multiple of 8, no gradient recorded) or raise."""
    if qkv.device.type == "cpu":
        return tiny_attention_reference(qkv, num_heads, mask=mask, scale=scale)
    require_no_grad("tiny_attention", "fused_tiny_attention_proj is the entry point with a "
                    "backward", qkv)
    mask = _kernel_inputs(qkv, num_heads, mask)
    B, S, D, Dh = _check_qkv(qkv, num_heads, None)
    o = torch.empty((B, S, D), dtype=qkv.dtype, device=qkv.device)
    entry = _entry("tiny_attention_fwd", qkv.dtype)
    _build.launch(entry, qkv.data_ptr(), _ptr(mask), o.data_ptr(), B, S,
                  num_heads, Dh, _scale(scale, Dh), _build.stream_of(qkv))
    _build.LAUNCHES.add(entry)
    return o


def tiny_attention_bwd(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `tiny_attention` from its residuals. CPU tensors
    take the plain version; CUDA tensors take the kernel or raise."""
    if qkv.device.type == "cpu":
        return tiny_attention_bwd_reference(dout, qkv, o, num_heads, mask=mask, scale=scale)
    mask = _kernel_inputs(qkv, num_heads, mask)
    B, S, D, Dh = _check_qkv(qkv, num_heads, None)
    for name, t in (("dout", dout), ("o", o)):
        if tuple(t.shape) != (B, S, D) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be ({B}, {S}, {D}) {qkv.dtype} on {qkv.device}")
    dout, o = dout.contiguous(), o.contiguous()
    dqkv = torch.empty_like(qkv)
    entry = _entry("tiny_attention_bwd", qkv.dtype)
    _build.launch(entry, qkv.data_ptr(), _ptr(mask), o.data_ptr(),
                  dout.data_ptr(), dqkv.data_ptr(), B, S, num_heads, Dh, _scale(scale, Dh),
                  _build.stream_of(qkv))
    _build.LAUNCHES.add(entry)
    return dqkv


def fused_tiny_attention_proj_reference(qkv, wo, bo, num_heads, mask=None, scale=None):
    """Plain version of `fused_tiny_attention_proj` (differentiable by
    autograd through plain ops)."""
    return out_projection_reference(
        tiny_attention_reference(qkv, num_heads, mask=mask, scale=scale), wo, bo)


class _TinyAttnProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, wo, bo, mask, num_heads, scale):
        o = tiny_attention(qkv, num_heads, mask=mask, scale=scale)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, o, wo, bo, mask)
        return out_projection(o, wo, bo)

    @staticmethod
    def backward(ctx, dy):
        qkv, o, wo, bo, mask = ctx.saved_tensors
        dy = dy.to(qkv.dtype)
        dqkv = tiny_attention_bwd(_dout(dy, wo.to(qkv.dtype)), qkv, o, ctx.num_heads,
                                  mask=mask, scale=ctx.scale)
        dwo, dbo = _proj_param_grads(dy, o)
        return dqkv, dwo.to(wo.dtype), dbo.to(bo.dtype), None, None, None


def fused_tiny_attention_proj(
    qkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """y = attention(qkv) @ wo^T + bo, (B, S, D) out, for 2 <= S < 64 and Dh
    a multiple of 8; `wo` is (out, in). Differentiable in qkv, wo and bo: the
    kernels on CUDA tensors (forward: attention, then the projection GEMM;
    backward: the dO GEMM, then the attention backward), bf16 or f32 by
    qkv's dtype, the plain versions on CPU tensors."""
    _, _, D, _ = _check_qkv(qkv, num_heads, None)
    _check_proj(qkv[..., :D], wo, bo)
    return _TinyAttnProj.apply(qkv, wo, bo, mask, num_heads, scale)
