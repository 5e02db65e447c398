"""Packed-qkv short-sequence attention with the out-projection fused, its
backward, and the CLS-query attention of a block that keeps only row 0.

Counterpart of `clip_dplm_tpu/ops/short_attention.py`:

- `fused_short_attention_qkv_proj`: y = attention(qkv) @ Wo^T + bo from the
  (B, S, 3D) output of one qkv Dense in [q | k | v] layout, with optional
  rotate-half RoPE on q and k. An autograd Function over three wrappers:
  `short_attention_qkv` (RoPE + attention -> o), `out_projection` (o @ Wo^T
  + bo) and, backward, `short_attention_qkv_bwd` (dqkv from dO = dy·Wo, the
  saved o, qkv and mask; the recompute mode of the TPU kernel). dO is the
  shared bf16 GEMM (`ops/fused_dense.py::_gemm`); dWo = dy^T·o and dbo = Σ dy
  are plain f32-output matmuls, as the JAX package leaves them to XLA, so
  they reach the f32 parameters unrounded.
- `fused_cls_attention`: attention output of query row 0, (B, 1, D), from
  packed qkv; an autograd Function whose backward recomputes the softmax
  from qkv and the mask (`fused_cls_attention_bwd`).

Every wrapper runs its CUDA kernel (`csrc/short_attention.cu`,
`csrc/cls_attention.cu`) for CUDA tensors and its plain PyTorch version
(`*_reference`) for CPU tensors; the plain versions keep the kernels'
rounding points. `short_attention_qkv` and `out_projection` have no backward
of their own: on CUDA they raise where autograd would record them.
"""

from __future__ import annotations

from typing import Optional

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.attention import (
    NEG_INF,
    SHORT_MAX_HEAD_DIM,
    attention_reference,
    merge_heads,
    require_no_grad,
    split_heads,
)

MAX_SEQ = 256  # K and V of a head for the whole sequence sit in shared memory
MAX_SMEM = 232448  # dynamic shared memory of one block on the H100 (227 KB)
CLS_MAX_HEADS = 128  # the TPU kernel's head columns; the port keeps its bound
_NO_GRAD_WHY = "fused_short_attention_qkv_proj is the entry point with a backward"


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


def _rope_rot_inv(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The transpose (= inverse) rotation, in f32: maps the cotangent of the
    rotated q/k to that of the unrotated one."""
    half = g.shape[-1] // 2
    g = g.float()
    g1, g2 = g[..., :half], g[..., half:]
    return torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)


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


def _scale(scale, Dh) -> float:
    return 1.0 / (Dh ** 0.5) if scale is None else float(scale)


def _device_mask(mask, B, S, dev):
    if mask is None:
        return None
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"mask must be ({B}, {S}), got {tuple(mask.shape)}")
    return mask.to(device=dev, dtype=torch.bool).contiguous()


def _kernel_inputs(qkv, num_heads, mask, rope_positions):
    """The short-S kernels' checks; (mask on the device or None, cos, sin)."""
    _require_cuda(qkv)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"the short-S kernel takes 1 <= S <= {MAX_SEQ}, got {S}")
    if Dh % 8 or Dh > SHORT_MAX_HEAD_DIM:
        raise ValueError(f"the short-S kernel takes Dh a multiple of 8 up to "
                         f"{SHORT_MAX_HEAD_DIM}, got {Dh}")
    cos = sin = None
    if rope_positions is not None:
        if tuple(rope_positions.shape) != (S,):
            raise ValueError(f"rope_positions must be ({S},)")
        cos, sin = (t.contiguous() for t in _rope_cos_sin(rope_positions.to(qkv.device), Dh))
    return _device_mask(mask, B, S, qkv.device), cos, sin


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    a multiple of 8 up to 128, no gradient recorded) or raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_reference(
            qkv, num_heads, mask=mask, scale=scale, rope_positions=rope_positions)
    require_no_grad("short_attention_qkv", _NO_GRAD_WHY, qkv)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    mask, cos, sin = _kernel_inputs(qkv, num_heads, mask, rope_positions)
    o = torch.empty((B, S, D), dtype=torch.bfloat16, device=qkv.device)
    _build.launch(
        "short_attention_qkv_fwd", qkv.data_ptr(), _ptr(mask), _ptr(cos), _ptr(sin),
        o.data_ptr(), B, S, num_heads, Dh, _scale(scale, Dh), _build.stream_of(qkv))
    _build.LAUNCHES.add("short_attention")
    return o


# ---------------------------------------------------------------------------
# its backward: (dO, qkv, o) -> dqkv
# ---------------------------------------------------------------------------


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _bwd_smem_bytes(S: int, Dh: int, QT: int) -> int:
    """Shared memory of one backward block (csrc/short_attention.cu::BwdSmem)."""
    a = lambda n: -(-n // 128) * 128  # noqa: E731
    Sp, Dp = _round16(S), _round16(Dh)
    ld_kv, ld_acc, ld_s, ld_p = Dp + 8, Dp + 4, Sp + 4, Sp + 8
    return (2 * a(Sp * ld_kv * 2) + 2 * a(QT * ld_kv * 2) + 2 * a(Sp * ld_acc * 4)
            + a(QT * max(ld_s, ld_acc) * 4) + a(QT * ld_s * 4) + 2 * a(QT * ld_p * 2)
            + a(Sp * 4) + a(QT * 4))


def short_attention_bwd_fits(S: int, Dh: int) -> bool:
    """Whether the backward kernel takes (S, Dh): K, V and the f32 dK/dV of
    a head, and a 16-row query tile, in one block's shared memory (at Dh = 64
    up to S = 208)."""
    return _bwd_smem_bytes(S, Dh, 16) <= MAX_SMEM


def _require_bwd_fits(S: int, Dh: int) -> None:
    if not short_attention_bwd_fits(S, Dh):
        raise ValueError(f"the short-S backward kernel does not fit S={S}, Dh={Dh} in "
                         "shared memory (up to S=208 at Dh=64)")


def short_attention_qkv_bwd_reference(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the backward kernel, (B, S, 3D) dqkv from dout (the
    cotangent of o), qkv, the saved o and the mask. The TPU kernel's rounding
    points in qkv's dtype: q/k rotated in f32 and rounded; f32 scores, max,
    exp, l = max(Σp, 1e-30), prob = p / l; dp = dO·V^T; delta = rowsum(dO∘o);
    ds = prob·(dp − delta)·scale rounded; dq = ds·K and dk = ds^T·Q through
    the inverse rotation in f32; dv = rounded(prob)^T·dO."""
    _, _, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    dt = qkv.dtype
    scale = _scale(scale, Dh)
    qh, kh, vh = (split_heads(qkv[..., i * D:(i + 1) * D], num_heads) for i in range(3))
    if rope_positions is not None:
        cos, sin = _rope_cos_sin(rope_positions.to(qkv.device), Dh)
        qh, kh = _rope_rot(qh, cos, sin).to(dt), _rope_rot(kh, cos, sin).to(dt)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    prob = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    do = split_heads(dout.to(dt), num_heads).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vh.float())
    delta = (do * split_heads(o, num_heads).float()).sum(dim=-1, keepdim=True)
    ds = (prob * (dp - delta) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh.float())
    if rope_positions is not None:
        dq, dk = _rope_rot_inv(dq, cos, sin), _rope_rot_inv(dk, cos, sin)
    dv = torch.einsum("bhqk,bhqd->bhkd", prob.to(dt).float(), do)
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def short_attention_qkv_bwd(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `short_attention_qkv` from its residuals. CPU
    tensors take the plain version; CUDA tensors take the kernel (bf16, the
    forward's bounds, `short_attention_bwd_fits`) or raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_bwd_reference(
            dout, qkv, o, num_heads, mask=mask, scale=scale, rope_positions=rope_positions)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    mask, cos, sin = _kernel_inputs(qkv, num_heads, mask, rope_positions)
    _require_bwd_fits(S, Dh)
    for name, t in (("dout", dout), ("o", o)):
        if tuple(t.shape) != (B, S, D) or t.dtype != torch.bfloat16 or t.device != qkv.device:
            raise ValueError(f"{name} must be ({B}, {S}, {D}) bf16 on {qkv.device}")
    dout, o = dout.contiguous(), o.contiguous()
    dqkv = torch.empty_like(qkv)
    _build.launch(
        "short_attention_qkv_bwd", qkv.data_ptr(), _ptr(mask), _ptr(cos), _ptr(sin),
        o.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), B, S, num_heads, Dh,
        _scale(scale, Dh), _build.stream_of(qkv))
    _build.LAUNCHES.add("short_attention_bwd")
    return dqkv


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
    GEMM kernel (bf16, D a multiple of 8, no gradient recorded) or raise."""
    if o.device.type == "cpu":
        return out_projection_reference(o, wo, bo)
    _require_cuda(o)
    require_no_grad("out_projection", _NO_GRAD_WHY, o, wo, bo)
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
# the fused entry point the model calls, with its backward
# ---------------------------------------------------------------------------


def fused_short_attention_qkv_proj_reference(
    qkv, wo, bo, num_heads, mask=None, scale=None, rope_positions=None,
) -> torch.Tensor:
    """Plain version of `fused_short_attention_qkv_proj` (differentiable by
    autograd through plain ops)."""
    o = short_attention_qkv_reference(qkv, num_heads, mask=mask, scale=scale,
                                      rope_positions=rope_positions)
    return out_projection_reference(o, wo, bo)


def _dout(dy: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """dO = dy @ wo in dy's dtype with f32 accumulation (wo is (out, in)):
    the shared GEMM on the card, plain on the CPU."""
    if dy.device.type == "cpu":
        return (dy.float() @ wo.float()).to(dy.dtype)
    from clip_dplm_tpu_torch.ops.fused_dense import _aligned, _gemm

    D = wo.shape[1]
    return _gemm(_aligned(dy.reshape(-1, wo.shape[0])), _aligned(wo), None, D,
                 b_row=True).reshape(*dy.shape[:-1], D)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result: bf16 operands on the tensor cores on the
    card, f32 on the CPU."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


def _proj_param_grads(dy: torch.Tensor, o: torch.Tensor):
    """(dWo, dbo) of y = o @ Wo^T + bo in f32: dy^T·o, (out, in), and Σ dy."""
    D = o.shape[-1]
    dy2 = dy.reshape(-1, D)
    return _mm_f32(dy2.t(), o.reshape(-1, D)), dy2.float().sum(dim=0)


class _ShortAttnProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, wo, bo, mask, rope_positions, num_heads, scale):
        o = short_attention_qkv(qkv, num_heads, mask=mask, scale=scale,
                                rope_positions=rope_positions)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, o, wo, bo, mask, rope_positions)
        return out_projection(o, wo, bo)

    @staticmethod
    def backward(ctx, dy):
        qkv, o, wo, bo, mask, pos = ctx.saved_tensors
        dy = dy.to(qkv.dtype)
        dqkv = short_attention_qkv_bwd(_dout(dy, wo.to(qkv.dtype)), qkv, o, ctx.num_heads,
                                       mask=mask, scale=ctx.scale, rope_positions=pos)
        dwo, dbo = _proj_param_grads(dy, o)
        return dqkv, dwo.to(wo.dtype), dbo.to(bo.dtype), None, None, None, None


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
    positions for rotate-half RoPE on q/k. Differentiable in qkv, wo and bo:
    the kernels on CUDA tensors (forward: attention, then the projection
    GEMM; backward: the dO GEMM, then the attention backward), the plain
    versions on CPU tensors. On CUDA a shape whose backward does not fit is
    refused before the forward when a gradient will be recorded."""
    _, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    _check_proj(qkv[..., :D], wo, bo)
    if (qkv.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (qkv, wo, bo))):
        _require_bwd_fits(S, Dh)
    return _ShortAttnProj.apply(qkv, wo, bo, mask, rope_positions, num_heads, scale)


# ---------------------------------------------------------------------------
# CLS-query attention: qkv (B, S, 3D) -> (B, 1, D), row 0 only
# ---------------------------------------------------------------------------


def _cls_smem_bytes(S: int, D: int, H: int, bwd: bool) -> int:
    """Shared memory of one CLS block (csrc/cls_attention.cu::ClsSmem)."""
    a = lambda n: -(-n // 128) * 128  # noqa: E731
    groups = max(1, 256 // (D // 8))
    rows = a(H * (S + 1) * 4)
    return (a(D * 4) * (2 if bwd else 1) + rows * (2 if bwd else 1)
            + a(groups * D * 4) + a(S * 4))


def _split_cls(qkv, num_heads, scale):
    B, S, D, Dh = _check_qkv(qkv, num_heads, None)
    q0 = qkv[:, 0, :D].float().reshape(B, num_heads, Dh)
    k, v = (qkv[:, :, i * D:(i + 1) * D].float().reshape(B, S, num_heads, Dh)
            for i in (1, 2))
    return q0, k, v, _scale(scale, Dh)


def _cls_probs(q0, k, mask, scale):
    s = torch.einsum("bhd,bshd->bhs", q0, k) * scale
    if mask is not None:
        s = s + torch.where(mask[:, None, :], 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def fused_cls_attention_reference(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the CLS-query kernel (differentiable by autograd):
    f32 scores, softmax and value sum from qkv's values, the probabilities
    kept in f32 as the TPU kernel keeps them, one rounding to qkv's dtype."""
    B, _, D3 = qkv.shape
    q0, k, v, scale = _split_cls(qkv, num_heads, scale)
    prob = _cls_probs(q0, k, mask, scale)
    o = torch.einsum("bhs,bshd->bhd", prob, v)
    return o.reshape(B, 1, D3 // 3).to(qkv.dtype)


def fused_cls_attention_bwd_reference(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the CLS backward kernel: dqkv (B, S, 3D) from dout
    (B, 1, D) (rounded to qkv's dtype), recomputing the softmax in f32; only
    row 0 of the q part is nonzero."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    q0, k, v, scale = _split_cls(qkv, num_heads, scale)
    prob = _cls_probs(q0, k, mask, scale)
    do = dout.to(qkv.dtype).float().reshape(B, num_heads, -1)
    dp = torch.einsum("bshd,bhd->bhs", v, do)
    ds = prob * (dp - (prob * dp).sum(dim=-1, keepdim=True)) * scale
    dq = torch.zeros(B, S, D, dtype=torch.float32, device=qkv.device)
    dq[:, 0] = torch.einsum("bhs,bshd->bhd", ds, k).reshape(B, D)
    dk = torch.einsum("bhs,bhd->bshd", ds, q0).reshape(B, S, D)
    dv = torch.einsum("bhs,bhd->bshd", prob, do).reshape(B, S, D)
    return torch.cat([dq, dk, dv], dim=-1).to(qkv.dtype)


def _cls_kernel_inputs(qkv, num_heads, mask):
    """The CLS kernels' checks; the mask on the device or None."""
    _require_cuda(qkv)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if num_heads > CLS_MAX_HEADS or (D // num_heads) % 8:
        raise ValueError(f"the CLS kernel takes up to {CLS_MAX_HEADS} heads of a width that "
                         f"is a multiple of 8, got {num_heads} heads of {D // num_heads}")
    if _cls_smem_bytes(S, D, num_heads, True) > MAX_SMEM:
        raise ValueError(f"the CLS kernel does not fit S={S}, H={num_heads} in shared memory")
    return _device_mask(mask, B, S, qkv.device)


def fused_cls_attention_bwd(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `fused_cls_attention` from qkv and the mask. CPU
    tensors take the plain version; CUDA tensors take the kernel or raise."""
    if qkv.device.type == "cpu":
        return fused_cls_attention_bwd_reference(dout, qkv, num_heads, mask=mask, scale=scale)
    B, S, D3 = qkv.shape
    mask = _cls_kernel_inputs(qkv, num_heads, mask)
    D = D3 // 3
    if tuple(dout.shape) != (B, 1, D):
        raise ValueError(f"dout must be ({B}, 1, {D}), got {tuple(dout.shape)}")
    dout = dout.to(torch.bfloat16).contiguous()
    dqkv = torch.empty_like(qkv)
    _build.launch("cls_attention_bwd", qkv.data_ptr(), _ptr(mask), dout.data_ptr(),
                  dqkv.data_ptr(), B, S, num_heads, D // num_heads,
                  _scale(scale, D // num_heads), _build.stream_of(qkv))
    _build.LAUNCHES.add("cls_attention_bwd")
    return dqkv


def _cls_forward(qkv, num_heads, mask, scale):
    if qkv.device.type == "cpu":
        return fused_cls_attention_reference(qkv, num_heads, mask=mask, scale=scale)
    B, S, D3 = qkv.shape
    mask = _cls_kernel_inputs(qkv, num_heads, mask)
    D = D3 // 3
    out = torch.empty((B, 1, D), dtype=torch.bfloat16, device=qkv.device)
    _build.launch("cls_attention_fwd", qkv.data_ptr(), _ptr(mask), out.data_ptr(), B, S,
                  num_heads, D // num_heads, _scale(scale, D // num_heads),
                  _build.stream_of(qkv))
    _build.LAUNCHES.add("cls_attention_fwd")
    return out


class _ClsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, mask)
        return _cls_forward(qkv, num_heads, mask, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, mask = ctx.saved_tensors
        return (fused_cls_attention_bwd(dout, qkv, ctx.num_heads, mask=mask, scale=ctx.scale),
                None, None, None)


def fused_cls_attention(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention output for query row 0 only, (B, 1, D), from packed (B, S,
    3D) qkv: `multihead_attention(q, k, v)[:, :1]` with the probabilities in
    f32. Differentiable in qkv; the backward recomputes the softmax. CUDA
    tensors take the kernels (bf16, up to 128 heads, Dh a multiple of 8),
    CPU tensors the plain versions."""
    _check_qkv(qkv, num_heads, None)
    return _ClsAttention.apply(qkv, mask, num_heads, scale)
