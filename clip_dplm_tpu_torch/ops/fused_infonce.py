"""Fused symmetric InfoNCE: the B x B similarity is never stored.

Counterpart of `clip_dplm_tpu/ops/fused_infonce.py::fused_symmetric_infonce`
and `fused_clip_loss` on the path with no hard-negative cache and no mesh
axis, with the recompute schedule of the backward (`_sym_grad_pass`):

  loss = 0.5 * (mean_i[lse_row_i - scale d_i] + mean_j[lse_col_j - scale d_j])

over s = scale * a b^T with d = rowsum(a * b). The forward takes the row
logsumexp and the column logsumexp (the row lse of b a^T) in one pass
(`csrc/fused_infonce.cu::sym_lse_kernel`); the backward runs the gradient
pass twice, (a, b) and (b, a), each recomputing the raw tiles and forming
acc = (P_row + P_col^T) y with p rounded to the dot dtype, and
rowdot = rowsum(p * raw) (`sym_grad_kernel`). The scalar tail

  da = 0.5 (g/B) scale acc_a - (g/B) scale b,   dscale = 0.5 (g/B) sum(rowdot) - (g/B) sum(d)

is plain torch, as in the reference. `dot_dtype` (bf16 on the train path)
is the type of the operands of both matmuls; d stays f32.

`fused_symmetric_infonce` runs the kernels for CUDA tensors (bf16 dot dtype,
d <= 512) and the plain version, which materializes the B x B similarity,
for CPU tensors. `fused_multiway_clip_loss` sums `fused_clip_loss` over
the modality pairs of tf_clip. The reference's materialized-raw schedule (int16 raw
tiles) and the cached / mesh paths (`fused_row_ce`) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.infonce import effective_scale, l2_normalize, modality_pairs

MAX_DIM = 512  # the grad kernel's accumulator: 32 x d f32 in registers
_BM = 32  # rows per block of both kernels


def _cast(t: torch.Tensor, dot_dtype) -> torch.Tensor:
    return t if dot_dtype is None else t.to(dot_dtype)


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _plain_lse(x, y, scale):
    s = scale * (x.float() @ y.float().t())
    return torch.logsumexp(s, dim=1), torch.logsumexp(s, dim=0)


def _plain_grad(x, y, scale, lse_row, lse_col):
    raw = x.float() @ y.float().t()
    s = raw * scale
    p = torch.exp(s - lse_row[:, None]) + torch.exp(s - lse_col[None, :])
    acc = p.to(y.dtype).float() @ y.float()
    return acc, torch.sum(p * raw, dim=1)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _pad_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero columns up to a multiple of 64 (no dot product changes)."""
    d = t.shape[1]
    dp = -(-d // 64) * 64
    t = t if dp == d else torch.nn.functional.pad(t, (0, dp - d))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_lse(x, y, scale):
    m, n = x.shape[0], y.shape[0]
    xp, yp = _pad_dim(x), _pad_dim(y)
    nm = -(-m // _BM)
    row_lse = torch.empty(m, dtype=torch.float32, device=x.device)
    part = torch.empty((2, nm, n), dtype=torch.float32, device=x.device)
    _build.launch("sym_infonce_lse", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  row_lse.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), m, n,
                  xp.shape[1], _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_lse")
    # exact combine of the per-row-block column partials
    log_part = part[0] + torch.log(torch.clamp(part[1], min=1e-30))
    return row_lse, torch.logsumexp(log_part, dim=0)


def _kernel_grad(x, y, scale, lse_row, lse_col):
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    xp, yp = _pad_dim(x), _pad_dim(y)
    dp = xp.shape[1]
    acc = torch.empty((-(-m // _BM) * _BM, dp), dtype=torch.float32, device=x.device)
    rowdot = torch.empty(m, dtype=torch.float32, device=x.device)
    _build.launch("sym_infonce_grad", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  lse_row.contiguous().data_ptr(), lse_col.contiguous().data_ptr(),
                  acc.data_ptr(), rowdot.data_ptr(), m, n, dp, _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_grad")
    return acc[:m, :d], rowdot


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _SymInfoNCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, scale, dot_dtype, use_kernel):
        ad, bd = _cast(a, dot_dtype), _cast(b, dot_dtype)
        scale32 = scale.float().reshape(1).contiguous()
        lse = _kernel_lse if use_kernel else _plain_lse
        lse_a, lse_b = lse(ad, bd, scale32)
        diag = torch.sum(a.float() * b.float(), dim=-1)
        loss = 0.5 * (torch.mean(lse_a - scale32 * diag) + torch.mean(lse_b - scale32 * diag))
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(a, b, ad, bd, scale32, lse_a, lse_b, diag)
        ctx.scale_shape, ctx.scale_dtype = scale.shape, scale.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        a, b, ad, bd, scale32, lse_a, lse_b, diag = ctx.saved_tensors
        grad = _kernel_grad if ctx.use_kernel else _plain_grad
        acc_a, rowdot = grad(ad, bd, scale32, lse_a, lse_b)
        acc_b, _ = grad(bd, ad, scale32, lse_b, lse_a)
        coef = g.float() / a.shape[0]
        da = 0.5 * coef * scale32 * acc_a - coef * scale32 * b.float()
        db = 0.5 * coef * scale32 * acc_b - coef * scale32 * a.float()
        dscale = 0.5 * coef * torch.sum(rowdot) - coef * torch.sum(diag)
        return (da.to(a.dtype), db.to(b.dtype),
                dscale.reshape(ctx.scale_shape).to(ctx.scale_dtype), None, None)


def _check(a, b, scale):
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, d) of one shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape {tuple(scale.shape)}")


def fused_symmetric_infonce_reference(a, b, scale, dot_dtype=None) -> torch.Tensor:
    """Plain version on any device: the B x B similarity materialized, the
    same rounding points and the same backward."""
    _check(a, b, scale)
    return _SymInfoNCE.apply(a, b, scale, dot_dtype, False)


def fused_symmetric_infonce(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                            dot_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """0.5 * (row-CE(scale a b^T, diag) + row-CE(scale b a^T, diag)); a, b
    (B, d) L2-normalized, scale a one-element tensor. CPU tensors take the
    plain version; CUDA tensors take the kernels (bf16 operands via
    dot_dtype=torch.bfloat16, d <= 512) or raise."""
    _check(a, b, scale)
    if a.device.type == "cpu":
        return _SymInfoNCE.apply(a, b, scale, dot_dtype, False)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if (dot_dtype or a.dtype) != torch.bfloat16:
        raise ValueError("the CUDA kernels take bf16 operands (dot_dtype=torch.bfloat16), "
                         f"got {dot_dtype or a.dtype}")
    if a.shape[1] > MAX_DIM:
        raise ValueError(f"the CUDA kernels take d <= {MAX_DIM}, got d={a.shape[1]}")
    if b.device != a.device or scale.device != a.device:
        raise ValueError("a, b and scale must be on the same CUDA device")
    return _SymInfoNCE.apply(a, b, scale, dot_dtype, True)


def _smoothing_adjustment(x, y, scale, smoothing: float) -> torch.Tensor:
    """Additive term turning the hard-label CE into the label-smoothed CE:
    mean_i[s z_pos_i - s/(n-1) (rowsum_z_i - z_pos_i)], z = scale <x, y>;
    plain ops, so autograd supplies its gradient."""
    n = float(y.shape[0])
    z_pos = scale * torch.sum(x * y, dim=-1)
    rowsum_z = scale * (x @ torch.sum(y, dim=0))
    adj = smoothing * z_pos - (smoothing / max(n - 1.0, 1.0)) * (rowsum_z - z_pos)
    return torch.mean(adj)


def fused_clip_loss(
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    logit_scale: torch.Tensor,
    max_scale: float = 100.0,
    dot_dtype: Optional[torch.dtype] = None,
    label_smoothing: float = 0.0,
    assume_normalized: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for infonce.clip_loss through the fused loss. Returns (loss,
    {loss_a, loss_b, logit_scale}), as the reference's fused path does (no
    accuracy: nothing materializes the similarity)."""
    if assume_normalized:
        a, b = emb_a.float(), emb_b.float()
    else:
        a, b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    loss = fused_symmetric_infonce(a, b, scale, dot_dtype)
    if label_smoothing > 0.0:
        loss = loss + 0.5 * (_smoothing_adjustment(a, b, scale, label_smoothing)
                             + _smoothing_adjustment(b, a, scale, label_smoothing))
    return loss, {"loss_a": loss, "loss_b": loss, "logit_scale": scale}


def fused_multiway_clip_loss(
    embeddings: Dict[str, torch.Tensor],
    logit_scale: torch.Tensor,
    max_scale: float = 100.0,
    dot_dtype: Optional[torch.dtype] = None,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for infonce.multiway_clip_loss through `fused_clip_loss`, one
    pair at a time (no B x B similarity is materialized); the total is the
    sum. Metrics: each pair's loss and the effective logit scale (no
    accuracy, as the reference's fused path)."""
    total = torch.zeros((), device=logit_scale.device)
    metrics: Dict[str, torch.Tensor] = {}
    for a, b in modality_pairs(embeddings):
        loss, _ = fused_clip_loss(embeddings[a], embeddings[b], logit_scale,
                                  max_scale=max_scale, dot_dtype=dot_dtype,
                                  label_smoothing=label_smoothing)
        total = total + loss
        metrics[f"loss_{a}_{b}"] = loss
    metrics["logit_scale"] = effective_scale(logit_scale, max_scale)
    return total, metrics
