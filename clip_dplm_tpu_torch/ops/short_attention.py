"""Short-sequence attention: from packed qkv with the out-projection fused,
from separate q, k, v, their backward, and the CLS-query attention of a
block that keeps only row 0.

Counterpart of `clip_dplm_tpu/ops/short_attention.py`:

- `fused_short_attention_qkv_proj`: y = attention(qkv) @ Wo^T + bo from the
  (B, S, 3D) output of one qkv Dense in [q | k | v] layout, with optional
  rotate-half RoPE on q and k. An autograd Function over the wrappers
  `short_attention_qkv` (RoPE + attention -> o) or, where a backward follows
  in the saved mode, `short_attention_qkv_save` (o and the bf16
  probabilities), `out_projection` (o @ Wo^T + bo) and, backward,
  `short_attention_qkv_bwd` (dqkv from dO = dy·Wo, the saved o, qkv and
  mask: the recompute mode of the TPU kernel) or `short_attention_qkv_bwd_probs`
  (dqkv from dO, qkv and the saved probabilities: its saved mode). The mode
  is the JAX package's: saved where its padded probabilities take at most
  512 MiB (`saves_probs`), fixed by shape on every device. dO is the shared
  bf16 GEMM (`ops/fused_dense.py::_gemm`); dWo = dy^T·o and dbo = Σ dy are
  plain f32-output matmuls, as the JAX package leaves them to XLA, so they
  reach the f32 parameters unrounded.
- `fused_short_attention` over separate (B, S, D) q, k, v and
  `fused_short_attention_heads` over (B, H, S, Dh) heads, the ops behind
  `multihead_attention` and `attention_dispatch` at 64 <= S < 256: an
  autograd Function (`_ShortAttn`, the JAX package's `_short_attn_core`)
  over `short_attention_sep` or, where a backward follows in the saved mode,
  `short_attention_sep_save`, and backward `short_attention_sep_bwd` (from o
  and the mask) or `short_attention_sep_bwd_probs`, with the same mode rule.
  They launch the packed path's kernels with each operand given by its
  strides (a `qkv.chunk(3, -1)` view is read in place), without RoPE or
  projection; `short_attention_reference` is the JAX package's parity
  target.
- `fused_cls_attention`: attention output of query row 0, (B, 1, D), from
  packed qkv; an autograd Function whose backward recomputes the softmax
  from qkv and the mask (`fused_cls_attention_bwd`: one block a batch row
  and head group where the group's K and V fit shared memory, else one block
  a batch row, by the rule `cls_bwd_design`).

Every wrapper runs its CUDA kernel (`csrc/short_attention.cu`,
`csrc/cls_attention.cu`) for CUDA tensors and its plain PyTorch version
(`*_reference`) for CPU tensors; the plain versions keep the kernels'
rounding points. The forward wrappers (`short_attention_qkv(_save)`,
`short_attention_sep(_save)`) and `out_projection` have no backward of their
own: on CUDA they raise where autograd would record them.
"""

from __future__ import annotations

import ctypes
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
from clip_dplm_tpu_torch.ops.fused_dense import _aligned

MAX_SEQ = 256  # K and V of a head for the whole sequence sit in shared memory
ONE_BLOCK_MAX_SEQ = 128  # the backward's one block a head, both modes
MAX_SMEM = 232448  # dynamic shared memory of one block on the H100 (227 KB)
HALF_SMEM = 115712  # each of two blocks on one SM (228 KB, less 1 KB a block)
# the JAX package's bound on the saved probabilities of one call
SAVE_PROBS_MAX_BYTES = 512 * 1024 * 1024
CLS_MAX_HEADS = 128  # the TPU kernel's head columns; the port keeps its bound
CLS_GROUP_COLS = 64  # the CLS backward's head groups: whole heads, at most this wide
CLS_GROUP_MAX = 256  # rows and columns of one TMA box: a group's S and width
CLS_GROUP_WIDE_ROWS = 96  # S from which a group block takes 256 threads, below it 128
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _jax_seq_pad(S: int) -> int:
    """The TPU kernel's padded sequence length (`_seq_pad`): 128-multiples
    from 64 tokens on, 16-multiples (at least 16) below."""
    return _round_up(S, 128) if S >= 64 else max(16, _round_up(S, 16))


def _jax_rows_per_program(block_b: int, B: int, Sp: int) -> int:
    """The TPU kernel's batch rows per program (`_rows_per_program`)."""
    return max(1, min(block_b * max(1, 128 // Sp), B))


def saves_probs(B: int, S: int, num_heads: int, block_b: int = 8) -> bool:
    """The JAX package's default mode of the short-S attention's backward:
    save the bf16 probabilities where its padded buffer, Bp·H·Sp²·2 bytes
    with its padded counts (Sp = `_jax_seq_pad(S)`, Bp = B rounded up to
    `_jax_rows_per_program(block_b, B, Sp)`; the packed entry has block_b =
    8), takes at most 512 MiB; recompute them above. Fixed by shape, on every
    device."""
    Sp = _jax_seq_pad(S)
    Bp = _round_up(B, _jax_rows_per_program(block_b, B, Sp))
    return Bp * num_heads * Sp * Sp * 2 <= SAVE_PROBS_MAX_BYTES


# ---------------------------------------------------------------------------
# attention: qkv (B, S, 3D) -> o (B, S, D), and in the saved mode the
# probabilities (B, H, S, S)
# ---------------------------------------------------------------------------


def _heads_rotated(qkv, num_heads, rope_positions):
    """(q, k, v) heads, (B, H, S, Dh), with q and k rotated in f32 and
    rounded to qkv's dtype; and the (cos, sin) tables or None."""
    _, _, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    qh, kh, vh = (split_heads(qkv[..., i * D:(i + 1) * D], num_heads) for i in range(3))
    cs = None
    if rope_positions is not None:
        cs = _rope_cos_sin(rope_positions.to(qkv.device), Dh)
        qh, kh = (_rope_rot(t, *cs).to(qkv.dtype) for t in (qh, kh))
    return qh, kh, vh, cs


def _exp_scores(qh, kh, mask, scale):
    """(p, l) of the kernels' softmax in f32: f32 scores · scale + key bias,
    max, p = exp(s − max), l = max(Σp, 1e-30)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    if mask is not None:
        s = s + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def _probs_f32(qh, kh, mask, scale):
    """The kernels' probabilities in f32, prob = p / l (`_exp_scores`)."""
    p, l = _exp_scores(qh, kh, mask, scale)
    return p / l


def short_attention_qkv_reference(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
    return_probs: bool = False,
):
    """Plain version: rotate q/k in f32 (rounded back to qkv's dtype), then
    attention_reference over the heads. With return_probs, (o, probs): the
    (B, H, S, S) probabilities rounded to bf16 whatever qkv's dtype, as the
    saving kernel writes them."""
    qh, kh, vh, _ = _heads_rotated(qkv, num_heads, rope_positions)
    o = merge_heads(attention_reference(qh, kh, vh, mask=mask, scale=scale))
    if not return_probs:
        return o
    prob = _probs_f32(qh, kh, mask, _scale(scale, qh.shape[-1]))
    return o, prob.to(torch.bfloat16)


def _attention_kernel(qkv, num_heads, mask, scale, rope_positions, save: bool):
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    mask, cos, sin = _kernel_inputs(qkv, num_heads, mask, rope_positions)
    o = torch.empty((B, S, D), dtype=torch.bfloat16, device=qkv.device)
    probs = (torch.empty((B, num_heads, S, S), dtype=torch.bfloat16, device=qkv.device)
             if save else None)
    _build.launch(
        "short_attention_qkv_fwd", qkv.data_ptr(), _ptr(mask), _ptr(cos), _ptr(sin),
        o.data_ptr(), _ptr(probs), B, S, num_heads, Dh, _scale(scale, Dh),
        _build.stream_of(qkv))
    return o, probs


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
    o, _ = _attention_kernel(qkv, num_heads, mask, scale, rope_positions, save=False)
    _build.LAUNCHES.add("short_attention")
    return o


def short_attention_qkv_save(
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
):
    """`short_attention_qkv` that also returns the probabilities, (o (B, S,
    D), probs (B, H, S, S) bf16): the saved mode's residual. CPU tensors take
    the plain version; CUDA tensors the kernel (its bounds, no gradient
    recorded) or raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_reference(qkv, num_heads, mask=mask, scale=scale,
                                             rope_positions=rope_positions, return_probs=True)
    require_no_grad("short_attention_qkv_save", _NO_GRAD_WHY, qkv)
    out = _attention_kernel(qkv, num_heads, mask, scale, rope_positions, save=True)
    _build.LAUNCHES.add("short_attention_save")
    return out


# ---------------------------------------------------------------------------
# its backward: (dO, qkv, o or the probabilities) -> dqkv
# ---------------------------------------------------------------------------


def _a128(n: int) -> int:
    return _round_up(n, 128)


def _bwd_dq_smem_bytes(Sp: int, Dp: int, QT: int, saved: bool) -> int:
    """Shared memory of one dQ block (csrc/short_attention.cu::BwdQSmem)."""
    ld_kv, ld_sq, ld_p = Dp + 8, max(Sp, Dp) + 4, Sp + 8
    p = QT * ld_p * 2 if saved else QT * ld_sq * 4
    return (2 * _a128(Sp * ld_kv * 2) + 2 * _a128(QT * ld_kv * 2) + _a128(p)
            + _a128(QT * ld_sq * 4) + _a128(QT * ld_p * 2) + (0 if saved else _a128(Sp * 4)))


def _bwd_dkv_smem_bytes(KT: int, Dp: int, QT: int, saved: bool) -> int:
    """Shared memory of one dK/dV block (csrc/short_attention.cu::BwdKVSmem)."""
    ld_kv, ld_acc, ld_s, ld_p = Dp + 8, Dp + 4, KT + 4, KT + 8
    return (2 * _a128(KT * ld_kv * 2) + 2 * _a128(QT * ld_kv * 2) + 2 * _a128(KT * ld_acc * 4)
            + (0 if saved else _a128(QT * ld_s * 4)) + _a128(QT * ld_s * 4)
            + 2 * _a128(QT * ld_p * 2) + (0 if saved else _a128(KT * 4))
            + _a128(3 * QT * 4))


def _fitting(layout, first: int) -> int:
    """Bytes of the layout at the most query rows (first, then fewer by 16)
    that fit half an SM's shared memory (two blocks an SM), else one
    block's; 0 when none does."""
    for cap in (HALF_SMEM, MAX_SMEM):
        for rows in range(first, 15, -16):
            if layout(rows) <= cap:
                return layout(rows)
    return 0


def bwd_smem_bytes(S: int, Dh: int, saved: bool):
    """(dQ block, dK/dV block) shared memory in bytes of the backward at (S,
    Dh) in a mode, with the tiles the launcher picks (csrc/short_attention.cu
    ::bwd_dq_rows, bwd_dkv_rows; dK/dV over 64-key tiles); 0 for a block that
    does not fit. The C launcher's `short_attention_bwd_smem` computes the
    same."""
    Sp, Dp = _round_up(S, 16), _round_up(Dh, 16)
    KT = min(Sp, 64)
    return (_fitting(lambda QT: _bwd_dq_smem_bytes(Sp, Dp, QT, saved), KT),
            _fitting(lambda QT: _bwd_dkv_smem_bytes(KT, Dp, QT, saved), KT))


def _one_block(S: int, Dh: int) -> bool:
    return S <= ONE_BLOCK_MAX_SEQ and Dh <= SHORT_MAX_HEAD_DIM


def bwd_saved_design(S: int, Dh: int) -> str:
    """The launches of the backward from the saved probabilities at (S, Dh),
    as csrc/short_attention.cu::launch_bwd_saved picks them: "one block" (a
    head a block, `short_attn_bwd_block_kernel`) at S <= 128, "pair" (the dQ
    and dK/dV launches, which pass delta through a (B, H, 3, S) f32 scratch)
    past it."""
    return "one block" if _one_block(S, Dh) else "pair"


def _block_smem_bytes(S: int, Dh: int, saved: bool) -> int:
    """csrc/short_attention.cu::BwdBlockSmem: Q, K, V and dO of the head at R
    = 64 or 128 rows and Dp = 64 or 128 columns, the probabilities (R x R;
    recompute mode: o first, the larger of the two), in recompute mode the
    key bias (R floats), one mbarrier, 1 KB for the base's alignment."""
    R, Dp = (64 if S <= 64 else 128), (64 if Dh <= 64 else 128)
    probs = R * R * 2 if saved else max(R * R, R * Dp) * 2 + R * 4
    return 4 * R * Dp * 2 + probs + 8 + 1024


def bwd_saved_smem_bytes(S: int, Dh: int) -> int:
    """Shared memory in bytes of the one-block saved backward's block at (S,
    Dh) (`_block_smem_bytes`); 0 where it does not run."""
    return _block_smem_bytes(S, Dh, True) if bwd_saved_design(S, Dh) == "one block" else 0


def bwd_recompute_design(S: int, Dh: int) -> str:
    """The launches of the recompute-mode backward at (S, Dh), as
    csrc/short_attention.cu::launch_bwd_recompute picks them: "one block" (a
    head a block, `short_attn_bwd_block_kernel` with the scores recomputed on
    wgmma) at S <= 128; past it "head" (the WMMA one-block-a-head kernel,
    `short_attn_bwd_head_kernel`) where its layout fits (`bwd_head_smem_bytes`:
    S <= 208 at Dh = 64), else "pair" (the dQ and dK/dV launches, which pass
    m, l and delta through a (B, H, 3, S) f32 scratch)."""
    if _one_block(S, Dh):
        return "one block"
    return "head" if bwd_head_smem_bytes(S, Dh) else "pair"


def bwd_recompute_smem_bytes(S: int, Dh: int) -> int:
    """Shared memory in bytes of the one-block recompute backward's block at
    (S, Dh) (`_block_smem_bytes`: o lands where the probabilities go, the key
    bias after them); 0 where it does not run."""
    return _block_smem_bytes(S, Dh, False) if bwd_recompute_design(S, Dh) == "one block" else 0


def cls_bwd_groups(D: int, H: int):
    """(heads a group, the group's columns, groups a batch row) of the CLS
    backward's group design (csrc/cls_attention.cu::ClsGroups): whole heads,
    at most CLS_GROUP_COLS columns, one head where Dh is wider; the last group
    holds the heads left over."""
    Dh = D // H
    heads = min(max(CLS_GROUP_COLS // Dh, 1), H)
    return heads, heads * Dh, -(-H // heads)


def cls_bwd_group_threads(S: int) -> int:
    """Threads of one block of the CLS backward's group design
    (csrc/cls_attention.cu::cls_group_threads)."""
    return 256 if S >= CLS_GROUP_WIDE_ROWS else 128


def cls_bwd_group_smem_bytes(S: int, D: int, H: int) -> int:
    """Shared memory of one block of the CLS backward's group design
    (csrc/cls_attention.cu::ClsGroupSmem): the group's K and V tiles (S x
    cols bf16; V's holds dq0's partials after the scores, 8 floats a thread,
    where those are more), q0 and dout in f32, prob and ds (heads x S f32),
    the key bias, one mbarrier, 128 bytes for the base's alignment."""
    heads, cols, _ = cls_bwd_groups(D, H)
    tile = S * cols * 2
    return (_a128(tile) + _a128(max(tile, cls_bwd_group_threads(S) * 8 * 4)) + 2 * _a128(cols * 4)
            + 2 * _a128(heads * S * 4) + _a128(S * 4) + 8 + 128)


def cls_bwd_design(S: int, D: int, H: int) -> str:
    """The launch of the CLS backward at (S, D, H), as
    csrc/cls_attention.cu::launch_cls_bwd picks it: "group" (one block a
    batch row and head group, K and V of the group staged once by TMA) where
    S and the group's width fit one TMA box (<= 256) and its layout fits a
    block's shared memory (`cls_bwd_group_smem_bytes`), else "row" (one block
    a batch row, `_cls_smem_bytes`). The launcher counts the calls of each
    (`cls_attention_bwd_calls`: 0 group, 1 row)."""
    _, cols, _ = cls_bwd_groups(D, H)
    fits = (1 <= S <= CLS_GROUP_MAX and cols <= CLS_GROUP_MAX
            and cls_bwd_group_smem_bytes(S, D, H) <= MAX_SMEM)
    return "group" if fits else "row"


def cls_bwd_smem_bytes(S: int, D: int, H: int) -> int:
    """Shared memory in bytes of the block the CLS backward launches at (S,
    D, H), 0 where neither design fits (the C launcher's
    `cls_attention_bwd_smem` computes the same)."""
    if cls_bwd_design(S, D, H) == "group":
        return cls_bwd_group_smem_bytes(S, D, H)
    row = _cls_smem_bytes(S, D, H, True)
    return row if row <= MAX_SMEM else 0


def _pair_stats(design: str, B: int, S: int, H: int, dev) -> Optional[torch.Tensor]:
    """The (B, H, 3, S) f32 scratch of the dQ and dK/dV pair where `design`
    is "pair", else None."""
    if design != "pair":
        return None
    return torch.empty((B, H, 3, S), dtype=torch.float32, device=dev)


def _saved_stats(B: int, S: int, H: int, Dh: int, dev) -> Optional[torch.Tensor]:
    """The scratch of the saved-mode pair, None where the one-block kernel
    runs."""
    return _pair_stats(bwd_saved_design(S, Dh), B, S, H, dev)


def _recompute_stats(B: int, S: int, H: int, Dh: int, dev) -> Optional[torch.Tensor]:
    """The scratch of the recompute-mode pair, None where one block a head
    runs (either kernel)."""
    return _pair_stats(bwd_recompute_design(S, Dh), B, S, H, dev)


def _bwd_head_smem_bytes(Sp: int, Dp: int, QT: int) -> int:
    """Shared memory of one block of the WMMA one-block-a-head recompute
    kernel (csrc/short_attention.cu::BwdHeadSmem)."""
    ld_kv, ld_acc, ld_s, ld_p = Dp + 8, Dp + 4, Sp + 4, Sp + 8
    return (2 * _a128(Sp * ld_kv * 2) + 2 * _a128(QT * ld_kv * 2) + 2 * _a128(Sp * ld_acc * 4)
            + _a128(QT * max(ld_s, ld_acc) * 4) + _a128(QT * ld_s * 4)
            + 2 * _a128(QT * ld_p * 2) + _a128(Sp * 4) + _a128(QT * 4))


def bwd_head_smem_bytes(S: int, Dh: int) -> int:
    """Shared memory in bytes of the recompute backward's WMMA
    one-block-a-head kernel at (S, Dh), 64 query rows halved while it does
    not fit (csrc/short_attention.cu::bwd_head_rows); 0 where even 16 rows do
    not fit, and past S = 128 the recompute mode then takes the dQ and dK/dV
    launches. It runs only past S = 128 (`bwd_recompute_design`)."""
    Sp, Dp = _round_up(S, 16), _round_up(Dh, 16)
    QT = min(Sp, 64)
    while QT > 16 and _bwd_head_smem_bytes(Sp, Dp, QT) > MAX_SMEM:
        QT //= 2
    return _bwd_head_smem_bytes(Sp, Dp, QT) if _bwd_head_smem_bytes(Sp, Dp, QT) <= MAX_SMEM else 0


def short_attention_qkv_bwd_reference(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the recompute-mode backward, (B, S, 3D) dqkv from
    dout (the cotangent of o), qkv, the saved o and the mask. The TPU
    kernel's rounding points in qkv's dtype: q/k rotated in f32 and rounded;
    f32 scores, max, exp, l = max(Σp, 1e-30), prob = p / l; dp = dO·V^T;
    delta = rowsum(dO∘o); ds = prob·(dp − delta)·scale rounded; dq = ds·K
    and dk = ds^T·Q through the inverse rotation in f32; dv =
    rounded(prob)^T·dO."""
    dt = qkv.dtype
    qh, kh, vh, cs = _heads_rotated(qkv, num_heads, rope_positions)
    scale = _scale(scale, qh.shape[-1])
    prob = _probs_f32(qh, kh, mask, scale)
    do = split_heads(dout.to(dt), num_heads).float()
    delta = (do * split_heads(o, num_heads).float()).sum(dim=-1, keepdim=True)
    return _dqkv_from_probs(do, qh, kh, vh, cs, prob, delta, scale, dt)


def _grads_from_probs(do, qh, kh, vh, prob, delta, scale, dt):
    """f32 (dq, dk, dv) heads from f32 dO heads and the f32 probabilities: dp
    = dO·V^T, delta = Σ dp·prob where not given (saved mode), ds =
    prob·(dp − delta)·scale rounded to dt, dq = ds·K, dk = ds^T·Q, dv =
    rounded(prob)^T·dO."""
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vh.float())
    if delta is None:  # saved mode: from the probabilities
        delta = (dp * prob).sum(dim=-1, keepdim=True)
    ds = (prob * (dp - delta) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", prob.to(dt).float(), do)
    return dq, dk, dv


def _dqkv_from_probs(do, qh, kh, vh, cs, prob, delta, scale, dt):
    """dqkv (B, S, 3D) from `_grads_from_probs`, dq and dk through the
    inverse rotation in f32."""
    dq, dk, dv = _grads_from_probs(do, qh, kh, vh, prob, delta, scale, dt)
    if cs is not None:
        dq, dk = _rope_rot_inv(dq, *cs), _rope_rot_inv(dk, *cs)
    return torch.cat([merge_heads(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def short_attention_qkv_bwd_probs_reference(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    probs: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the saved-mode backward, (B, S, 3D) dqkv from dout,
    qkv and the saved bf16 probabilities (B, H, S, S), at the TPU kernel's
    saved-mode rounding points: dp = dO·V^T in f32, delta = Σ dp·prob from
    the bf16 probabilities, ds = prob·(dp − delta)·scale rounded to qkv's
    dtype, dq = ds·K and dk = ds^T·Q through the inverse rotation in f32, dv =
    prob^T·dO. The mask is in the probabilities."""
    dt = qkv.dtype
    qh, kh, vh, cs = _heads_rotated(qkv, num_heads, rope_positions)
    do = split_heads(dout.to(dt), num_heads).float()
    return _dqkv_from_probs(do, qh, kh, vh, cs, probs.float(), None,
                            _scale(scale, qh.shape[-1]), dt)


def _check_residual(name, t, shape, dev):
    if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != dev:
        raise ValueError(f"{name} must be {shape} bf16 on {dev}")
    return t.contiguous()


def short_attention_qkv_bwd(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `short_attention_qkv` from its residuals, recompute
    mode. CPU tensors take the plain version; CUDA tensors take the kernels
    (bf16, the forward's bounds: one block a head at S <= 128 and, past it,
    where the WMMA head kernel fits, else a dQ launch and a dK/dV launch;
    `bwd_recompute_design`) or raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_bwd_reference(
            dout, qkv, o, num_heads, mask=mask, scale=scale, rope_positions=rope_positions)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    mask, cos, sin = _kernel_inputs(qkv, num_heads, mask, rope_positions)
    dout, o = (_check_residual(n, t, (B, S, D), qkv.device) for n, t in (("dout", dout), ("o", o)))
    dqkv = torch.empty_like(qkv)
    stats = _recompute_stats(B, S, num_heads, Dh, qkv.device)
    _build.launch(
        "short_attention_qkv_bwd", qkv.data_ptr(), _ptr(mask), _ptr(cos), _ptr(sin),
        o.data_ptr(), dout.data_ptr(), _ptr(stats), dqkv.data_ptr(), B, S, num_heads, Dh,
        _scale(scale, Dh), _build.stream_of(qkv))
    _build.LAUNCHES.add("short_attention_bwd")
    return dqkv


def short_attention_qkv_bwd_probs(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    probs: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `short_attention_qkv_save` from dout, qkv and its
    saved probabilities, saved mode. CPU tensors take the plain version; CUDA
    tensors take the kernels (bf16, the forward's bounds: one block a head
    at S <= 128, else a dQ launch and a dK/dV launch; `bwd_saved_design`) or
    raise."""
    if qkv.device.type == "cpu":
        return short_attention_qkv_bwd_probs_reference(
            dout, qkv, probs, num_heads, scale=scale, rope_positions=rope_positions)
    B, S, D, Dh = _check_qkv(qkv, num_heads, rope_positions)
    _, cos, sin = _kernel_inputs(qkv, num_heads, None, rope_positions)
    dout = _check_residual("dout", dout, (B, S, D), qkv.device)
    probs = _check_residual("probs", probs, (B, num_heads, S, S), qkv.device)
    dqkv = torch.empty_like(qkv)
    stats = _saved_stats(B, S, num_heads, Dh, qkv.device)
    _build.launch(
        "short_attention_qkv_bwd_probs", qkv.data_ptr(), _ptr(cos), _ptr(sin), probs.data_ptr(),
        dout.data_ptr(), _ptr(stats), dqkv.data_ptr(), B, S, num_heads, Dh,
        _scale(scale, Dh), _build.stream_of(qkv))
    _build.LAUNCHES.add("short_attention_bwd_probs")
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
    from clip_dplm_tpu_torch.ops.fused_dense import _gemm

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
    def forward(ctx, qkv, wo, bo, mask, rope_positions, num_heads, scale, save_probs):
        if save_probs:
            o, probs = short_attention_qkv_save(qkv, num_heads, mask=mask, scale=scale,
                                                rope_positions=rope_positions)
        else:
            o = short_attention_qkv(qkv, num_heads, mask=mask, scale=scale,
                                    rope_positions=rope_positions)
            probs = None
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, o, probs, wo, bo, mask, rope_positions)
        return out_projection(o, wo, bo)

    @staticmethod
    def backward(ctx, dy):
        qkv, o, probs, wo, bo, mask, pos = ctx.saved_tensors
        dy = dy.to(qkv.dtype)
        dout = _dout(dy, wo.to(qkv.dtype))
        if probs is not None:
            dqkv = short_attention_qkv_bwd_probs(dout, qkv, probs, ctx.num_heads,
                                                 scale=ctx.scale, rope_positions=pos)
        else:
            dqkv = short_attention_qkv_bwd(dout, qkv, o, ctx.num_heads, mask=mask,
                                           scale=ctx.scale, rope_positions=pos)
        dwo, dbo = _proj_param_grads(dy, o)
        return dqkv, dwo.to(wo.dtype), dbo.to(bo.dtype), None, None, None, None, None


def fused_short_attention_qkv_proj(
    qkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope_positions: Optional[torch.Tensor] = None,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """y = attention(qkv) @ wo^T + bo, (B, S, D) out; rope_positions: (S,)
    positions for rotate-half RoPE on q/k. Differentiable in qkv, wo and bo:
    the kernels on CUDA tensors (forward: attention, then the projection
    GEMM; backward: the dO GEMM, then the attention backward), the plain
    versions on CPU tensors. `save_probs` is the JAX package's argument:
    where a gradient will be recorded, True saves the bf16 probabilities in
    the forward and the backward reads them, False recomputes them from qkv,
    o and the mask, None takes the JAX package's rule (`saves_probs`).
    Without a gradient nothing is saved."""
    B, S, D, _ = _check_qkv(qkv, num_heads, rope_positions)
    _check_proj(qkv[..., :D], wo, bo)
    save = _save_mode(save_probs, (B, S, num_heads, 8), qkv, wo, bo)
    return _ShortAttnProj.apply(qkv, wo, bo, mask, rope_positions, num_heads, scale, save)


def _save_mode(save_probs, rule_args, *inputs) -> bool:
    """Whether the forward saves the probabilities: only where a gradient
    will be recorded, then as `save_probs` says or, for None, as the JAX
    package's rule (`saves_probs(*rule_args)`) picks."""
    if save_probs is None:
        save_probs = saves_probs(*rule_args)
    return bool(save_probs) and torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


# ---------------------------------------------------------------------------
# attention over separate q, k, v: (B, S, D) tensors or (B, H, S, Dh) heads
# ---------------------------------------------------------------------------

_SEP_NO_GRAD_WHY = "fused_short_attention(_heads) is the entry point with a backward"


def _sep_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The (B, H, S, Dh) view of a (B, S, D) operand, or the heads as given."""
    return t if t.dim() == 4 else split_heads(t, num_heads)


def _from_heads(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, H, S, Dh) heads back in the layout of `like`."""
    return x if like.dim() == 4 else merge_heads(x)


def _check_sep(q, k, v, num_heads):
    """Shape checks of separate operands; (B, S, H, Dh)."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"separate attention needs q, k, v of one shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dim() == 4:
        B, H, S, Dh = q.shape
        if H != num_heads:
            raise ValueError(f"heads (B, H, S, Dh) with H={H}, num_heads={num_heads}")
        return B, S, H, Dh
    if q.dim() != 3:
        raise ValueError(f"q must be (B, S, D) or (B, H, S, Dh), got {tuple(q.shape)}")
    B, S, D = q.shape
    if D % num_heads:
        raise ValueError(f"D={D} not divisible by num_heads={num_heads}")
    return B, S, num_heads, D // num_heads


def short_attention_sep_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_probs: bool = False,
):
    """Plain version of the separate-operand forward kernel, o in q's layout
    ((B, S, D) or (B, H, S, Dh)), at the TPU kernel's rounding points: f32
    scores · scale + key bias, p = exp(s − max), l = max(Σp, 1e-30), o =
    (p in v's dtype)·V in f32, divided by l, rounded to q's dtype. With
    return_probs, (o, probs): bf16(p / l), (B, H, S, S), whatever q's dtype,
    as the saving kernel writes them."""
    _check_sep(q, k, v, num_heads)
    qh, kh, vh = (_sep_heads(t, num_heads) for t in (q, k, v))
    scale = _scale(scale, qh.shape[-1])
    p, l = _exp_scores(qh, kh, mask, scale)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vh.float()) / l
    o = _from_heads(o.to(q.dtype), q)
    return (o, (p / l).to(torch.bfloat16)) if return_probs else o


def short_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The JAX package's parity target of `fused_short_attention`: head split,
    `attention_reference`, merge; (B, S, D) in and out."""
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    return merge_heads(attention_reference(qh, kh, vh, mask=mask, scale=scale))


def short_attention_sep_bwd_reference(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Plain version of the recompute-mode backward, (dq, dk, dv) in q's
    layout from dout (the cotangent of o, rounded to q's dtype), q, k, v, the
    saved o and the mask: the forward's f32 probabilities recomputed, delta =
    rowsum(dO∘o), then `_grads_from_probs`, each rounded to q's dtype."""
    dt = q.dtype
    qh, kh, vh = (_sep_heads(t, num_heads) for t in (q, k, v))
    scale = _scale(scale, qh.shape[-1])
    do = _sep_heads(dout.to(dt), num_heads).float()
    delta = (do * _sep_heads(o, num_heads).float()).sum(dim=-1, keepdim=True)
    grads = _grads_from_probs(do, qh, kh, vh, _probs_f32(qh, kh, mask, scale), delta, scale, dt)
    return tuple(_from_heads(g.to(dt), q) for g in grads)


def short_attention_sep_bwd_probs_reference(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    probs: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
):
    """Plain version of the saved-mode backward, (dq, dk, dv) in q's layout
    from dout, q, k, v and the saved bf16 probabilities: delta = Σ dp·prob,
    then `_grads_from_probs`. The mask is in the probabilities."""
    dt = q.dtype
    qh, kh, vh = (_sep_heads(t, num_heads) for t in (q, k, v))
    do = _sep_heads(dout.to(dt), num_heads).float()
    grads = _grads_from_probs(do, qh, kh, vh, probs.float(), None,
                              _scale(scale, qh.shape[-1]), dt)
    return tuple(_from_heads(g.to(dt), q) for g in grads)


def _operand(t: torch.Tensor) -> _build.Operand:
    """A (B, H, S, Dh) view with a unit last stride as the kernels take it."""
    return _build.Operand(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _sep_kernel_inputs(q, k, v, num_heads, mask, *rest):
    """The separate-operand kernels' checks: bounds first, then device and
    dtype. Returns the mask on the device (or None), then (B, S, H, Dh), then
    the (B, H, S, Dh) views of q, k, v and of each of `rest` (tensors in q's
    layout) with a unit last stride (a copy only where it was not)."""
    B, S, H, Dh = _check_sep(q, k, v, num_heads)
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"the short-S kernel takes 1 <= S <= {MAX_SEQ}, got {S}")
    if Dh % 8 or Dh > SHORT_MAX_HEAD_DIM:
        raise ValueError(f"the short-S kernel takes Dh a multiple of 8 up to "
                         f"{SHORT_MAX_HEAD_DIM}, got {Dh}")
    if B > 65535:
        raise ValueError(f"the short-S kernel takes B <= 65535, got {B}")
    for t in (q, k, v, *rest):
        _require_cuda(t)
        if t.device != q.device:
            raise ValueError(f"operands on {q.device} and {t.device}")
    views = []
    for t in (q, k, v, *rest):
        t = _sep_heads(t, num_heads)
        views.append(t if t.stride(-1) == 1 else t.contiguous())
    return _device_mask(mask, B, S, q.device), (B, S, H, Dh), views


def _sep_forward(q, k, v, num_heads, mask, scale, save: bool):
    mask, (B, S, H, Dh), (qh, kh, vh) = _sep_kernel_inputs(q, k, v, num_heads, mask)
    o = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    probs = (torch.empty((B, H, S, S), dtype=torch.bfloat16, device=q.device)
             if save else None)
    ops = [_operand(t) for t in (qh, kh, vh, _sep_heads(o, H))]
    args = [ctypes.byref(x) for x in ops[:3]] + [_ptr(mask), ctypes.byref(ops[3])]
    if save:
        _build.launch("short_attention_sep_fwd_save", *args, probs.data_ptr(), B, S, H, Dh,
                      _scale(scale, Dh), _build.stream_of(q))
    else:
        _build.launch("short_attention_sep_fwd", *args, B, S, H, Dh, _scale(scale, Dh),
                      _build.stream_of(q))
    return o, probs


def short_attention_sep(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head self-attention over separate q, k, v, each (B, S, D) or
    (B, H, S, Dh); o in that layout. CPU tensors take the plain version; CUDA
    tensors take the kernel (bf16, 1 <= S <= 256, Dh a multiple of 8 up to
    128, B <= 65535, no gradient recorded; any strides with a unit last one)
    or raise."""
    if q.device.type == "cpu":
        return short_attention_sep_reference(q, k, v, num_heads, mask=mask, scale=scale)
    require_no_grad("short_attention_sep", _SEP_NO_GRAD_WHY, q, k, v)
    o, _ = _sep_forward(q, k, v, num_heads, mask, scale, save=False)
    _build.LAUNCHES.add("short_attention_sep")
    return o


def short_attention_sep_save(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """`short_attention_sep` that also returns the probabilities, (o, probs
    (B, H, S, S) bf16): the saved mode's residual. CPU tensors take the plain
    version; CUDA tensors the kernel (its bounds) or raise."""
    if q.device.type == "cpu":
        return short_attention_sep_reference(q, k, v, num_heads, mask=mask, scale=scale,
                                             return_probs=True)
    require_no_grad("short_attention_sep_save", _SEP_NO_GRAD_WHY, q, k, v)
    out = _sep_forward(q, k, v, num_heads, mask, scale, save=True)
    _build.LAUNCHES.add("short_attention_sep_save")
    return out


def _sep_backward(name, dout, q, k, v, num_heads, mask, scale, o=None, probs=None):
    """Launch `name` (the recompute backward from o and the mask, or the one
    from the probabilities); (dq, dk, dv) in q's layout."""
    rest = (dout,) if o is None else (dout, o)
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"dout and o must be {tuple(q.shape)}, got {tuple(t.shape)}")
    mask, (B, S, H, Dh), views = _sep_kernel_inputs(q, k, v, num_heads, mask, *rest)
    grads = [torch.empty(q.shape, dtype=torch.bfloat16, device=q.device) for _ in range(3)]
    ops = [_operand(t) for t in views + [_sep_heads(g, H) for g in grads]]
    qkv_ops = [ctypes.byref(x) for x in ops[:3]]
    grad_ops = [ctypes.byref(x) for x in ops[-3:]]
    if o is None:
        probs = _check_residual("probs", probs, (B, H, S, S), q.device)
        stats = _saved_stats(B, S, H, Dh, q.device)
        _build.launch(name, *qkv_ops, probs.data_ptr(), ctypes.byref(ops[3]), _ptr(stats),
                      *grad_ops, B, S, H, Dh, _scale(scale, Dh), _build.stream_of(q))
    else:
        stats = _recompute_stats(B, S, H, Dh, q.device)
        _build.launch(name, *qkv_ops, _ptr(mask), ctypes.byref(ops[4]), ctypes.byref(ops[3]),
                      _ptr(stats), *grad_ops, B, S, H, Dh, _scale(scale, Dh),
                      _build.stream_of(q))
    _build.LAUNCHES.add(name)
    return tuple(grads)


def short_attention_sep_bwd(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of `short_attention_sep` from its residuals, recompute
    mode, in q's layout. CPU tensors take the plain version; CUDA tensors
    take the kernels (the forward's bounds: one block a head at S <= 128 and,
    past it, where the WMMA head kernel fits, else a dQ and a dK/dV launch;
    `bwd_recompute_design`) or raise."""
    if q.device.type == "cpu":
        return short_attention_sep_bwd_reference(dout, q, k, v, o, num_heads, mask=mask,
                                                 scale=scale)
    return _sep_backward("short_attention_sep_bwd", dout, q, k, v, num_heads, mask, scale, o=o)


def short_attention_sep_bwd_probs(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    probs: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of `short_attention_sep_save` from dout, q, k, v and its
    saved probabilities, saved mode, in q's layout. CPU tensors take the
    plain version; CUDA tensors take the kernels (the forward's bounds: one
    block a head at S <= 128, else a dQ and a dK/dV launch;
    `bwd_saved_design`) or raise."""
    if q.device.type == "cpu":
        return short_attention_sep_bwd_probs_reference(dout, q, k, v, probs, num_heads,
                                                       scale=scale)
    return _sep_backward("short_attention_sep_bwd_probs", dout, q, k, v, num_heads, None, scale,
                         probs=probs)


class _ShortAttn(torch.autograd.Function):
    """The counterpart of the JAX package's `_short_attn_core`: o from q, k, v
    in one layout; saving the probabilities where asked (only ever with a
    gradient to record), else keeping o for the recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, scale, save_probs):
        if save_probs:
            o, probs = short_attention_sep_save(q, k, v, num_heads, mask=mask, scale=scale)
        else:
            o, probs = short_attention_sep(q, k, v, num_heads, mask=mask, scale=scale), None
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(q, k, v, None if save_probs else o, probs, mask)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, probs, mask = ctx.saved_tensors
        do = do.to(q.dtype)
        if probs is not None:
            grads = short_attention_sep_bwd_probs(do, q, k, v, probs, ctx.num_heads,
                                                  scale=ctx.scale)
        else:
            grads = short_attention_sep_bwd(do, q, k, v, o, ctx.num_heads, mask=mask,
                                            scale=ctx.scale)
        return (*grads, None, None, None, None)


def fused_short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_b: int = 8,
    layout: str = "bhsd",
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """Multi-head self-attention over (B, S, D) q, k, v, D = num_heads · Dh;
    (B, S, D) out, as `ops/attention.py::multihead_attention`. mask: (B, S)
    bool, True = real token. Differentiable in q, k and v: the kernels on
    CUDA tensors (any strides with a unit last one, so `qkv.chunk(3, -1)`
    views are read in place), the plain versions on CPU tensors.

    `layout` ('bhsd' or 'bsd') is the JAX package's choice of TPU block
    layout; the card has no counterpart of it, so both compute the same
    thing the same way. `block_b` (the TPU kernel's batch rows per program)
    enters only the JAX package's rule for `save_probs=None` (`saves_probs`).
    Where a gradient will be recorded, True saves the bf16 probabilities in
    the forward and the backward reads them; False recomputes them from q,
    k, o and the mask. Without a gradient nothing is saved."""
    if q.dim() != 3:
        raise ValueError(f"fused_short_attention takes (B, S, D), got {tuple(q.shape)}")
    B, S, H, _ = _check_sep(q, k, v, num_heads)
    if layout not in ("bhsd", "bsd"):
        raise ValueError(f"unknown layout {layout!r}")
    save = _save_mode(save_probs, (B, S, H, block_b), q, k, v)
    return _ShortAttn.apply(q, k, v, mask, num_heads, scale, save)


def fused_short_attention_heads(
    qh: torch.Tensor,
    kh: torch.Tensor,
    vh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_b: int = 8,
    save_probs: Optional[bool] = None,
) -> torch.Tensor:
    """`fused_short_attention` over (B, H, S, Dh) heads, (B, H, S, Dh) out:
    for towers that transform q and k per head after the split (ESM's rotary
    embedding). The same kernels, modes and rule."""
    if qh.dim() != 4:
        raise ValueError(f"fused_short_attention_heads takes (B, H, S, Dh), got "
                         f"{tuple(qh.shape)}")
    B, S, H, _ = _check_sep(qh, kh, vh, qh.shape[1])
    save = _save_mode(save_probs, (B, S, H, block_b), qh, kh, vh)
    return _ShortAttn.apply(qh, kh, vh, mask, H, scale, save)


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


def _cls_kernel_inputs(qkv, num_heads, mask, bwd: bool):
    """The CLS kernels' checks; (qkv at a 16-byte-aligned address, a copy
    only where it was not, the mask on the device or None). The forward
    takes what the row design's backward layout fits, the backward what
    either design fits (`cls_bwd_smem_bytes`)."""
    _require_cuda(qkv)
    B, S, D3 = qkv.shape
    D = D3 // 3
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if num_heads > CLS_MAX_HEADS or (D // num_heads) % 8:
        raise ValueError(f"the CLS kernel takes up to {CLS_MAX_HEADS} heads of a width that "
                         f"is a multiple of 8, got {num_heads} heads of {D // num_heads}")
    fits = (cls_bwd_smem_bytes(S, D, num_heads) if bwd
            else _cls_smem_bytes(S, D, num_heads, True) <= MAX_SMEM)
    if not fits:
        raise ValueError(f"the CLS kernel does not fit S={S}, H={num_heads} in shared memory")
    return _aligned(qkv), _device_mask(mask, B, S, qkv.device)


def fused_cls_attention_bwd(
    dout: torch.Tensor,
    qkv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dqkv (B, S, 3D) of `fused_cls_attention` from qkv and the mask. CPU
    tensors take the plain version; CUDA tensors take the kernel of the
    design `cls_bwd_design` names, or raise."""
    if qkv.device.type == "cpu":
        return fused_cls_attention_bwd_reference(dout, qkv, num_heads, mask=mask, scale=scale)
    B, S, D3 = qkv.shape
    qkv, mask = _cls_kernel_inputs(qkv, num_heads, mask, bwd=True)
    D = D3 // 3
    if tuple(dout.shape) != (B, 1, D):
        raise ValueError(f"dout must be ({B}, 1, {D}), got {tuple(dout.shape)}")
    dout = _aligned(dout.to(torch.bfloat16))
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
    qkv, mask = _cls_kernel_inputs(qkv, num_heads, mask, bwd=False)
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
