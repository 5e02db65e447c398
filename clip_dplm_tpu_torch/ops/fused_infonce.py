"""Fused InfoNCE: the f32 similarity is never stored.

Counterpart of `clip_dplm_tpu/ops/fused_infonce.py` on the paths with no
mesh axis: `fused_symmetric_infonce` with both schedules of its backward
(recompute, `_sym_grad_pass`, and from the int16 raw the forward saved,
`_sym_grad_merged` / `_sym_grad_passes_from_raw`), and `fused_row_ce`, the
row cross-entropy the hard-negative cache path runs in both directions.

`fused_symmetric_infonce` (no cache):

  loss = 0.5 * (mean_i[lse_row_i - scale d_i] + mean_j[lse_col_j - scale d_j])

over s = scale * a b^T with d = rowsum(a * b). The forward takes the row
logsumexp and the column logsumexp (the row lse of b a^T) in one pass
(`csrc/lse_walk.cu::lse_walk_kernel`, the wgmma walk: row partials per
column range and column partials per 64 rows, which `lse_combine_kernel`
combines in a fixed order). The backward has two schedules, as the
reference's:

- recompute (`materialize_raw=False`): the gradient pass runs twice, (a, b)
  and (b, a), each recomputing the raw tiles and forming
  acc = (P_row + P_col^T) y with p rounded to the dot dtype, and
  rowdot = rowsum(p * raw) (`sym_infonce_grad`: `csrc/row_ce.cu::
  row_ce_grad_kernel` in its symmetric mode, the row CE's wgmma kernel with
  the walked rows' lse read beside the own rows');
- saved raw (`materialize_raw=True`): the forward also stores the raw
  similarity before the scale as int16, q = round(raw * RAW_QSCALE)
  (`sym_infonce_lse_save`; the lse, so the loss, are the same bit for
  bit), and the backward reads it instead of recomputing: s = q * (scale /
  RAW_QSCALE), acc_a = P y, acc_b = P^T x and rowdot = rowsum(p * q) /
  RAW_QSCALE, either in two passes (`csrc/raw_grad.cu::
  from_raw_grad_kernel`, wgmma with p formed from the int16 tile in the A
  fragments' registers: pass A acc_a and rowdot, pass B acc_b) or in one pass
  over q (`sym_grad_merged_kernel`, a cluster of 8 blocks sharing its p
  tiles, then a fixed-order sum of the per-256-row partials of acc_b). Which
  one is fixed by shape (`_from_raw_merged`), by what the H100 runs faster.

The scalar tail

  da = 0.5 (g/B) scale acc_a - (g/B) scale b,   dscale = 0.5 (g/B) sum(rowdot) - (g/B) sum(d)

is plain torch, as in the reference. `fused_clip_loss` and
`fused_multiway_clip_loss` take `materialize_raw="auto"` (the reference's
default: save while the int16 raw is at most MATERIALIZE_BYTES_LIMIT, that
is up to B = 18,317 square), "always", "never" or a bool.

`fused_row_ce(x, y, scale, labels, n_valid)` (the cache path):

  loss = mean_i[lse_i - scale <x_i, y_labels_i>]

over the columns of y below n_valid (a device int32: the cache's fill
level), the rest at -1e30. The forward's row lse (`csrc/lse_walk.cu::
row_ce_lse`, the same walk and combine), then in the backward P y with
rowsum(p * raw) (`row_ce_dx`) and P^T x (`row_ce_dy`, no column mask, as the
reference's); the tail

  dx = (g/m) scale (P y - y_pos),   dy = (g/m) scale P^T x, minus (g/m) scale x at the labels,
  dscale = (g/m) (sum(rowdot) - sum(raw_pos))

is plain torch. `fused_clip_loss(cache=..., cache_len=...)` runs it twice: a
against [b; cache] with n_valid = B + cache_len, whose dy is formed for b's
rows only (the cache takes no gradient), and b against a.

`dot_dtype` (bf16 on the train path) is the type of the operands of every
product, p is rounded to it before each contraction; the positive logits,
rowdot and every sum stay f32. CPU tensors take the plain versions (which
materialize the similarity); CUDA tensors take the kernels (bf16 dot dtype,
d <= 512) or raise. `fused_multiway_clip_loss` sums `fused_clip_loss` over
the modality pairs of tf_clip. The reference's mesh paths are not ported
yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops.infonce import (
    NEG_INF,
    effective_scale,
    l2_normalize,
    modality_pairs,
)

MAX_DIM = 512  # the grad kernels' accumulators: d f32 columns in registers
_BM = 32  # rows per block of the merged backward kernel
_BN = 64  # columns per tile: the saved raw's row pitch is a multiple of it
_WALK_ROWS = 128  # own rows a block of the lse walk (csrc/lse_walk.cu)
_WALK_GROUP = 64  # own rows of one column partial of the walk: a warpgroup
H100_SMS = 132
_MERGED_ROWS = 256  # rows of one cluster of the merged kernel: one acc_b partial each
# The saved raw is int16 fixed point: cosines of (bf16-rounded) unit vectors
# stay below ~1.008, so q = round(raw * RAW_QSCALE) keeps an absolute error
# of ~1.5e-5, the reference's constant.
RAW_QSCALE = 32767.0 / 1.01
# "auto" saves the raw while rows * cols * 2 bytes stay at or below this
MATERIALIZE_BYTES_LIMIT = 640 * 1024 * 1024


def _cast(t: torch.Tensor, dot_dtype) -> torch.Tensor:
    return t if dot_dtype is None else t.to(dot_dtype)


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def _plain_lse(x, y, scale):
    s = scale * (x.float() @ y.float().t())
    return torch.logsumexp(s, dim=1), torch.logsumexp(s, dim=0)


def _plain_lse_save(x, y, scale):
    """The row and column lse of `_plain_lse` (the same bits) and the raw
    similarity before the scale as int16, round(raw * RAW_QSCALE), rounding
    half to even as the reference's jnp.round (clamped to int16, which unit
    rows never reach)."""
    raw = x.float() @ y.float().t()
    s = scale * raw
    q = torch.round(raw * RAW_QSCALE).clamp(-32768, 32767).to(torch.int16)
    return torch.logsumexp(s, dim=1), torch.logsumexp(s, dim=0), q


def _plain_grad(x, y, scale, lse_row, lse_col):
    raw = x.float() @ y.float().t()
    s = raw * scale
    p = torch.exp(s - lse_row[:, None]) + torch.exp(s - lse_col[None, :])
    acc = p.to(y.dtype).float() @ y.float()
    return acc, torch.sum(p * raw, dim=1)


def _plain_p_from_raw(raw_q, scale, lse_row, lse_col):
    """(q as f32, p) from the saved raw, with the reference's rounding
    points: the dequantization and the scale in one multiply."""
    qf = raw_q.float()
    s = qf * (scale * (1.0 / RAW_QSCALE))
    return qf, torch.exp(s - lse_row[:, None]) + torch.exp(s - lse_col[None, :])


def _plain_grad_raw(raw_q, x, y, scale, lse_row, lse_col):
    """Pass A from the saved raw (m, n): (P y, rowsum(p * raw)), rowdot from
    the quantized raw divided once, p rounded to y's type for the product."""
    qf, p = _plain_p_from_raw(raw_q, scale, lse_row, lse_col)
    return p.to(y.dtype).float() @ y.float(), torch.sum(p * qf, dim=1) * (1.0 / RAW_QSCALE)


def _plain_grad_rawT(raw_q, x, y, scale, lse_row, lse_col):
    """Pass B from the saved raw: P^T x, p rounded to x's type."""
    _, p = _plain_p_from_raw(raw_q, scale, lse_row, lse_col)
    return p.to(x.dtype).float().t() @ x.float()


def _plain_grad_from_raw(raw_q, x, y, scale, lse_row, lse_col):
    """(P y, rowsum(p * raw), P^T x) from the saved raw: both passes."""
    return (*_plain_grad_raw(raw_q, x, y, scale, lse_row, lse_col),
            _plain_grad_rawT(raw_q, x, y, scale, lse_row, lse_col))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous on a 16-byte boundary (the kernels' tensor maps)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_dim(t: torch.Tensor) -> torch.Tensor:
    """Zero columns up to a multiple of 64 (no dot product changes)."""
    d = t.shape[1]
    dp = -(-d // 64) * 64
    return _aligned(t if dp == d else torch.nn.functional.pad(t, (0, dp - d)))


def _raw_pitch(n: int) -> int:
    return -(-n // _BN) * _BN


def _walk_splits(m: int, n: int, sms: int = H100_SMS) -> int:
    """Column ranges the lse walk splits n columns into for m own rows: as
    many as fill `sms` SMs with one block each of 128 own rows (2 at m=8192,
    4 at 4096, 16 at 1000 on the H100's 132), at least one, at most one a
    64-column tile."""
    return max(1, min(-(-n // _BN), sms // -(-m // _WALK_ROWS)))


def _from_raw_splits(n_own: int, n_walk: int, sms: int = H100_SMS) -> int:
    """Ranges the from-raw passes and the recompute pass split their walk into
    (`csrc/common.cuh::from_raw_splits`, which the launchers give the card's
    SM count): one while the blocks of 64 own entries fill half the card
    (8192 rows), else as many as fill it with one block an SM (2 at 4096, 8
    at 1000), at most one a 64-entry walked tile and the 8 blocks of one
    cluster."""
    blocks, tiles = -(-n_own // 64), -(-n_walk // _BN)
    if 2 * blocks > sms:
        return 1
    return max(1, min(8, sms // blocks, tiles))


def _walk_groups(m: int) -> int:
    """Column partials of the walk a column: one each 64 own rows."""
    return -(-m // _WALK_GROUP)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plain_lse_combine(part, nsplit: int, m: int, groups: int, n: int):
    """The plain version of `lse_combine`: (row lse (m), column lse (n), or
    None for n = 0) from the walk's flat partials, [2][nsplit][m] (max, sum)
    of each column range, then [2][groups][n] of each 64 own rows; each
    partial counts as max + log(max(sum, 1e-30)), combined with
    torch.logsumexp, as the reference combines its column partials with
    jax.nn.logsumexp."""
    def lse(mx, sm):
        return torch.logsumexp(mx + torch.log(torch.clamp(sm, min=1e-30)), dim=0)

    rows = 2 * nsplit * m
    row_lse = lse(*part[:rows].view(2, nsplit, m))
    if n == 0:
        return row_lse, None
    return row_lse, lse(*part[rows:rows + 2 * groups * n].view(2, groups, n))


def _kernel_lse_combine(part, nsplit: int, m: int, groups: int, n: int):
    """`_plain_lse_combine` in one launch (`lse_combine_kernel`): each lse
    summed in a fixed order, no atomics."""
    row_lse = torch.empty(m, dtype=torch.float32, device=part.device)
    col_lse = torch.empty(n, dtype=torch.float32, device=part.device) if n else None
    _build.launch("lse_combine", part.data_ptr(), nsplit, m, groups, n, row_lse.data_ptr(),
                  None if col_lse is None else col_lse.data_ptr(), _build.stream_of(part))
    _build.LAUNCHES.add("lse_combine")
    return row_lse, col_lse


def _walk_partials(x, y, scale, save: bool = False):
    """The symmetric walk alone: (its flat partials, nsplit, groups, and the
    int16 raw's (m, round_up(n, 64)) buffer with `save`, else None)."""
    m, n = x.shape[0], y.shape[0]
    xp, yp = _pad_dim(x), _pad_dim(y)
    nsplit, groups = _walk_splits(m, n, _sm_count(x.device.index)), _walk_groups(m)
    part = torch.empty(2 * nsplit * m + 2 * groups * n, dtype=torch.float32, device=x.device)
    ptrs = (xp.data_ptr(), yp.data_ptr(), scale.data_ptr(), part.data_ptr())
    raw_q = None
    if save:
        raw_q = torch.empty((m, _raw_pitch(n)), dtype=torch.int16, device=x.device)
        _build.launch("sym_infonce_lse_save", *ptrs, raw_q.data_ptr(), raw_q.shape[1], m, n,
                      xp.shape[1], nsplit, _build.stream_of(x))
        _build.LAUNCHES.add("sym_infonce_lse_save")
    else:
        _build.launch("sym_infonce_lse", *ptrs, m, n, xp.shape[1], nsplit, _build.stream_of(x))
        _build.LAUNCHES.add("sym_infonce_lse")
    return part, nsplit, groups, raw_q


def _kernel_lse(x, y, scale, save: bool = False):
    """(row lse, column lse), and with `save` the int16 raw: an (m, n) view
    of an (m, round_up(n, 64)) buffer, as the from-raw kernels read it. The
    walk writes its partials, the combine reduces them."""
    m, n = x.shape[0], y.shape[0]
    part, nsplit, groups, raw_q = _walk_partials(x, y, scale, save)
    lse = _kernel_lse_combine(part, nsplit, m, groups, n)
    return (*lse, raw_q[:, :n]) if save else lse


def _kernel_lse_save(x, y, scale):
    return _kernel_lse(x, y, scale, save=True)


def _kernel_grad(x, y, scale, lse_row, lse_col):
    """The recompute pass: ((P_row + P_col^T) y (m, d), rowdot (m)),
    `row_ce_grad_kernel` in its symmetric mode (64 rows of x a cluster,
    walking the rows of y split over `_from_raw_splits` blocks; the valid
    rows only)."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    xp, yp = _pad_dim(x), _pad_dim(y)
    dp = xp.shape[1]
    acc = torch.empty((m, dp), dtype=torch.float32, device=x.device)
    rowdot = torch.empty(m, dtype=torch.float32, device=x.device)
    _build.launch("sym_infonce_grad", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  lse_row.contiguous().data_ptr(), lse_col.contiguous().data_ptr(),
                  acc.data_ptr(), rowdot.data_ptr(), m, n, dp, _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_grad")
    return acc[:, :d], rowdot


def _raw_pitch_of(raw_q: torch.Tensor) -> int:
    """The row pitch of the saved raw as the from-raw kernels read it: the
    saving forward's (m, n) int16 view of rows of round_up(n, 64) entries,
    16-byte aligned; anything else raises."""
    ldq = _raw_pitch(raw_q.shape[1])
    if raw_q.dtype != torch.int16 or raw_q.stride() != (ldq, 1) or raw_q.data_ptr() % 16:
        raise ValueError("raw_q must be the saving forward's int16 (m, n) view of rows of "
                         f"{ldq} entries, got {raw_q.dtype} with strides {raw_q.stride()}")
    return ldq


def _from_raw_args(raw_q, x, y, scale, lse_row, lse_col):
    return (raw_q, _raw_pitch_of(raw_q), _pad_dim(x), _pad_dim(y), scale.data_ptr(),
            _aligned(lse_row), _aligned(lse_col))


def _kernel_grad_raw(raw_q, x, y, scale, lse_row, lse_col):
    """Pass A from the saved raw: (P y, rowdot), `from_raw_grad_kernel<KB,
    false>` (64 rows of raw a block, walking its columns)."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    q, ldq, _, yp, sp, lr, lc = _from_raw_args(raw_q, x, y, scale, lse_row, lse_col)
    dp = yp.shape[1]
    acc_a = torch.empty((m, dp), dtype=torch.float32, device=x.device)
    rowdot = torch.empty(m, dtype=torch.float32, device=x.device)
    _build.launch("sym_infonce_grad_raw", q.data_ptr(), ldq, yp.data_ptr(), sp, lr.data_ptr(),
                  lc.data_ptr(), acc_a.data_ptr(), rowdot.data_ptr(), m, n, dp,
                  _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_grad_raw")
    return acc_a[:, :d], rowdot


def _kernel_grad_rawT(raw_q, x, y, scale, lse_row, lse_col):
    """Pass B from the saved raw: P^T x, `from_raw_grad_kernel<KB, true>`
    (64 columns of raw a block, walking its rows)."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    q, ldq, xp, _, sp, lr, lc = _from_raw_args(raw_q, x, y, scale, lse_row, lse_col)
    dp = xp.shape[1]
    acc_b = torch.empty((n, dp), dtype=torch.float32, device=x.device)
    _build.launch("sym_infonce_grad_rawT", q.data_ptr(), ldq, xp.data_ptr(), sp, lr.data_ptr(),
                  lc.data_ptr(), acc_b.data_ptr(), m, n, dp, _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_grad_rawT")
    return acc_b[:, :d]


def _kernel_grad_two_pass(raw_q, x, y, scale, lse_row, lse_col):
    """(acc_a, rowdot, acc_b) from the saved raw: pass A, then pass B."""
    return (*_kernel_grad_raw(raw_q, x, y, scale, lse_row, lse_col),
            _kernel_grad_rawT(raw_q, x, y, scale, lse_row, lse_col))


def _kernel_grad_merged(raw_q, x, y, scale, lse_row, lse_col):
    """(acc_a, rowdot, acc_b) from the saved raw in one pass over it, then
    the fixed-order sum of acc_b's per-256-row partials (one launcher)."""
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    q, ldq, xp, yp, sp, lr, lc = _from_raw_args(raw_q, x, y, scale, lse_row, lse_col)
    dp, dev = xp.shape[1], x.device
    acc_a = torch.empty((-(-m // _BM) * _BM, dp), dtype=torch.float32, device=dev)
    rowdot = torch.empty(m, dtype=torch.float32, device=dev)
    clusters = -(-m // _MERGED_ROWS)  # one: its partial is acc_b, no scratch
    part = (torch.empty((clusters, ldq, dp), dtype=torch.float32, device=dev)
            if clusters > 1 else None)
    acc_b = torch.empty((ldq, dp), dtype=torch.float32, device=dev)
    _build.launch("sym_infonce_grad_merged", q.data_ptr(), ldq, xp.data_ptr(), yp.data_ptr(), sp,
                  lr.data_ptr(), lc.data_ptr(), acc_a.data_ptr(), rowdot.data_ptr(),
                  None if part is None else part.data_ptr(), acc_b.data_ptr(), m, n, dp,
                  _build.stream_of(x))
    _build.LAUNCHES.add("sym_infonce_grad_merged")
    return acc_a[:m, :d], rowdot, acc_b[:n, :d]


def _from_raw_merged(m: int) -> bool:
    """The port's choice of the from-raw schedule for m rows, fixed by shape,
    by what the H100 ran faster at d=512 in alternating rounds (chip_smoke.py
    phase 11; PERF.md, section 6): the two passes of `from_raw_grad_kernel`
    (wgmma, p in registers, the walk split over a cluster below 4224 rows) at
    every batch of B = 128..8192 the rounds time. The merged kernel (WMMA, a
    cluster of 8 blocks), which took m <= 256 while the passes were WMMA
    too, ran 2.3-16x slower in device time from B = 200 to 8192 and 1.18x at
    128 (its one launch, not two, made it faster host-and-device at 128-256:
    0.053 against 0.076 ms a call at 256), so no train path takes it;
    `_kernel_grad_merged` keeps it reachable, held to its plain version in
    the smoke and the card tests."""
    del m  # no batch takes the merged kernel
    return False


def _kernel_grad_from_raw(raw_q, x, y, scale, lse_row, lse_col):
    fn = _kernel_grad_merged if _from_raw_merged(x.shape[0]) else _kernel_grad_two_pass
    return fn(raw_q, x, y, scale, lse_row, lse_col)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _SymInfoNCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, scale, dot_dtype, use_kernel, materialize_raw):
        ad, bd = _cast(a, dot_dtype), _cast(b, dot_dtype)
        scale32 = scale.float().reshape(1).contiguous()
        raw_q = None
        if materialize_raw:
            lse = _kernel_lse_save if use_kernel else _plain_lse_save
            lse_a, lse_b, raw_q = lse(ad, bd, scale32)
        else:
            lse = _kernel_lse if use_kernel else _plain_lse
            lse_a, lse_b = lse(ad, bd, scale32)
        diag = torch.sum(a.float() * b.float(), dim=-1)
        loss = 0.5 * (torch.mean(lse_a - scale32 * diag) + torch.mean(lse_b - scale32 * diag))
        ctx.use_kernel, ctx.materialize_raw = use_kernel, materialize_raw
        # autograd drops the saved raw when this node's backward has run
        # (unless the graph is retained): tf_clip's three buffers go one by one
        ctx.save_for_backward(a, b, ad, bd, scale32, lse_a, lse_b, diag, raw_q)
        ctx.scale_shape, ctx.scale_dtype = scale.shape, scale.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        a, b, ad, bd, scale32, lse_a, lse_b, diag, raw_q = ctx.saved_tensors
        if ctx.materialize_raw:
            grad = _kernel_grad_from_raw if ctx.use_kernel else _plain_grad_from_raw
            acc_a, rowdot, acc_b = grad(raw_q, ad, bd, scale32, lse_a, lse_b)
        else:
            grad = _kernel_grad if ctx.use_kernel else _plain_grad
            acc_a, rowdot = grad(ad, bd, scale32, lse_a, lse_b)
            acc_b, _ = grad(bd, ad, scale32, lse_b, lse_a)
        da, db, dscale = _sym_tail(g, a, b, scale32, diag, acc_a, rowdot, acc_b)
        return (da.to(a.dtype), db.to(b.dtype),
                dscale.reshape(ctx.scale_shape).to(ctx.scale_dtype), None, None, None)


def _sym_tail(g, a, b, scale32, diag, acc_a, rowdot, acc_b):
    """(da, db, dscale) in f32 from the backward's contractions."""
    coef = g.float() / a.shape[0]
    da = 0.5 * coef * scale32 * acc_a - coef * scale32 * b.float()
    db = 0.5 * coef * scale32 * acc_b - coef * scale32 * a.float()
    return da, db, 0.5 * coef * torch.sum(rowdot) - coef * torch.sum(diag)


def _resolve_materialize(materialize_raw, rows: int, cols: int) -> bool:
    """'auto' saves the raw while the int16 buffer stays at or below
    MATERIALIZE_BYTES_LIMIT; 'always' saves it, any other string does not;
    a bool is taken as given."""
    if materialize_raw == "auto":
        return rows * cols * 2 <= MATERIALIZE_BYTES_LIMIT
    if isinstance(materialize_raw, str):
        return materialize_raw == "always"
    return bool(materialize_raw)


def _check(a, b, scale):
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, d) of one shape, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape {tuple(scale.shape)}")


def fused_symmetric_infonce_reference(a, b, scale, dot_dtype=None,
                                      materialize_raw: bool = False) -> torch.Tensor:
    """Plain version on any device: the B x B similarity materialized, the
    same rounding points and the same backward."""
    _check(a, b, scale)
    return _SymInfoNCE.apply(a, b, scale, dot_dtype, False, bool(materialize_raw))


def _use_kernel(x: torch.Tensor, y: torch.Tensor, dot_dtype, *others: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version); True for CUDA tensors the
    kernels take (the operands x and y, the rest on the same device); raises
    for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if dot_dtype is None and y.dtype != x.dtype:
        raise ValueError(f"x and y differ in type ({x.dtype}, {y.dtype}): pass dot_dtype")
    if (dot_dtype or x.dtype) != torch.bfloat16:
        raise ValueError("the CUDA kernels take bf16 operands (dot_dtype=torch.bfloat16), "
                         f"got {dot_dtype or x.dtype}")
    if x.shape[1] > MAX_DIM:
        raise ValueError(f"the CUDA kernels take d <= {MAX_DIM}, got d={x.shape[1]}")
    if any(t.device != x.device for t in (y, *others)):
        raise ValueError("every input must be on the same CUDA device")
    return True


def fused_symmetric_infonce(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                            dot_dtype: Optional[torch.dtype] = None,
                            materialize_raw: bool = False) -> torch.Tensor:
    """0.5 * (row-CE(scale a b^T, diag) + row-CE(scale b a^T, diag)); a, b
    (B, d) L2-normalized, scale a one-element tensor. `materialize_raw`
    saves the raw similarity as int16 in the forward so that the backward
    reads it instead of recomputing it (B x B x 2 bytes). CPU tensors take
    the plain version; CUDA tensors take the kernels (bf16 operands via
    dot_dtype=torch.bfloat16, d <= 512) or raise."""
    _check(a, b, scale)
    return _SymInfoNCE.apply(a, b, scale, dot_dtype, _use_kernel(a, b, dot_dtype, scale),
                             bool(materialize_raw))


# ---------------------------------------------------------------------------
# row cross-entropy with a column-validity count (the cache path)
# ---------------------------------------------------------------------------


def _colmask(n: int, n_valid: torch.Tensor, device) -> torch.Tensor:
    """(n,) f32: 0 below n_valid, -1e30 from it on."""
    return torch.where(torch.arange(n, device=device) < n_valid, 0.0, NEG_INF)


def _plain_row_lse(x, y, scale, n_valid):
    s = (x.float() @ y.float().t()) * scale + _colmask(y.shape[0], n_valid, x.device)
    return torch.logsumexp(s, dim=1)


def _plain_row_dx(x, y, scale, lse, n_valid):
    """(P y with p rounded to y's type, rowsum(p * raw))."""
    raw = x.float() @ y.float().t()
    p = torch.exp(raw * scale + _colmask(y.shape[0], n_valid, x.device) - lse[:, None])
    return p.to(y.dtype).float() @ y.float(), torch.sum(p * raw, dim=1)


def _plain_row_dy(x, y, scale, lse, rows: int):
    """P^T x over the first `rows` rows of y, p rounded to x's type; no
    column mask, as the reference's `_dy_kernel`."""
    raw = x.float() @ y[:rows].float().t()
    p = torch.exp(raw * scale - lse[:, None])
    return p.to(x.dtype).float().t() @ x.float()


def _kernel_row_lse(x, y, scale, n_valid):
    m, n = x.shape[0], y.shape[0]
    xp, yp = _pad_dim(x), _pad_dim(y)
    nsplit = _walk_splits(m, n, _sm_count(x.device.index))
    part = torch.empty(2 * nsplit * m, dtype=torch.float32, device=x.device)
    _build.launch("row_ce_lse", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  n_valid.data_ptr(), part.data_ptr(), m, n, xp.shape[1], nsplit,
                  _build.stream_of(x))
    _build.LAUNCHES.add("row_ce_lse")
    return _kernel_lse_combine(part, nsplit, m, 0, 0)[0]


def _kernel_row_dx(x, y, scale, lse, n_valid):
    m, n, d = x.shape[0], y.shape[0], x.shape[1]
    xp, yp = _pad_dim(x), _pad_dim(y)
    dp = xp.shape[1]
    py = torch.empty((m, dp), dtype=torch.float32, device=x.device)
    rowdot = torch.empty(m, dtype=torch.float32, device=x.device)
    _build.launch("row_ce_dx", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  n_valid.data_ptr(), lse.contiguous().data_ptr(), py.data_ptr(),
                  rowdot.data_ptr(), m, n, dp, _build.stream_of(x))
    _build.LAUNCHES.add("row_ce_dx")
    return py[:, :d], rowdot


def _kernel_row_dy(x, y, scale, lse, rows: int):
    m, d = x.shape[0], x.shape[1]
    xp, yp = _pad_dim(x), _pad_dim(y[:rows])
    dp = xp.shape[1]
    ptx = torch.empty((rows, dp), dtype=torch.float32, device=x.device)
    _build.launch("row_ce_dy", xp.data_ptr(), yp.data_ptr(), scale.data_ptr(),
                  lse.contiguous().data_ptr(), ptx.data_ptr(), m, rows, dp, _build.stream_of(x))
    _build.LAUNCHES.add("row_ce_dy")
    return ptx[:, :d]


class _RowCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, scale, labels, n_valid, dot_dtype, grad_rows, use_kernel):
        xd, yd = _cast(x, dot_dtype), _cast(y, dot_dtype)
        scale32 = scale.float().reshape(1).contiguous()
        lse = (_kernel_row_lse if use_kernel else _plain_row_lse)(xd, yd, scale32, n_valid)
        raw_pos = torch.sum(x.float() * y.float()[labels], dim=-1)
        loss = torch.mean(lse - scale32 * raw_pos)
        ctx.use_kernel, ctx.grad_rows = use_kernel, grad_rows
        ctx.scale_shape, ctx.scale_dtype = scale.shape, scale.dtype
        ctx.save_for_backward(x, y, xd, yd, scale32, labels, n_valid, lse, raw_pos)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, xd, yd, scale32, labels, n_valid, lse, raw_pos = ctx.saved_tensors
        dx_fn, dy_fn = ((_kernel_row_dx, _kernel_row_dy) if ctx.use_kernel
                        else (_plain_row_dx, _plain_row_dy))
        py, rowdot = dx_fn(xd, yd, scale32, lse, n_valid)
        ptx = dy_fn(xd, yd, scale32, lse, ctx.grad_rows)
        cs = g.float() / x.shape[0] * scale32
        dx = cs * (py - y.float()[labels])
        dy = cs * ptx
        dy.index_add_(0, labels, -cs * x.float())
        if ctx.grad_rows < y.shape[0]:
            dy = torch.nn.functional.pad(dy, (0, 0, 0, y.shape[0] - ctx.grad_rows))
        dscale = g.float() / x.shape[0] * (torch.sum(rowdot) - torch.sum(raw_pos))
        return (dx.to(x.dtype), dy.to(y.dtype),
                dscale.reshape(ctx.scale_shape).to(ctx.scale_dtype),
                None, None, None, None, None)


def _row_ce_args(x, y, scale, labels, n_valid, grad_rows):
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y must be (m, d) and (n, d), got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if labels.shape != (x.shape[0],):
        raise ValueError(f"labels must be ({x.shape[0]},), got {tuple(labels.shape)}")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape {tuple(scale.shape)}")
    n = y.shape[0]
    grad_rows = n if grad_rows is None else grad_rows
    if not 0 < grad_rows <= n:
        raise ValueError(f"grad_rows must be in [1, {n}], got {grad_rows}")
    if n_valid is None:
        n_valid = torch.full((1,), n, dtype=torch.int32, device=x.device)
    return n_valid.to(torch.int32).reshape(1).contiguous(), grad_rows


def fused_row_ce(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                 labels: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                 dot_dtype: Optional[torch.dtype] = None,
                 grad_rows: Optional[int] = None) -> torch.Tensor:
    """mean_i[logsumexp_j(scale <x_i, y_j>) - scale <x_i, y_labels_i>] over
    the columns j < n_valid (the rest masked with -1e30). x (m, d), y (n, d)
    L2-normalized; scale a one-element tensor; labels (m,) int64 column
    indices; n_valid None (all n) or a one-element int tensor on x's device
    (read there: the host never waits for it). `grad_rows` forms y's
    gradient for its first rows only (the rest are zero; every label must
    lie below it). CPU tensors take the plain version; CUDA tensors take the
    kernels (dot_dtype=torch.bfloat16, d <= 512) or raise."""
    n_valid, grad_rows = _row_ce_args(x, y, scale, labels, n_valid, grad_rows)
    use = _use_kernel(x, y, dot_dtype, scale, labels, n_valid)
    return _RowCE.apply(x, y, scale, labels, n_valid, dot_dtype, grad_rows, use)


def fused_row_ce_reference(x, y, scale, labels, n_valid=None, dot_dtype=None,
                           grad_rows=None) -> torch.Tensor:
    """Plain version on any device: the m x n similarity materialized, the
    same rounding points and the same backward."""
    n_valid, grad_rows = _row_ce_args(x, y, scale, labels, n_valid, grad_rows)
    return _RowCE.apply(x, y, scale, labels, n_valid, dot_dtype, grad_rows, False)


def _smoothing_adjustment(x, y, scale, labels, smoothing: float,
                          n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive term turning the hard-label CE into the label-smoothed CE:
    mean_i[s z_pos_i - s/(n-1) (rowsum_z_i - z_pos_i)], z = scale <x, y>
    over the n valid columns (all of y without n_valid); plain ops, so
    autograd supplies its gradient."""
    if n_valid is None:
        spread = smoothing / max(y.shape[0] - 1.0, 1.0)
        ysum = torch.sum(y, dim=0)
    else:
        spread = smoothing / torch.clamp(n_valid.float().reshape(()) - 1.0, min=1.0)
        col = torch.arange(y.shape[0], device=x.device)[:, None] < n_valid
        ysum = torch.sum(torch.where(col, y, 0.0), dim=0)
    z_pos = scale * torch.sum(x * y[labels], dim=-1)
    rowsum_z = scale * (x @ ysum)
    return torch.mean(smoothing * z_pos - spread * (rowsum_z - z_pos))


def fused_clip_loss(
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    logit_scale: torch.Tensor,
    max_scale: float = 100.0,
    dot_dtype: Optional[torch.dtype] = None,
    label_smoothing: float = 0.0,
    assume_normalized: bool = False,
    cache: Optional[torch.Tensor] = None,
    cache_len: Optional[torch.Tensor] = None,
    materialize_raw="auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for infonce.clip_loss through the fused loss. Without a cache
    the symmetric kernels, saving the int16 raw as `materialize_raw` says
    ("auto": while B x B x 2 bytes <= MATERIALIZE_BYTES_LIMIT; "always",
    "never" or a bool); with `cache` (C, d), normalized rows whose first
    `cache_len` (a device int32) are filled, the two row cross-entropies,
    which never save it: a against [b; cache], b against a. Returns (loss,
    {loss_a, loss_b, logit_scale}), as the reference's fused path does (no
    accuracy: nothing materializes the f32 similarity)."""
    if assume_normalized:
        a, b = emb_a.float(), emb_b.float()
    else:
        a, b = l2_normalize(emb_a), l2_normalize(emb_b)
    scale = effective_scale(logit_scale, max_scale)
    B = a.shape[0]
    labels = torch.arange(B, device=a.device)
    if cache is None:
        mat = _resolve_materialize(materialize_raw, a.shape[0], b.shape[0])
        loss = fused_symmetric_infonce(a, b, scale, dot_dtype, mat)
        if label_smoothing > 0.0:
            loss = loss + 0.5 * (_smoothing_adjustment(a, b, scale, labels, label_smoothing)
                                 + _smoothing_adjustment(b, a, scale, labels, label_smoothing))
        return loss, {"loss_a": loss, "loss_b": loss, "logit_scale": scale}
    cols = torch.cat([b, cache.to(b.dtype)])
    n_valid = None if cache_len is None else (cache_len + B).to(torch.int32).reshape(1)
    loss_a = fused_row_ce(a, cols, scale, labels, n_valid, dot_dtype, grad_rows=B)
    loss_b = fused_row_ce(b, a, scale, labels, None, dot_dtype)
    if label_smoothing > 0.0:
        loss_a = loss_a + _smoothing_adjustment(a, cols, scale, labels, label_smoothing,
                                                n_valid)
        loss_b = loss_b + _smoothing_adjustment(b, a, scale, labels, label_smoothing)
    return 0.5 * (loss_a + loss_b), {"loss_a": loss_a, "loss_b": loss_b, "logit_scale": scale}


def fused_multiway_clip_loss(
    embeddings: Dict[str, torch.Tensor],
    logit_scale: torch.Tensor,
    pairs=None,
    max_scale: float = 100.0,
    label_smoothing: float = 0.0,
    weights=None,
    dot_dtype: Optional[torch.dtype] = None,
    materialize_raw="auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in for infonce.multiway_clip_loss through `fused_clip_loss`, one
    pair at a time (no f32 B x B similarity is materialized; each pair saves
    its int16 raw as `materialize_raw` says); the same `pairs` (missing
    modalities skipped) and `weights` (`weights.get((a, b), 1.0)` scales a
    pair's loss in the total; autograd hands that weight to the pair's
    backward as the scale of its incoming gradient, so on the card it
    reaches the from-raw passes). Metrics: each pair's loss and the
    effective logit scale (no accuracy, as the reference's fused path)."""
    total = torch.zeros((), device=logit_scale.device)
    metrics: Dict[str, torch.Tensor] = {}
    for a, b in modality_pairs(embeddings) if pairs is None else pairs:
        if a not in embeddings or b not in embeddings:
            continue
        loss, _ = fused_clip_loss(embeddings[a], embeddings[b], logit_scale,
                                  max_scale=max_scale, dot_dtype=dot_dtype,
                                  label_smoothing=label_smoothing,
                                  materialize_raw=materialize_raw)
        total = total + (1.0 if weights is None else weights.get((a, b), 1.0)) * loss
        metrics[f"loss_{a}_{b}"] = loss
    metrics["logit_scale"] = effective_scale(logit_scale, max_scale)
    return total, metrics
