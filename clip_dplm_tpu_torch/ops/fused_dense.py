"""Fused Dense -> LayerNorm -> activation -> dropout block with its backward.

Counterpart of `clip_dplm_tpu/ops/fused_dense.py::fused_dense_norm_act`:

  order='ln_act':  y = dropout(act(LN(x W^T + b)))   (projection-head blocks)
  order='act_ln':  y = LN(act(x W^T + b))            (tower final layer)

with the optional tail y = skip + layer_scale * h and an L2-normalized
output. The port's Dense layout holds W as (N, K), the transpose of flax's.

Rounding points are the reference kernel's: x and W in the compute dtype
with f32 accumulation; the product rounded to the compute dtype and the bias
added in it; an act_ln activation in f32, rounded; LayerNorm in f32 (eps
1e-6); an ln_act activation on the LN output rounded to the compute dtype;
dropout, skip tail and L2 normalize in f32. The backward fuses dropout',
act', LN' into du (compute dtype) with dgamma/dbeta/db sums; dx = du W is a
hand-written GEMM on the card (the TPU kernel computes it in its body) and
dW = du^T x a plain matmul with f32 output (XLA's, in the reference).

Dropout keeps an element iff dropout_bits(seed, row, col) >= floor(rate *
2^32) and scales it by 1/(1-rate). The bits are a counter-based hash, so the
mask does not depend on tiling, the backward regenerates it, and the kernel
(`csrc/fused_dense.cu`) and the plain version give the same mask. It cannot
match the TPU's hardware PRNG; seeds come from `DropoutSeeds`.

`fused_dense_norm_act` runs the CUDA kernels for CUDA tensors (bf16 compute
only) and the plain version `fused_dense_reference` for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from clip_dplm_tpu_torch.ops import _build

LN_EPS = 1e-6  # flax nn.LayerNorm default
ACTS = ("none", "relu", "gelu", "silu", "tanh")
_ACT_CODE = {a: i for i, a in enumerate(ACTS)}
MAX_N = 65536  # the widest row the CUDA row kernels take (a cluster of 8 blocks a row)
_SQRT_2_OVER_PI = 0.7978845608028654
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# activations (f32), as the reference kernel's _act_fwd / _act_grad
# ---------------------------------------------------------------------------


def act_fwd(name: str, u: torch.Tensor) -> torch.Tensor:
    if name == "none":
        return u
    if name == "relu":
        return torch.clamp(u, min=0.0)
    if name == "gelu":  # tanh approximation
        return 0.5 * u * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * u * u * u)))
    if name == "silu":
        return u / (1.0 + torch.exp(-u))
    if name == "tanh":
        return torch.tanh(u)
    raise ValueError(f"unsupported activation {name!r}")


def act_grad(name: str, u: torch.Tensor) -> torch.Tensor:
    """d act / d u at u (f32)."""
    if name == "none":
        return torch.ones_like(u)
    if name == "relu":
        return (u > 0.0).to(u.dtype)
    if name == "gelu":
        t = torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * u * u * u))
        dg = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * u * u)
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * dg
    if name == "silu":
        sig = 1.0 / (1.0 + torch.exp(-u))
        return sig * (1.0 + u * (1.0 - sig))
    if name == "tanh":
        t = torch.tanh(u)
        return 1.0 - t * t
    raise ValueError(f"unsupported activation {name!r}")


def saves_pre_act(order: str, act: str) -> bool:
    """act_ln with gelu/silu saves the pre-activation (act' is not readable
    from act(u)); every other case saves the LN input s."""
    return order == "act_ln" and act in ("gelu", "silu")


# ---------------------------------------------------------------------------
# dropout bits: the same murmur3-finalizer chain as csrc/fused_dense.cu
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """Low 32 bits of x * c for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_bits(seed: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """(rows, cols) int64 tensor of uint32 hash values of (seed, row, col)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    rkey = _fmix32((seed & _M32) ^ _fmix32(r))
    return _fmix32(rkey ^ _mul32(c, 0x9E3779B1))


def dropout_threshold(rate: float) -> int:
    """keep iff bits >= floor(rate * 2^32) (the reference's threshold)."""
    return min(int(rate * 4294967296.0), _M32)


def keep_prob(rate: float) -> float:
    """1 - rate as the f32 the kernel divides by."""
    return float(np.float32(1.0 - rate))


def hash_dropout(h: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout of a (B, N) tensor with the hash mask, in h's dtype
    (the unfused modules' dropout)."""
    if rate <= 0.0:
        return h
    keep = dropout_bits(seed, h.shape[0], h.shape[1], h.device) >= dropout_threshold(rate)
    return torch.where(keep, h / keep_prob(rate), 0.0).to(h.dtype)


class DropoutSeeds:
    """32-bit seeds for the dropout sites of one forward pass, derived on the
    host from an integer key, the step and the site's index in call order
    (no device RNG): the same state and batch give the same masks on the
    card and on the CPU."""

    def __init__(self, key: int, step: int):
        self.key, self.step, self.count = int(key), int(step), 0

    def next(self) -> int:
        k = _fmix32(_fmix32(self.key & _M32) ^ ((self.key >> 32) & _M32))
        seed = _fmix32(_fmix32(k ^ (self.step & _M32)) ^ self.count)
        self.count += 1
        return int(seed)


# ---------------------------------------------------------------------------
# the block's static description
# ---------------------------------------------------------------------------


class _Spec(NamedTuple):
    order: str
    act: str
    rate: float
    seed: int
    compute_dtype: torch.dtype
    out_dtype: torch.dtype
    l2: bool

    @property
    def ln_act(self) -> bool:
        return self.order == "ln_act"

    @property
    def saves_pre(self) -> bool:
        return saves_pre_act(self.order, self.act)


# ---------------------------------------------------------------------------
# plain versions (any device): forward and backward, whole batch at once
# ---------------------------------------------------------------------------


def _s_from_saved(spec: _Spec, saved: torch.Tensor) -> torch.Tensor:
    if spec.saves_pre:
        return act_fwd(spec.act, saved.float()).to(saved.dtype)
    return saved


def _plain_fwd(spec, x, w, b, gamma, beta, skip, ls):
    cd = spec.compute_dtype
    u = (x.float() @ w.float().t()).to(cd) + b.to(cd)
    return _plain_rows_fwd(spec, u, gamma, beta, skip, ls)


def _plain_rows_fwd(spec, u, gamma, beta, skip, ls):
    """The forward's row epilogue from u = bf16(x W^T) + b (compute dtype):
    y, the saved rows, mean and rstd."""
    cd = spec.compute_dtype
    pre = u
    if not spec.ln_act:
        u = act_fwd(spec.act, u.float()).to(cd)
    sf = u.float()
    mean = sf.mean(dim=-1, keepdim=True)
    c = sf - mean
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + LN_EPS)
    h = c * rstd * gamma.float() + beta.float()
    if spec.ln_act:
        h = act_fwd(spec.act, h.to(cd).float())
        if spec.rate > 0.0:
            keep = dropout_bits(spec.seed, *h.shape, h.device) >= dropout_threshold(spec.rate)
            h = torch.where(keep, h / keep_prob(spec.rate), 0.0)
    if skip is not None:
        h = skip.float() + ls.float() * h
    if spec.l2:
        h = h / torch.clamp(torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True)), min=1e-12)
    saved = pre if spec.saves_pre else u
    return h.to(spec.out_dtype), saved, mean[:, 0], rstd[:, 0]


def _plain_bwd(spec, dy, saved, mean, rstd, gamma, beta, skip, ls):
    """The reference kernel's _bwd_chunk over the whole batch: du (compute
    dtype), dgamma, dbeta, db (f32), dls (or None) and the post-L2 skip
    cotangent (or None)."""
    cd = spec.compute_dtype
    dy = dy.float()
    s = _s_from_saved(spec, saved)
    z = (s.float() - mean[:, None]) * rstd[:, None]
    g, bt = gamma.float(), beta.float()
    dls = dskip = None
    if ls is not None:
        h = z * g + bt
        if spec.ln_act and spec.act != "none":
            h = act_fwd(spec.act, h.to(cd).float())
        if spec.l2:
            y = skip.float() + ls.float() * h
            ny = torch.clamp(torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True)), min=1e-12)
            yn = y / ny
            dy = (dy - yn * torch.sum(dy * yn, dim=-1, keepdim=True)) / ny
            dskip = dy.to(cd)
        dls = torch.sum(dy * h).reshape(ls.shape)
        dy = dy * ls.float()
    if spec.ln_act:
        if spec.rate > 0.0:
            keep = dropout_bits(spec.seed, *dy.shape, dy.device) >= dropout_threshold(spec.rate)
            dy = torch.where(keep, dy / keep_prob(spec.rate), 0.0)
        ga = dy * act_grad(spec.act, (z * g + bt).to(cd).float())
    else:
        ga = dy
    dg = torch.sum(ga * z, dim=0)
    dbeta = torch.sum(ga, dim=0)
    gz = ga * g
    n = s.shape[1]
    m1 = torch.sum(gz, dim=-1, keepdim=True) / n
    m2 = torch.sum(gz * z, dim=-1, keepdim=True) / n
    du = rstd[:, None] * (gz - m1 - z * m2)
    if not spec.ln_act:
        if spec.act == "relu":
            du = du * (s.float() > 0.0).float()
        elif spec.saves_pre:
            du = du * act_grad(spec.act, saved.float())
        elif spec.act == "tanh":
            a = torch.clamp(s.float(), -1.0 + 1e-6, 1.0 - 1e-6)
            du = du * act_grad("tanh", torch.atanh(a))
    db = torch.sum(du, dim=0)
    return du.to(cd), dg, dbeta, db, dls, dskip


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    return t if t.shape[1] == cols else torch.nn.functional.pad(t, (0, cols - t.shape[1]))


def _gemm(a, b, bias, out_cols: int, b_row: bool) -> torch.Tensor:
    """C = a @ B in bf16 with f32 accumulation: B = b (b_row) or b^T."""
    M, Kr = a.shape
    c = torch.empty((M, out_cols), dtype=torch.bfloat16, device=a.device)
    _build.launch("fused_dense_gemm", a.data_ptr(), b.data_ptr(),
                  None if bias is None else bias.data_ptr(), c.data_ptr(),
                  M, out_cols, Kr, int(b_row), _build.stream_of(a))
    _build.LAUNCHES.add("fused_dense_gemm")
    return c


def _kernel_fwd(spec, x, w, b, gamma, beta, skip, ls):
    B, K = x.shape
    N = w.shape[0]
    Kp = -(-K // 8) * 8  # the GEMM reads 16-byte rows: zero columns to a multiple of 8
    xk = _aligned(_pad_cols(x, Kp))
    wk = _aligned(_pad_cols(w.to(torch.bfloat16), Kp))
    saved = _gemm(xk, wk, _aligned(b.to(torch.bfloat16)), N, b_row=False)
    return _kernel_rows_fwd(spec, saved, gamma, beta, skip, ls)


def _kernel_rows_fwd(spec, saved, gamma, beta, skip, ls):
    """The forward's row epilogue in one launch over u = bf16(x W^T) + b
    (`saved`, (B, N) bf16, rewritten in place where act_ln changes it): y,
    saved, mean and rstd."""
    B, N = saved.shape
    y = torch.empty((B, N), dtype=spec.out_dtype, device=saved.device)
    mean = torch.empty(B, dtype=torch.float32, device=saved.device)
    rstd = torch.empty_like(mean)
    gamma, beta = _aligned(gamma.float()), _aligned(beta.float())
    skip_k = None if skip is None else _aligned(skip)
    ls_k = None if ls is None else ls.float().contiguous()
    _build.launch(
        "fused_dense_fwd_rows", saved.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if skip_k is None else skip_k.data_ptr(),
        None if ls_k is None else ls_k.data_ptr(), B, N, int(spec.ln_act),
        _ACT_CODE[spec.act], int(spec.saves_pre), spec.seed & _M32,
        dropout_threshold(spec.rate) if spec.rate > 0.0 else 0, keep_prob(spec.rate),
        int(spec.l2), int(spec.out_dtype == torch.float32), _build.stream_of(saved))
    _build.LAUNCHES.add("fused_dense_fwd_rows")
    return y, saved, mean, rstd


@functools.lru_cache(maxsize=None)
def _bwd_work(N: int) -> int:
    """Bytes of the backward row kernel's scratch at width N."""
    nwork = _build.LIBRARY.get().fused_dense_bwd_work(N)
    if nwork < 0:
        raise ValueError(f"the backward row kernel takes N <= {MAX_N}, got N={N}")
    return nwork


def _kernel_bwd(spec, dy, saved, mean, rstd, gamma, beta, skip, ls):
    """The backward row pass in one launch: du, dskip (with an L2 output)
    and the batch sums dgamma, dbeta, db and dls, all written by the
    kernel."""
    B, N = saved.shape
    dev = saved.device
    dy = _aligned(dy)
    dy_f32 = int(dy.dtype == torch.float32)
    du = torch.empty((B, N), dtype=torch.bfloat16, device=dev)
    dskip = torch.empty((B, N), dtype=torch.bfloat16, device=dev) if spec.l2 else None
    sums = torch.empty((3, N), dtype=torch.float32, device=dev)
    dls = torch.empty(1, dtype=torch.float32, device=dev) if ls is not None else None
    work = torch.empty(_bwd_work(N), dtype=torch.uint8, device=dev)
    gamma, beta = _aligned(gamma.float()), _aligned(beta.float())
    skip_k = _aligned(skip) if spec.l2 else None
    ls_k = None if ls is None else ls.float().contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        "fused_dense_bwd_rows", dy.data_ptr(), saved.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(skip_k), ptr(ls_k),
        du.data_ptr(), ptr(dskip), sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(),
        ptr(dls), work.data_ptr(), B, N, int(spec.ln_act), _ACT_CODE[spec.act],
        int(spec.saves_pre), spec.seed & _M32,
        dropout_threshold(spec.rate) if spec.rate > 0.0 else 0, keep_prob(spec.rate),
        int(spec.l2), dy_f32, _build.stream_of(dy))
    _build.LAUNCHES.add("fused_dense_bwd_rows")
    dg, dbeta, db = sums
    return du, dg, dbeta, db, None if ls is None else dls.reshape(ls.shape), dskip


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FusedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, skip, ls, spec, use_kernel):
        w_c = w.to(spec.compute_dtype)
        fwd = _kernel_fwd if use_kernel else _plain_fwd
        y, saved, mean, rstd = fwd(spec, x, w_c, b, gamma, beta, skip, ls)
        ctx.spec, ctx.use_kernel = spec, use_kernel
        ctx.w_dtype, ctx.skip_dtype = w.dtype, None if skip is None else skip.dtype
        ctx.save_for_backward(x, w_c, gamma, beta, saved, mean, rstd,
                              skip if spec.l2 else None, ls)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_c, gamma, beta, saved, mean, rstd, skip, ls = ctx.saved_tensors
        dx, dw, db, dg, dbeta, dls, dskip = _backward(
            ctx.spec, dy, x, w_c, gamma, beta, saved, mean, rstd, skip, ls, ctx.use_kernel)
        return (dx.to(x.dtype), dw.to(ctx.w_dtype), db, dg, dbeta,
                None if dskip is None else dskip.to(ctx.skip_dtype),
                None if dls is None else dls.to(ls.dtype), None, None)


def _backward(spec, dy, x, w_c, gamma, beta, saved, mean, rstd, skip, ls, use_kernel):
    """Every cotangent of the block from the forward's residuals: dx, dW
    (f32), db, dgamma, dbeta, dls and dskip (the last two None without the
    skip tail; `skip` is read only with an L2 output). The kernels, or the
    plain versions with use_kernel false."""
    bwd = _kernel_bwd if use_kernel else _plain_bwd
    du, dg, dbeta, db, dls, dskip = bwd(spec, dy, saved, mean, rstd, gamma, beta, skip, ls)
    K = x.shape[1]
    if use_kernel:
        Kp = -(-K // 8) * 8
        dx = _gemm(du, _aligned(_pad_cols(w_c, Kp)), None, Kp, b_row=True)[:, :K]
        dw = torch.mm(du.t(), x, out_dtype=torch.float32)
    else:
        dx = (du.float() @ w_c.float()).to(spec.compute_dtype)
        dw = du.float().t() @ x.float()
    if ls is not None and dskip is None:  # y = skip + ls * h: dy itself
        dskip = dy.to(spec.compute_dtype)
    return dx, dw, db, dg, dbeta, dls, dskip


def _check(x, kernel, order, act, rate, dropout_seed, skip, layer_scale, l2):
    if order not in ("ln_act", "act_ln"):
        raise ValueError(f"unknown order {order!r}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if x.dim() != 2 or kernel.dim() != 2 or kernel.shape[1] != x.shape[1]:
        raise ValueError(f"x (B, K) and kernel (N, K) do not match: {tuple(x.shape)}, "
                         f"{tuple(kernel.shape)}")
    if order == "act_ln" and rate > 0.0:
        raise ValueError("order='act_ln' does not implement dropout "
                         "(dropout_rate must be 0 or deterministic=True)")
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires a dropout_seed")
    if skip is not None and rate > 0.0:
        raise ValueError("the skip/layer_scale epilogue requires rate == 0")
    if (skip is None) != (layer_scale is None):
        raise ValueError("skip and layer_scale must be passed together")
    if l2 and skip is None:
        raise ValueError("l2_normalize_out is only supported with skip")


def _apply(x, kernel, bias, ln_scale, ln_bias, order, act, dropout_rate, dropout_seed,
           deterministic, out_dtype, compute_dtype, skip, layer_scale, l2_normalize_out,
           use_kernel):
    rate = 0.0 if deterministic else float(dropout_rate)
    _check(x, kernel, order, act, rate, dropout_seed, skip, layer_scale, l2_normalize_out)
    spec = _Spec(order, act, rate, 0 if dropout_seed is None else int(dropout_seed),
                 compute_dtype, out_dtype, bool(l2_normalize_out))
    xc = x.to(compute_dtype)
    skip_c = None if skip is None else skip.to(compute_dtype)
    return _FusedDense.apply(xc, kernel, bias, ln_scale, ln_bias, skip_c, layer_scale,
                             spec, use_kernel)


def fused_dense_reference(
    x, kernel, bias, ln_scale, ln_bias, *, order="ln_act", act="gelu", dropout_rate=0.0,
    dropout_seed=None, deterministic=True, out_dtype=torch.float32,
    compute_dtype=torch.bfloat16, skip=None, layer_scale=None, l2_normalize_out=False,
):
    """Plain PyTorch version of `fused_dense_norm_act` on any device: the same
    rounding points, the same hash dropout mask, and the same backward."""
    return _apply(x, kernel, bias, ln_scale, ln_bias, order, act, dropout_rate,
                  dropout_seed, deterministic, out_dtype, compute_dtype, skip,
                  layer_scale, l2_normalize_out, use_kernel=False)


def fused_dense_norm_act(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    *,
    order: str = "ln_act",
    act: str = "gelu",
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    deterministic: bool = True,
    out_dtype: torch.dtype = torch.float32,
    compute_dtype: torch.dtype = torch.bfloat16,
    skip: Optional[torch.Tensor] = None,
    layer_scale: Optional[torch.Tensor] = None,
    l2_normalize_out: bool = False,
) -> torch.Tensor:
    """Fused Dense + LayerNorm + activation (+ dropout, + skip tail) block.

    x (B, K); kernel (N, K) (f32 params, cast to compute_dtype inside);
    bias / ln_scale / ln_bias (N,); skip (B, N) with layer_scale (1,).
    Returns (B, N) in out_dtype. CPU tensors take the plain version; CUDA
    tensors take the kernels (bf16 compute, N a multiple of 8 up to MAX_N)
    or raise.
    """
    if x.device.type == "cpu":
        return fused_dense_reference(
            x, kernel, bias, ln_scale, ln_bias, order=order, act=act,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            deterministic=deterministic, out_dtype=out_dtype,
            compute_dtype=compute_dtype, skip=skip, layer_scale=layer_scale,
            l2_normalize_out=l2_normalize_out)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel computes in bf16, got compute_dtype={compute_dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel writes bf16 or f32, got out_dtype={out_dtype}")
    if kernel.shape[0] % 8 or kernel.shape[0] > MAX_N:
        raise ValueError(f"the CUDA kernel takes N a multiple of 8 up to {MAX_N}, "
                         f"got N={kernel.shape[0]}")
    params = (kernel, bias, ln_scale, ln_bias) + (() if skip is None else (skip, layer_scale))
    if any(p.device != x.device for p in params):
        raise ValueError("x and every parameter must be on the same CUDA device")
    return _apply(x, kernel, bias, ln_scale, ln_bias, order, act, dropout_rate,
                  dropout_seed, deterministic, out_dtype, compute_dtype, skip,
                  layer_scale, l2_normalize_out, use_kernel=True)
