"""The port's fused Dense+LN+act+dropout block (clip_dplm_tpu_torch/ops/
fused_dense.py) against the JAX kernel (`fused_dense_norm_act`, interpret
mode) on the same numpy inputs: forward and every gradient, both orders and
every activation, at f32 (the JAX suite's rtol 2e-4) and bf16 (rtol 0.05,
atol 0.03), with B ragged against the tile and K no multiple of 128. Dropout
runs on the port alone (the Pallas interpreter stubs the TPU PRNG to zeros):
its keep rate, the same mask in forward and backward, and a new mask per
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.ops import fused_dense as jfd
from clip_dplm_tpu_torch.ops import fused_dense as fd

ORDERS_ACTS = [(o, a) for o in ("ln_act", "act_ln") for a in fd.ACTS]
F32 = dict(rtol=2e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.03)


def _inputs(B=40, K=96, N=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, K)).astype(np.float32),
            (rng.normal(size=(K, N)) * 0.05).astype(np.float32),
            (rng.normal(size=(N,)) * 0.1).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=(N,))).astype(np.float32),
            (0.1 * rng.normal(size=(N,))).astype(np.float32))


def _jax_grads(arrs, cd, **kw):
    def f(*a):
        y = jfd.fused_dense_norm_act(*a, deterministic=True, interpret=True,
                                     compute_dtype=cd, **kw)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, y), grads = jax.value_and_grad(f, argnums=tuple(range(len(arrs))),
                                       has_aux=True)(*map(jnp.asarray, arrs))
    return np.asarray(y, np.float32), [np.asarray(g, np.float32) for g in grads]


def _port_grads(arrs, cd, **kw):
    x, w, *rest = (torch.tensor(a, requires_grad=True) for a in arrs)
    # flax kernel (K, N) -> the port's (N, K); the gradient is transposed back
    wt = w.detach().t().contiguous().requires_grad_(True)
    y = fd.fused_dense_norm_act(x, wt, *rest[:3], compute_dtype=cd, **kw)
    torch.sin(y.float()).sum().backward()
    grads = [x.grad, wt.grad.t()] + [t.grad for t in rest]
    return y.detach().float().numpy(), [g.float().numpy() for g in grads]


def _check_against_jax(arrs, cd_pair, tol, **kw):
    y_j, g_j = _jax_grads(arrs, cd_pair[0], **kw)
    y_p, g_p = _port_grads(arrs, cd_pair[1], **kw)
    np.testing.assert_allclose(y_p, y_j, **tol)
    for name, a, b in zip(["dx", "dW", "db", "dgamma", "dbeta"], g_p, g_j):
        scale = max(1.0, float(np.abs(b).max()))  # sums over B rows: relative
        np.testing.assert_allclose(a / scale, b / scale, err_msg=name, **tol)


@pytest.mark.parametrize("order,act", ORDERS_ACTS)
def test_matches_jax_f32(order, act):
    _check_against_jax(_inputs(), (jnp.float32, torch.float32), F32, order=order, act=act)


@pytest.mark.parametrize("order,act", [("ln_act", "gelu"), ("ln_act", "none"),
                                       ("act_ln", "relu"), ("act_ln", "silu"),
                                       ("act_ln", "tanh")])
def test_matches_jax_bf16(order, act):
    _check_against_jax(_inputs(N=256), (jnp.bfloat16, torch.bfloat16), BF16,
                       order=order, act=act)


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("dtypes,tol", [((jnp.float32, torch.float32), F32),
                                        ((jnp.bfloat16, torch.bfloat16), BF16)])
def test_skip_tail_matches_jax(l2, dtypes, tol):
    """y = skip + layer_scale * LN(x W + b) (+ L2 normalize): the
    optimized head's fc_out block, with dskip and dls."""
    x, w, b, g, bt = _inputs(N=128, seed=1)
    rng = np.random.default_rng(2)
    skip = rng.normal(size=(x.shape[0], 128)).astype(np.float32)
    ls = np.array([0.3], np.float32)
    arrs = (x, w, b, g, bt)
    kw = dict(order="ln_act", act="none", l2_normalize_out=l2)

    def jf(*a):
        y = jfd.fused_dense_norm_act(*a[:5], skip=a[5], layer_scale=a[6],
                                     deterministic=True, interpret=True,
                                     compute_dtype=dtypes[0], **kw)
        return jnp.sum(jnp.sin(y)), y

    (_, y_j), g_j = jax.value_and_grad(jf, argnums=tuple(range(7)), has_aux=True)(
        *map(jnp.asarray, arrs + (skip, ls)))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs + (skip, ls)]
    wt = ts[1].detach().t().contiguous().requires_grad_(True)
    y_p = fd.fused_dense_norm_act(ts[0], wt, *ts[2:5], skip=ts[5], layer_scale=ts[6],
                                  compute_dtype=dtypes[1], **kw)
    torch.sin(y_p).sum().backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j), **tol)
    g_p = [ts[0].grad, wt.grad.t()] + [t.grad for t in ts[2:]]
    for name, a, b in zip(["dx", "dW", "db", "dgamma", "dbeta", "dskip", "dls"], g_p, g_j):
        b = np.asarray(b, np.float32)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.float().numpy() / scale, b / scale, err_msg=name, **tol)


def test_reference_is_the_cpu_path():
    arrs = [torch.from_numpy(a) for a in _inputs()]
    wt = arrs[1].t().contiguous()
    kw = dict(order="ln_act", act="gelu", dropout_rate=0.1, dropout_seed=7,
              deterministic=False, out_dtype=torch.bfloat16)
    a = fd.fused_dense_norm_act(arrs[0], wt, *arrs[2:], **kw)
    b = fd.fused_dense_reference(arrs[0], wt, *arrs[2:], **kw)
    assert torch.equal(a, b)


def _dropout_run(seed, rate=0.1, B=40, N=256):
    x, w, b, g, bt = (torch.from_numpy(a) for a in _inputs(B=B, N=N))
    return fd.fused_dense_norm_act(x, w.t().contiguous(), b, g, bt, order="ln_act",
                                   act="gelu", dropout_rate=rate, dropout_seed=seed,
                                   deterministic=False, compute_dtype=torch.float32)


def test_dropout_keep_rate_mask_and_seed():
    rate, B, N = 0.1, 40, 256
    y = _dropout_run(3, rate, B, N)
    kept = (y != 0).float().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / (B * N))
    assert abs(kept - (1 - rate)) <= 3 * sigma, kept
    keep = fd.dropout_bits(3, B, N) >= fd.dropout_threshold(rate)
    assert torch.equal(keep, y != 0)
    y2 = _dropout_run(4, rate, B, N)
    assert not torch.equal(y2 != 0, y != 0)
    y3 = _dropout_run(3, rate, B, N)
    assert torch.equal(y3, y)


def test_dropout_mask_shared_by_forward_and_backward():
    """Gradient through one dropped element is zero: a one-hot dy on a
    dropped output gives dx = 0, on a kept one dx != 0."""
    rate, B, N = 0.5, 8, 128
    x, w, b, g, bt = (torch.from_numpy(a) for a in _inputs(B=B, N=N))
    wt = w.t().contiguous()
    keep = fd.dropout_bits(11, B, N) >= fd.dropout_threshold(rate)
    for want_zero in (True, False):
        r, c = map(int, torch.nonzero(~keep if want_zero else keep)[0])
        xg = x.clone().requires_grad_(True)
        y = fd.fused_dense_norm_act(xg, wt, b, g, bt, act="relu", dropout_rate=rate,
                                    dropout_seed=11, deterministic=False,
                                    compute_dtype=torch.float32)
        assert (y[r, c] == 0).item() == want_zero
        dy = torch.zeros_like(y)
        dy[r, c] = 1.0
        y.backward(dy)
        assert (xg.grad.abs().sum() == 0).item() == want_zero


def test_dropout_bits_are_uint32_and_uniform():
    bits = fd.dropout_bits(123, 64, 512)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    frac = (bits < 2 ** 31).float().mean().item()
    assert abs(frac - 0.5) < 3 * np.sqrt(0.25 / bits.numel())
    a, b, c = fd.DropoutSeeds(key=5, step=2), fd.DropoutSeeds(5, 2), fd.DropoutSeeds(5, 3)
    s = [a.next() for _ in range(3)]
    assert len(set(s)) == 3 and s == [b.next() for _ in range(3)]
    assert c.next() != s[0]


def test_rejects_bad_args():
    x, w, b, g, bt = (torch.from_numpy(a) for a in _inputs())
    wt = w.t().contiguous()
    with pytest.raises(ValueError):
        fd.fused_dense_norm_act(x, wt, b, g, bt, order="bogus")
    with pytest.raises(ValueError):
        fd.fused_dense_norm_act(x, wt, b, g, bt, act="mish")
    with pytest.raises(ValueError):
        fd.fused_dense_norm_act(x, wt, b, g, bt, dropout_rate=0.5, deterministic=False)
    with pytest.raises(ValueError):
        fd.fused_dense_norm_act(x, wt, b, g, bt, order="act_ln", act="relu",
                                dropout_rate=0.5, dropout_seed=1, deterministic=False)
    with pytest.raises(ValueError):
        fd.fused_dense_norm_act(x, wt, b, g, bt, l2_normalize_out=True)
    with pytest.raises(ValueError, match="no kernel"):
        fd.fused_dense_norm_act(x.to("meta"), wt.to("meta"), b, g, bt)


# ---------------------------------------------------------------------------
# the one-launch backward row kernel's order of summation (csrc/fused_dense.cu
# bwd_rows_kernel), modelled in plain torch and held against JAX
# ---------------------------------------------------------------------------


def _layout(N):
    """(span, groups, cpt) of bwd_rows_kernel: a row group of `span`
    threads, thread gl owning the 8-column chunks gl, gl + span, ..."""
    nch = N // 8
    span = 256 if nch >= 256 else -(-nch // 32) * 32
    return span, 256 // span, -(-nch // span)


def _row_sums(x, N):
    """Row sums in the kernel's order: each thread its chunks in order (8
    columns each), the warp's butterfly (xor 16, 8, 4, 2, 1), then the
    group's warps in order."""
    span, _, cpt = _layout(N)
    B = x.shape[0]
    chunks = torch.zeros(B, span * cpt, 8)
    chunks[:, :N // 8] = x.reshape(B, N // 8, 8)
    t = torch.zeros(B, span)
    for k in range(cpt):
        for e in range(8):
            t = t + chunks[:, k * span:(k + 1) * span, e]
    t = t.reshape(B, span // 32, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[:, :, lanes ^ o]
    s = torch.zeros(B)
    for w in range(span // 32):
        s = s + t[:, w, 0]
    return s


def _column_sums(v, rows, grid, N):
    """Column sums (and the batch sum of a per-row scalar, v of shape (B,))
    in the kernel's order: a block's tiles b, b + grid, ... and in a tile
    its row group's rows g, g + groups, ..., one running sum a thread; the
    block's groups added in order; then column by column warp w adds blocks
    w, w + 8, ... and the eight warps are added in order."""
    _, groups, _ = _layout(N)
    B = v.shape[0]
    ntiles = -(-B // rows)
    parts = []
    for b in range(min(grid, ntiles)):
        acc = [torch.zeros(v.shape[1:]) for _ in range(groups)]
        for tile in range(b, ntiles, grid):
            for g in range(groups):
                for r in range(g, min(rows, B - tile * rows), groups):
                    acc[g] = acc[g] + v[tile * rows + r]
        for g in range(1, groups):
            acc[0] = acc[0] + acc[g]
        parts.append(acc[0])
    total = torch.zeros(v.shape[1:])
    for w in range(8):
        t = torch.zeros(v.shape[1:])
        for q in range(w, len(parts), 8):
            t = t + parts[q]
        total = total + t
    return total


def _kernel_order_bwd(spec, dy, saved, mean, rstd, gamma, beta, skip, ls, rows, grid):
    """The plain backward (`fd._plain_bwd`, f32) with every sum over a row
    and over the batch taken in bwd_rows_kernel's order: du, dgamma, dbeta,
    db, dls."""
    N = saved.shape[1]
    dy = dy.float()
    s = fd._s_from_saved(spec, saved).float()
    z = (s - mean[:, None]) * rstd[:, None]
    g, bt = gamma.float(), beta.float()
    dyp, h = dy, torch.zeros_like(dy)
    if ls is not None:
        h = z * g + bt
        if spec.ln_act and spec.act != "none":
            h = fd.act_fwd(spec.act, h.to(spec.compute_dtype).float())
        if spec.l2:
            yv = skip.float() + ls * h
            ny = torch.clamp(torch.sqrt(_row_sums(yv * yv, N)), min=1e-12)[:, None]
            dot = _row_sums(dy * yv, N)[:, None] / ny
            dyp = (dy - (yv / ny) * dot) / ny
    d = dyp * ls if ls is not None else dyp
    if spec.ln_act:
        d = d * fd.act_grad(spec.act, (z * g + bt).to(spec.compute_dtype).float())
    ga = d
    m1 = _row_sums(ga * g, N)[:, None] / N
    m2 = _row_sums(ga * g * z, N)[:, None] / N
    du = rstd[:, None] * (ga * g - m1 - z * m2)
    if not spec.ln_act and spec.act == "relu":
        du = du * (s > 0.0).float()
    sums = [_column_sums(x, rows, grid, N) for x in (ga * z, ga, du)]
    dls = _column_sums(_row_sums(dyp * h, N)[:, None], rows, grid, N) if ls is not None else None
    return du, *sums, dls


@pytest.mark.parametrize("B,N,rows,grid,act,tail", [
    (40, 128, 16, 2, "gelu", None),  # 8 row groups a block, a ragged last tile
    (37, 384, 4, 3, "relu", None),  # 48 chunks: the row group padded to two warps
    (8, 2560, 1, 3, "none", "skip"),  # 320 chunks: two a thread, one row a tile
    (29, 128, 8, 5, "none", "l2"),  # the L2 output's two row sums first
])
def test_kernel_summation_order_matches_jax(B, N, rows, grid, act, tail):
    """bwd_rows_kernel adds the row sums lane by lane, by a warp butterfly
    and across warps, and the batch sums tile by tile, row group by row
    group and block by block: a plain-torch model of that order, on the
    port's plain forward residuals, against JAX's gradients (interpret
    mode) at f32 (the JAX suite's rtol 2e-4; batch sums relative to their
    largest entry)."""
    x, w, b, g, bt = _inputs(B=B, K=24, N=N, seed=5)
    rng = np.random.default_rng(6)
    skip = rng.normal(size=(B, N)).astype(np.float32) if tail else None
    ls = np.array([0.3], np.float32) if tail else None
    kw = dict(order="ln_act" if act != "relu" else "act_ln", act=act,
              l2_normalize_out=tail == "l2")

    def jf(*a):
        extra = dict(skip=a[5], layer_scale=a[6]) if tail else {}
        y = jfd.fused_dense_norm_act(*a[:5], deterministic=True, interpret=True,
                                     compute_dtype=jnp.float32, **extra, **kw)
        return jnp.sum(jnp.sin(y)), y

    arrs = (x, w, b, g, bt) + ((skip, ls) if tail else ())
    (_, y_j), g_j = jax.value_and_grad(jf, argnums=tuple(range(len(arrs))), has_aux=True)(
        *map(jnp.asarray, arrs))
    spec = fd._Spec(kw["order"], act, 0.0, 0, torch.float32, torch.float32, tail == "l2")
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    wt = t(w).t().contiguous()
    y, saved, mean, rstd = fd._plain_fwd(spec, t(x), wt, t(b), t(g), t(bt), t(skip), t(ls))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **F32)
    du, dg, dbeta, db, dls = _kernel_order_bwd(spec, torch.cos(y), saved, mean, rstd, t(g),
                                               t(bt), t(skip), t(ls), rows, grid)
    got = [du @ wt, db, dg, dbeta] + ([dls.reshape(1)] if tail else [])
    want = [g_j[0], g_j[2], g_j[3], g_j[4]] + ([g_j[6]] if tail else [])
    for name, a, b_ in zip(["dx", "db", "dgamma", "dbeta", "dls"], got, want):
        b_ = np.asarray(b_, np.float32).reshape(a.shape)
        scale = max(1.0, float(np.abs(b_).max()))
        np.testing.assert_allclose(a.numpy() / scale, b_ / scale, err_msg=name, **F32)
