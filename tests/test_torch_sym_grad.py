"""The symmetric InfoNCE's recompute pass (`sym_infonce_grad`,
csrc/row_ce.cu: `row_ce_grad_kernel` in its symmetric mode) on the CPU: the
pass formed in plain torch the way the kernel forms it, against the JAX
package's `_sym_grad_pass` (Pallas in interpret mode) on the same numpy
inputs, within the f32 gradient bound of `test_torch_fused_infonce.py`
(atol 1e-5, rtol 1e-4), at the default logit scale (1 / 0.07) and at the
clamp (100), with m and n off the 64-row tiles (n < 64 among them) and d off
64; then in bf16 against the port's plain version. The kernel's own
arithmetic is held to the plain version on the card
(`tests/test_torch_kernels.py`).

How the kernel forms it: a block owns 64 rows of x and walks the rows of y
in tiles of 64 (rows past n arrive as zeros), where the card has SMs to spare
split into ranges of whole tiles (`_from_raw_splits`), one block of a cluster
each, whose sums are added in range order; d is padded to dp, a multiple
of 64, and each tile's S is the sum of two partials, warpgroup 0's over the
first 64·ceil(dp / 128) columns and warpgroup 1's over the rest;
p = 2^((s - lse_row) · log2 e) + 2^((s - lse_col) · log2 e) with
s = S · scale (the exp2 domain, the subtraction the reference's), formed by
32-column halves of the tile (one a warpgroup) and 0 past n; p rounded to
y's type for each tile's product, summed tile by tile in f32; rowdot's sum
of p·S taken per half and the halves added once at the end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu_torch.ops import fused_infonce as fi

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOG2E = 1.4426950408889634
SCALES = (1.0 / 0.07, 100.0)
TILE = 64


def kernel_pass(x, y, scale, lse_row, lse_col, splits=None):
    """(acc (m, d) f32, rowdot (m) f32) as `row_ce_grad_kernel`'s symmetric
    mode forms them from x (m, d), y (n, d), lse_row (m), lse_col (n): the
    walk in `splits` ranges of whole tiles (the port's rule by default),
    each range's sums added in range order."""
    m, d = x.shape
    n = y.shape[0]
    dp = -(-d // 64) * 64
    half_d = 64 * -(-(dp // 64) // 2)  # warpgroup 0's columns of d
    xp = torch.nn.functional.pad(x, (0, dp - d)).float()
    yp = torch.nn.functional.pad(y, (0, dp - d, 0, -(-n // TILE) * TILE - n))
    lse_c = torch.nn.functional.pad(lse_col, (0, yp.shape[0] - n))
    sc, log2e = torch.tensor(scale, dtype=torch.float32), torch.tensor(LOG2E)
    splits = fi._from_raw_splits(m, n) if splits is None else splits
    tiles = -(-n // TILE)
    per = -(-tiles // splits)
    acc, rowdot = torch.zeros(m, dp), torch.zeros(m)
    for r in range(splits):
        part, halves = torch.zeros(m, dp), torch.zeros(2, m)
        for tile in range(min(tiles, r * per), min(tiles, r * per + per)):
            j0 = tile * TILE
            ytf = yp[j0:j0 + TILE].float()
            s = xp[:, :half_d] @ ytf[:, :half_d].t() + xp[:, half_d:] @ ytf[:, half_d:].t()
            sv = s * sc
            p = (torch.exp2((sv - lse_row[:, None]) * log2e)
                 + torch.exp2((sv - lse_c[None, j0:j0 + TILE]) * log2e))
            p = torch.where(torch.arange(j0, j0 + TILE)[None, :] < n, p, 0.0)
            part += p.to(y.dtype).float() @ ytf
            for h in range(2):  # each warpgroup's half of the tile
                halves[h] += (p[:, 32 * h:32 * h + 32] * s[:, 32 * h:32 * h + 32]).sum(dim=1)
        acc, rowdot = acc + part, rowdot + (halves[0] + halves[1])
    return acc[:, :d], rowdot


def _unit(rng, rows, d):
    return np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(rows, d)).astype(np.float32))))


def _inputs(m, n, d, scale, seed):
    """Unit rows, the first min(m, n) pairs aligned (their entries peak far
    above the rest at the clamp), and the row and column lse of s = scale ·
    x·y^T taken in f64 from the f32 similarity."""
    rng = np.random.default_rng(seed)
    x, y = _unit(rng, m, d), _unit(rng, n, d)
    k = min(m, n)
    y[:k] = np.array(jinf.l2_normalize(jnp.asarray(x[:k] + 0.5 * y[:k])))
    s = ((x @ y.T).astype(np.float32) * np.float32(scale)).astype(np.float64)
    lse_row = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    lse_col = np.log(np.exp(s - s.max(0, keepdims=True)).sum(0)) + s.max(0)
    return x, y, lse_row.astype(np.float32), lse_col.astype(np.float32)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("m,n,d,splits", [(136, 136, 48, None), (200, 40, 72, None),
                                          (129, 300, 96, None), (129, 300, 96, 1),
                                          (70, 130, 200, None)])
def test_kernel_pass_matches_jax(m, n, d, splits, scale):
    """The pass formed the kernel's way against JAX's pallas_call on the same
    inputs: several own blocks and walked tiles, a partial last tile on both
    sides, n < 64, d off 64 (dp = 64, 128, 128, 256: warpgroup 1 with no
    columns of d at dp = 64); the walk split by the port's rule (3 ranges at
    136 x 136, 1 at 200 x 40, 5 at 129 x 300, 3 at 70 x 130) and whole."""
    x, y, lse_row, lse_col = _inputs(m, n, d, scale, seed=m + n + d)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jfi._sym_grad_pass)(jnp.asarray(x), jnp.asarray(y), jnp.float32(scale),
                                           jnp.asarray(lse_row[:, None]),
                                           jnp.asarray(lse_col[:, None]))
    got = kernel_pass(torch.from_numpy(x), torch.from_numpy(y), scale,
                      torch.from_numpy(lse_row), torch.from_numpy(lse_col), splits)
    for g, w, name in zip(got, (np.asarray(want[0]), np.asarray(want[1])[:, 0]),
                          ("acc", "rowdot")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_kernel_pass_matches_the_plain_version(scale):
    """In bf16 (the train path's dot type: x, y and p rounded to bf16) the
    kernel's arithmetic against the port's plain version (`_plain_grad`: the
    whole S at once, p = exp(s - lse_row) + exp(s - lse_col)), to a few bf16
    roundings of p: the exponentials round differently, so an entry of p
    near a bf16 tie may round the other way."""
    x, y, lse_row, lse_col = _inputs(200, 333, 64, scale, seed=3)
    xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    lr, lc = torch.from_numpy(lse_row), torch.from_numpy(lse_col)
    got = kernel_pass(xb, yb, scale, lr, lc)
    want = fi._plain_grad(xb, yb, torch.tensor([scale]), lr, lc)
    for g, w, name in zip(got, want, ("acc", "rowdot")):
        top = w.abs().max().item()
        torch.testing.assert_close(g / top, w / top, atol=2e-3, rtol=0, msg=name)

