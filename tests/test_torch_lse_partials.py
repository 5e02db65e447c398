"""The lse walk's partials (csrc/lse_walk.cu: `lse_walk_kernel`) and their
combine, on the CPU: partials formed in plain torch the way the kernel forms
them, fed to the plain version of the combine kernel
(`fused_infonce._plain_lse_combine`), against the JAX package's
`_sym_row_col_lse` and `_row_lse` (Pallas in interpret mode) on the same numpy
inputs, within rtol 1e-5 in f32, at the default logit scale (1 / 0.07) and at
the clamp (100). The kernel's own arithmetic is held to the plain versions on
the card (`tests/test_torch_kernels.py`).

How the kernel forms them: blocks of 128 own rows (two warpgroups of 64, four
warps of 16 each; rows past m padded with zero rows), the walked columns in
64-wide tiles (padded with zero rows of y), split into `nsplit` ranges of
whole tiles over [0, end) (end = n_valid when a column count is given and
positive); per range an online row max and sum over its tiles in the log2
domain with one exponential an entry, p = 2^(s2 - m_new); per tile and 64-row
group the column partial from the same p, weighed by 2^(m_new - M_w) with M_w
the largest running row max of each warp's valid rows, and the four warps'
partials combined exactly, stored in log form (M_w + log2(sum), 1) so that the
combine's floor of a sum at 1e-30 never cuts a partial that is only small
against the rows' max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu_torch.ops import fused_infonce as fi

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
SCALES = (1.0 / 0.07, 100.0)


def walk_partials(x, y, scale, nsplit, n_valid=None, cols=True):
    """The flat partials of `lse_walk_kernel` (the layout `lse_combine`
    reads), formed in f32 torch as the kernel forms them."""
    m, n = x.shape[0], y.shape[0]
    mp = -(-m // 128) * 128
    xf = torch.zeros(mp, x.shape[1])
    xf[:m] = x
    raw_all = xf @ y.t()
    masked = n_valid is not None
    nv = min(max(int(n_valid), 0), n) if masked else n
    end = nv if masked and nv > 0 else n
    tiles = -(-end // 64)
    per = -(-tiles // nsplit)
    scale2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    valid = torch.arange(mp) < m
    groups = -(-m // 64)
    rmax, rsum = torch.full((nsplit, m), -torch.inf), torch.zeros(nsplit, m)
    cmax, csum = torch.empty(groups, n), torch.empty(groups, n)
    for r in range(nsplit):
        mrow, lrow = torch.full((mp,), -torch.inf), torch.zeros(mp)
        for tile in range(min(tiles, r * per), min(tiles, r * per + per)):
            c0, c = tile * 64, torch.arange(tile * 64, tile * 64 + 64)
            w = min(64, n - c0)
            raw = torch.zeros(mp, 64)
            raw[:, :w] = raw_all[:, c0:c0 + w]
            bias = (torch.where(c < nv, 0.0, -1e30 * LOG2E) if masked
                    else torch.where(c < n, 0.0, -torch.inf))
            s2 = raw * scale2 + bias
            m_new = torch.maximum(mrow, s2.max(dim=1).values)
            p = torch.exp2(s2 - m_new[:, None])  # the one exponential an entry
            lrow = lrow * torch.exp2(mrow - m_new) + p.sum(dim=1)
            mrow = m_new
            if not cols:
                continue
            m_warp = torch.where(valid, m_new, -torch.inf).view(-1, 16).max(dim=1).values
            e = torch.where(valid, torch.exp2(m_new - m_warp.repeat_interleave(16)), 0.0)
            by_warp = (p * e[:, None]).view(-1, 16, 64).sum(dim=1).view(-1, 4, 64)
            m4 = m_warp.view(-1, 4)
            top = m4.max(dim=1).values
            f = torch.where(m4 > -torch.inf, torch.exp2(m4 - top[:, None]), 0.0)
            total = (by_warp * f[..., None]).sum(dim=1)[:groups, :w]  # relative to top
            cmax[:, c0:c0 + w] = torch.where(total > 0, (top[:groups, None] + torch.log2(total))
                                             * LN2, -torch.inf)
            csum[:, c0:c0 + w] = (total > 0).float()
        rmax[r], rsum[r] = mrow[:m] * LN2, lrow[:m]
    parts = [rmax, rsum] + ([cmax, csum] if cols else [])
    return torch.cat([t.flatten() for t in parts]), groups


def _unit(rng, rows, d):
    return np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(rows, d)).astype(np.float32))))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("m,n,d,nsplit", [(200, 333, 48, 3), (129, 40, 96, 1), (300, 700, 64, 5)])
def test_symmetric_partials_combine_to_jax_lse(m, n, d, nsplit, scale):
    """Row and column lse from the walk's partials (several row blocks,
    padded rows and columns, column ranges, n < 64) against
    `_sym_row_col_lse`; the first min(m, n) pairs aligned, so each of their
    rows and columns peaks far above the rest at the clamp."""
    rng = np.random.default_rng(m + n)
    x, y = _unit(rng, m, d), _unit(rng, n, d)
    k = min(m, n)
    y[:k] = np.array(jinf.l2_normalize(jnp.asarray(x[:k] + 0.5 * y[:k])))
    with pltpu.force_tpu_interpret_mode():
        want = jfi._sym_row_col_lse(jnp.asarray(x), jnp.asarray(y), jnp.float32(scale))
    part, groups = walk_partials(torch.from_numpy(x), torch.from_numpy(y), scale, nsplit)
    row, col = fi._plain_lse_combine(part, nsplit, m, groups, n)
    np.testing.assert_allclose(row.numpy(), np.asarray(want[0])[:, 0], rtol=1e-5)
    np.testing.assert_allclose(col.numpy(), np.asarray(want[1])[:, 0], rtol=1e-5)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("n_valid", [None, 0, 64, 250])
def test_row_ce_partials_combine_to_jax_lse(n_valid, scale):
    """The row lse from the row-CE walk's partials against `_row_lse` with the
    same column count: all columns, none (every column at -1e30), a tile
    edge (the last three of four ranges empty) and mid-tile."""
    m, n, d, nsplit = 150, 333, 48, 4
    rng = np.random.default_rng(7)
    x, y = _unit(rng, m, d), _unit(rng, n, d)
    nv = None if n_valid is None else jnp.int32(n_valid)
    with pltpu.force_tpu_interpret_mode():
        want = jfi._row_lse(jnp.asarray(x), jnp.asarray(y), jnp.float32(scale), nv)
    part, _ = walk_partials(torch.from_numpy(x), torch.from_numpy(y), scale, nsplit, n_valid,
                            cols=False)
    row, col = fi._plain_lse_combine(part, nsplit, m, 0, 0)
    assert col is None
    np.testing.assert_allclose(row.numpy(), np.asarray(want)[:, 0], rtol=1e-5)


def test_plain_combine_is_the_reference_combine():
    """The plain combine is max + log(max(sum, 1e-30)) through logsumexp, rows
    over their ranges and columns over their groups; an all -inf entry stays
    -inf."""
    nsplit, m, groups, n = 2, 3, 2, 2
    rows = torch.tensor([[[1.0, -torch.inf, 0.5], [2.0, -torch.inf, -1.0]],
                         [[2.0, 0.0, 1.0], [0.5, 0.0, 3.0]]])
    cols = torch.tensor([[[0.0, 4.0], [1.0, -2.0]], [[1.0, 2.0], [0.0, 1.0]]])
    part = torch.cat([rows.flatten(), cols.flatten()])
    row, col = fi._plain_lse_combine(part, nsplit, m, groups, n)
    want_row = torch.logsumexp(rows[0] + torch.log(torch.clamp(rows[1], min=1e-30)), dim=0)
    want_col = torch.logsumexp(cols[0] + torch.log(torch.clamp(cols[1], min=1e-30)), dim=0)
    assert torch.equal(row, want_row) and torch.equal(col, want_col)
    assert row[1] == -torch.inf


@pytest.mark.parametrize("m,n,want", [(8192, 8192, 2), (4096, 4096, 4), (1000, 1000, 16),
                                      (1000, 1777, 16), (8192, 16384, 2), (256, 256, 4),
                                      (200, 40, 1), (20000, 20000, 1)])
def test_walk_splits_fill_the_card(m, n, want):
    """Column ranges: as many as fill the H100's 132 SMs with one 128-row
    block each, at most one a 64-column tile, at least one."""
    assert fi._walk_splits(m, n) == want
    assert fi._walk_splits(m, n) * -(-m // 128) <= max(132, -(-m // 128))


def test_walk_groups_and_scratch():
    """One column partial each 64 own rows; the scratch is 2·nsplit·m +
    2·groups·n floats (the combine's layout)."""
    assert [fi._walk_groups(m) for m in (1, 64, 65, 8192)] == [1, 1, 2, 128]
    part, groups = walk_partials(torch.zeros(65, 8), torch.zeros(70, 8), 1.0, 2)
    assert groups == 2 and part.numel() == 2 * 2 * 65 + 2 * 2 * 70
