"""The backward from the saved int16 raw (csrc/raw_grad.cu:
`from_raw_grad_kernel`, pass A: P y and rowdot; pass B: P^T x) on the CPU:
each pass formed in plain torch the way the kernel forms it, against the JAX
package's `_sym_grad_passes_from_raw` with the two-pass schedule
(CLIP_DPLM_LOSS_MERGED=0, Pallas in interpret mode) on the same numpy
inputs, within rtol 1e-5 in f32 (atol 1e-6 of each output's largest entry,
the floor of an entry that is a cancelling sum of ~n terms), at the default
logit scale (1 / 0.07) and at the clamp (100), m and n off the 64-entry
tiles (n < 64 among them) and d off 64. The kernel's own arithmetic is held
to the plain versions on the card (`tests/test_torch_kernels.py`); the
shape rules (the from-raw schedule, the walk's ranges) are checked at the
smoke's shapes.

How the kernel forms them: a block owns 64 entries (rows of the raw for pass
A, its columns for pass B, read as the transposed tile) and walks the other
side in tiles of 64; s = q · c with c = f32(scale · f32(1 / RAW_QSCALE)), one
multiply as the reference's; p = 2^((s - lse_own) · log2 e) + 2^((s -
lse_walked) · log2 e) (the exp2 domain, the subtraction the reference's); p
rounded to the walked operand's type for each tile's product, summed tile
by tile in f32; p 0 past the walked end; where the card has SMs to spare
the walk is split into ranges of whole tiles (`_from_raw_splits`), each
range's sums (the product and rowdot's sum of p·q) added in range order;
rowdot's sum of p·q taken per 32-entry half of each tile (each warpgroup's
exponentials) and the halves added once a range, times 1 / RAW_QSCALE once
at the end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import fused_infonce as jfi
from clip_dplm_tpu.ops import infonce as jinf
from clip_dplm_tpu_torch.ops import fused_infonce as fi

LOG2E = 1.4426950408889634
SCALES = (1.0 / 0.07, 100.0)
TILE = 64


def kernel_pass(q, walk, scale, lse_own, lse_walk, splits=None):
    """One pass as `from_raw_grad_kernel` forms it: q (own, walked) int16 (the
    raw for pass A, its transpose for pass B), walk (walked, d); the walk in
    `splits` ranges of whole tiles (the port's rule by default), each range's
    sums added in range order; returns (acc (own, d) f32, rowdot (own)
    f32)."""
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.0 / fi.RAW_QSCALE,
                                                                dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    own, nw = q.shape
    splits = fi._from_raw_splits(own, nw) if splits is None else splits
    tiles = -(-nw // TILE)
    per = -(-tiles // splits)
    acc, rowdot = torch.zeros(own, walk.shape[1]), torch.zeros(own)
    for r in range(splits):
        part, halves = torch.zeros(own, walk.shape[1]), torch.zeros(2, own)
        for tile in range(min(tiles, r * per), min(tiles, r * per + per)):
            j0 = tile * TILE
            qf = q[:, j0:j0 + TILE].float()
            s = qf * c
            p = (torch.exp2((s - lse_own[:, None]) * log2e)
                 + torch.exp2((s - lse_walk[None, j0:j0 + TILE]) * log2e))
            part += p.to(walk.dtype).float() @ walk[j0:j0 + TILE].float()
            for h in range(2):  # each warpgroup's half of the tile
                halves[h] += (p[:, 32 * h:32 * h + 32] * qf[:, 32 * h:32 * h + 32]).sum(dim=1)
        acc, rowdot = acc + part, rowdot + (halves[0] + halves[1])
    return acc, rowdot * torch.tensor(1.0 / fi.RAW_QSCALE, dtype=torch.float32)


def kernel_passes(raw_q, x, y, scale, lse_row, lse_col, splits=None):
    """(acc_a, rowdot, acc_b) the two launches give."""
    acc_a, rowdot = kernel_pass(raw_q, y, scale, lse_row, lse_col, splits)
    acc_b, _ = kernel_pass(raw_q.t(), x, scale, lse_col, lse_row, splits)
    return acc_a, rowdot, acc_b


def _unit(rng, rows, d):
    return np.array(jinf.l2_normalize(jnp.asarray(rng.normal(size=(rows, d)).astype(np.float32))))


def _inputs(m, n, d, scale, seed):
    """Unit rows, the first min(m, n) pairs aligned (each of their rows and
    columns peaks far above the rest at the clamp); the int16 raw and the f32
    lse of s = q · scale / RAW_QSCALE."""
    rng = np.random.default_rng(seed)
    x, y = _unit(rng, m, d), _unit(rng, n, d)
    k = min(m, n)
    y[:k] = np.array(jinf.l2_normalize(jnp.asarray(x[:k] + 0.5 * y[:k])))
    raw_q = np.round(x @ y.T * jfi.RAW_QSCALE).astype(np.int16)
    s = raw_q.astype(np.float32) * np.float32(np.float32(scale) / np.float32(jfi.RAW_QSCALE))
    s64 = s.astype(np.float64)
    lse_row = (np.log(np.exp(s64 - s64.max(1, keepdims=True)).sum(1)) + s64.max(1))
    lse_col = (np.log(np.exp(s64 - s64.max(0, keepdims=True)).sum(0)) + s64.max(0))
    return x, y, raw_q, lse_row.astype(np.float32), lse_col.astype(np.float32)


def _jax_passes(monkeypatch, x, y, raw_q, scale, lse_row, lse_col):
    m, n = raw_q.shape
    block_m, block_n = 64, 128
    padded = np.zeros((jfi._round_up(m, block_m), jfi._round_up(n, block_n)), np.int16)
    padded[:m, :n] = raw_q
    monkeypatch.setenv("CLIP_DPLM_LOSS_MERGED", "0")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda *xs: jfi._sym_grad_passes_from_raw(
            *xs, block_m=block_m, block_n=block_n))(
            jnp.asarray(padded), jnp.asarray(x), jnp.asarray(y), jnp.float32(scale),
            jnp.asarray(lse_row[:, None]), jnp.asarray(lse_col[:, None]))
    jax.clear_caches()  # the env is read at trace time
    return np.asarray(want[0]), np.asarray(want[1])[:, 0], np.asarray(want[2])


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("m,n,d,splits", [(136, 136, 48, None), (200, 40, 72, None),
                                          (129, 300, 96, None), (129, 300, 96, 1),
                                          (129, 300, 96, 3)])
def test_kernel_passes_match_jax(monkeypatch, m, n, d, splits, scale):
    """Pass A and pass B formed the kernel's way against JAX's two pallas_calls
    on the same raw and lse: several own blocks and walked tiles, a partial
    last tile on both sides, n < 64, d off 64; the walk split by the port's
    rule (3 ranges for pass A at 136 x 136, 4 for pass B at 200 x 40, 5 and 3
    at 129 x 300), whole, and in 3 ranges."""
    x, y, raw_q, lse_row, lse_col = _inputs(m, n, d, scale, seed=m + n)
    want = _jax_passes(monkeypatch, x, y, raw_q, scale, lse_row, lse_col)
    got = kernel_passes(torch.from_numpy(raw_q), torch.from_numpy(x), torch.from_numpy(y),
                        scale, torch.from_numpy(lse_row), torch.from_numpy(lse_col), splits)
    for g, w, name in zip(got, want, ("acc_a", "rowdot", "acc_b")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("scale", SCALES)
def test_kernel_passes_match_the_plain_versions(scale):
    """In bf16 (the train path's dot type: p rounded to bf16 for each tile's
    product) the kernel's arithmetic against the port's plain from-raw
    versions (`_plain_grad_raw`, `_plain_grad_rawT`: p = exp(s - lse_row) +
    exp(s - lse_col) with expf), to a few bf16 roundings of p: the two
    exponentials round differently, so an entry of p near a bf16 tie may
    round the other way."""
    x, y, raw_q, lse_row, lse_col = _inputs(200, 333, 64, scale, seed=3)
    args = (torch.from_numpy(raw_q), torch.from_numpy(x).bfloat16(),
            torch.from_numpy(y).bfloat16(), torch.tensor([scale]), torch.from_numpy(lse_row),
            torch.from_numpy(lse_col))
    got = kernel_passes(args[0], args[1], args[2], scale, args[4], args[5])
    want = fi._plain_grad_from_raw(*args)
    for g, w, name in zip(got, want, ("acc_a", "rowdot", "acc_b")):
        top = w.abs().max().item()
        torch.testing.assert_close(g / top, w / top, atol=2e-3, rtol=0, msg=name)


@pytest.mark.parametrize("B,merged", [(8192, False), (4096, False), (1024, False), (1000, False),
                                      (512, False), (256, False), (200, False), (128, False)])
def test_from_raw_schedule_rule(B, merged):
    """The port's shape rule at the smoke's shapes (phase 11 and the schedule
    rounds): the two wgmma passes at every batch the train paths run."""
    assert fi._from_raw_merged(B) is merged


@pytest.mark.parametrize("n_own,n_walk,splits", [(8192, 8192, 1), (4096, 4096, 2),
                                                 (1024, 1024, 8), (1000, 1000, 8),
                                                 (512, 512, 8), (256, 256, 4), (200, 200, 4),
                                                 (128, 128, 2), (200, 40, 1), (40, 200, 4),
                                                 (8448, 100, 1), (4224, 8192, 2)])
def test_from_raw_splits_fill_the_card(n_own, n_walk, splits):
    """The walk's ranges at the smoke's shapes: one while the 64-entry own
    blocks fill half of the H100's 132 SMs, else as many as fill it (at most
    one a walked tile, at most a cluster's 8 blocks); never more blocks than
    SMs once split."""
    assert fi._from_raw_splits(n_own, n_walk) == splits
    blocks = -(-n_own // 64)
    assert splits == 1 or blocks * splits <= 132
