"""The port's CLS-query attention (clip_dplm_tpu_torch/ops/short_attention.py::
fused_cls_attention and ops/attention.py::cls_query_attention) against the
JAX package: the JAX kernel `fused_cls_attention` in Pallas interpret mode
and its XLA formulation `cls_query_attention`, on the same numpy inputs, in
f32 (values atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3, the JAX
suite's bounds). In f32 the kernel's f32 probabilities and the XLA
formulation's probabilities, rounded to the input dtype, agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.attention import cls_query_attention as jax_cls_query
from clip_dplm_tpu.ops.short_attention import fused_cls_attention as jax_fused_cls
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.attention import cls_query_attention

VAL = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-3)


def _inputs(rng, B, S, D, masked):
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    ct = rng.normal(size=(B, 1, D)).astype(np.float32)
    return qkv, mask if masked else None, ct


def _torch_value_and_grad(fn, qkv, mask, ct, H):
    leaf = torch.from_numpy(qkv).requires_grad_(True)
    out = fn(leaf, H, mask=None if mask is None else torch.from_numpy(mask))
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)), leaf)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_matches_jax_kernel_and_xla_formulation(rng, masked):
    """B=4, S=128, D=64, 4 heads: the plain version (autograd), the wrapper
    (its Function: the plain forward and the plain recompute backward) and
    the port's cls_query_attention, against the JAX kernel and its XLA
    formulation."""
    B, S, D, H = 4, 128, 64, 4
    qkv, mask, ct = _inputs(rng, B, S, D, masked)
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_cls(jnp.asarray(qkv), H, mask=jm, block_b=2, interpret=True)
        want_g = jax.grad(lambda x: jnp.sum(jax_fused_cls(
            x, H, mask=jm, block_b=2, interpret=True) * ct))(jnp.asarray(qkv))
    want_x = jax_cls_query(jnp.asarray(qkv), H, mask=jm)
    want_xg = jax.grad(lambda x: jnp.sum(jax_cls_query(x, H, mask=jm) * ct))(jnp.asarray(qkv))
    for fn in (sa.fused_cls_attention_reference, sa.fused_cls_attention, cls_query_attention):
        got, got_g = _torch_value_and_grad(fn, qkv, mask, ct, H)
        assert got.shape == (B, 1, D)
        np.testing.assert_allclose(got, np.asarray(want), **VAL, err_msg=fn.__name__)
        np.testing.assert_allclose(got, np.asarray(want_x), **VAL, err_msg=fn.__name__)
        np.testing.assert_allclose(got_g, np.asarray(want_g), **GRAD, err_msg=fn.__name__)
        np.testing.assert_allclose(got_g, np.asarray(want_xg), **GRAD, err_msg=fn.__name__)
    assert not np.any(got_g[:, 1:, :D])  # only row 0 of the q part carries gradient


def test_ragged_batch_matches_jax_kernel(rng):
    """B=3 against the JAX kernel's 2-row programs (it pads the batch), S=64."""
    B, S, D, H = 3, 64, 32, 2
    qkv, mask, ct = _inputs(rng, B, S, D, True)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_cls(jnp.asarray(qkv), H, mask=jnp.asarray(mask), block_b=2,
                             interpret=True)
        want_g = jax.grad(lambda x: jnp.sum(jax_fused_cls(
            x, H, mask=jnp.asarray(mask), block_b=2, interpret=True) * ct))(jnp.asarray(qkv))
    got, got_g = _torch_value_and_grad(sa.fused_cls_attention, qkv, mask, ct, H)
    np.testing.assert_allclose(got, np.asarray(want), **VAL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_bwd_reference_matches_autograd_and_counts_nothing(rng, masked):
    """The plain recompute backward equals autograd through the plain
    forward, with a fully masked row; CPU tensors launch nothing."""
    B, S, D, H = 3, 65, 64, 4
    qkv, mask, ct = _inputs(rng, B, S, D, masked)
    if mask is not None:
        mask[-1] = False
    before = _build.LAUNCHES.snapshot()
    _, want = _torch_value_and_grad(sa.fused_cls_attention_reference, qkv, mask, ct, H)
    got = sa.fused_cls_attention_bwd(torch.from_numpy(ct), torch.from_numpy(qkv), H,
                                     mask=None if mask is None else torch.from_numpy(mask))
    assert _build.LAUNCHES.snapshot() == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


# (S, D, H, design, shared-memory bytes of the block the backward launches):
# the flagship, S=1, ESM-CLIP's lengths 32 and 64, the group design's cut at
# S=256 and one row past it (the row design), Dh=128, Dh=8 with 16 heads (8
# heads a group), Dh=256 at S=256 (the group's K and V past 227 KB), Dh=264
# (a group wider than one TMA box), 128 heads of 8 at S=256, which only the
# group design fits, and one head of 8 on each side of S=96, where a block's
# threads go from 128 to 256 and with them dq0's partials, 4 or 8 KB over V's
# 1.5 KB tile
CLS_BWD_SHAPES = [
    (128, 512, 8, "group", 34952),
    (1, 512, 8, "group", 5256),
    (32, 512, 8, "group", 9224),
    (64, 512, 8, "group", 17800),
    (256, 512, 8, "group", 69256),
    (257, 512, 8, "row", sa._cls_smem_bytes(257, 512, 8, True)),
    (128, 1024, 8, "group", 68232),
    (200, 128, 16, "group", 65544),
    (256, 512, 2, "row", sa._cls_smem_bytes(256, 512, 2, True)),
    (64, 528, 2, "row", sa._cls_smem_bytes(64, 528, 2, True)),
    (256, 1024, 128, "group", 2 * 32768 + 2 * 256 + 2 * 8192 + 1024 + 136),
    (95, 8, 1, "group", 1536 + 4096 + 2 * 128 + 2 * 384 + 384 + 136),
    (96, 8, 1, "group", 1536 + 8192 + 2 * 128 + 2 * 384 + 384 + 136),
]


@pytest.mark.parametrize("S,D,H,design,smem", CLS_BWD_SHAPES)
def test_cls_bwd_design_and_its_layout(S, D, H, design, smem):
    """The launcher's rule and the Python mirror of its block's shared memory
    (csrc/cls_attention.cu::ClsGroupSmem, ClsSmem), counted by hand: K and V
    tiles of S x the group's columns in bf16 (V's at least dq0's partials,
    which it holds after the scores: 8 floats a thread, 128 threads below
    S=96 and 256 from it), q0 and dout,
    prob and ds, the key bias, an mbarrier and 128 bytes of alignment."""
    assert sa.cls_bwd_design(S, D, H) == design
    assert sa.cls_bwd_smem_bytes(S, D, H) == smem
    assert 0 < smem <= sa.MAX_SMEM
    if design == "group":
        assert sa.cls_bwd_group_smem_bytes(S, D, H) == smem


@pytest.mark.parametrize("D,H,groups", [
    (512, 8, (1, 64, 8)), (512, 16, (2, 64, 8)), (128, 16, (8, 64, 2)),
    (96, 12, (8, 64, 2)), (96, 4, (2, 48, 2)), (1024, 8, (1, 128, 8)),
    (64, 2, (2, 64, 1)), (8, 1, (1, 8, 1)), (1280, 20, (1, 64, 20)),
])
def test_cls_bwd_groups(D, H, groups):
    """Whole heads a group, up to 64 columns (one head where Dh is wider, no
    more than H), the last group the heads left over: 12 heads of 8 make a
    group of 8 and one of 4."""
    assert sa.cls_bwd_groups(D, H) == groups


def test_cls_bwd_takes_what_either_design_takes():
    """Where the row design's layout is past 227 KB the group design still
    takes the backward (128 heads of 8 at S=256), and past both the wrapper's
    check refuses before any launch."""
    assert sa._cls_smem_bytes(256, 1024, 128, True) > sa.MAX_SMEM
    assert sa.cls_bwd_smem_bytes(256, 1024, 128) > 0
    assert sa._cls_smem_bytes(1024, 1024, 128, True) > sa.MAX_SMEM
    assert sa.cls_bwd_design(1024, 1024, 128) == "row"
    assert sa.cls_bwd_smem_bytes(1024, 1024, 128) == 0
