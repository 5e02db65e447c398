"""The backward of the port's packed-qkv short-S attention with the fused
out-projection (clip_dplm_tpu_torch/ops/short_attention.py), recompute
mode: value, dqkv, dWo and dbo of `fused_short_attention_qkv_proj` on CPU
tensors (the plain path, through its autograd Function) against the JAX
kernel it replaces, both with save_probs=False, the JAX kernel run in Pallas
interpret mode, at the JAX suite's tolerances (f32; gradients atol 5e-5,
rtol 2e-3), at S = 64 and 65 (padding rows and keys in the one-block
kernel), with ragged masks and with keys masked inside the rows; the plain
backward `short_attention_qkv_bwd_reference` against autograd of the plain
forward; the backward's shared memory, which fits every (S, Dh) the forward
takes; and which launches each mode's backward takes at each (S, Dh), with
the scratch only the dQ and dK/dV pair reads. The saved mode is
tests/test_torch_saved_probs.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.short_attention import (
    fused_short_attention_qkv_proj as jax_qkv_proj,
)
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import short_attention as sa


def _inputs(rng, B, S, D, holes=False):
    """qkv, wo, bo and a ragged (B, S) mask; with holes, keys 1 and S // 2
    masked too (key 0 stays real: no row without a real key, since the TPU
    kernel pads keys with -1e30 where the port's kernels take -inf)."""
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    wo = (rng.normal(size=(D, D)) * 0.1).astype(np.float32)  # flax (in, out)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    if holes:
        mask[:, [1, S // 2]] = False
    return qkv, wo, bo, mask


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("S,holes", [(64, False), (65, False), (65, True)],
                         ids=["64", "65", "65-holes"])
def test_value_and_grads_match_jax_kernel(rng, rope, S, holes):
    """B=2, D=64, 2 heads, ragged masks, and keys masked inside the rows
    (holes); S=65 pads to 128 rows in the JAX kernel and in the port's
    one-block kernel. The loss sin(y)·valid is the JAX suite's."""
    B, D, H = 2, 64, 2
    qkv, wo, bo, mask = _inputs(rng, B, S, D, holes)
    pos = np.arange(S)
    w = mask[:, :, None].astype(np.float32)

    def jloss(qkv, wo, bo):
        y = jax_qkv_proj(qkv, wo, bo, H, mask=jnp.asarray(mask), block_b=2, save_probs=False,
                         rope_positions=jnp.asarray(pos) if rope else None, interpret=True)
        return jnp.sum(jnp.sin(y * w))

    with pltpu.force_tpu_interpret_mode():
        l_j, g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    y = sa.fused_short_attention_qkv_proj(
        leaves[0], leaves[1], leaves[2], H, mask=torch.from_numpy(mask),
        rope_positions=torch.from_numpy(pos) if rope else None, save_probs=False)
    loss = torch.sum(torch.sin(y * torch.from_numpy(w)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    got = [leaves[0].grad.numpy(), leaves[1].grad.numpy().T, leaves[2].grad.numpy()]
    for name, a, b in zip(["dqkv", "dwo", "dbo"], got, g_j):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("S", [64, 65])
def test_bwd_reference_matches_autograd_of_plain_forward(rng, rope, S):
    """The plain backward on the forward's residuals (qkv, o, mask) equals
    autograd through the plain forward, with a fully masked row."""
    B, D, H = 2, 64, 2
    qkv_np, _, _, mask_np = _inputs(rng, B, S, D)
    mask_np[-1] = False
    qkv = torch.from_numpy(qkv_np).requires_grad_(True)
    mask = torch.from_numpy(mask_np)
    pos = torch.arange(S) if rope else None
    o = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos)
    dout = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    (want,) = torch.autograd.grad(o, qkv, dout)
    got = sa.short_attention_qkv_bwd_reference(dout, qkv.detach(), o.detach(), H, mask=mask,
                                               rope_positions=pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_cpu_backward_takes_plain_versions_and_counts_nothing(rng):
    qkv, wo, bo, mask = _inputs(rng, 2, 70, 32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    before = _build.LAUNCHES.snapshot()
    y = sa.fused_short_attention_qkv_proj(*leaves, 4, mask=torch.from_numpy(mask),
                                          rope_positions=torch.arange(70))
    y.sum().backward()
    assert _build.LAUNCHES.snapshot() == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    assert leaves[1].grad.dtype == torch.float32


@pytest.mark.parametrize("Dh", [8, 64, 128])
@pytest.mark.parametrize("S", [1, 16, 64, 65, 128, 208, 209, 240, 255, 256])
def test_backward_shared_memory_bound(S, Dh):
    """Both backward blocks (dQ: K and V of the head for the whole sequence;
    dK/dV: a 64-key tile and its f32 dK/dV) fit the H100's 227 KB in both
    modes at every S and Dh of the forward's range
    (csrc/short_attention.cu::BwdQSmem, BwdKVSmem)."""
    for saved in (False, True):
        dq, dkv = sa.bwd_smem_bytes(S, Dh, saved)
        assert 0 < dq <= sa.MAX_SMEM and 0 < dkv <= sa.MAX_SMEM, (saved, dq, dkv)
    # the pair's blocks at S=128, Dh=64 (saved mode runs the one-block kernel
    # there since it took S <= 128; the pair keeps 128 < S <= 256), two an
    # SM: 48 query rows (dQ) and 64 x 64 (dK/dV)
    assert sa.bwd_smem_bytes(128, 64, True) == (102144, 108288)
    assert max(sa.bwd_smem_bytes(128, 64, True) + sa.bwd_smem_bytes(128, 64, False)) <= (
        sa.HALF_SMEM)


@pytest.mark.parametrize("S,Dh,fits", [(1, 64, True), (64, 64, True), (128, 64, True),
                                       (208, 64, True), (209, 64, False), (255, 64, False),
                                       (64, 128, True), (128, 128, False), (256, 8, True)])
def test_recompute_one_block_bound(S, Dh, fits):
    """The recompute backward's WMMA one-block-a-head kernel (the whole head's
    K, V and f32 dK/dV in one block, 64 query rows halved while they do not
    fit) fits S <= 208 at Dh = 64, S = 128 at 64 query rows; it runs past S =
    128 (below, the wgmma one-block kernel takes every call,
    `bwd_recompute_design`), and past its bound the recompute mode takes the
    dQ and dK/dV launches (csrc/short_attention.cu::bwd_head_rows)."""
    got = sa.bwd_head_smem_bytes(S, Dh)
    assert (0 < got <= sa.MAX_SMEM) == fits, got
    if not fits:
        assert got == 0
    # its block at S = 128: 64 query rows, 223 KB, one block an SM
    assert sa.bwd_head_smem_bytes(128, 64) == 228096


@pytest.mark.parametrize("S,Dh,smem", [(128, 64, 99336), (128, 128, 164872), (64, 64, 41992),
                                       (64, 128, 74760)])
def test_saved_one_block_shared_memory(S, Dh, smem):
    """The one-block saved backward's block (csrc/short_attention.cu::
    BwdSavedSmem: Q, K, V, dO and the probabilities of the head, R = 64 or
    128 rows, Dp = 64 or 128): at DPLM's and the flagship's (128, 64) it fits
    half an SM, two blocks an SM; at Dh=128 one block's 227 KB."""
    got = sa.bwd_saved_smem_bytes(S, Dh)
    assert got == smem
    assert got <= (sa.HALF_SMEM if Dh <= 64 else sa.MAX_SMEM)
    # every (S, Dh) of a padded size shares its block
    assert sa.bwd_saved_smem_bytes(S - 7, Dh - 8) == smem


@pytest.mark.parametrize("Dh", [8, 64, 128])
@pytest.mark.parametrize("S", [1, 16, 64, 65, 100, 128, 129, 200, 255, 256])
def test_saved_backward_design_by_shape(S, Dh):
    """The saved-mode backward runs one block a head at S <= 128 and the dQ
    and dK/dV pair past it, which alone allocates the (B, H, 3, S) scratch;
    the one-block block's shared memory is 0 where it does not run."""
    one = S <= 128
    assert sa.bwd_saved_design(S, Dh) == ("one block" if one else "pair")
    assert (sa.bwd_saved_smem_bytes(S, Dh) > 0) == one
    stats = sa._saved_stats(2, S, 3, Dh, torch.device("cpu"))
    assert (stats is None) == one
    if not one:
        assert stats.shape == (2, 3, 3, S) and stats.dtype == torch.float32


@pytest.mark.parametrize("Dh", [8, 64, 128])
@pytest.mark.parametrize("S", [1, 16, 64, 65, 128, 129, 200, 208, 209, 256])
def test_recompute_backward_design_by_shape(S, Dh):
    """The recompute-mode backward runs one block a head (the wgmma kernel)
    at S <= 128 and Dh <= 128; past S = 128 the WMMA head kernel where it
    fits (S <= 208 at Dh = 64; S <= 256 at Dh = 8, `test_recompute_one_block_
    bound`; never at Dh = 128), else the dQ and dK/dV pair, which alone
    allocates the (B, H, 3, S) scratch. The one-block block's shared memory
    is 0 where it does not run."""
    if S <= 128:
        want = "one block"
    elif Dh == 8 or (Dh == 64 and S <= 208):
        want = "head"
    else:
        want = "pair"
    assert sa.bwd_recompute_design(S, Dh) == want
    assert (sa.bwd_recompute_smem_bytes(S, Dh) > 0) == (want == "one block")
    stats = sa._recompute_stats(2, S, 3, Dh, torch.device("cpu"))
    assert (stats is None) == (want != "pair")
    if want == "pair":
        assert stats.shape == (2, 3, 3, S) and stats.dtype == torch.float32


@pytest.mark.parametrize("S,Dh,smem", [(128, 64, 99848), (64, 64, 42248), (128, 128, 165384),
                                       (64, 128, 83208)])
def test_recompute_one_block_shared_memory(S, Dh, smem):
    """The one-block recompute backward's block (csrc/short_attention.cu::
    BwdBlockSmem: Q, K, V, dO of the head, o where the probabilities go, the
    larger of the two, then the key bias): 512 bytes over the saved mode's
    block at (128, 64), still within half an SM, two blocks an SM at Dh = 64;
    at (64, 128) o (16 KB) is larger than the probabilities (8 KB)."""
    got = sa.bwd_recompute_smem_bytes(S, Dh)
    assert got == smem
    assert got <= (sa.HALF_SMEM if Dh <= 64 else sa.MAX_SMEM)
    R = 64 if S <= 64 else 128
    assert got - sa.bwd_saved_smem_bytes(S, Dh) == R * 4 + (8192 if (S, Dh) == (64, 128) else 0)
    # every (S, Dh) of a padded size shares its block
    assert sa.bwd_recompute_smem_bytes(S - 7, Dh - 8) == smem


def test_recompute_wrapper_allocates_the_scratch_only_for_the_pair(monkeypatch):
    """On the card the recompute wrappers hand the C launcher a (B, H, 3, S)
    scratch only where the dQ and dK/dV pair runs, and null elsewhere: their
    launch arguments, recorded on meta tensors with the launch replaced."""
    calls = []
    monkeypatch.setattr(sa, "_require_cuda", lambda x: None)
    monkeypatch.setattr(sa._build, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(sa._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(sa, "_ptr", lambda t: None if t is None else 1)
    monkeypatch.setattr(sa, "_device_mask", lambda mask, B, S, dev: None)
    meta = torch.device("meta")
    for S, H, Dh in ((128, 8, 64), (200, 10, 64), (255, 8, 128)):
        D = H * Dh
        qkv = torch.empty(2, S, 3 * D, dtype=torch.bfloat16, device=meta)
        o = torch.empty(2, S, D, dtype=torch.bfloat16, device=meta)
        calls.clear()
        sa.short_attention_qkv_bwd(o, qkv, o, H)
        (name, args), = calls
        assert name == "short_attention_qkv_bwd"
        pair = sa.bwd_recompute_design(S, Dh) == "pair"
        assert (args[6] is not None) == pair, (S, Dh)  # stats
        q, k, v = qkv.chunk(3, dim=-1)
        calls.clear()
        sa.short_attention_sep_bwd(o, q, k, v, o, H)
        (name, args), = calls
        assert name == "short_attention_sep_bwd"
        assert (args[6] is not None) == pair, (S, Dh)
