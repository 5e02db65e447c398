"""The port's tiny-S packed attention with the out-projection
(clip_dplm_tpu_torch/ops/tiny_attention.py, the plain versions its CUDA
kernels are held to) against the JAX package's `fused_tiny_attention_proj`
run in Pallas interpret mode, as tests/test_short_attention.py runs it, on
the same numpy inputs in f32: the perturbation tower's S=10 with sample
padding (B=19), masked and unmasked; S=33 (the sp=48 geometry); S=8 (the
transformer tower). Values on valid rows at atol 2e-5 / rtol 1e-3 and dqkv,
dWo, dbo at atol 5e-5 / rtol 2e-3 (the JAX suite's own bounds); and the
plain backward against autograd of the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops.short_attention import fused_tiny_attention_proj as jax_tiny
from clip_dplm_tpu_torch.ops.tiny_attention import (
    fused_tiny_attention_proj,
    tiny_attention_bwd_reference,
    tiny_attention_reference,
)


def _inputs(rng, B, S, D, masked):
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    wo = (rng.normal(size=(D, D)) / 8.0).astype(np.float32)  # flax (in, out)
    bo = rng.normal(size=(D,)).astype(np.float32)
    mask = None
    if masked:  # every row keeps at least 3 keys: a fully masked row pads
        lens = rng.integers(3, S + 1, B)  # differently in the two packings
        mask = np.arange(S)[None, :] < lens[:, None]
    return qkv, wo, bo, mask


@pytest.mark.parametrize("B,S,D,heads,masked", [
    (19, 10, 64, 4, True), (19, 10, 64, 4, False), (16, 33, 64, 4, True), (12, 8, 64, 8, False)])
def test_tiny_attention_matches_jax_interpret(rng, B, S, D, heads, masked):
    qkv, wo, bo, mask = _inputs(rng, B, S, D, masked)
    w = rng.normal(size=(B, S, D)).astype(np.float32)
    valid = np.ones((B, S, 1), np.float32) if mask is None else mask[:, :, None].astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jfused(q, o, b):
        return jax_tiny(q, o, b, heads, mask=jmask, interpret=True)

    args = (jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo))
    with pltpu.force_tpu_interpret_mode():
        want = jfused(*args)
        jgrads = jax.grad(lambda *a: jnp.sum(jfused(*a) * w * valid), argnums=(0, 1, 2))(*args)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_tiny_attention_proj(*leaves, heads, mask=tmask)
    torch.sum(got * torch.from_numpy(w * valid)).backward()
    np.testing.assert_allclose(got.detach().numpy() * valid, np.asarray(want) * valid,
                               atol=2e-5, rtol=1e-3)
    gq, gwo, gbo = (t.grad.numpy() for t in leaves)
    for g, jg, name in ((gq, jgrads[0], "dqkv"), (gwo.T, jgrads[1], "dwo"),
                        (gbo, jgrads[2], "dbo")):
        np.testing.assert_allclose(g, np.asarray(jg), atol=5e-5, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_backward_matches_autograd_of_plain_forward(rng, dtype):
    """In f32 the plain backward is the exact gradient of the plain forward;
    in bf16 its rounding points (ds rounded, dv from the f32 probabilities)
    keep it within bf16 noise of it."""
    B, S, D, heads = 5, 10, 64, 8
    qkv, _, _, mask = _inputs(rng, B, S, D, True)
    leaf = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    tmask = torch.from_numpy(mask)
    o = tiny_attention_reference(leaf, heads, mask=tmask)
    do = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)).to(dtype)
    o.backward(do)
    got = tiny_attention_bwd_reference(do, leaf.detach(), o.detach(), heads, mask=tmask)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(got.float(), leaf.grad.float(), **tol)


def _split3(x: torch.Tensor):
    """The backward kernel's exact split of an f32 probability into three
    bf16 parts: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)."""
    parts = []
    for _ in range(3):
        part = x.to(torch.bfloat16).float()
        parts.append(part)
        x = x - part
    return parts


def test_split_of_the_probabilities_is_exact():
    """hi + mid + lo == p exactly (the remainder after the third part is 0)
    for f32 probabilities from 1e-30 to 1: a log sweep, random draws, and
    values one ulp either side of bf16 rounding ties."""
    rng = np.random.default_rng(5)
    sweep = np.concatenate([
        np.logspace(-30, 0, 200001), rng.uniform(0, 1, 200000),
        np.exp(-rng.uniform(0, 69, 200000))]).astype(np.float32)
    ties = (sweep.view(np.uint32) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    x = np.concatenate([sweep, ties.view(np.float32),
                        np.nextafter(ties.view(np.float32), np.float32(0)),
                        np.nextafter(ties.view(np.float32), np.float32(2))])
    x = torch.from_numpy(x[(x >= 1e-30) & (x <= 1)])
    hi, mid, lo = _split3(x)
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(x - hi - mid - lo, torch.zeros_like(x))


def _split_bwd(dout, qkv, o, num_heads, mask=None, scale=None):
    """The plain backward with dV formed as the kernel forms it: the three
    bf16 parts of prob^T, each times dO, summed in f32."""
    import clip_dplm_tpu_torch.ops.tiny_attention as ta
    from clip_dplm_tpu_torch.ops.attention import merge_heads, split_heads

    dqkv = tiny_attention_bwd_reference(dout, qkv, o, num_heads, mask=mask, scale=scale)
    _, _, _, p, l = ta._heads_and_probs(qkv, num_heads, mask, scale)
    do = split_heads(dout.to(qkv.dtype), num_heads).float()
    dv = sum(torch.einsum("bhqk,bhqd->bhkd", part, do) for part in _split3(p / l))
    D = qkv.shape[-1] // 3
    return torch.cat([dqkv[..., :2 * D], merge_heads(dv).to(qkv.dtype)], dim=-1)


@pytest.mark.parametrize("B,S,D,heads,masked", [
    (19, 10, 64, 4, True), (19, 10, 64, 4, False), (16, 33, 64, 4, True), (12, 8, 64, 8, False)])
def test_split_dv_matches_jax_interpret(rng, monkeypatch, B, S, D, heads, masked):
    """The whole fused projection's gradients with the backward's dV formed
    from the three-part split, against JAX's `fused_tiny_attention_proj` in
    interpret mode, at the JAX suite's bounds."""
    import clip_dplm_tpu_torch.ops.tiny_attention as ta

    monkeypatch.setattr(ta, "tiny_attention_bwd", _split_bwd)
    qkv, wo, bo, mask = _inputs(rng, B, S, D, masked)
    w = rng.normal(size=(B, S, D)).astype(np.float32)
    valid = np.ones((B, S, 1), np.float32) if mask is None else mask[:, :, None].astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jfused(q, o, b):
        return jax_tiny(q, o, b, heads, mask=jmask, interpret=True)

    args = (jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo))
    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(lambda *a: jnp.sum(jfused(*a) * w * valid), argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_tiny_attention_proj(*leaves, heads, mask=tmask)
    torch.sum(got * torch.from_numpy(w * valid)).backward()
    gq, gwo, gbo = (t.grad.numpy() for t in leaves)
    for g, jg, name in ((gq, jgrads[0], "dqkv"), (gwo.T, jgrads[1], "dwo"),
                        (gbo, jgrads[2], "dbo")):
        np.testing.assert_allclose(g, np.asarray(jg), atol=5e-5, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_tiny_attention_f32_at_the_probe_shape_matches_jax_interpret(rng, masked):
    """The transformer probe's attention (B=64, S=8, D=128, 4 heads, f32;
    models/classifiers.py): the plain f32 versions the card's f32 kernels
    are held to, against JAX's kernel in interpret mode, forward and
    dqkv, dWo, dbo at rtol 1e-5 (and atol 1e-5 of the output's largest
    entry, for entries near 0: dWo sums 512 rows and is 2e-5 off on entries
    of 15)."""
    B, S, D, heads = 64, 8, 128, 4
    qkv, wo, bo, mask = _inputs(rng, B, S, D, masked)
    w = rng.normal(size=(B, S, D)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def jfused(q, o, b):
        return jax_tiny(q, o, b, heads, mask=jmask, interpret=True)

    args = (jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo))
    with pltpu.force_tpu_interpret_mode():
        want = jfused(*args)
        jgrads = jax.grad(lambda *a: jnp.sum(jfused(*a) * w), argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    got = fused_tiny_attention_proj(*leaves, heads,
                                    mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    torch.sum(got * torch.from_numpy(w)).backward()
    gq, gwo, gbo = (t.grad.numpy() for t in leaves)
    for g, jg, name in ((got.detach().numpy(), want, "y"), (gq, jgrads[0], "dqkv"),
                        (gwo.T, jgrads[1], "dwo"), (gbo, jgrads[2], "dbo")):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max(), err_msg=name)
