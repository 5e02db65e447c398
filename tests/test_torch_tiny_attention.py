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
