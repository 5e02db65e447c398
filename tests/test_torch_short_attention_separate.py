"""The port's short-S attention over separate q, k, v
(clip_dplm_tpu_torch/ops/short_attention.py: `fused_short_attention` over
(B, S, D), `fused_short_attention_heads` over (B, H, S, Dh)) against the JAX
package's ops of the same names, whose Pallas kernels (`_fwd_kernel`,
`_bwd_kernel`) run in interpret mode, on the same numpy inputs, in f32. On
CPU tensors the port runs its plain versions (no launch), through its
autograd Function:

- values at atol 1e-5, rtol 1e-4, and the gradients in the recompute mode
  (save_probs=False) at atol 2e-5, rtol 1e-3: both layouts, 2 and 4 heads,
  masked and unmasked, S = 64, 72, 200 and a tiny S = 33 through the op
  itself, B = 3 (not a multiple of the TPU kernel's rows per program); S =
  65 (padding rows and keys in the port's one-block kernel) with keys masked
  inside the rows;
  `multihead_attention` and `attention_dispatch` give the op's values in the
  band;
- the heads entry, recompute mode with an explicit scale, saved mode at the
  default scale;
- the saved mode's gradients against JAX's save_probs=True at atol 5e-5,
  rtol 2e-3 (both round the probabilities to bf16 at the same point), and
  against the exact formulation at the JAX suite's rel-L2 gate of 2e-2;
- `short_attention_reference` against JAX's;
- the mode rule `saves_probs(B, S, H, block_b)` against the one the JAX
  wrappers apply, over a grid that includes 512 MiB and one row past it;
- no probabilities written without a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clip_dplm_tpu.ops import short_attention as jax_sa
from clip_dplm_tpu_torch.ops import _build
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.attention import attention_dispatch, multihead_attention

B, D = 3, 64


def _inputs(rng, S, masked):
    """masked: False, True (ragged) or "holes" (ragged, keys 1 and S // 2
    masked too)."""
    q, k, v, w = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:  # no row without a real key: the TPU kernel pads keys with -1e30 too
        mask = np.arange(S)[None, :] < rng.integers(S // 2, S + 1, B)[:, None]
    if masked == "holes":
        mask[:, [1, S // 2]] = False
    return q, k, v, w, mask


def _heads(x, H):
    return x.reshape(x.shape[0], x.shape[1], H, -1).transpose(0, 2, 1, 3).copy()


def _jax_vjp(fn, args, w, save_probs, **kw):
    """(out, grads) of the JAX op in interpret mode, cotangent w."""
    def f(*a):
        return fn(*a, save_probs=save_probs, interpret=True, **kw)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
        grads = vjp(jnp.asarray(w))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_vjp(fn, args, w, save_probs, **kw):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    before = _build.LAUNCHES.snapshot()
    out = fn(*leaves, save_probs=save_probs, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(w))
    assert _build.LAUNCHES.snapshot() == before  # CPU tensors: the plain versions
    return out.detach().numpy(), [g.numpy() for g in grads]


def _mask_kw(mask, torch_side):
    if mask is None:
        return {}
    return {"mask": torch.from_numpy(mask) if torch_side else jnp.asarray(mask)}


@pytest.mark.parametrize("layout,H,masked,S", [
    ("bhsd", 2, True, 64), ("bsd", 4, True, 72), ("bhsd", 4, False, 200),
    ("bsd", 2, False, 200), ("bhsd", 4, True, 33), ("bsd", 2, "holes", 65),
    ("bhsd", 4, "holes", 65)])
def test_values_and_recompute_grads_match_jax_kernel(rng, layout, H, masked, S):
    q, k, v, w, mask = _inputs(rng, S, masked)
    want, g_want = _jax_vjp(jax_sa.fused_short_attention, (q, k, v), w, False, num_heads=H,
                            block_b=8, layout=layout, **_mask_kw(mask, False))
    got, g_got = _port_vjp(sa.fused_short_attention, (q, k, v), w, False, num_heads=H,
                           layout=layout, **_mask_kw(mask, True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    for name, a, b in zip("qkv", g_got, g_want):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3, err_msg=f"d{name}")
    if S >= 64:  # the band of the gates: the op's own values
        t = [torch.from_numpy(a) for a in (q, k, v)]
        np.testing.assert_array_equal(
            multihead_attention(*t, H, **_mask_kw(mask, True)).numpy(), got)
        heads = attention_dispatch(*(sa.split_heads(a, H) for a in t), **_mask_kw(mask, True))
        np.testing.assert_array_equal(sa.merge_heads(heads).numpy(), got)


@pytest.mark.parametrize("save_probs,scale", [(False, 0.3), (True, None)])
def test_heads_entry_with_scale_matches_jax_kernel(rng, save_probs, scale):
    """(B, H, S, Dh) heads, 4 heads, S = 72, masked; an explicit scale 0.3 in
    the recompute mode. The saved mode runs at the default scale: both sides
    round f32 probabilities that differ in the last bits (other summation
    orders) to bf16, and at 0.3 one of them rounds the other way, which moves
    one dq entry of 13824 by 1.3e-4, past atol 5e-5."""
    H, S = 4, 72
    q, k, v, w, mask = _inputs(rng, S, True)
    args = tuple(_heads(a, H) for a in (q, k, v))
    want, g_want = _jax_vjp(jax_sa.fused_short_attention_heads, args, _heads(w, H), save_probs,
                            scale=scale, **_mask_kw(mask, False))
    got, g_got = _port_vjp(sa.fused_short_attention_heads, args, _heads(w, H), save_probs,
                           scale=scale, **_mask_kw(mask, True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    tol = dict(atol=5e-5, rtol=2e-3) if save_probs else dict(atol=2e-5, rtol=1e-3)
    for name, a, b in zip("qkv", g_got, g_want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("layout,H,masked,S", [
    ("bsd", 2, True, 72), ("bhsd", 4, False, 64), ("bhsd", 2, True, 200)])
def test_saved_mode_matches_jax_kernel_and_exact(rng, layout, H, masked, S):
    q, k, v, w, mask = _inputs(rng, S, masked)
    _, g_want = _jax_vjp(jax_sa.fused_short_attention, (q, k, v), w, True, num_heads=H,
                         block_b=8, layout=layout, **_mask_kw(mask, False))
    _, g_got = _port_vjp(sa.fused_short_attention, (q, k, v), w, True, num_heads=H,
                         layout=layout, **_mask_kw(mask, True))
    _, g_exact = _port_vjp(sa.fused_short_attention, (q, k, v), w, False, num_heads=H,
                           layout=layout, **_mask_kw(mask, True))
    for name, a, b, c in zip("qkv", g_got, g_want, g_exact):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=2e-3, err_msg=f"d{name}")
        rel = np.linalg.norm(a - c) / max(np.linalg.norm(c), 1e-12)
        assert rel < 2e-2, f"d{name} rel L2 {rel:.2e} against the exact formulation"
    assert np.linalg.norm(g_got[0] - g_exact[0]) > 0  # the bf16 rounding is there


def test_reference_matches_jax_reference(rng):
    q, k, v, _, mask = _inputs(rng, 72, True)
    want = jax_sa.short_attention_reference(*(jnp.asarray(a) for a in (q, k, v)), 4,
                                            mask=jnp.asarray(mask), scale=0.2)
    got = sa.short_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), 4,
                                       mask=torch.from_numpy(mask), scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def _jax_rule(Bt, S, H, block_b, heads_entry, monkeypatch):
    """The save_probs the JAX wrapper passes to its core, traced abstractly
    (no kernel runs, nothing is allocated)."""
    seen = []

    def core(q, k, v, bias, heads, scale, G, layout, interpret, save_probs):
        seen.append(save_probs)
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(jax_sa, "_short_attn_core", core)
    Dh = 8
    if heads_entry:
        shape = jax.ShapeDtypeStruct((Bt, H, S, Dh), jnp.bfloat16)
        jax.eval_shape(lambda q: jax_sa.fused_short_attention_heads(q, q, q, block_b=block_b),
                       shape)
    else:
        shape = jax.ShapeDtypeStruct((Bt, S, H * Dh), jnp.bfloat16)
        jax.eval_shape(lambda q: jax_sa.fused_short_attention(q, q, q, H, block_b=block_b),
                       shape)
    (save,) = seen
    return save


@pytest.mark.parametrize("Bt,S,H,block_b,heads_entry", [
    (2048, 128, 8, 8, False), (2049, 128, 8, 8, False), (2049, 128, 8, 1, True),
    (2304, 128, 8, 8, True), (1024, 128, 8, 8, False), (1024, 129, 8, 8, True),
    (256, 128, 10, 8, True), (512, 255, 10, 8, False), (1632, 64, 10, 8, True),
    (1633, 64, 10, 8, True), (1633, 64, 10, 1, False), (4096, 33, 8, 8, False),
    (3, 72, 4, 8, True)])
def test_mode_rule_matches_jax(monkeypatch, Bt, S, H, block_b, heads_entry):
    """B=2048, S=128, H=8 is 512 MiB exactly (saved); one row more pads to
    2056 rows at block_b=8 (recompute) and 2049 at block_b=1 (recompute)."""
    assert sa.saves_probs(Bt, S, H, block_b) is bool(
        _jax_rule(Bt, S, H, block_b, heads_entry, monkeypatch))


def test_probs_written_only_where_a_gradient_follows(rng, monkeypatch):
    """Without a gradient to record the saving forward is never called,
    whatever the mode; with one the rule decides."""
    calls = []
    save = sa.short_attention_sep_save

    def spy(*a, **k):
        calls.append(1)
        return save(*a, **k)

    monkeypatch.setattr(sa, "short_attention_sep_save", spy)
    q, k, v, _, mask = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(rng, 72, True))
    q.requires_grad_(True)
    with torch.no_grad():
        for mode in (None, True):
            assert sa.fused_short_attention(q, k, v, 4, mask=mask, save_probs=mode).grad_fn is None
    with torch.inference_mode():
        sa.fused_short_attention_heads(*(sa.split_heads(t.detach(), 4) for t in (q, k, v)),
                                       mask=mask, save_probs=True)
    sa.fused_short_attention(q.detach(), k, v, 4, mask=mask, save_probs=True)
    assert calls == []  # no input needs a gradient
    o = sa.fused_short_attention(q, k, v, 4, mask=mask)  # the rule: save
    assert calls == [1]
    o.sum().backward()
    assert torch.isfinite(q.grad).all()
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)
    sa.fused_short_attention(q, k, v, 4, mask=mask).sum().backward()
    assert calls == [1]
