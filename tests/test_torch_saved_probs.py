"""The saved-probabilities mode of the port's packed-qkv short-S attention
(clip_dplm_tpu_torch/ops/short_attention.py): the forward keeps the bf16
probabilities and the backward reads them (`short_attention_qkv_save`,
`short_attention_qkv_bwd_probs`), as the JAX kernel does with
save_probs=True. On CPU tensors (the plain versions, through the autograd
Function):

- value, dqkv, dWo and dbo against the JAX kernel run in Pallas interpret
  mode with save_probs=True, with and without RoPE, at S=64, 65 and a ragged
  S=200: the loss at rtol 1e-5, the gradients at atol 5e-5, rtol 2e-3 (f32;
  the JAX suite's tolerances: both round the probabilities to bf16 at the
  same point);
- the same gradients against the exact formulation at the JAX suite's
  rel-L2 gate of 2e-2 (the bf16 probabilities' rounding);
- the mode rule `saves_probs` against the one the JAX wrapper applies, over
  a grid of (B, S, H) that includes 512 MiB and one row past it;
- both plain backwards at the shapes the kernels' bound was lifted to (S =
  209, 240, 255 at Dh=64; S=255 at Dh=128) against autograd of the plain
  forward (recompute: atol 1e-5, rtol 1e-4; saved: rel L2 2e-2);
- no probabilities written without a gradient, and the rule followed with
  one.
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


def _inputs(rng, B, S, D):
    qkv = rng.normal(size=(B, S, 3 * D)).astype(np.float32)
    wo = (rng.normal(size=(D, D)) * 0.1).astype(np.float32)  # flax (in, out)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    return qkv, wo, bo, mask


def _port_grads(qkv, wo, bo, mask, H, pos, w, save_probs):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qkv, wo.T.copy(), bo)]
    y = sa.fused_short_attention_qkv_proj(
        leaves[0], leaves[1], leaves[2], H, mask=torch.from_numpy(mask),
        rope_positions=None if pos is None else torch.from_numpy(pos), save_probs=save_probs)
    loss = torch.sum(torch.sin(y * torch.from_numpy(w)))
    loss.backward()
    return float(loss.detach()), [leaves[0].grad.numpy(), leaves[1].grad.numpy().T,
                                  leaves[2].grad.numpy()]


@pytest.mark.parametrize("S,rope,Dh,dead_row,jax_residual", [
    pytest.param(64, False, 32, False, False, id="64-False"),
    pytest.param(64, True, 32, False, False, id="64-True"),
    pytest.param(65, False, 32, False, False, id="65-False"),
    pytest.param(65, True, 32, False, False, id="65-True"),
    pytest.param(200, False, 32, False, False, id="200-False"),
    pytest.param(200, True, 32, False, False, id="200-True"),
    pytest.param(128, True, 32, True, True, id="128-True-dead_row"),
    pytest.param(129, False, 32, False, True, id="129-False"),
    pytest.param(256, True, 32, True, True, id="256-True-dead_row"),
    pytest.param(128, True, 24, False, True, id="128-True-Dh24"),
    pytest.param(129, False, 128, False, True, id="129-False-Dh128"),
    pytest.param(256, False, 128, False, True, id="256-False-Dh128"),
])
def test_saved_mode_matches_jax_kernel(rng, monkeypatch, S, rope, Dh, dead_row, jax_residual):
    """B=2, 2 heads, ragged masks; the JAX kernel pads S=65 to 128 and
    S=129, 200 to 256 rows. The loss sin(y)·valid is the JAX suite's. The
    shapes the CUDA forward treats differently as in
    test_torch_short_attention.py::test_plain_matches_jax_kernel; a batch
    row with no real key (dead_row, where JAX's padded key count is S) takes
    uniform weights and all of its rows count in the loss.

    With jax_residual (the cases added with those shapes) the port's saved
    probabilities are first held to the ones JAX's forward saves
    (`_fwd_call_qkv`, interpret mode) within one bf16 step, and the port's
    backward then reads JAX's: the two compute the f32 scores in different
    summation orders, so a few probabilities on a bf16 rounding boundary
    round apart (6 of the 262,144 at S=256, Dh=32), and each such step moves
    a dqkv entry by up to ~1e-4, past the gradient tolerance, which holds
    the two backwards on the same residual."""
    B, H = 2, 2
    D = H * Dh
    qkv, wo, bo, mask = _inputs(rng, B, S, D)
    pos = np.arange(S) if rope else None
    w = mask[:, :, None].astype(np.float32)
    if dead_row:
        mask[1] = False
        w[1] = 1.0

    def jloss(qkv, wo, bo):
        y = jax_sa.fused_short_attention_qkv_proj(
            qkv, wo, bo, H, mask=jnp.asarray(mask), block_b=2, save_probs=True,
            rope_positions=None if pos is None else jnp.asarray(pos), interpret=True)
        return jnp.sum(jnp.sin(y * w))

    with pltpu.force_tpu_interpret_mode():
        l_j, g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo))
    if jax_residual:
        probs_j = torch.from_numpy(_jax_saved_probs(qkv, mask, H, pos))
        kw = dict(mask=torch.from_numpy(mask),
                  rope_positions=None if pos is None else torch.from_numpy(pos))
        _, probs_port = sa.short_attention_qkv_reference(torch.from_numpy(qkv), H,
                                                         return_probs=True, **kw)
        a, b = probs_port.float().numpy(), probs_j.float().numpy()
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)  # one bf16 step
        assert (a != b).mean() < 1e-4
        save = sa.short_attention_qkv_save
        monkeypatch.setattr(sa, "short_attention_qkv_save",
                            lambda *args, **kwargs: (save(*args, **kwargs)[0], probs_j))
    before = _build.LAUNCHES.snapshot()
    loss, got = _port_grads(qkv, wo, bo, mask, H, pos, w, save_probs=True)
    assert _build.LAUNCHES.snapshot() == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(loss, float(l_j), rtol=1e-5)
    for name, a, b in zip(["dqkv", "dwo", "dbo"], got, g_j):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=2e-3, err_msg=name)


def _jax_saved_probs(qkv, mask, H, pos):
    """The bf16 probabilities JAX's saving forward keeps (B, H, S, S), as
    `fused_short_attention_qkv_proj` calls it with block_b=2: qkv and the
    mask padded to the kernel's rows, the -1e30 key bias, the RoPE tables of
    the padded length."""
    B, S, D3 = qkv.shape
    Dh = D3 // 3 // H
    Sp = jax_sa._seq_pad(S)
    G = jax_sa._rows_per_program(2, B, Sp)
    Bp = -(-B // G) * G
    qkvp = np.zeros((Bp, Sp, D3), np.float32)
    qkvp[:B, :S] = qkv
    maskp = np.zeros((Bp, Sp), bool)
    maskp[:B, :S] = mask
    bias = jnp.where(jnp.asarray(maskp), 0.0, jax_sa.NEG_INF).astype(jnp.float32)[:, None, :]
    rope_cs = None if pos is None else jax_sa._rope_cos_sin(jnp.asarray(pos), Dh, Sp)
    with pltpu.force_tpu_interpret_mode():
        _, probs, _ = jax_sa._fwd_call_qkv(jnp.asarray(qkvp), bias, None, None, heads=H,
                                           scale=1.0 / Dh ** 0.5, G=G, interpret=True,
                                           save_probs=True, rope_cs=rope_cs)
    return np.array(probs[:B, :, :S, :S].astype(jnp.float32))  # a writable copy


@pytest.mark.parametrize("rope", [False, True])
def test_saved_mode_within_jax_gate_of_exact(rng, rope):
    """The saved mode's gradients against the recompute mode's (the exact
    softmax in f32) at the JAX suite's rel-L2 gate of 2e-2."""
    B, S, D, H = 2, 128, 64, 4
    qkv, wo, bo, mask = _inputs(rng, B, S, D)
    pos = np.arange(S) if rope else None
    w = mask[:, :, None].astype(np.float32)
    _, exact = _port_grads(qkv, wo, bo, mask, H, pos, w, save_probs=False)
    _, saved = _port_grads(qkv, wo, bo, mask, H, pos, w, save_probs=True)
    for name, a, b in zip(["dqkv", "dwo", "dbo"], saved, exact):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert rel < 2e-2, f"{name} rel L2 {rel:.2e}"
    assert np.linalg.norm(saved[0] - exact[0]) > 0  # the rounding is there


def _jax_rule(B, S, H, monkeypatch):
    """The save_probs the JAX wrapper passes to its core at (B, S, H),
    traced abstractly (no kernel runs, nothing is allocated)."""
    seen = []

    def core(qkv, bias, wo, bo, cos, sin, heads, scale, G, interpret, save_probs):
        seen.append(save_probs)
        return jnp.zeros(qkv.shape[:2] + (qkv.shape[2] // 3,), qkv.dtype)

    monkeypatch.setattr(jax_sa, "_short_attn_core_qkv_proj", core)
    D = 8 * H
    jax.eval_shape(
        lambda q, w, b: jax_sa.fused_short_attention_qkv_proj(q, w, b, H),
        jax.ShapeDtypeStruct((B, S, 3 * D), jnp.bfloat16),
        jax.ShapeDtypeStruct((D, D), jnp.float32), jax.ShapeDtypeStruct((D,), jnp.float32))
    (save,) = seen
    return save


@pytest.mark.parametrize("B,S,H", [
    (2048, 128, 8), (2049, 128, 8), (2041, 128, 8), (2304, 128, 8), (1024, 128, 8),
    (1024, 129, 8), (256, 129, 8), (256, 128, 10), (512, 255, 10), (256, 64, 10),
    (1632, 64, 10), (1633, 64, 10), (1, 200, 20), (8192, 32, 8), (30000, 16, 8),
    (4096, 10, 8), (1000, 65, 8)])
def test_mode_rule_matches_jax(monkeypatch, B, S, H):
    """B=2048, S=128, H=8 is 512 MiB exactly (saved); one row more pads to
    2056 rows (recompute)."""
    assert sa.saves_probs(B, S, H) is bool(_jax_rule(B, S, H, monkeypatch))


@pytest.mark.parametrize("S,Dh", [(209, 64), (240, 64), (255, 64), (255, 128)])
@pytest.mark.parametrize("saved", [False, True])
def test_lifted_shapes_plain_backwards(rng, S, Dh, saved):
    """The shapes past the old single-block bound (S <= 208 at Dh=64), both
    modes: the plain backward on the plain forward's residuals against
    autograd of the plain forward, with a fully masked row."""
    B, H = 2, 2
    D = H * Dh
    qkv_np, _, _, mask_np = _inputs(rng, B, S, D)
    mask_np[-1] = False
    qkv = torch.from_numpy(qkv_np).requires_grad_(True)
    mask, pos = torch.from_numpy(mask_np), torch.arange(S)
    o, probs = sa.short_attention_qkv_reference(qkv, H, mask=mask, rope_positions=pos,
                                                return_probs=True)
    assert probs.dtype == torch.bfloat16 and probs.shape == (B, H, S, S)
    dout = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    (want,) = torch.autograd.grad(o, qkv, dout)
    if saved:
        got = sa.short_attention_qkv_bwd_probs_reference(dout, qkv.detach(), probs, H,
                                                         rope_positions=pos)
        rel = ((got - want).norm() / want.norm()).item()
        assert rel < 2e-2, rel
    else:
        got = sa.short_attention_qkv_bwd_reference(dout, qkv.detach(), o.detach(), H,
                                                   mask=mask, rope_positions=pos)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_probs_written_only_where_a_gradient_follows(rng, monkeypatch):
    """Under no_grad (the sampler, the eval step) the saving forward is never
    called, whatever the mode; with a gradient the rule decides."""
    calls = []
    save = sa.short_attention_qkv_save

    def spy(*a, **k):
        calls.append(1)
        return save(*a, **k)

    monkeypatch.setattr(sa, "short_attention_qkv_save", spy)
    qkv, wo, bo, mask = (torch.from_numpy(a) for a in _inputs(rng, 2, 70, 32))
    wo = wo.t().contiguous()
    with torch.no_grad():
        for mode in (None, True):
            y = sa.fused_short_attention_qkv_proj(qkv.requires_grad_(True), wo, bo, 4,
                                                  mask=mask, save_probs=mode)
            assert y.grad_fn is None
    with torch.inference_mode():
        sa.fused_short_attention_qkv_proj(qkv.detach(), wo, bo, 4, mask=mask, save_probs=True)
    assert calls == []
    y = sa.fused_short_attention_qkv_proj(qkv.detach(), wo, bo, 4, mask=mask, save_probs=True)
    assert calls == []  # no input needs a gradient
    y = sa.fused_short_attention_qkv_proj(qkv, wo, bo, 4, mask=mask)  # the rule: save
    assert calls == [1]
    y.sum().backward()
    assert torch.isfinite(qkv.grad).all()
    monkeypatch.setattr(sa, "saves_probs", lambda *a: False)
    sa.fused_short_attention_qkv_proj(qkv, wo, bo, 4, mask=mask).sum().backward()
    assert calls == [1]
