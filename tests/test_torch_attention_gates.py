"""The port's attention gates at 64 <= S < 256 (clip_dplm_tpu_torch/ops/
attention.py) against the JAX package's (`multihead_attention`,
`attention_dispatch` in clip_dplm_tpu/ops/attention.py) without their
backend term: where the TPU takes its short-S kernel over separate q, k, v
the port takes its own (`fused_short_attention`, `fused_short_attention_heads`)
on every device, whose CUDA wrappers raise with the kernel's bound for what
they do not take (Dh > 128); every other shape takes the plain formulation,
as on the TPU. A device other than the CPU is shown with meta tensors, which
carry no data; one TransformerBlock whose heads the kernels do not take
(Dh = 60) is held to JAX on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.models.layers import TransformerBlock as JaxBlock
from clip_dplm_tpu_torch.models.layers import TransformerBlock
from clip_dplm_tpu_torch.ops import short_attention as sa
from clip_dplm_tpu_torch.ops.attention import (
    attention_dispatch,
    attention_reference,
    multihead_attention,
)
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_esm import rng_params

S = 128


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("case", ["Dh=60", "mask (B, 1, S, S)", "q shorter than k"])
def test_multihead_attention_runs_where_the_tpu_runs_plain(case):
    """Where the TPU's short-S gate fails the port computes the plain
    formulation on every device instead of raising."""
    q = k = v = _meta(2, S, 480 if case == "Dh=60" else 512)
    mask = None
    if case == "mask (B, 1, S, S)":
        mask = torch.ones(2, 1, S, S, dtype=torch.bool, device="meta")
    if case == "q shorter than k":
        q = _meta(2, 100, 512)
    out = multihead_attention(q, k, v, 8, mask=mask)
    assert out.shape == q.shape and out.device.type == "meta"


def _spy(monkeypatch, name):
    """Replace the entry `name` of ops/short_attention.py with a recorder
    that returns zeros of q's shape; the list of its calls' q shapes."""
    calls = []

    def entry(q, k, v, *args, **kwargs):
        calls.append(tuple(q.shape))
        return torch.zeros_like(q)

    monkeypatch.setattr(sa, name, entry)
    return calls


@pytest.mark.parametrize("mask", [None, "(B, S)"])
def test_multihead_attention_raises_where_the_tpu_takes_its_kernel(monkeypatch, mask):
    """Where the TPU takes its short-S kernel over separate (B, S, D) q, k, v,
    the port calls `fused_short_attention`."""
    calls = _spy(monkeypatch, "fused_short_attention")
    x = _meta(2, S, 512)  # Dh = 64
    m = None if mask is None else torch.ones(2, S, dtype=torch.bool, device="meta")
    assert multihead_attention(x, x, x, 8, mask=m).shape == x.shape
    assert calls == [(2, S, 512)]


@pytest.mark.parametrize("Dh,raises", [(192, True), (64, True), (60, False)])
def test_attention_dispatch_gate(monkeypatch, Dh, raises):
    """The head-level gate: EsmBlock's route for heads the packed kernel does
    not take. Dh = 192: the short-S kernel over the heads, whose wrapper
    raises with its Dh <= 128 bound on a device other than the CPU (the TPU
    runs its kernel there); Dh = 64: `fused_short_attention_heads` is called;
    Dh = 60 takes the plain formulation."""
    qh = torch.empty(2, 4, S, Dh, device="meta", dtype=torch.bfloat16)
    mask = torch.ones(2, S, dtype=torch.bool, device="meta")
    if Dh == 192:
        with pytest.raises(ValueError, match="Dh a multiple of 8 up to 128, got 192"):
            attention_dispatch(qh, qh, qh, mask=mask)
        return
    calls = _spy(monkeypatch, "fused_short_attention_heads")
    assert attention_dispatch(qh, qh, qh, mask=mask).shape == qh.shape
    assert calls == ([(2, 4, S, Dh)] if raises else [])


def test_attention_dispatch_is_plain_on_the_cpu():
    """In the band, CPU tensors take the plain version of the short-S kernel
    over the heads, equal to the plain formulation in f32."""
    g = torch.Generator().manual_seed(0)
    qh, kh, vh = (torch.randn(2, 4, S, 64, generator=g) for _ in range(3))
    mask = torch.arange(S)[None, :] < torch.tensor([[S], [90]])
    got = attention_dispatch(qh, kh, vh, mask=mask)
    torch.testing.assert_close(got, sa.short_attention_sep_reference(qh, kh, vh, 4, mask=mask),
                               atol=0, rtol=0)
    torch.testing.assert_close(got, attention_reference(qh, kh, vh, mask=mask))


def test_block_with_60_wide_heads_matches_flax(rng):
    """d_model 480, 8 heads (Dh = 60) at S = 128: the packed gate fails, the
    block calls multihead_attention, which takes the plain formulation, as
    JAX's block does on the TPU. Values and every gradient, f32, at rtol
    1e-4 and an atol of 1e-5 of each array's largest entry (at d = 480 the
    outputs and gradients reach ~10-1000)."""
    B, d = 2, 480
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([[S], [70]])
    ct = rng.normal(size=(B, S, d)).astype(np.float32)
    jb = JaxBlock(d_model=d, num_heads=8, dropout=0.0, dtype=jnp.float32)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    params = rng_params(params, np.random.default_rng(4))

    def jloss(p, xx):
        return jnp.sum(jb.apply({"params": p}, xx, jnp.asarray(mask)) * ct)

    want = jax.jit(jb.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    pb = TransformerBlock(d, 8, dropout=0.0, dtype=torch.float32)
    pb.load_state_dict(flax_to_state_dict(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pb(xt, torch.from_numpy(mask))
    torch.sum(got * torch.from_numpy(ct)).backward()
    _close(got.detach().numpy(), np.asarray(want), "out")
    _close(xt.grad.numpy(), np.asarray(gx), "dx")
    want_g = flax_to_state_dict(gp)
    for k, p in pb.named_parameters():
        _close(p.grad.numpy(), want_g[k].numpy(), k)


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)
