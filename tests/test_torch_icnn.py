"""The port's ICNN Brenier potentials and transport maps
(clip_dplm_tpu_torch/models/icnn.py) against the JAX package on the same
numpy weights and inputs, in f32 at small widths (d = 6, hidden (16, 8)):
the potential, its gradient and its Hessian (rtol 1e-4 / atol 1e-5) over
the layer-norm / strict-convex / activation variants. The layers' `scale`
leaves keep their init value (softplus^-1(init_scale), plus noise): flax's
LayerNorm takes the variance as E[x^2] - E[x]^2, which in f32 loses digits
where the z contributions' mean dwarfs their spread, as it does at a scale
of 1; there the port's gradient stays within 1e-5 of its own f64 value (a
test below) while JAX's f32 one is off by ~1e-3 relative; the train-time clamp
of the z contribution; convexity along lines and PSD Hessians with
use_layer_norm=false; `TripleTransportMaps` with its consistency loss and
`total_transport_loss` (the maps' outputs at atol 5e-5: the output
LayerNorm divides T by its spread, and at d = 6 both packages' f32 maps sit
up to 1.7e-5 from an f64 run of the same weights); the gradients of one second-order train step (the
loss differentiates through T = grad Psi; atol 1e-5 + 1e-4 of each leaf's
largest entry), and no graph on the eval path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.config import ICNNConfig as JICNNConfig
from clip_dplm_tpu.models import icnn as jicnn
from clip_dplm_tpu_torch.config import ICNNConfig
from clip_dplm_tpu_torch.models import icnn as picnn
from clip_dplm_tpu_torch.models.layers import init_params
from clip_dplm_tpu_torch.utils import pretrained
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_segment_gnn import F32, jax_params, load, t

D = 6
SMALL = dict(hidden_dims=(16, 8))


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return JICNNConfig(**kw), ICNNConfig(**kw)


def icnn_params(module, rng, cfg, *args, **kwargs):
    """jax_params with each ConvexLayer's `scale` at its init value plus
    noise (the rest of the leaves as rng_params draws them)."""
    params = jax_params(module, rng, *args, **kwargs)
    init = (float(np.log(np.expm1(cfg.init_scale))) if cfg.strict_convex else cfg.init_scale)

    def fix(path, x):
        if path[-1].key == "scale" and "layer_" in str(path[-2].key) and np.shape(x) == (1,):
            return np.float32(init + 0.1 * rng.normal(size=(1,))).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(fix, params)


VARIANTS = [dict(), dict(use_layer_norm=False), dict(strict_convex=False),
            dict(activation="celu", use_layer_norm=False)]


@pytest.mark.parametrize("kw", VARIANTS, ids=["default", "no_ln", "not_strict", "celu"])
def test_potential_gradient_hessian_match_jax(kw):
    jcfg, pcfg = _cfgs(**kw)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, D)).astype(np.float32)
    net = jicnn.SingleCellICNN(cfg=jcfg)
    params = icnn_params(net, rng, jcfg, jnp.asarray(x))
    port = load(picnn.SingleCellICNN(pcfg, D), params)
    variables, jx = {"params": params}, jnp.asarray(x)
    np.testing.assert_allclose(port(t(x)).detach().numpy(),
                               np.asarray(jax.jit(net.apply)(variables, jx)), **F32)
    np.testing.assert_allclose(
        picnn.icnn_gradient(port, t(x)).detach().numpy(),
        np.asarray(jax.jit(lambda v, a: jicnn.icnn_gradient(net, v, a))(variables, jx)), **F32)
    np.testing.assert_allclose(
        picnn.icnn_hessian(port, t(x), reg=1e-4).detach().numpy(),
        np.asarray(jax.jit(lambda v, a: jicnn.icnn_hessian(net, v, a, reg=1e-4))(variables, jx)),
        **F32)


def test_train_clamp_matches_jax():
    """A gradient_clip far below the z contributions: the clamp scales every
    layer's contribution in the potential and in the clipped gradient."""
    jcfg, pcfg = _cfgs(gradient_clip=0.05)
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(7, D))).astype(np.float32)
    net = jicnn.SingleCellICNN(cfg=jcfg)
    params = icnn_params(net, rng, jcfg, jnp.asarray(x))
    port = load(picnn.SingleCellICNN(pcfg, D), params)
    v, jx = {"params": params}, jnp.asarray(x)
    apply = jax.jit(net.apply, static_argnames="train")
    want = np.asarray(apply(v, jx, train=True))
    assert not np.allclose(want, np.asarray(apply(v, jx, train=False)))
    np.testing.assert_allclose(port(t(x), train=True).detach().numpy(), want, **F32)
    np.testing.assert_allclose(
        picnn.icnn_gradient(port, t(x), train=True, clip=0.5).detach().numpy(),
        np.asarray(jax.jit(lambda p, a: jicnn.icnn_gradient(net, p, a, train=True, clip=0.5))(
            v, jx)), **F32)


def test_gradient_holds_its_f64_value_at_unit_scales():
    """At rng_params' unit layer scales (z contributions with a large mean)
    the port's f32 gradient against the same module run in f64."""
    _, pcfg = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, D)).astype(np.float32)
    params = jax_params(jicnn.SingleCellICNN(cfg=_cfgs()[0]), rng, jnp.asarray(x))
    port = load(picnn.SingleCellICNN(pcfg, D), params)
    g32 = picnn.icnn_gradient(port, t(x)).detach().numpy()
    g64 = picnn.icnn_gradient(port.double(), t(x).double()).detach().numpy()
    np.testing.assert_allclose(g32, g64, rtol=1e-4, atol=1e-5)


def test_convex_without_layer_norm():
    _, pcfg = _cfgs(use_layer_norm=False)
    port = picnn.SingleCellICNN(pcfg, D)
    init_params(port, torch.Generator().manual_seed(0))
    with torch.no_grad():  # nonzero positive z-path weights
        for name, p in port.named_parameters():
            if "pos_weights" in name:
                p.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(len(name)))
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(64, D, generator=g), torch.randn(64, D, generator=g)
    for lam in (0.25, 0.5, 0.75):
        mid = port(lam * a + (1 - lam) * b)[:, 0]
        chord = lam * port(a)[:, 0] + (1 - lam) * port(b)[:, 0]
        assert bool((mid <= chord + 1e-5).all()), lam
    eig = torch.linalg.eigvalsh(picnn.icnn_hessian(port, a[:8]).detach())
    assert float(eig.min()) > -1e-5


@pytest.fixture(scope="module")
def maps():
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(2)
    cell, pert, prot = (rng.normal(size=(9, D)).astype(np.float32) for _ in range(3))
    net = jicnn.TripleTransportMaps(cfg=jcfg, cell_dim=D, pert_dim=D, protein_dim=D)
    params = icnn_params(net, rng, jcfg, *(jnp.asarray(a) for a in (cell, pert, prot)),
                         train=True)
    port = load(picnn.TripleTransportMaps(pcfg, D, D, D), params)
    return net, params, port, (cell, pert, prot)


def test_transport_maps_and_loss_match_jax(maps):
    net, params, port, arrays = maps
    j = [jnp.asarray(a) for a in arrays]
    apply = jax.jit(net.apply, static_argnames="train")
    for train in (True, False):
        jout = apply({"params": params}, *j, train=train)
        pout = port(*(t(a) for a in arrays), train=train)
        assert set(pout) == set(jout)
        for name in ("cell_to_pert", "cell_to_protein", "pert_to_protein"):
            np.testing.assert_allclose(pout[name]["transported"].detach().numpy(),
                                       np.asarray(jout[name]["transported"]), rtol=1e-4,
                                       atol=5e-5)
            np.testing.assert_allclose(float(pout[name]["cost"]), float(jout[name]["cost"]),
                                       **F32)
        jl, jm = jicnn.total_transport_loss(jout, 0.1)
        pl, pm = picnn.total_transport_loss(pout, 0.1)
        np.testing.assert_allclose(float(pl), float(jl), **F32)
        assert set(pm) == set(jm)
    # a single map without a target, and the eval path builds no graph
    with torch.no_grad():
        out = port.cell_to_pert.transport(t(arrays[0]))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(net.apply(
        {"params": params}, j[0], method=lambda m, x: m.cell_to_pert.transport(x))),
        rtol=1e-4, atol=5e-5)


def test_second_order_train_step_gradients_match_jax(maps):
    net, params, port, arrays = maps
    j = [jnp.asarray(a) for a in arrays]

    def jloss(p):
        return jicnn.total_transport_loss(net.apply({"params": p}, *j, train=True), 0.1)[0]

    want = flax_to_state_dict(jax.jit(jax.grad(jloss))(params))
    port.zero_grad()
    loss, _ = picnn.total_transport_loss(port(*(t(a) for a in arrays), train=True), 0.1)
    loss.backward()
    for k, p in port.named_parameters():
        w = want[k].numpy()
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=k)
    # the potential's own parameters take their gradient through T = grad Psi
    assert port.cell_to_pert.transport_net.layer_0.linear.kernel.grad.abs().sum() > 0
    port.zero_grad()


def test_transport_keeps_its_width():
    with pytest.raises(ValueError, match="keeps its width"):
        picnn.SingleCellTransport(ICNNConfig(**SMALL), 4, 5)
    # JAX's defaults: the port's fields, and in `_UNPORTED` the ones it does not read
    jd, pd = dataclasses.asdict(JICNNConfig()), dataclasses.asdict(ICNNConfig())
    assert pd == {k: v for k, v in jd.items() if k in pd}
    assert {k: v for k, v in jd.items() if k not in pd} == pretrained._UNPORTED["icnn"]
