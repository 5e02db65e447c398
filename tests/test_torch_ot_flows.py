"""The port's OT, flows, encoders and integrator (clip_dplm_tpu_torch:
ops/sinkhorn.py, models/flows.py, models/tong_encoders.py,
ops/integrate.py) against the JAX package on the same numpy inputs and
weights, in f32 at small widths: Sinkhorn's plan, f and g at epsilon 0.02
and 0.2 (the potentials within 1e-5 x max C), the Hungarian permutation
and `ot_pairing`; the conditional flow of exact_ot, sb and independent from
JAX's own draw (its pairing, t and eps fed to
`sample_location_and_conditional_flow_from_draw`); the three encoders and
`create_projection_stack`; `VectorFieldNet`, its velocity and the Jacobian
regularizer (rtol 1e-4 / atol 1e-5); Euler, Heun and RK4 with their
trajectories."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.models import flows as jflows
from clip_dplm_tpu.models import tong_encoders as jenc
from clip_dplm_tpu.ops import integrate as jint
from clip_dplm_tpu.ops import sinkhorn as jsk
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.models import flows as pflows
from clip_dplm_tpu_torch.models import tong_encoders as penc
from clip_dplm_tpu_torch.ops import integrate as pint
from clip_dplm_tpu_torch.ops import sinkhorn as psk
from test_torch_segment_gnn import F32, graph, jax_params, load, t

ENC = ["encoders.latent_dim=32", "encoders.gene_dim=24", "encoders.esm_dim=20",
       "encoders.time_embed_dim=8", "encoders.protein_hidden_dims=[24,16]",
       "encoders.gnn.num_layers=2", "encoders.gnn.num_heads=4", "encoders.dropout=0.0",
       "encoders.gnn.dropout=0.0", "flow.latent_dim=32", "flow.hidden_dim=48",
       "flow.time_embed_dim=8", "flow.dropout=0.0"]


def cfgs(extra=()):
    return (jconfig.apply_overrides(jconfig.Config(), ENC + list(extra)),
            pconfig.apply_overrides(pconfig.Config(), ENC + list(extra)))


def points(seed, n=24, d=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(n, d)) + 0.5).astype(np.float32))


@pytest.mark.parametrize("eps", [0.02, 0.2])
def test_sinkhorn_matches_jax(eps):
    x0, x1 = points(0)
    cost = np.asarray(jsk.pairwise_sqdist(jnp.asarray(x0), jnp.asarray(x1)))
    cost = cost / cost.max()
    jp, jf, jg = (np.asarray(a) for a in jsk.sinkhorn(jnp.asarray(cost), epsilon=eps))
    pp, pf, pg = psk.sinkhorn(t(cost), epsilon=eps)
    np.testing.assert_allclose(psk.pairwise_sqdist(t(x0), t(x1)).numpy(),
                               np.asarray(jsk.pairwise_sqdist(jnp.asarray(x0), jnp.asarray(x1))),
                               **F32)
    atol = 1e-5 * cost.max()
    np.testing.assert_allclose(pf.numpy(), jf, rtol=0, atol=atol)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=0, atol=atol)
    np.testing.assert_allclose(pp.numpy(), jp, rtol=1e-3, atol=1e-3 * jp.max())
    np.testing.assert_allclose(pp.sum(1).numpy(), np.full(len(x0), 1 / len(x0)), rtol=1e-3)


def test_hungarian_and_ot_pairing_match_jax():
    x0, x1 = points(1, n=32)
    j0, j1 = jnp.asarray(x0), jnp.asarray(x1)
    want = np.asarray(jsk.ot_pairing(jax.random.PRNGKey(0), j0, j1, method="exact"))
    assert sorted(want) == list(range(32))
    np.testing.assert_array_equal(psk.ot_pairing(t(x0), t(x1), "exact").numpy(), want)
    np.testing.assert_array_equal(
        psk.hungarian_pairing(psk.pairwise_sqdist(t(x0), t(x1))).numpy(),
        np.asarray(jsk.hungarian_pairing(jsk.pairwise_sqdist(j0, j1))))
    np.testing.assert_array_equal(psk.ot_pairing(t(x0), t(x1), "independent").numpy(),
                                  np.asarray(jsk.ot_pairing(None, j0, j1, "independent")))
    # targets that are a permutation of the sources, slightly moved: the
    # entropic plan is that permutation, and every sampled index is the
    # exact one, on both sides
    perm = np.random.default_rng(2).permutation(32)
    x1 = (x0[perm] + 0.01 * np.random.default_rng(3).normal(size=x0.shape)).astype(np.float32)
    exact = np.argsort(perm)
    got = psk.ot_pairing(t(x0), t(x1), "sinkhorn", epsilon=0.05, seed=7)
    jgot = jsk.ot_pairing(jax.random.PRNGKey(7), j0, jnp.asarray(x1), "sinkhorn", epsilon=0.05)
    np.testing.assert_array_equal(psk.ot_pairing(t(x0), t(x1), "exact").numpy(), exact)
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(np.asarray(jgot), exact)
    with pytest.raises(ValueError, match="square"):
        psk.hungarian_pairing(torch.zeros(3, 4))


@pytest.mark.parametrize("flow_type", ["exact_ot", "sb", "independent"])
def test_conditional_flow_from_jax_draw(flow_type):
    x0, x1 = points(2, n=16, d=8)
    j0, j1 = jnp.asarray(x0), jnp.asarray(x1)
    key, sigma = jax.random.PRNGKey(3), 0.3
    jt, jxt, jut = jflows.sample_location_and_conditional_flow(
        key, j0, j1, flow_type=flow_type, sigma=sigma, sinkhorn_iters=50)
    k_pair, k_t, k_eps = jax.random.split(key, 3)
    t_draw = jax.random.uniform(k_t, (16,), jnp.float32)
    eps = jax.random.normal(k_eps, x0.shape, jnp.float32)
    if flow_type == "exact_ot":
        idx = jsk.ot_pairing(k_pair, j0, j1, method="exact")
    elif flow_type == "sb":
        idx = jsk.ot_pairing(k_pair, j0, j1, method="sinkhorn", epsilon=2 * sigma * sigma,
                             num_iters=50)
    else:
        idx = jnp.arange(16)
    pt, pxt, put = pflows.sample_location_and_conditional_flow_from_draw(
        t(x0), t(x1), t(np.asarray(idx)).long(), t(np.asarray(t_draw)), t(np.asarray(eps)),
        flow_type, sigma)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pxt.numpy(), np.asarray(jxt), **F32)
    np.testing.assert_allclose(put.numpy(), np.asarray(jut), **F32)


def test_flow_draw_is_uniform_and_normal():
    seeds = pflows.DropoutSeeds(5, 0)
    _, tt, eps = pflows.flow_draw(seeds, 4096, 8)
    assert seeds.count == 4 and tt.dtype == eps.dtype == torch.float32
    assert 0.0 <= float(tt.min()) and float(tt.max()) < 1.0 and abs(float(tt.mean()) - 0.5) < 0.02
    assert abs(float(eps.mean())) < 0.02 and abs(float(eps.std()) - 1.0) < 0.02


def _enc_batch(rng, jcfg):
    e = jcfg.encoders
    h, ei, em, bi = graph(rng, n_nodes=16, n_edges=40, pad_edges=8, num_graphs=2,
                          d=e.gene_dim)
    return {"gene_expr": h, "dpt": rng.random(16).astype(np.float32), "edge_index": ei,
            "edge_mask": em, "batch_idx": bi,
            "pert_esm": rng.normal(size=(16, e.esm_dim)).astype(np.float32),
            "pert_values": rng.uniform(-1, 1, (16, e.n_perturb_genes)).astype(np.float32),
            "protein_emb_raw": rng.normal(size=(16, e.esm_dim)).astype(np.float32)}


@pytest.mark.parametrize("which,extra", [
    ("cell", []), ("cell", ["encoders.use_time_encoding=false"]), ("pert", []),
    ("pert", ["encoders.use_cross_attention=false"]), ("protein", []),
    ("protein", ["encoders.esm_dim=32"])])
def test_encoders_match_jax(which, extra):
    jcfg, pcfg = cfgs(extra)
    rng = np.random.default_rng(4)
    b = _enc_batch(rng, jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if which == "cell":
        jm, pm = jenc.CellStateEncoder(cfg=jcfg.encoders), penc.CellStateEncoder(pcfg.encoders)
        args = (jb["gene_expr"], jb["dpt"], jb["edge_index"], jb["batch_idx"], jb["edge_mask"])
        pargs = (t(b["gene_expr"]), t(b["dpt"]), t(b["edge_index"]), t(b["batch_idx"]),
                 t(b["edge_mask"]))
        kw = {"num_graphs": 2}
    elif which == "pert":
        jm, pm = (jenc.PerturbationEncoder(cfg=jcfg.encoders),
                  penc.PerturbationEncoder(pcfg.encoders))
        args, pargs, kw = ((jb["pert_esm"], jb["pert_values"]),
                           (t(b["pert_esm"]), t(b["pert_values"])), {})
    else:
        jm, pm = jenc.ProteinEncoder(cfg=jcfg.encoders), penc.ProteinEncoder(pcfg.encoders)
        args, pargs, kw = (jb["protein_emb_raw"],), (t(b["protein_emb_raw"]),), {}
    params = jax_params(jm, rng, *args, **kw)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, *args, **kw))(params))
    got = load(pm, params)(*pargs, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


def test_projection_stack_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 12)).astype(np.float32)
    jm = jenc.create_projection_stack(16, dropout=0.0)
    params = jax_params(jm, rng, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = load(penc.create_projection_stack(12, 16, dropout=0.0), params)(t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


@pytest.fixture(scope="module")
def vector_field():
    jcfg, pcfg = cfgs()
    rng = np.random.default_rng(6)
    xt, ut = (rng.normal(size=(8, 32)).astype(np.float32) for _ in range(2))
    tt = rng.random(8).astype(np.float32)
    net = jflows.VectorFieldNet(cfg=jcfg.flow)
    params = jax_params(net, rng, jnp.asarray(xt), jnp.asarray(ut), jnp.asarray(tt))
    port = load(pflows.VectorFieldNet(pcfg.flow), params)
    return net, params, port, (xt, ut, tt)


def test_vector_field_matches_jax(vector_field):
    net, params, port, (xt, ut, tt) = vector_field
    j = [jnp.asarray(a) for a in (xt, ut, tt)]
    np.testing.assert_allclose(port(t(xt), t(ut), t(tt)).detach().numpy(),
                               np.asarray(net.apply({"params": params}, *j)), **F32)
    np.testing.assert_allclose(
        port.velocity(t(xt), t(tt)).detach().numpy(),
        np.asarray(net.apply({"params": params}, j[0], j[2], method=net.velocity)), **F32)


def test_jacobian_regularizer_matches_jax(vector_field):
    net, params, port, (xt, _, _) = vector_field
    want = jflows.jacobian_regularization(
        lambda x: net.apply({"params": params}, x, jnp.zeros_like(x), jnp.zeros(x.shape[0])),
        jnp.asarray(xt))
    got = pflows.jacobian_regularization(
        lambda x: port(x, torch.zeros_like(x), x.new_zeros(x.shape[0])), t(xt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    # differentiable in the net's parameters
    got.backward()
    assert all(p.grad is not None for p in port.parameters())
    port.zero_grad()


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
def test_integrate_matches_jax(method):
    rng = np.random.default_rng(7)
    W = (0.5 * rng.normal(size=(6, 6))).astype(np.float32)
    x0 = rng.normal(size=(5, 6)).astype(np.float32)
    jx, jtraj = jint.integrate(lambda x, s: jnp.tanh(x @ W) * (1.0 + s[:, None]),
                               jnp.asarray(x0), num_steps=7, method=method)
    Wt = t(W)
    px, ptraj = pint.integrate(lambda x, s: torch.tanh(x @ Wt) * (1.0 + s[:, None]), t(x0),
                               num_steps=7, method=method)
    assert ptraj.shape == (8, 5, 6) and not px.requires_grad
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ptraj.numpy(), np.asarray(jtraj), rtol=1e-5, atol=1e-6)
    _, empty = pint.integrate(lambda x, s: x, t(x0), num_steps=2, method=method,
                              return_trajectory=False)
    assert empty.numel() == 0
    # with grad=True the integration is differentiable in its start
    x = t(x0).requires_grad_()
    xf, _ = pint.integrate(lambda x, s: torch.tanh(x @ Wt), x, num_steps=3, method=method,
                           grad=True)
    xf.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
