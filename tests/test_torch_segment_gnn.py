"""The port's segment ops and PiGNN (clip_dplm_tpu_torch/ops/segment.py,
models/gnn.py) against the JAX package on the same numpy inputs and
weights, in f32 at small widths: the segment sum, mean, max and softmax
against `jax.ops` with masks and empty segments; `PiGNNLayer` and
`MultiLayerPiGNN` forwards (rtol 1e-4 / atol 1e-5) with padded edges, and
their invariance to more padded edges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.config import GNNConfig as JGNNConfig
from clip_dplm_tpu.models import gnn as jgnn
from clip_dplm_tpu.ops import segment as jseg
from clip_dplm_tpu_torch.config import GNNConfig
from clip_dplm_tpu_torch.models.gnn import MultiLayerPiGNN, PiGNNLayer
from clip_dplm_tpu_torch.ops import segment as pseg
from clip_dplm_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_esm import rng_params

F32 = dict(rtol=1e-4, atol=1e-5)


def jax_params(module, rng, *args, **kwargs):
    """A flax module's params, every leaf replaced by numpy draws."""
    params = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)
    return rng_params(params["params"], rng)


def load(port, params):
    port.load_state_dict(flax_to_state_dict(params), strict=True)
    return port


def t(x):
    return torch.from_numpy(np.array(x))


def graph(rng, n_nodes=12, n_edges=24, pad_edges=8, num_graphs=2, d=32):
    """Nodes, a padded edge list (padded edges point at node 0, masked),
    the edge mask and sorted graph ids; graph 2 of 3 may be empty."""
    h = rng.normal(size=(n_nodes, d)).astype(np.float32)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    edge_index = np.stack([np.concatenate([src, np.zeros(pad_edges, np.int64)]),
                           np.concatenate([dst, np.zeros(pad_edges, np.int64)])]).astype(np.int32)
    edge_mask = np.concatenate([np.ones(n_edges, bool), np.zeros(pad_edges, bool)])
    batch_idx = np.sort(rng.integers(0, num_graphs, n_nodes)).astype(np.int32)
    return h, edge_index, edge_mask, batch_idx


@pytest.mark.parametrize("op,masked,width", [
    ("sum", False, 3), ("sum", True, 3), ("mean", False, 3), ("mean", True, 3),
    ("max", False, 3), ("softmax", False, None), ("softmax", True, None), ("softmax", True, 4)])
def test_segment_ops_match_jax(op, masked, width):
    rng = np.random.default_rng(3)
    n, num = 40, 7  # segments 5 and 6 stay empty
    data = rng.normal(size=(n,) if width is None else (n, width)).astype(np.float32)
    ids = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.7 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else t(mask)
    if op == "max":
        want = jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids), num_segments=num)
        got = pseg.segment_max(t(data), t(ids), num)
    else:
        jfn = {"sum": jseg.segment_sum, "mean": jseg.segment_mean,
               "softmax": jseg.segment_softmax}[op]
        pfn = {"sum": pseg.segment_sum, "mean": pseg.segment_mean,
               "softmax": pseg.segment_softmax}[op]
        want = jfn(jnp.asarray(data), jnp.asarray(ids), num, mask=jm)
        got = pfn(t(data), t(ids), num, mask=pm)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if op in ("sum", "mean"):
        assert (got.numpy()[5:] == 0).all()  # empty segments
    if op == "max":
        assert np.isneginf(got.numpy()[5:]).all()


def test_pignn_layer_matches_jax():
    rng = np.random.default_rng(0)
    d, H = 32, 4
    h, ei, em, bi = graph(rng, d=d)
    e = rng.normal(size=(ei.shape[1], d)).astype(np.float32)
    layer = jgnn.PiGNNLayer(d_emb=d, n_heads=H, dropout=0.0)
    args = (jnp.asarray(h), jnp.asarray(e), jnp.asarray(ei), jnp.asarray(bi), jnp.asarray(em))
    params = jax_params(layer, rng, *args, num_graphs=2)
    jh, je = jax.jit(lambda p: layer.apply({"params": p}, *args, num_graphs=2))(params)
    port = load(PiGNNLayer(d, H, dropout=0.0), params)
    ph, pe = port(t(h), t(e), t(ei), t(bi), t(em), num_graphs=2)
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(pe.detach().numpy(), np.asarray(je), **F32)


@pytest.fixture(scope="module")
def multilayer():
    rng = np.random.default_rng(1)
    d = 32
    h, ei, em, bi = graph(rng, n_nodes=16, n_edges=40, pad_edges=8, num_graphs=3, d=d)
    jcfg = JGNNConfig(num_layers=2, num_heads=4, dropout=0.0)
    net = jgnn.MultiLayerPiGNN(cfg=jcfg, latent_dim=d)
    args = (jnp.asarray(h), jnp.asarray(ei), jnp.asarray(bi), jnp.asarray(em))
    params = jax_params(net, rng, *args, num_graphs=3)
    want = np.asarray(jax.jit(lambda p: net.apply({"params": p}, *args, num_graphs=3))(params))
    port = load(MultiLayerPiGNN(GNNConfig(num_layers=2, num_heads=4, dropout=0.0), d), params)
    return port, (h, ei, em, bi), want


def test_multilayer_pignn_matches_jax(multilayer):
    port, (h, ei, em, bi), want = multilayer
    got = port(t(h), t(ei), t(bi), t(em), num_graphs=3)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


def test_multilayer_pignn_ignores_padded_edges(multilayer):
    port, (h, ei, em, bi), want = multilayer
    extra = 24  # more padding, pointing at node 0 and masked
    ei2 = np.concatenate([ei, np.zeros((2, extra), ei.dtype)], axis=1)
    em2 = np.concatenate([em, np.zeros(extra, bool)])
    got = port(t(h), t(ei2), t(bi), t(em2), num_graphs=3)
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
