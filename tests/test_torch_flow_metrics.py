"""The port's flow metrics, ESM projection heads and gene-embedding
pipeline (clip_dplm_tpu_torch: train/metrics.py, models/esm_projections.py,
data/gene_embeddings.py) against the JAX package on the same numpy inputs
and weights, in f32: the Gaussian W2, the Frechet distance, the RBF MMD, the
sliced W2 given JAX's projection matrix, and `FlowEvaluator` (rtol 1e-4 /
atol 1e-5); `ProteinProjection` and `GeneProjection` (the attention's
flax layout converted); the embed functions over the ESM-2, ProtT5 and
RNABERT towers; `build_gene_embedding_dict` with its cache. No test calls
the network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_dplm_tpu.data import gene_embeddings as jge
from clip_dplm_tpu.models import esm_projections as jproj
from clip_dplm_tpu.train import metrics as jmetrics
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data import gene_embeddings as pge
from clip_dplm_tpu_torch.models import esm_projections as pproj
from clip_dplm_tpu_torch.models.esm import ESMTower
from clip_dplm_tpu_torch.train import metrics as pmetrics
from clip_dplm_tpu_torch.utils.convert import load_flax_params, state_dict_to_flax
from test_torch_pretrained import _jax_esm
from test_torch_segment_gnn import F32, jax_params, load, t
from test_torch_t5_rnabert import RNA, SEQS
from test_torch_t5_rnabert import _pair as tower_pair


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 5)).astype(np.float32)
    y = (0.8 * rng.normal(size=(48, 5)) + 0.3).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", ["wasserstein2_gaussian", "frechet_distance", "mmd_rbf"])
def test_distribution_metrics_match_jax(samples, name):
    x, y = samples
    want = float(getattr(jmetrics, name)(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(getattr(pmetrics, name)(t(x), t(y))), want, **F32)


def test_sliced_wasserstein_and_evaluator(samples):
    x, y = samples
    key = jax.random.PRNGKey(0)
    want = float(jmetrics.sliced_wasserstein(jnp.asarray(x), jnp.asarray(y), key=key))
    proj = np.asarray(jax.random.normal(key, (5, 64)))  # JAX's own draw, before normalizing
    np.testing.assert_allclose(float(pmetrics.sliced_wasserstein(t(x), t(y), proj=t(proj))),
                               want, **F32)
    got = pmetrics.FlowEvaluator(seed=3).compute_all_metrics(t(x), t(y))
    again = pmetrics.sliced_wasserstein(t(x), t(y), generator=torch.Generator().manual_seed(3))
    assert got["wasserstein"] == float(again) > 0
    ref = jmetrics.FlowEvaluator().compute_all_metrics(jnp.asarray(x), jnp.asarray(y))
    assert set(got) == set(ref)
    for k in ("mmd", "fid"):
        np.testing.assert_allclose(got[k], ref[k], **F32)


@pytest.mark.parametrize("kind", ["protein", "gene"])
def test_projection_heads_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 24)).astype(np.float32)
    if kind == "protein":
        jm, pm = jproj.ProteinProjection(out_dim=16, dropout=0.0), pproj.ProteinProjection(
            24, 16, dropout=0.0)
    else:
        jm, pm = (jproj.GeneProjection(out_dim=16, num_heads=4, dropout=0.0),
                  pproj.GeneProjection(24, 16, num_heads=4, dropout=0.0))
    params = jax_params(jm, rng, jnp.asarray(x))
    load(pm, params)
    np.testing.assert_allclose(pm(t(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(x))), **F32)
    # back to flax's layout, attention heads included
    back = state_dict_to_flax(pm)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                           params, back)


def test_embed_functions_match_jax():
    jcfg, jtower, params = _jax_esm()
    pcfg = pconfig.ESMConfig(name="t", d_model=64, num_layers=2, num_heads=4)
    port = load_flax_params(ESMTower(pcfg, torch.float32), params)
    seqs = ["MKTAYIAKQR", "GAVLI", "MSTNPKPQRKTKRNTNRRPQDVKFPGG"]
    np.testing.assert_allclose(pge.make_esm_embed_fn(port, max_len=64)(seqs),
                               jge.make_esm_embed_fn(jtower, {"params": params}, 64)(seqs),
                               **F32)
    for kind, make_j, make_p, data, kw in (
            ("t5", jge.make_prot_t5_embed_fn, pge.make_prot_t5_embed_fn, SEQS, {}),
            ("bert", jge.make_rnabert_embed_fn, pge.make_rnabert_embed_fn, RNA,
             {"pooling": "mean"})):
        _, _, jm, jparams, pm = tower_pair(kind)
        got = make_p(pm, **kw)(data)
        np.testing.assert_allclose(got, make_j(jm, {"params": jparams}, **kw)(data), **F32,
                                   err_msg=kind)
        assert got.dtype == np.float32


def test_gene_embedding_dict_and_cache(tmp_path):
    calls = []

    def embed(seqs):
        calls.append(list(seqs))
        return np.stack([np.full(3, len(s), np.float32) for s in seqs])

    genes = {"A": "MKV", "B": "MKVLA", "C": None, "D": "M" * 20, "E": "MKV"}
    path = str(tmp_path / "cache.npz")
    out = pge.build_gene_embedding_dict(genes, embed, batch_size=2, max_len_aa=10,
                                        cache=pge.EmbeddingCache(path))
    want = jge.build_gene_embedding_dict(genes, embed, batch_size=2, max_len_aa=10)
    assert set(out) == set(want) == {"A", "B", "E"}
    for g in out:
        np.testing.assert_array_equal(out[g], want[g])
    calls.clear()
    again = pge.build_gene_embedding_dict(genes, embed, cache=pge.EmbeddingCache(path),
                                          max_len_aa=10)
    assert not calls and set(again) == set(out)  # every sequence came from the cache
    assert pge.EmbeddingCache.key("MKV") == jge.EmbeddingCache.key("MKV")
