"""The port's cell-data pipeline (clip_dplm_tpu_torch/data/cells.py,
data/multimodal.py, the triple_flow registry entry) against the JAX
package's, bit for bit, at the same seeds: the kNN graph (the port's
brute-force kNN against scikit-learn's), diffusion maps and DPT, leiden,
modularity, PAGA and the cluster graph, top DEGs, HVG selection, one-hot
labels, the trajectory info, `TripleFlowDataset.batch`, the augmentation,
the collator, the memory queue, `.npz` round trips and the registry's
batches."""

import itertools

import jax  # noqa: F401  (the JAX package's data modules are numpy; keep JAX on the CPU)
import numpy as np
import pytest

from clip_dplm_tpu import config as jconfig
from clip_dplm_tpu.data import cells as jc
from clip_dplm_tpu.data import multimodal as jmm
from clip_dplm_tpu.experiments.registry import build_data as jax_build_data
from clip_dplm_tpu_torch import config as pconfig
from clip_dplm_tpu_torch.data import cells as pc
from clip_dplm_tpu_torch.data import multimodal as pmm
from clip_dplm_tpu_torch.experiments.registry import build_data


def equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            equal(a[k], b[k])
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cells():
    """(JAX's, the port's) trajectory info over the same synthetic cells."""
    return tuple(m.compute_trajectory_info(m.CellData.synthetic(n_cells=160, n_genes=48, seed=2))
                 for m in (jc, pc))


@pytest.mark.parametrize("n,g,seed", [(1024, 2000, 0), (200, 100, 3), (90, 16, 1)])
def test_knn_graph_is_sklearns(n, g, seed):
    X = jc.CellData.synthetic(n_cells=n, n_genes=g, seed=seed).X
    for k in (15, 8):
        equal(pc.knn_graph(X, k), jc.knn_graph(X, k))


def test_trajectory_info_matches_jax(cells):
    j, p = cells
    equal(p.obs, j.obs)
    equal(p.obsm, j.obsm)
    for key in ("edge_index", "connectivities", "iroot"):
        equal(p.uns[key], j.uns[key])
    equal(p.uns["paga"]["connectivities"], j.uns["paga"]["connectivities"])


def test_graph_statistics_match_jax(cells):
    j, _ = cells
    conn, labels = j.uns["connectivities"], j.obs["leiden"]
    equal(pc.diffusion_map(conn, 6), jc.diffusion_map(conn, 6))
    equal(pc.diffusion_pseudotime(conn, 3, 6), jc.diffusion_pseudotime(conn, 3, 6))
    for res, seed in ((1.0, 0), (0.5, 3)):
        equal(pc.leiden_clusters(conn, res, seed), jc.leiden_clusters(conn, res, seed))
    assert pc.modularity(conn, labels) == jc.modularity(conn, labels)
    equal(pc.paga_connectivities(conn, labels), jc.paga_connectivities(conn, labels))
    equal(pc.cluster_graph(conn, labels), jc.cluster_graph(conn, labels))


def test_gene_level_helpers_match_jax(cells):
    j, _ = cells
    equal(pc.top_degs(j.layers["X_pert"], 3, 4), jc.top_degs(j.layers["X_pert"], 3, 4))
    equal(pc.select_hvg(j.X, 20), jc.select_hvg(j.X, 20))
    equal(pc.one_hot_labels(j.obs["cell_type"]), jc.one_hot_labels(j.obs["cell_type"]))


def test_npz_round_trip(tmp_path):
    c = pc.CellData.synthetic(n_cells=30, n_genes=8, seed=1)
    c.save(str(tmp_path / "c.npz"))
    back = jc.CellData.load(str(tmp_path / "c.npz"))
    equal(back.X, c.X)
    equal(back.obs, c.obs)
    with pytest.raises(ImportError, match="anndata"):
        pc.CellData.read_h5ad(str(tmp_path / "missing.h5ad"))


def _datasets(cells):
    rng = np.random.default_rng(4)
    g2e = {g: rng.normal(size=12).astype(np.float32) for g in range(48)}
    prot = rng.normal(size=(160, 12)).astype(np.float32)
    return tuple(m.TripleFlowDataset(c, gene_to_esm=g2e, protein_embeddings=prot, n_top_degs=6)
                 for m, c in zip((jmm, pmm), cells))


def test_dataset_augmentation_and_loader_match_jax(cells):
    jd, pd = _datasets(cells)
    ids = np.random.default_rng(5).permutation(160)[:40]
    equal(pd.batch(ids), jd.batch(ids))
    equal(pd.batch(ids, max_edges_per_node=2), jd.batch(ids, max_edges_per_node=2))
    acfg = dict(gene_dropout=0.2, edge_dropout=0.3, perturbation_noise=0.1)
    jaug = jmm.DataAugmentation(jconfig.AugmentConfig(**acfg), seed=9)
    paug = pmm.DataAugmentation(pconfig.AugmentConfig(**acfg), seed=9)
    for _ in range(2):
        equal(paug(pd.batch(ids)), jaug(jd.batch(ids)))
    for jb, pb in itertools.zip_longest(jmm.get_dataloader(jd, 32, augment=jaug, seed=1),
                                        pmm.get_dataloader(pd, 32, augment=paug, seed=1)):
        equal(pb, jb)


def test_collator_and_queue_match_jax(cells):
    jd, pd = _datasets(cells)
    samples = [pd.batch(np.arange(s, s + n)) for s, n in ((0, 10), (20, 7), (50, 12))]
    equal(pmm.MultiModalBatch()(samples), jmm.MultiModalBatch()(samples))
    jq, pq = jmm.MemoryQueue(16, 3), pmm.MemoryQueue(16, 3)
    rng = np.random.default_rng(6)
    for b in (5, 9, 7, 20, 3):
        x = rng.normal(size=(b, 3)).astype(np.float32)
        jq.enqueue_dequeue(x)
        pq.enqueue_dequeue(x)
        equal(pq.get(), jq.get())
        assert (pq.ptr, pq.filled) == (jq.ptr, jq.filled)


def test_registry_batches_match_jax():
    overrides = ["experiment=triple_flow", "encoders.gene_dim=40", "encoders.esm_dim=16",
                 "train.batch_size=128"]
    jtrain, jval = jax_build_data(jconfig.apply_overrides(jconfig.Config(), overrides))
    ptrain, pval = build_data(pconfig.apply_overrides(pconfig.Config(), overrides))
    for jb, pb in itertools.zip_longest(jtrain(seed=7), ptrain(seed=7)):
        equal(pb, jb)
    for jb, pb in itertools.zip_longest(jval(), pval()):
        equal(pb, jb)
